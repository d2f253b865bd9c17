"""Numeric context tables shared by every PairHMM/genotyper implementation.

These mirror the reference's numeric context exactly:

* ``ph2pr``: Phred-index -> error probability, 10^(-x/10) for x in [0,128)
  (pairhmm/native/Context.h:105-107 / 145-147).  NOTE the Intel main path
  indexes this with the RAW ASCII byte of the quality/GOP/GCP strings
  (``tc->q[r-1] & 127``, avx-pairhmm-template.h:110-126) — no ASCII-33
  offset — and we replicate that.
* ``qual_to_error_prob``: the scalar-path LUT that DOES subtract the '!'
  offset (utils/quality_utils.hpp:11-19).  Used by the assembler's
  base-quality gate and the scalar oracle.
* Jacobian log table + ``approximate_log10_sum_log10``
  (Context.h:42-47,67-90 and utils/math_utils.hpp:11-32).
* ``match_to_match_prob``: the triangular matchToMatch table
  (Context.h:50-61) and ``set_mm_prob`` (Context.h:123-134/163-174).

All tables are computed in float64 and, for the float32 context, rounded to
float32 once.  The C++ native library recomputes them with the same formulas;
``tests/test_native.py`` asserts bit-equality between the two.
"""

from __future__ import annotations

import numpy as np

ASCII_OFFSET = 33  # '!'

MAX_QUAL = 254
MAX_JACOBIAN_TOLERANCE = 8.0
JACOBIAN_LOG_TABLE_STEP = 1e-4
JACOBIAN_LOG_TABLE_INV_STEP = 1.0 / JACOBIAN_LOG_TABLE_STEP
JACOBIAN_LOG_TABLE_SIZE = int(MAX_JACOBIAN_TOLERANCE / JACOBIAN_LOG_TABLE_STEP) + 1

# Anti-underflow scaling constants (Context.h:109-111, 149-151).
INITIAL_CONSTANT_F32 = np.float32(np.ldexp(1.0, 120))
LOG10_INITIAL_CONSTANT_F32 = np.float32(np.log10(np.float64(INITIAL_CONSTANT_F32)))
INITIAL_CONSTANT_F64 = np.ldexp(1.0, 1020)
LOG10_INITIAL_CONSTANT_F64 = np.log10(INITIAL_CONSTANT_F64)
MIN_ACCEPTED = np.float32(1e-28)  # pairhmm_common.h:16


def _ph2pr(dtype) -> np.ndarray:
    x = np.arange(128, dtype=np.float64)
    return (10.0 ** (-x / 10.0)).astype(dtype)


PH2PR_F64 = _ph2pr(np.float64)
PH2PR_F32 = _ph2pr(np.float32)


def _qual_to_error_prob() -> np.ndarray:
    # quality_utils.hpp: cache[i] = 10^(-(i-33)/10) for i in [33,128), else 0
    cache = np.zeros(128, dtype=np.float64)
    i = np.arange(ASCII_OFFSET, 128, dtype=np.float64)
    cache[ASCII_OFFSET:] = 10.0 ** (-(i - ASCII_OFFSET) / 10.0)
    return cache


QUAL_TO_ERROR_PROB = _qual_to_error_prob()


def _jacobian_table(dtype) -> np.ndarray:
    k = np.arange(JACOBIAN_LOG_TABLE_SIZE, dtype=np.float64)
    return np.log10(1.0 + 10.0 ** (-k * JACOBIAN_LOG_TABLE_STEP)).astype(dtype)


JACOBIAN_F64 = _jacobian_table(np.float64)
JACOBIAN_F32 = _jacobian_table(np.float32)


def approximate_log10_sum_log10(a: float, b: float) -> float:
    """MathUtils::approximate_log10_sum_log10 (math_utils.hpp:11-15), f64.

    Note: this genotyper-side variant has no -inf special case; the table
    lookup uses round-half-away-from-zero like std::round (diff >= 0 here).
    """
    if a > b:
        a, b = b, a
    diff = b - a
    if diff < MAX_JACOBIAN_TOLERANCE:
        ind = int(np.floor(diff * JACOBIAN_LOG_TABLE_INV_STEP + 0.5))
        return b + JACOBIAN_F64[ind]
    return b


def _context_approx_log10_sum_log10(small: float, big: float) -> float:
    """ContextBase::approximateLog10SumLog10 (Context.h:67-90), f64."""
    if small > big:
        small, big = big, small
    if np.isneginf(small) or np.isneginf(big):
        return big
    diff = big - small
    if diff >= MAX_JACOBIAN_TOLERANCE:
        return big
    # fastRound: d > 0 ? int(d+0.5) : int(d-0.5)
    d = diff * JACOBIAN_LOG_TABLE_INV_STEP
    ind = int(d + 0.5) if d > 0.0 else int(d - 0.5)
    return big + JACOBIAN_F64[ind]


def _match_to_match_scalar(dtype) -> np.ndarray:
    """Triangular matchToMatchProb table (Context.h:50-61), scalar oracle.

    Entry [offset(i) + j] for j <= i is
    10^(log1p(-min(1, 10^approxLog10SumLog10(-0.1 i, -0.1 j))) / ln(10)).
    Kept as the semantic reference for ``_match_to_match`` (the vectorized
    production builder below); tests/test_quality.py asserts bit-equality.
    """
    size = ((MAX_QUAL + 1) * (MAX_QUAL + 2)) >> 1
    table = np.zeros(size, dtype=np.float64)
    inv_ln10 = 1.0 / np.log(10.0)
    offset = 0
    for i in range(MAX_QUAL + 1):
        for j in range(i + 1):
            log10_sum = _context_approx_log10_sum_log10(-0.1 * i, -0.1 * j)
            with np.errstate(divide="ignore"):  # log1p(-1) = -inf -> entry 0
                m2m_log10 = np.log1p(-min(1.0, 10.0 ** log10_sum)) * inv_ln10
            table[offset + j] = 10.0 ** m2m_log10
        offset += i + 1
    return table.astype(dtype)


def _match_to_match(dtype) -> np.ndarray:
    """Vectorized ``_match_to_match_scalar`` — bit-identical, ~400x faster.

    The scalar double loop cost ~0.8 s at import in every process (a third
    of the chrM end-to-end wall).  Vectorization notes for exactness:

    * ``np.tril_indices`` enumerates (i, j<=i) row-major — exactly the
      table's ``offset(i) + j`` flat order.
    * ``small > big`` never happens (j <= i) and neither input is -inf, so
      the swap and isneginf branches of Context.h:67-90 drop out.
    * fastRound ``d > 0 ? int(d+0.5) : int(d-0.5)`` is trunc() of the same
      expressions (int() truncates toward zero).
    * ``np.float_power`` is used for both 10**x sites: the ``**`` ufunc's
      SIMD f64 loop drifts 1 ulp from libm pow on ~5% of inputs, while
      float_power's loop matches the scalar path bit-for-bit.
    """
    inv_ln10 = 1.0 / np.log(10.0)
    ii, jj = np.tril_indices(MAX_QUAL + 1)
    small = -0.1 * ii
    big = -0.1 * jj
    diff = big - small
    d = diff * JACOBIAN_LOG_TABLE_INV_STEP
    ind = np.trunc(np.where(d > 0.0, d + 0.5, d - 0.5)).astype(np.int64)
    safe = np.clip(ind, 0, JACOBIAN_LOG_TABLE_SIZE - 1)
    log10_sum = np.where(
        diff >= MAX_JACOBIAN_TOLERANCE, big, big + JACOBIAN_F64[safe]
    )
    with np.errstate(divide="ignore"):  # log1p(-1) = -inf -> entry 0
        m2m_log10 = (
            np.log1p(-np.minimum(1.0, np.float_power(10.0, log10_sum)))
            * inv_ln10
        )
    return np.float_power(10.0, m2m_log10).astype(dtype)


MATCH_TO_MATCH_F64 = _match_to_match(np.float64)
# the f32 table is the f64 table rounded once (both builders compute in f64)
MATCH_TO_MATCH_F32 = MATCH_TO_MATCH_F64.astype(np.float32)


def set_mm_prob(ins_qual: int, del_qual: int, table: np.ndarray) -> float:
    """Context::set_mm_prob (Context.h:123-134).  Quals are raw indices."""
    min_q, max_q = (ins_qual, del_qual) if ins_qual <= del_qual else (del_qual, ins_qual)
    if max_q > MAX_QUAL:  # unreachable for & 127 inputs; kept for parity
        return 1.0 - 10.0 ** _context_approx_log10_sum_log10(-0.1 * min_q, -0.1 * max_q)
    return float(table[((max_q * (max_q + 1)) >> 1) + min_q])


# Base encoding used by every kernel: A=0, C=1, T=2, G=3, N=4
# (pairhmm_common.h:30-39).  Any other byte maps to 0 ('A'), matching the
# zero-initialized conversionTable in the reference.
def base_conversion_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    for ch, code in (("A", 0), ("C", 1), ("T", 2), ("G", 3), ("N", 4)):
        table[ord(ch)] = code
    return table


BASE_TABLE = base_conversion_table()
AMBIG_CODE = 4
