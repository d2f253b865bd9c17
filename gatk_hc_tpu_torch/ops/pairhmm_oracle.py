"""PairHMM forward oracle — exact semantics of the reference's main path
(pairhmm/native/avx-pairhmm-template.h + intel_pairhmm.hpp).

Replicated semantics (deliberate, see SURVEY.md §3 quirks):

* Transition probabilities come from the constant GOP='I'/GCP='+' strings
  indexed into ph2pr by RAW ASCII byte (``tc->i[r-1] & 127``) — so 'I'(73)
  acts as Phred-73 and '+'(43) as Phred-43, NOT Q40/Q10.  Base qualities are
  likewise raw-ASCII-indexed.  (The reference's *scalar* PairHMM instead uses
  a fixed transition matrix and offset-corrected quals — it is dead code on
  the main path; we expose it as `scalar_reference_likelihoods` for tests.)
* Recurrences per cell (computeMXY, avx-pairhmm-template.h:183-198):
    M[r][c] = distm(r,c) * ((M[r-1][c-1]*pMM + X[r-1][c-1]*pGAPM)
                            + Y[r-1][c-1]*pGAPM)
    X[r][c] = M[r-1][c]*pMX + X[r-1][c]*pXX        (consumes a read base)
    Y[r][c] = M[r][c-1]*pMY + Y[r][c-1]*pYY        (consumes a hap base)
  with distm = match? (1-q) : q/3 and N matching everything; row 0 has
  M=X=0, Y=INITIAL_CONSTANT/haplen; column 0 is all zeros for r>=1.
* float32 first with flush-to-zero after every arithmetic op
  (intel_pairhmm.hpp:102-105 enables FTZ; DAZ is NOT set), rescue to
  float64 when the f32 result < MIN_ACCEPTED=1e-28f
  (intel_pairhmm.hpp:135-143).
* result = sum over the last row of M (left to right), plus the same for X,
  then sumM+sumX (avx-pairhmm-template.h:308-343: per-lane accumulation in
  anti-diagonal order equals column order for the final row).

The oracle vectorizes along anti-diagonals, which preserves bit-exact per-cell
arithmetic (each cell's fp expression tree is fixed; evaluation order across
cells does not matter), and keeps the final-row summation sequential.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.quality import (
    BASE_TABLE,
    AMBIG_CODE,
    INITIAL_CONSTANT_F32,
    INITIAL_CONSTANT_F64,
    LOG10_INITIAL_CONSTANT_F32,
    LOG10_INITIAL_CONSTANT_F64,
    MATCH_TO_MATCH_F32,
    MATCH_TO_MATCH_F64,
    MIN_ACCEPTED,
    PH2PR_F32,
    PH2PR_F64,
    set_mm_prob,
)

_F32_MIN_NORMAL = np.float32(np.ldexp(1.0, -126))


def _ftz32(x: np.ndarray) -> np.ndarray:
    """Flush subnormal float32 RESULTS to zero (FTZ, not DAZ)."""
    return np.where(np.abs(x) < _F32_MIN_NORMAL, np.float32(0.0), x).astype(np.float32)


def row_params(
    quals: np.ndarray,  # uint8 ASCII, shape (R,)
    gop: int,
    gcp: int,
    dtype,
) -> Tuple[np.ndarray, ...]:
    """Per-read-row transition probabilities + priors
    (initializeVectors, avx-pairhmm-template.h:83-128)."""
    ph2pr = PH2PR_F32 if dtype == np.float32 else PH2PR_F64
    m2m = MATCH_TO_MATCH_F32 if dtype == np.float32 else MATCH_TO_MATCH_F64
    i_q = gop & 127
    d_q = gop & 127
    c_q = gcp & 127
    R = len(quals)
    p_mm = np.full(R, set_mm_prob(i_q, d_q, m2m), dtype=dtype)
    p_gapm = np.full(R, dtype(1.0) - ph2pr[c_q], dtype=dtype)
    p_mx = np.full(R, ph2pr[i_q], dtype=dtype)
    p_xx = np.full(R, ph2pr[c_q], dtype=dtype)
    p_my = np.full(R, ph2pr[d_q], dtype=dtype)
    p_yy = np.full(R, ph2pr[c_q], dtype=dtype)
    q = ph2pr[(quals & 127).astype(np.int64)].astype(dtype)
    return p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, q


def pairhmm_prob(
    read_bases: np.ndarray,  # uint8 ASCII
    read_quals: np.ndarray,  # uint8 ASCII
    hap_bases: np.ndarray,  # uint8 ASCII
    gop: int = ord("I"),
    gcp: int = ord("+"),
    dtype=np.float32,
    ftz: bool = True,
) -> float:
    """Raw forward probability (scaled by INITIAL_CONSTANT) for one pair."""
    R = len(read_bases)
    C = len(hap_bases)
    f32 = dtype == np.float32
    initial = INITIAL_CONSTANT_F32 if f32 else INITIAL_CONSTANT_F64
    flush = _ftz32 if (f32 and ftz) else (lambda x: x)

    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, q = row_params(read_quals, gop, gcp, dtype)
    one_minus_q = (dtype(1.0) - q).astype(dtype)
    q_div3 = (q / dtype(3.0)).astype(dtype)

    rs = BASE_TABLE[read_bases]
    hap = BASE_TABLE[hap_bases]
    init_y = dtype(initial / dtype(C)) if f32 else initial / C

    # Diagonal arrays indexed by row r (0..R); diagonal d holds cells (r, d-r).
    zeros = np.zeros(R + 1, dtype=dtype)
    M_d2, X_d2, Y_d2 = zeros.copy(), zeros.copy(), zeros.copy()
    M_d1, X_d1, Y_d1 = zeros.copy(), zeros.copy(), zeros.copy()
    # d=0: only cell (0,0): row-0 boundary
    Y_d2[0] = init_y
    # d=1: cells (0,1) and (1,0): Y_d1[0]=init_y (row 0), col-0 zeros
    Y_d1[0] = init_y

    sum_m = np.zeros(C + 1, dtype=dtype)  # sum_m[c] = M[R][c]
    sum_x = np.zeros(C + 1, dtype=dtype)

    r_idx = np.arange(R + 1)
    zero1 = np.array([0.0], dtype=dtype)
    read_codes = np.concatenate(([0], rs))  # read_codes[r] = rs[r-1]
    omq = np.concatenate((zero1, one_minus_q))
    q3 = np.concatenate((zero1, q_div3))
    pmm = np.concatenate((zero1, p_mm))
    pgapm = np.concatenate((zero1, p_gapm))
    pmx = np.concatenate((zero1, p_mx))
    pxx = np.concatenate((zero1, p_xx))
    pmy = np.concatenate((zero1, p_my))
    pyy = np.concatenate((zero1, p_yy))

    # shift by one row: value at (r-1, ...) moves to index r
    def up(a: np.ndarray) -> np.ndarray:
        out = np.empty_like(a)
        out[0] = dtype(0.0)
        out[1:] = a[:-1]
        return out

    for d in range(2, R + C + 1):
        c_of_r = d - r_idx
        valid = (r_idx >= 1) & (c_of_r >= 1) & (c_of_r <= C)
        # distm: match selector for cells (r, d-r)
        hap_codes = hap[np.clip(c_of_r - 1, 0, C - 1)]
        match = (
            (read_codes == hap_codes)
            | (read_codes == AMBIG_CODE)
            | (hap_codes == AMBIG_CODE)
        )
        distm = np.where(match, omq, q3).astype(dtype)

        t1 = flush(up(M_d2) * pmm)
        t2 = flush(up(X_d2) * pgapm)
        t3 = flush(up(Y_d2) * pgapm)
        M_new = flush(flush(flush(t1 + t2) + t3) * distm)
        X_new = flush(flush(up(M_d1) * pmx) + flush(up(X_d1) * pxx))
        Y_new = flush(flush(M_d1 * pmy) + flush(Y_d1 * pyy))

        M_new = np.where(valid, M_new, dtype(0.0)).astype(dtype)
        X_new = np.where(valid, X_new, dtype(0.0)).astype(dtype)
        Y_new = np.where(valid, Y_new, dtype(0.0)).astype(dtype)
        # boundaries for the NEXT diagonals: row 0 keeps Y=init_y while it is
        # still inside the matrix (c = d <= C)
        if d <= C:
            Y_new[0] = init_y

        # capture last-row cells
        c_last = d - R
        if 1 <= c_last <= C:
            sum_m[c_last] = M_new[R]
            sum_x[c_last] = X_new[R]

        M_d2, X_d2, Y_d2 = M_d1, X_d1, Y_d1
        M_d1, X_d1, Y_d1 = M_new, X_new, Y_new

    # Final accumulation: sumM then sumX, each left-to-right, then add.
    acc_m = dtype(0.0)
    acc_x = dtype(0.0)
    for c in range(1, C + 1):
        acc_m = dtype(acc_m + sum_m[c])
        acc_x = dtype(acc_x + sum_x[c])
    return float(dtype(acc_m + acc_x))


def pairhmm_log10_batch(
    reads: Sequence[Tuple[np.ndarray, np.ndarray]],
    haps: Sequence[np.ndarray],
    gop: int = ord("I"),
    gcp: int = ord("+"),
    ftz: bool = True,
    rescue_mode: str = "exact",
) -> np.ndarray:
    """Read-major log10 likelihood matrix, float-first + double rescue
    (intel_pairhmm.hpp:128-147).  rescue_mode matches finalize_log10 so the
    oracle's matrix stays bit-identical to the production engines under
    either cfg.f64_rescue setting."""
    out = np.zeros((len(reads), len(haps)), dtype=np.float64)
    for i, (bases, quals) in enumerate(reads):
        for j, hap in enumerate(haps):
            pf = np.float32(pairhmm_prob(bases, quals, hap, gop, gcp, np.float32, ftz))
            if pf < MIN_ACCEPTED:
                if rescue_mode == "sentinel":
                    out[i, j] = RESCUE_SENTINEL_LOG10
                else:
                    pd = pairhmm_prob(bases, quals, hap, gop, gcp, np.float64)
                    out[i, j] = np.log10(pd) - LOG10_INITIAL_CONSTANT_F64
            else:
                out[i, j] = float(
                    np.log10(pf, dtype=np.float32) - LOG10_INITIAL_CONSTANT_F32
                )
    return out


# Stand-in log10 likelihood for pairs whose f32 probability underflowed
# MIN_ACCEPTED, used in "sentinel" rescue mode.  Provably VCF-neutral: a
# rescued pair's true log10 is <= log10(1e-28) - log10(2^120) ~= -64.1, while
# (a) if every hap of a read underflows, best <= -64.1 is far below the
# poorly-modeled-read threshold (>= -8 for len>=10, intel_pairhmm.hpp:24-46)
# so the read is dropped for ANY stand-in <= -64.1, and (b) if the read is
# kept, best > -8 comes from a non-rescued pair and normalization floors the
# rescued entry to exactly best-4.5 regardless of its value.  Verified
# empirically: identical VCFs on the chrM and 2Mb fixtures in both modes.
RESCUE_SENTINEL_LOG10 = -100.0


def finalize_log10(
    prob_f32: np.ndarray, rescue_fn, mode: str = "exact"
) -> np.ndarray:
    """Shared conversion used by ALL engines: f32 log10 unless the raw f32
    probability is below MIN_ACCEPTED.  mode="exact": ``rescue_fn(indices)``
    returns float64 raw probabilities for those pairs (the reference's
    float->double rescue, intel_pairhmm.hpp:135-143).  mode="sentinel":
    underflowed pairs get RESCUE_SENTINEL_LOG10 without recomputation —
    ~0.13ms/pair saved, identical VCF output (see note above)."""
    prob_f32 = prob_f32.astype(np.float32)
    with np.errstate(divide="ignore"):  # fully-underflowed probs are rescued
        out = (
            np.log10(prob_f32, dtype=np.float32) - LOG10_INITIAL_CONSTANT_F32
        ).astype(np.float64)
    needs = np.nonzero(prob_f32 < MIN_ACCEPTED)[0]
    if needs.size:
        if mode == "sentinel":
            out[needs] = RESCUE_SENTINEL_LOG10
        else:
            pd = np.asarray(rescue_fn(needs), dtype=np.float64)
            out[needs] = np.log10(pd) - LOG10_INITIAL_CONSTANT_F64
    return out


def scalar_reference_log10(
    read_bases: np.ndarray,
    read_quals: np.ndarray,
    mapq: int,
    hap_bases: np.ndarray,
) -> float:
    """The reference's *scalar* PairHMM (pairhmm/pairhmm.hpp) — dead code on
    its main path but the semantic sanity oracle: fixed transition matrix
    {0.9998,1e-4,1e-4,0.9,0.1,0.9,0.1}, offset-corrected quals capped at
    MAPQ, full-f64 DP, final sum of M+D over the last row."""
    from ..utils.quality import QUAL_TO_ERROR_PROB, ASCII_OFFSET

    t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd = (
        0.9998, 0.0001, 0.0001, 0.9, 0.1, 0.9, 0.1,
    )
    R, C = len(read_bases), len(hap_bases)
    initial = INITIAL_CONSTANT_F64
    quals = np.minimum(read_quals, ASCII_OFFSET + mapq)  # pairhmm.hpp:113-118
    M = np.zeros((R + 1, C + 1))
    I = np.zeros((R + 1, C + 1))
    D = np.zeros((R + 1, C + 1))
    D[0, :] = initial / C
    err = QUAL_TO_ERROR_PROB[quals & 127]
    for i in range(1, R + 1):
        x = read_bases[i - 1]
        for j in range(1, C + 1):
            y = hap_bases[j - 1]
            is_match = x == y or x == ord("N") or y == ord("N")
            p = (1.0 - err[i - 1]) if is_match else err[i - 1] / 3.0
            M[i, j] = p * (
                M[i - 1, j - 1] * t_mm
                + I[i - 1, j - 1] * t_im
                + D[i - 1, j - 1] * t_dm
            )
            I[i, j] = M[i - 1, j] * t_mi + I[i - 1, j] * t_ii
            D[i, j] = M[i, j - 1] * t_md + D[i, j - 1] * t_dd
    final = float(np.sum(M[R, 1:]) + np.sum(D[R, 1:]))
    return float(np.log10(final) - LOG10_INITIAL_CONSTANT_F64)


def normalize_and_filter(
    log_likelihoods: np.ndarray,  # (n_reads, n_haps) float64
    read_lengths: Sequence[int],
    max_best_alt_diff: float = -4.5,
    expected_error_rate: float = 0.02,
    log10_quality_per_base: float = -4.0,
    max_expected_error: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """normalize_likelihoods_and_filter_poorly_modeled_reads
    (intel_pairhmm.hpp:24-46).  Returns (filtered matrix, kept row indices)."""
    if log_likelihoods.shape[0] == 0:
        return log_likelihoods.copy(), np.empty(0, dtype=np.int64)
    best = log_likelihoods.max(axis=1)  # row max is order-independent
    out = np.maximum(log_likelihoods, (best + max_best_alt_diff)[:, None])
    lens = np.asarray(read_lengths, dtype=np.float64)  # one vectorized
    # convert (the int arrays from columnar callers still copy to f64, but
    # without np.fromiter's per-element Python iteration)
    threshold = (
        np.minimum(max_expected_error, np.ceil(lens * expected_error_rate))
        * log10_quality_per_base
    )
    kept = np.nonzero(best >= threshold)[0]
    return out[kept], kept
