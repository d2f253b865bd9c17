"""Smith-Waterman with backtrack — exact semantics of the reference's native
AVX2 engine (smithwaterman/native/PairWiseSW.h), which is what the assembly
path uses to align haplotypes to the window reference
(graph_wrapper.hpp:232-239, SOFTCLIP overhang, NEW_SW_PARAMETERS).

This NumPy implementation is the *oracle*; the C++ library in
``gatk_hc_tpu/native`` is the production host engine and is differential-
tested against this.  All arithmetic is integer, so vectorization is exact.

Semantics replicated from PairWiseSW.h:

* recurrences (MAIN_CODE, :4-38):
    E[i][j] = max(H[i][j-1] + open, E[i][j-1] + extend)   (gap in ref, 'I')
    F[i][j] = max(H[i-1][j] + open, F[i-1][j] + extend)   (gap in alt, 'D')
    H[i][j] = max(MATRIX_MIN_CUTOFF, m11, E[i][j], F[i][j]),
      m11 = H[i-1][j-1] + (match ? w_match : w_mismatch)
* backtrack code: 2-bit base (0=M, 1=I, 2=D; I wins only strictly over
  max(cutoff, m11); D wins only strictly over max(cutoff, m11, E)), plus
  INSERT_EXT when H[i][j-1]+open <= E[i][j-1]+extend and DELETE_EXT when
  H[i-1][j]+open <= F[i-1][j]+extend (both flags always recorded).
* start-cell selection scans anti-diagonals in order, bottom-row check
  before last-column check, with the reference's exact tie-breaks
  (PairWiseSW.h:202-227).
* CIGAR walk + run-length merge + soft-clip emission (getCIGAR, :240-415).

The row-wise E vectorization uses: with open <= extend,
E[i][j] = extend*j + cummax_{k<j}(H'[i][k] + open - extend*k) where
H' = max(cutoff, m11, F) — exact because H = max(H', E) and E+open <= E+ext.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import NEW_SW_PARAMETERS, SWParameters
from ..utils.cigar import Cigar

MATCH = 0
INSERT = 1
DELETE = 2
INSERT_EXT = 4
DELETE_EXT = 8

MATRIX_MIN_CUTOFF = -100000000
LOW_INIT_VALUE = -(2 ** 30)  # any "very low" works: never selected nor tied

_OP_CHARS = {MATCH: "M", INSERT: "I", DELETE: "D", 9: "S"}
SOFTCLIP_CODE = 9


def is_all_match(ref: str, alt: str, max_mismatches: int = 2) -> bool:
    """intel_smithwaterman.hpp:47-58: equal length and <= 2 mismatches."""
    if len(ref) != len(alt):
        return False
    mismatches = 0
    for r, a in zip(ref, alt):
        if r != a:
            mismatches += 1
            if mismatches > max_mismatches:
                return False
    return True


def sw_align(
    ref: str,
    alt: str,
    params: SWParameters = NEW_SW_PARAMETERS,
    max_mismatches_all_match: int = 2,
) -> Tuple[int, Cigar]:
    """Align ``alt`` (haplotype) against ``ref`` (window reference).

    Returns (alignment_offset, cigar) exactly like IntelSWAligner::align with
    the SOFTCLIP overhang strategy.  CIGAR ops are w.r.t. ``alt``.
    """
    if not ref or not alt:
        raise ValueError("non-empty sequences required for the SW aligner")
    if is_all_match(ref, alt, max_mismatches_all_match):
        return 0, ((len(ref), "M"),)

    w_open, w_extend = params.w_open, params.w_extend
    if w_open > w_extend:
        raise NotImplementedError("vectorized path assumes w_open <= w_extend")

    seq1 = np.frombuffer(ref.encode(), dtype=np.uint8)
    seq2 = np.frombuffer(alt.encode(), dtype=np.uint8)
    n, m = len(seq1), len(seq2)

    H_prev = np.zeros(m + 1, dtype=np.int64)  # H[0][*] = 0 (SOFTCLIP boundary)
    F_prev = np.full(m + 1, LOW_INIT_VALUE, dtype=np.int64)
    H_rows = np.empty((n + 1, m + 1), dtype=np.int64)
    H_rows[0] = H_prev
    bt = np.zeros((n + 1, m + 1), dtype=np.uint8)

    sub_match = np.int64(params.w_match)
    sub_mismatch = np.int64(params.w_mismatch)
    j_idx = np.arange(m + 1, dtype=np.int64)

    for i in range(1, n + 1):
        match = seq2 == seq1[i - 1]
        m11 = H_prev[:-1] + np.where(match, sub_match, sub_mismatch)
        # F for this row, from the previous row's final H and F
        f_open = H_prev[1:] + w_open
        f_ext = F_prev[1:] + w_extend
        F_row = np.maximum(f_open, f_ext)
        del_ext_flag = f_open <= f_ext  # !(open > ext)

        h_noE = np.maximum(np.int64(MATRIX_MIN_CUTOFF), m11)
        h_noE = np.maximum(h_noE, F_row)
        # exact E via cummax: E[j] = ext*j + max_{k<j}(H'[k] + open - ext*k),
        # with H'[0] = boundary H[i][0] = 0
        # E[j] = max_{k<=j-1}(H'[k] + open + (j-1-k)*ext) = ext*(j-1) + cummax g
        g = np.empty(m + 1, dtype=np.int64)
        g[0] = 0 + w_open - 0
        g[1:] = h_noE + w_open - w_extend * j_idx[1:]
        E_row = w_extend * (j_idx[1:] - 1) + np.maximum.accumulate(g)[:-1]

        H_row_inner = np.maximum(h_noE, E_row)
        H_row = np.empty(m + 1, dtype=np.int64)
        H_row[0] = 0
        H_row[1:] = H_row_inner

        # backtrack codes
        base = np.where(
            F_row > np.maximum(np.maximum(np.int64(MATRIX_MIN_CUTOFF), m11), E_row),
            np.uint8(DELETE),
            np.where(
                E_row > np.maximum(np.int64(MATRIX_MIN_CUTOFF), m11),
                np.uint8(INSERT),
                np.uint8(MATCH),
            ),
        )
        # INSERT_EXT: H[i][j-1]+open <= E[i][j-1]+ext; E[i][0] is LOW
        E_prevcol = np.empty(m + 1, dtype=np.int64)
        E_prevcol[0] = LOW_INIT_VALUE
        E_prevcol[1:] = E_row
        ins_ext_flag = (H_row[:-1] + w_open) <= (E_prevcol[:-1] + w_extend)
        code = base
        code = code | np.where(ins_ext_flag, np.uint8(INSERT_EXT), np.uint8(0))
        code = code | np.where(del_ext_flag, np.uint8(DELETE_EXT), np.uint8(0))
        bt[i, 1:] = code

        H_rows[i] = H_row
        H_prev = H_row
        F_prev[1:] = F_row
        F_prev[0] = LOW_INIT_VALUE

    max_i, max_j = _select_start_cell(H_rows, n, m)
    return _walk_cigar(bt, max_i, max_j, n, m)


def _select_start_cell(H: np.ndarray, n: int, m: int) -> Tuple[int, int]:
    """PairWiseSW.h:202-227 (SOFTCLIP strategy), anti-diagonal scan order."""
    max_score = -(2 ** 62)
    max_i = 0
    max_j = 0
    for anti in range(1, n + m + 1):
        if anti >= n + 1:  # bottom row cell (n, anti - n)
            j = anti - n
            score = int(H[n, j])
            if score > max_score or (
                score == max_score and abs(n - j) < abs(max_i - max_j)
            ):
                max_score = score
                max_i, max_j = n, j
        if anti >= m + 1:  # last column cell (anti - m, m)
            i = anti - m
            score = int(H[i, m])
            if score > max_score or (
                score == max_score
                and (max_j == m or abs(i - m) <= abs(max_i - max_j))
            ):
                max_score = score
                max_i, max_j = i, m
    return max_i, max_j


def _walk_cigar(
    bt: np.ndarray, max_i: int, max_j: int, n: int, m: int
) -> Tuple[int, Cigar]:
    """getCIGAR (PairWiseSW.h:240-415), SOFTCLIP strategy."""
    i, j = max_i, max_j
    raw: List[List[int]] = []  # [op_code, length], newest last
    if j < m:
        raw.append([SOFTCLIP_CODE, m - j])
    state = 0
    while i > 0 and j > 0:
        btr = int(bt[i, j])
        if state == INSERT_EXT:
            j -= 1
            raw[-1][1] += 1
            state = btr & INSERT_EXT
        elif state == DELETE_EXT:
            i -= 1
            raw[-1][1] += 1
            state = btr & DELETE_EXT
        else:
            op = btr & 3
            if op == MATCH:
                i -= 1
                j -= 1
                raw.append([MATCH, 1])
                state = 0
            elif op == INSERT:
                j -= 1
                raw.append([INSERT, 1])
                state = btr & INSERT_EXT
            else:  # DELETE
                i -= 1
                raw.append([DELETE, 1])
                state = btr & DELETE_EXT
    if j > 0:
        raw.append([SOFTCLIP_CODE, j])
    alignment_offset = i

    # run-length merge (:368-386), then reverse for final order (:388-413)
    merged: List[List[int]] = []
    for op, length in raw:
        if merged and merged[-1][0] == op:
            merged[-1][1] += length
        else:
            merged.append([op, length])
    cigar = tuple((length, _OP_CHARS[op]) for op, length in reversed(merged))
    return alignment_offset, cigar
