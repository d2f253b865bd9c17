"""The plain PairHMM reference and the comparison that decides ``correct``.

Plain PyTorch, independent of the port: it imports nothing of
``gatk_hc_tpu_torch`` and takes nothing the program made.  From the
harness's own reads, qualities and haplotypes it computes every pair's
log10 likelihood by the forward recurrence of GATK's main PairHMM path
(the reference's ``avx-pairhmm-template.h``), in float64:

* transitions from the constant gap strings, indexed by their raw ASCII
  byte as the main path does: GOP 'I' (73) and GCP '+' (43), so
  p(M->M) = 1 - 2 * 10^-7.3, p(gap->M) = 1 - 10^-4.3, p(M->I) = p(M->D) =
  10^-7.3, p(I->I) = p(D->D) = 10^-4.3;
* base error q = 10^(-(qual & 127) / 10), the raw ASCII byte again; the
  emission is 1 - q on a match (N matches anything) and q / 3 otherwise;
* M, X (a read base against a gap) and Y (a haplotype base against a gap)
  per cell; row 0 holds Y = scale / haplotype length, column 0 zeros;
* the likelihood is the last row's M and X summed over the columns,
  scaled by 2^1020 here and unscaled in log10.

The program computes the forward in float32 with flush-to-zero, scaled by
2^120, and its finalize writes log10(p) - log10(2^120), or the sentinel
-100 where the scaled float32 probability is below 1e-28 (its default
``f64_rescue="sentinel"``).  ``gaps`` holds each of its answers to that
rule against the float64 truth:

* a sentinel is right where the truth lies below the threshold; above it,
  its gap is how far above;
* any other answer's gap is its distance from the truth.

The widest gap over the checked pairs is the number compared.  Its limit
and the readings it was set from are in the configuration's file and in
``PERF.md``.

The control puts this reference in the program's place computed one
precision lower, bfloat16 for float32 (``forward(..., torch.bfloat16)``
and ``finalize``): it has to fail the limit.

Pairs run in blocks along anti-diagonals, vectorised over the block's
pairs: diagonal d holds the cells (r, d - r), so each cell reads the two
diagonals before it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

GOP = 73  # 'I'
GCP = 43  # '+'
MIN_ACCEPTED = float(np.float32(1e-28))  # the program's underflow test
SENTINEL = -100.0
SCALE_F32 = 2.0 ** 120  # the program's and the control's scale
SCALE_F64 = 2.0 ** 1020
# a sentinel is due where the unscaled log10 likelihood lies below this
THRESHOLD_LOG10 = math.log10(MIN_ACCEPTED) - 120 * math.log10(2.0)

N_CODE = 4


def _codes() -> np.ndarray:
    table = np.full(256, 255, np.uint8)  # 255: not a base the traffic makes
    for k, ch in enumerate("ACGTN"):
        table[ord(ch)] = k
    return table


CODES = _codes()


def ph2pr(q) -> float:
    return 10.0 ** (-(q & 127) / 10.0)


def transitions(gop: int = GOP, gcp: int = GCP) -> Tuple[float, ...]:
    """(M->M, gap->M, M->I, I->I, M->D, D->D) in float64."""
    i_p, c_p = ph2pr(gop), ph2pr(gcp)
    return (1.0 - (i_p + i_p), 1.0 - c_p, i_p, c_p, i_p, c_p)


def forward(reads: torch.Tensor, quals: torch.Tensor, read_len: torch.Tensor,
            haps: torch.Tensor, hap_len: torch.Tensor, dtype,
            scale: float) -> torch.Tensor:
    """The scaled forward probability of each pair, in ``dtype``.

    reads, quals: (B, R) uint8, pair b's read in its first read_len[b]
    bytes; haps: (B, C) uint8, its haplotype in the first hap_len[b]."""
    dev = reads.device
    B, R = reads.shape
    C = haps.shape[1]
    codes = torch.from_numpy(CODES).to(dev)
    rc = codes[reads.long()].T.contiguous()  # (R, B)
    hc = codes[haps.long()].T.contiguous()  # (C, B)
    q = torch.pow(10.0, -(quals.long() & 127).double() / 10.0).T
    omq = (1.0 - q).to(dtype)
    q3 = (q / 3.0).to(dtype)
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = (
        torch.tensor(t, dtype=torch.float64).to(dtype).to(dev)
        for t in transitions())
    hl = hap_len.to(dev).long()
    rl = read_len.to(dev).long()
    init_y = (scale / hl.double()).to(dtype)
    zero = torch.zeros((1, B), dtype=dtype, device=dev)

    def blank():
        return torch.zeros((R + 1, B), dtype=dtype, device=dev)

    m2, x2, y2 = blank(), blank(), blank()
    m1, x1, y1 = blank(), blank(), blank()
    y2[0] = init_y  # cell (0, 0)
    y1[0] = init_y  # cell (0, 1)
    acc_m = torch.zeros(B, dtype=dtype, device=dev)
    acc_x = torch.zeros(B, dtype=dtype, device=dev)
    rows = torch.arange(1, R + 1, device=dev)
    last = (rl - 1).clamp(min=0)[None, :]
    for d in range(2, R + C + 1):
        col = d - rows  # (R,): the column of row r on this diagonal
        valid = (col >= 1)[:, None] & (col[:, None] <= hl[None, :])
        hcol = hc.index_select(0, (col - 1).clamp(0, C - 1))
        match = (rc == hcol) | (rc == N_CODE) | (hcol == N_CODE)
        distm = torch.where(match, omq, q3)
        m_new = distm * ((m2[:-1] * p_mm + x2[:-1] * p_gapm)
                         + y2[:-1] * p_gapm)
        x_new = m1[:-1] * p_mx + x1[:-1] * p_xx
        y_new = m1[1:] * p_my + y1[1:] * p_yy
        m_new = torch.where(valid, m_new, 0.0)
        x_new = torch.where(valid, x_new, 0.0)
        y_new = torch.where(valid, y_new, 0.0)
        # each pair's last row meets one new column per diagonal
        col_last = d - rl
        take = (col_last >= 1) & (col_last <= hl)
        acc_m = acc_m + torch.where(take, m_new.gather(0, last)[0], 0.0)
        acc_x = acc_x + torch.where(take, x_new.gather(0, last)[0], 0.0)
        row0 = torch.where(d <= hl, init_y, 0.0)[None, :]
        m2, x2, y2 = m1, x1, y1
        m1 = torch.cat([zero, m_new])
        x1 = torch.cat([zero, x_new])
        y1 = torch.cat([row0, y_new])
    return acc_m + acc_x


def log10_truth(prob_f64: np.ndarray) -> np.ndarray:
    """Unscaled log10 likelihoods of ``forward(..., float64, SCALE_F64)``
    (-inf where even float64 underflowed)."""
    with np.errstate(divide="ignore"):
        return np.log10(prob_f64) - 1020 * math.log10(2.0)


def finalize(prob: np.ndarray) -> np.ndarray:
    """The program's answer format from probabilities scaled by 2^120:
    log10(p) - log10(2^120), or the sentinel below MIN_ACCEPTED (the
    control's finalize)."""
    prob = np.asarray(prob, np.float64)
    out = np.full(prob.shape, SENTINEL)
    ok = prob >= MIN_ACCEPTED
    out[ok] = np.log10(prob[ok]) - 120 * math.log10(2.0)
    return out


def gaps(answers: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Each answer's gap from the float64 truth, by the rule in the module
    docstring; inf for an answer that is not a number."""
    answers = np.asarray(answers, np.float64)
    truth = np.asarray(truth, np.float64)
    sentinel = answers == SENTINEL
    with np.errstate(invalid="ignore"):
        out = np.where(sentinel, np.maximum(truth - THRESHOLD_LOG10, 0.0),
                       np.abs(answers - truth))
    return np.where(np.isnan(out), np.inf, out)


class PairSet:
    """Every (read, haplotype) pair of some region jobs, read-major within
    a job, jobs in order: the pairs the check compares."""

    def __init__(self, jobs: Sequence[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, List[np.ndarray]]]):
        """``jobs``: (flat_seq u8, flat_qual u8, off i64, [hap u8]) each."""
        read_rows, qual_rows, read_lens, hap_rows = [], [], [], []
        pr, ph = [], []
        n_reads = n_haps = 0
        for seq, qual, off, haps in jobs:
            lens = np.diff(off)
            for k in range(len(lens)):
                read_rows.append(seq[off[k]:off[k + 1]])
                qual_rows.append(qual[off[k]:off[k + 1]])
            read_lens.append(lens)
            hap_rows.extend(haps)
            nr, nh = len(lens), len(haps)
            pr.append(np.repeat(np.arange(n_reads, n_reads + nr), nh))
            ph.append(np.tile(np.arange(n_haps, n_haps + nh), nr))
            n_reads += nr
            n_haps += nh
        self.read_len = np.concatenate(read_lens).astype(np.int64)
        self.hap_len = np.array([len(h) for h in hap_rows], np.int64)
        self.reads = _rows(read_rows, int(self.read_len.max()))
        self.quals = _rows(qual_rows, int(self.read_len.max()))
        self.haps = _rows(hap_rows, int(self.hap_len.max()))
        for table in (self.reads, self.haps):
            if not _only_pad(table):
                raise ValueError("the reference reads only A, C, G, T, N")
        self.pair_read = np.concatenate(pr)
        self.pair_hap = np.concatenate(ph)

    def __len__(self) -> int:
        return self.pair_read.size

    def forward(self, dtype, scale: float, device, block: int = 32768):
        """``forward`` over every pair, in blocks -> (pairs,) float64."""
        reads = torch.from_numpy(self.reads).to(device)
        quals = torch.from_numpy(self.quals).to(device)
        haps = torch.from_numpy(self.haps).to(device)
        rlen = torch.from_numpy(self.read_len).to(device)
        hlen = torch.from_numpy(self.hap_len).to(device)
        out = np.empty(len(self), np.float64)
        for lo in range(0, len(self), block):
            r = torch.from_numpy(self.pair_read[lo:lo + block]).to(device)
            h = torch.from_numpy(self.pair_hap[lo:lo + block]).to(device)
            prob = forward(reads[r], quals[r], rlen[r], haps[h], hlen[h],
                           dtype, scale)
            out[lo:lo + r.numel()] = prob.double().cpu().numpy()
        return out


def _rows(rows: Sequence[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(rows), width), np.uint8)
    for k, row in enumerate(rows):
        out[k, :len(row)] = row
    return out


def _only_pad(table: np.ndarray) -> bool:
    """True when the only bytes outside ACGTN are the 0 padding."""
    bad = CODES[table] == 255
    return bool((table[bad] == 0).all())


def check(pairs: PairSet, answers: np.ndarray, limit: float, device,
          region_pairs: Sequence[int] = ()) -> Dict[str, float]:
    """The program's ``answers`` for ``pairs`` against the float64 truth
    -> {"max_log10_gap", "limit", "pairs", "sentinels",
    "truth_below_threshold", "regions_past_limit"}; ``region_pairs``
    splits the pairs into regions, in order."""
    truth = log10_truth(pairs.forward(torch.float64, SCALE_F64, device))
    gap = gaps(answers, truth)
    bounds = np.cumsum([0, *region_pairs])
    return {
        "max_log10_gap": float(gap.max()) if gap.size else 0.0,
        "limit": limit,
        "pairs": int(gap.size),
        "sentinels": int((np.asarray(answers) == SENTINEL).sum()),
        "truth_below_threshold": int((truth < THRESHOLD_LOG10).sum()),
        "regions_past_limit": int(sum(
            bool((gap[lo:hi] > limit).any())
            for lo, hi in zip(bounds[:-1], bounds[1:]))),
    }


def control_answers(pairs: PairSet, device) -> np.ndarray:
    """The control: this reference in bfloat16 in the program's place, in
    the program's answer format."""
    return finalize(pairs.forward(torch.bfloat16, SCALE_F32, device))
