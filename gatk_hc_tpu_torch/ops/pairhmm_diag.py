"""Batched PairHMM forward in PyTorch ops: the anti-diagonal engine.

The counterpart of gatk_hc_tpu/ops/pairhmm_jax.py (the reference package's
jnp engine).  State arrays are (B, R+1) slices indexed by row; diagonal d
holds cells (r, d - r).  Each cell's expression tree is the reference
recurrence (avx-pairhmm-template.h:183-198), every multiply and add its
own tensor op, so per-cell results are bit-comparable with the NumPy
oracle and the C++ engine; the final sum accumulates the last row in
column order like the reference's per-lane accumulators.

It runs wherever PyTorch runs, on the inputs' device, and exists (a) to
cross-check the CUDA kernels and (b) to run the pipeline through a second,
independent forward (``--pairhmm diag``).  It is its own copy of the
recurrence: it calls nothing of ops/pairhmm_torch.py's plain versions, as
the reference's jnp engine does not alias its Pallas kernel.  PyTorch does
not fuse a multiply into the add that follows it, so with
``flush_denormals`` (the default) it is bit-exact with the FTZ oracle on
the CPU and on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..config import HCConfig
from ..utils.quality import BASE_TABLE, INITIAL_CONSTANT_F32, PH2PR_F32
from .batching import PairBatch, all_pairs, pack_pairs
from .pairhmm_torch import _host_f64_rescue, transition_constants

# the largest f32 subnormal: a value at or below it flushes to zero
_MAX_SUBNORMAL = float(np.ldexp(1.0, -126) - np.ldexp(1.0, -149))
_AMBIG = 4  # base code of N (and of every byte that is not ACGT)


def pairhmm_forward_batch(
    read_codes: torch.Tensor,  # (B, R_pad) int32 base codes (A0 C1 T2 G3 N4)
    read_omq: torch.Tensor,  # (B, R_pad) f32 1 - ph2pr[qual] (host-computed)
    read_q3: torch.Tensor,  # (B, R_pad) f32 ph2pr[qual] / 3 (host-computed)
    read_lens: torch.Tensor,  # (B,) int32
    hap_codes: torch.Tensor,  # (B, C_pad) int32
    hap_lens: torch.Tensor,  # (B,) int32
    init_y: torch.Tensor,  # (B,) f32 INITIAL_CONSTANT / hap_len (host-computed)
    trans: Tuple[float, ...],  # 6 scalar f32
    r_pad: int,
    c_pad: int,
    flush_denormals: bool = True,
) -> torch.Tensor:
    """Raw forward probabilities (B,) f32, scaled by INITIAL_CONSTANT, on
    the inputs' device.

    Divisions (q/3, INITIAL/haplen) happen on the host.  Diagonals and rows
    past the batch's longest read and haplotype feed no captured cell and
    are not computed; cells past a pair's own lengths are computed and
    never captured, as in the reference."""
    dev = read_codes.device
    f32 = torch.float32
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = (
        torch.tensor(float(t), dtype=f32, device=dev) for t in trans
    )
    B = read_codes.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=f32, device=dev)
    read_lens = read_lens.to(torch.int64)
    hap_lens = hap_lens.to(torch.int64)
    R = int(min(r_pad, int(read_lens.max())))
    C = c_pad
    c_eff = int(min(c_pad, int(hap_lens.max())))

    if flush_denormals:
        # every DP value is >= 0 (products and sums of probabilities), so
        # one threshold op flushes a subnormal result to zero
        def ftz(x):
            return torch.nn.functional.threshold(x, _MAX_SUBNORMAL, 0.0)
    else:
        def ftz(x):
            return x

    # row-indexed (B, R + 1), index 0 = the boundary row
    zero_col = torch.zeros((B, 1), dtype=f32, device=dev)
    omq = torch.cat([zero_col, read_omq[:, :R].to(f32)], dim=1)
    q3 = torch.cat([zero_col, read_q3[:, :R].to(f32)], dim=1)
    rcodes = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int32, device=dev),
         read_codes[:, :R].to(torch.int32)], dim=1)
    hap_codes = hap_codes.to(torch.int32)
    r_idx = torch.arange(R + 1, device=dev)

    def up(a):
        return torch.cat([zero_col, a[:, :-1]], dim=1)

    def set_row0(a, value):
        a[:, 0] = value
        return a

    zeros = torch.zeros((B, R + 1), dtype=f32, device=dev)
    Y0 = set_row0(zeros.clone(), init_y)
    M2, X2, Y2, M1, X1, Y1 = zeros, zeros, Y0, zeros, zeros, Y0
    acc_m = torch.zeros(B, dtype=f32, device=dev)
    acc_x = torch.zeros(B, dtype=f32, device=dev)
    last = read_lens[:, None]  # (B, 1)
    for d in range(2, R + c_eff + 1):
        c_of_r = d - r_idx  # (R + 1,)
        hap_idx = torch.clamp(c_of_r - 1, 0, C - 1)
        hapc = hap_codes.index_select(1, hap_idx)  # (B, R + 1)
        match = (rcodes == hapc) | (rcodes == _AMBIG) | (hapc == _AMBIG)
        distm = torch.where(match, omq, q3)

        t1 = ftz(up(M2) * p_mm)
        t2 = ftz(up(X2) * p_gapm)
        t3 = ftz(up(Y2) * p_gapm)
        M_new = ftz(ftz(ftz(t1 + t2) + t3) * distm)
        X_new = ftz(ftz(up(M1) * p_mx) + ftz(up(X1) * p_xx))
        Y_new = ftz(ftz(M1 * p_my) + ftz(Y1 * p_yy))

        M_new = set_row0(M_new, 0.0)
        X_new = set_row0(X_new, 0.0)
        Y_new = set_row0(Y_new, init_y)

        # capture last-row cells (r == rlen) while inside 1 <= c <= clen
        m_last = M_new.gather(1, last)[:, 0]
        x_last = X_new.gather(1, last)[:, 0]
        c_last = d - read_lens
        in_range = (c_last >= 1) & (c_last <= hap_lens)
        acc_m = acc_m + torch.where(in_range, m_last, 0.0)
        acc_x = acc_x + torch.where(in_range, x_last, 0.0)
        M2, X2, Y2, M1, X1, Y1 = M1, X1, Y1, M_new, X_new, Y_new
    return acc_m + acc_x


def batch_to_device_args(batch: PairBatch):
    """A PairBatch -> the forward's host arrays: base codes, 1 - q, q / 3,
    lengths and INITIAL / haplen (the divisions on the host)."""
    read_codes = BASE_TABLE[batch.read_bases].astype(np.int32)
    read_q = PH2PR_F32[(batch.read_quals & 127).astype(np.int64)].astype(np.float32)
    read_omq = (np.float32(1.0) - read_q).astype(np.float32)
    read_q3 = (read_q / np.float32(3.0)).astype(np.float32)
    hap_codes = BASE_TABLE[batch.hap_bases].astype(np.int32)
    init_y = (INITIAL_CONSTANT_F32 / batch.hap_lens.astype(np.float32)).astype(
        np.float32
    )
    return (read_codes, read_omq, read_q3, batch.read_lens, hap_codes,
            batch.hap_lens, init_y)


def diag_pairhmm_engine(cfg: HCConfig, device="cuda",
                        forward_fn: Callable = pairhmm_forward_batch):
    """Per-region engine: every (read, hap) pair of a region packed into
    one padded batch, the forward on ``device`` ("cuda": the card, raising
    when none is visible; "cpu"), rescue through the host f64 path."""
    from .engines import _to_arrays
    from .pairhmm_oracle import finalize_log10

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diag engine: no CUDA device is available (pass device='cpu')"
        )
    trans = transition_constants(cfg.gop_char, cfg.gcp_char)

    def engine(reads, haplotypes):
        read_arrays, hap_arrays = _to_arrays(reads, haplotypes)
        n_r, n_h = len(read_arrays), len(hap_arrays)
        pair_read, pair_hap = all_pairs(n_r, n_h)
        # pair_batch 1: the pair axis holds the region's pairs and no
        # dummy ones (the reference's 128 is a TPU tile size)
        batch = pack_pairs(
            read_arrays, hap_arrays, pair_read, pair_hap,
            cfg.read_pad_buckets, cfg.hap_pad_buckets, pair_batch=1,
        )
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in batch_to_device_args(batch)]
        probs = forward_fn(
            *args, trans, r_pad=batch.shape[1], c_pad=batch.shape[2],
        ).cpu().numpy()[: batch.n_valid]

        def rescue(indices):
            return _host_f64_rescue(cfg, read_arrays, hap_arrays,
                                    pair_read[indices], pair_hap[indices])

        return finalize_log10(
            probs, rescue, mode=cfg.f64_rescue
        ).reshape(n_r, n_h)

    return engine
