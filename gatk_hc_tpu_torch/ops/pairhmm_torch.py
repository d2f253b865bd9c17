"""PairHMM forward on PyTorch: the ppe CUDA kernel's wrapper, its plain
PyTorch version, and the planes-path glue around them.

The kernel (csrc/pairhmm_ppe.cu) replaces the TPU kernel family
gatk_hc_tpu/ops/pairhmm_pallas.py::_kernel_ppe / _kernel_ppe2 /
_make_kernel_ppe_multi(NR) behind _pallas_call_ppe: one warp per
(read, hap) pair, K read rows per lane (``rows_per_lane``, with NR as its
floor), the wavefront across the lanes and the DP state in registers and
shared memory.  This module's entry, ``ppe_forward``, takes pair-minor
inputs (the last axis is the pair), as ``forward_batch`` and the planes
glue build them; a block's warps take consecutive pairs:

* ``rows``  (r_pad, 3, B) i32 — per read row: base mask, f32 bits of
  1 - q, f32 bits of q / 3;
* ``hap``   (c_pad, B) i32 one-hot base masks (A=1 C=2 G=4 T=8, N=15);
* ``rlen``, ``clen`` (B,) i32 and ``init_y`` (B,) f32 = INITIAL / haplen.

The runner launches the same kernel through its unique-rows entry
instead (ops/pairhmm_front.py), which reads a group's shipped rows itself.
``ppe_forward`` launches the kernel on CUDA tensors and runs the plain
version on CPU tensors; nothing else picks between them.  The public
entry points keep the reference package's layouts: ``pairhmm_planes`` has
the signature of pairhmm_pallas_planes and ``forward_batch`` the pair-major
signature of _pallas_forward (it also reaches the striped kernel of
ops/pairhmm_striped.py), so the tests compare like with like.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.quality import MATCH_TO_MATCH_F32, PH2PR_F32, set_mm_prob
# the kernels' launch counts (LAUNCHES) live in the torch-free
# ops/_kernels.py, so that --stats reads them without loading torch
from ._kernels import LAUNCHES, reset_launches  # noqa: F401 - re-exported

# f32 smallest normal: results below it flush to zero (FTZ, not DAZ)
MIN_NORMAL = float(np.ldexp(1.0, -126))

def transition_constants(gop: int, gcp: int) -> Tuple[float, ...]:
    """Scalar transition probs (GOP/GCP are constant strings, sam.hpp:31-32,
    indexed raw-ASCII per the main-path quirk)."""
    i_q, c_q = gop & 127, gcp & 127
    p_mm = set_mm_prob(i_q, i_q, MATCH_TO_MATCH_F32)
    p_gapm = np.float32(1.0) - PH2PR_F32[c_q]
    p_mx = PH2PR_F32[i_q]
    p_xx = PH2PR_F32[c_q]
    p_my = PH2PR_F32[i_q]
    p_yy = PH2PR_F32[c_q]
    return (
        np.float32(p_mm),
        np.float32(p_gapm),
        np.float32(p_mx),
        np.float32(p_xx),
        np.float32(p_my),
        np.float32(p_yy),
    )


def ppe_element_table(base_table: np.ndarray, ph2pr_f32: np.ndarray) -> np.ndarray:
    """The 768-entry combined lookup table:
    [0:256]   byte -> one-hot base mask (A=1 C=2 G=4 T=8, N=15),
    [256:512] byte -> (1 - ph2pr[byte & 127]) f32 bits,
    [512:768] byte -> (ph2pr[byte & 127] / 3) f32 bits."""
    codes = base_table.astype(np.int64)
    masks = np.where(codes == 4, 15, 1 << codes).astype(np.int32)
    k = np.arange(256) & 127
    omq = (np.float32(1.0) - ph2pr_f32)[k].astype(np.float32)
    q3 = (ph2pr_f32 / np.float32(3.0))[k].astype(np.float32)
    return np.concatenate(
        [masks, omq.view(np.int32), q3.view(np.int32)]
    ).astype(np.int32)


def plane_tables(base_table: np.ndarray, ph2pr_f32: np.ndarray):
    """Host-side 256-entry lookup tables for the planes path:
    (byte -> one-hot mask i32, byte -> omq f32 bits, byte -> q3 f32 bits).
    The divisions happen here, on the host, once."""
    t = ppe_element_table(base_table, ph2pr_f32)
    return t[:256].copy(), t[256:512].copy(), t[512:768].copy()


def _host_f64_rescue(cfg, read_arrays, hap_arrays, pair_read, pair_hap):
    """f64 recompute of underflowed pairs on the host: the native library
    when it is available, else the NumPy oracle (both exact f64)."""
    from .. import native

    if native.available():
        stride_r = max(len(b) for b, _ in read_arrays)
        stride_h = max(len(h) for h in hap_arrays)
        rb = np.zeros((len(read_arrays), stride_r), dtype=np.uint8)
        rq = np.zeros_like(rb)
        rl = np.zeros(len(read_arrays), dtype=np.int32)
        for i, (b, qv) in enumerate(read_arrays):
            rb[i, : len(b)] = b
            rq[i, : len(qv)] = qv
            rl[i] = len(b)
        hb = np.zeros((len(hap_arrays), stride_h), dtype=np.uint8)
        hl = np.zeros(len(hap_arrays), dtype=np.int32)
        for j, h in enumerate(hap_arrays):
            hb[j, : len(h)] = h
            hl[j] = len(h)
        return native.pairhmm_raw_native(
            rb, rq, rl, hb, hl,
            pair_read.astype(np.int32), pair_hap.astype(np.int32),
            cfg.gop_char, cfg.gcp_char, np.float64,
        )
    from .pairhmm_oracle import pairhmm_prob

    return np.array(
        [
            pairhmm_prob(
                read_arrays[r][0], read_arrays[r][1], hap_arrays[h],
                cfg.gop_char, cfg.gcp_char, np.float64,
            )
            for r, h in zip(pair_read, pair_hap)
        ],
        dtype=np.float64,
    )


TABLE_KEYS = ("base_table", "ph2pr", "mask", "omq_bits", "q3_bits", "trans")


def make_tables(cfg, device) -> Dict[str, torch.Tensor]:
    """The numeric context every engine shares, as tensors on ``device``:
    byte -> base code, Phred -> error prob (f32), the three plane tables,
    and the six transition constants (f32)."""
    from ..utils.quality import BASE_TABLE

    mask, omq_bits, q3_bits = plane_tables(BASE_TABLE, PH2PR_F32)
    arrays = {
        "base_table": BASE_TABLE.astype(np.int32),
        "ph2pr": PH2PR_F32,
        "mask": mask,
        "omq_bits": omq_bits,
        "q3_bits": q3_bits,
        "trans": np.array(
            transition_constants(cfg.gop_char, cfg.gcp_char), np.float32
        ),
    }
    return {k: torch.from_numpy(arrays[k].copy()).to(device) for k in TABLE_KEYS}


# ---------------------------------------------------------------------------
# The ppe forward: plain version and kernel wrapper.


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal f32 results to zero."""
    return torch.where(x.abs() < MIN_NORMAL, 0.0, x)


def ppe_forward_plain(rows, hap, rlen, clen, init_y, trans) -> torch.Tensor:
    """Plain PyTorch version of the ppe kernel, same inputs, same (B,) f32
    result bit for bit.

    Vectorised over pairs and along anti-diagonals: diagonal d holds the
    cells (r, d - r), kept in (R + 2, B) buffers whose index 0 is a
    permanent zero row and index r + 1 holds row r, so "the row above" is a
    view.  Every multiply and add is its own tensor op followed by an
    explicit flush (no addcmul, no fusion), so each cell's expression tree
    is the kernel's.  Each pair's last row meets one new column per
    diagonal, so the captured sums run in column order as in the kernel.
    Cells past the batch's largest rlen / clen feed no captured cell and
    are not computed."""
    R, three, B = rows.shape
    C = hap.shape[0]
    assert three == 3 and hap.shape[1] == B
    dev = rows.device
    f32 = torch.float32
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = (
        torch.tensor(float(t), dtype=f32, device=dev) for t in trans
    )
    rlen = rlen.to(torch.int64)
    clen_c = torch.clamp(clen.to(torch.int64), max=C)
    r_eff = int(min(R, max(int(rlen.max()), 1))) if B else 1
    c_eff = int(min(C, max(int(clen_c.max()), 1))) if B else 1

    def padded_rows(plane):  # (R, B) -> (r_eff + 1, B) with a zero row 0
        out = torch.zeros((r_eff + 1, B), dtype=plane.dtype, device=dev)
        out[1:] = plane[:r_eff]
        return out

    rmask = padded_rows(rows[:, 0, :])
    omq = padded_rows(rows[:, 1, :].contiguous().view(f32))
    q3 = padded_rows(rows[:, 2, :].contiguous().view(f32))
    r_idx = torch.arange(r_eff + 1, device=dev)
    row_valid = (r_idx >= 1)[:, None]

    def buf():
        return torch.zeros((r_eff + 2, B), dtype=f32, device=dev)

    M2, X2, Y2, M1, X1, Y1 = (buf() for _ in range(6))
    # d = 0: Y(0, 0) = init_y;  d = 1: Y(0, 1) = init_y, column 0 zero
    Y2[1] = init_y
    Y1[1] = init_y
    acc_m = torch.zeros(B, dtype=f32, device=dev)
    acc_x = torch.zeros(B, dtype=f32, device=dev)
    capture_ok = (rlen >= 1) & (rlen <= R)
    last = torch.clamp(rlen, 0, r_eff)[None, :]
    for d in range(2, r_eff + c_eff + 1):
        c_of_r = d - r_idx
        hapc = hap.index_select(0, torch.clamp(c_of_r - 1, 0, C - 1))
        distm = torch.where((rmask & hapc) != 0, omq, q3)
        t1 = _flush(M2[:-1] * p_mm)
        t2 = _flush(X2[:-1] * p_gapm)
        t3 = _flush(Y2[:-1] * p_gapm)
        m_new = _flush(_flush(_flush(t1 + t2) + t3) * distm)
        x_new = _flush(_flush(M1[:-1] * p_mx) + _flush(X1[:-1] * p_xx))
        y_new = _flush(_flush(M1[1:] * p_my) + _flush(Y1[1:] * p_yy))
        valid = row_valid & ((c_of_r >= 1) & (c_of_r <= c_eff))[:, None]
        # the d-2 buffers are dead: reuse them for diagonal d
        M2[1:] = torch.where(valid, m_new, 0.0)
        X2[1:] = torch.where(valid, x_new, 0.0)
        Y2[1:] = torch.where(valid, y_new, 0.0)
        if d <= C:  # row 0 keeps Y = init_y inside the matrix
            Y2[1] = init_y
        c_last = d - rlen
        take = capture_ok & (c_last >= 1) & (c_last <= clen_c)
        m_last = M2[1:].gather(0, last)[0]
        x_last = X2[1:].gather(0, last)[0]
        acc_m = _flush(acc_m + torch.where(take, m_last, 0.0))
        acc_x = _flush(acc_x + torch.where(take, x_last, 0.0))
        M2, X2, Y2, M1, X1, Y1 = M1, X1, Y1, M2, X2, Y2
    return _flush(acc_m + acc_x)


def select_rows(ppe_rows: int, r_pad: int) -> int:
    """NR actually run: _pallas_call_ppe's rule (pairhmm_pallas.py:650-661)
    — the requested rows when r_pad divides by them, else 2 or 1."""
    if ppe_rows == 8 and r_pad % 8 == 0:
        return 8
    if ppe_rows == 4 and r_pad % 4 == 0:
        return 4
    if ppe_rows >= 2 and r_pad % 2 == 0:
        return 2
    return 1


WARP_LANES = 32
MAX_ROWS_PER_LANE = 8


def rows_per_lane(nr: int, r_pad: int) -> int:
    """K, the read rows each lane of the ppe kernel holds: enough for one
    warp to cover r_pad in one stripe of 32 K rows, at least NR (so the
    --ppe-rows instances stay distinct launches) and at most 8 (registers).
    -> 4 / 5 / 7 at the buckets 96 / 160 / 224 with NR 4."""
    return min(MAX_ROWS_PER_LANE, max(nr, -(-r_pad // WARP_LANES)))


def ppe_stripes(k: int, r_pad: int) -> int:
    """Stripes of 32 k rows the ppe kernel needs to cover r_pad; above one,
    each stripe's last row is carried to the next in shared memory."""
    return -(-r_pad // (WARP_LANES * k))


def _check_inputs(rows, hap, rlen, clen, init_y) -> None:
    if rows.dim() != 3 or rows.shape[1] != 3:
        raise ValueError(f"rows must be (r_pad, 3, B), got {tuple(rows.shape)}")
    B = rows.shape[2]
    if hap.dim() != 2 or hap.shape[1] != B:
        raise ValueError(f"hap must be (c_pad, {B}), got {tuple(hap.shape)}")
    for name, t, dtype in (
        ("rows", rows, torch.int32), ("hap", hap, torch.int32),
        ("rlen", rlen, torch.int32), ("clen", clen, torch.int32),
        ("init_y", init_y, torch.float32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("rlen", rlen), ("clen", clen), ("init_y", init_y)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")


def ppe_forward(rows, hap, rlen, clen, init_y, trans, ppe_rows: int = 4):
    """Raw forward probabilities (B,) f32 for pair-minor kernel inputs.

    CUDA tensors launch the CUDA kernel (NR from ``select_rows``, rows per
    lane from ``rows_per_lane``) and count the launch under ``ppe<NR>``;
    CPU tensors run ``ppe_forward_plain``.  Does not synchronise and
    allocates nothing but the result.  A failed build or launch raises."""
    _check_inputs(rows, hap, rlen, clen, init_y)
    if rows.device.type == "cpu":
        return ppe_forward_plain(rows, hap, rlen, clen, init_y, trans)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    out = launch_ppe(rows, hap, rlen, clen, init_y, trans, ppe_rows)
    LAUNCHES[f"ppe{select_rows(ppe_rows, rows.shape[0])}"] += 1
    return out


def launch_ppe(rows, hap, rlen, clen, init_y, trans, ppe_rows: int):
    """The ppe kernel's launch on checked CUDA tensors, uncounted: what
    ``ppe_forward`` counts, and the runner's warm-up launches (which load
    an instance before its first group) do not."""
    from . import _kernels

    lib = _kernels.load("pairhmm_ppe")
    r_pad, _, B = rows.shape
    c_pad = hap.shape[0]
    nr = select_rows(ppe_rows, r_pad)
    out = torch.empty(B, dtype=torch.float32, device=rows.device)
    err = lib.pairhmm_ppe_forward(
        rows.data_ptr(), hap.data_ptr(), rlen.data_ptr(), clen.data_ptr(),
        init_y.data_ptr(), out.data_ptr(), B, r_pad, c_pad,
        rows_per_lane(nr, r_pad),
        *(float(t) for t in trans),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pairhmm_ppe_forward launch failed: CUDA error {err}")
    return out


def ppe_launch_shape(r_pad: int, c_pad: int, ppe_rows: int) -> Dict[str, int]:
    """How ``ppe_forward`` launches at (r_pad, c_pad, ppe_rows) on the
    current card: rows per lane, stripes, warps (pairs) per block, dynamic
    shared memory per block (bytes) and the blocks an SM holds at once.
    Needs a card."""
    from . import _kernels

    lib = _kernels.load("pairhmm_ppe")
    k = rows_per_lane(select_rows(ppe_rows, r_pad), r_pad)
    out = (ctypes.c_int * 3)()
    err = lib.pairhmm_ppe_launch_shape(r_pad, c_pad, k, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"pairhmm_ppe_launch_shape: CUDA error {err}")
    return {"rows_per_lane": k, "stripes": ppe_stripes(k, r_pad),
            "warps_per_block": out[0], "smem_per_block": out[1],
            "blocks_per_sm": out[2]}


# ---------------------------------------------------------------------------
# Planes-path glue (the XLA program around _pallas_call_ppe, as torch ops).


def unpack_planes(buf, nr_pad, nh_pad, r_pad, c_pad):
    """View-only unpack of the host-prepared plane buffer:
    [rlens(NR) | hlens(NH) | iy bits(NH) | ru(3*NR*R) | hu(NH*C)] i32."""
    nrr = nr_pad * r_pad
    head = nr_pad + 2 * nh_pad
    read_lens = buf[:nr_pad]
    hap_lens = buf[nr_pad : nr_pad + nh_pad]
    init_y = buf[nr_pad + nh_pad : head].view(torch.float32)
    ru = buf[head : head + 3 * nrr].view(3, nr_pad, r_pad)
    hu = buf[head + 3 * nrr : head + 3 * nrr + nh_pad * c_pad].view(
        nh_pad, c_pad
    )
    return ru, hu, read_lens, hap_lens, init_y


def gather_pairs(buf, pairs, nr_pad, nh_pad, r_pad, c_pad):
    """Per-pair expansion into the kernel's pair-minor layout: exact
    integer index ops on the buffer's device.  -> (rows, hap, rlen, clen,
    init_y)."""
    return gather_unique(
        *unpack_planes(buf, nr_pad, nh_pad, r_pad, c_pad), pairs[0], pairs[1]
    )


def gather_unique(ru, hu, read_lens, hap_lens, init_y, pair_read, pair_hap):
    """The gathers of dispatch_pairs_ppe: unique tables (ru (3, NR, R),
    hu (NH, C), lengths, init_y) and (B,) pair indices -> the kernel's
    pair-minor (rows, hap, rlen, clen, init_y)."""
    pr = pair_read.to(torch.int64)
    ph = pair_hap.to(torch.int64)
    rows = ru.permute(2, 0, 1).index_select(2, pr)  # (r_pad, 3, B)
    hap = hu.t().index_select(1, ph)  # (c_pad, B)
    return (
        rows.contiguous(), hap.contiguous(),
        read_lens.index_select(0, pr), hap_lens.index_select(0, ph),
        init_y.index_select(0, ph),
    )


def pairhmm_planes(buf, pairs, trans, nr_pad: int, nh_pad: int, r_pad: int,
                   c_pad: int, ppe_rows: int = 2) -> torch.Tensor:
    """Planes-path dispatch: view-only unpack + pair gather + ppe forward.
    ``buf`` is the i32 plane buffer (unpack_planes), ``pairs`` (2, B) i32;
    returns (B,) f32 on their device."""
    args = gather_pairs(buf, pairs, nr_pad, nh_pad, r_pad, c_pad)
    return ppe_forward(*args, trans, ppe_rows)


def base_mask(codes: torch.Tensor) -> torch.Tensor:
    """One-hot base masks from codes A0 C1 T2 G3 N4: A=1 C=2 T=4 G=8
    (1 << code), N=15 (matches anything)."""
    codes = codes.to(torch.int32)
    return torch.where(
        codes == 4, torch.full_like(codes, 15), torch.ones_like(codes) << codes
    )


def forward_batch(read_codes, read_omq, read_q3, read_lens, hap_codes,
                  hap_lens, init_y, trans, r_pad: int, c_pad: int,
                  ppe_rows: int = 2, stripe: int = 8,
                  algo: str = "auto") -> torch.Tensor:
    """Pair-major entry point with _pallas_forward's inputs: (B, r_pad)
    read codes / 1-q / q/3, (B, c_pad) hap codes, (B,) lengths and init_y;
    the counterpart of pairhmm_pallas_batch.  Runs on the inputs' device;
    returns (B,) f32.

    ``algo`` is "ppe" (NR from ``ppe_rows``), "striped" (stripe height
    ``stripe``, which must divide r_pad) or "auto", which is ppe at every
    shape: the reference's _ppe_eligible conditions (c_pad <= 640 and a
    multiple of 32, B a multiple of 1024, not interpret mode) are limits of
    the TPU's VMEM and (8, 128) tiling that the CUDA ppe kernel, which
    takes any B and stripes reads longer than 256 rows, does not have.
    Every choice computes the same result bit for bit."""
    if algo not in ("ppe", "striped", "auto"):
        raise ValueError(f"unknown algo {algo!r}")
    read_codes = torch.as_tensor(read_codes)
    dev = read_codes.device
    as_t = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    if read_codes.shape[1] != r_pad or hap_codes.shape[1] != c_pad:
        raise ValueError(
            f"expected (B, {r_pad}) reads and (B, {c_pad}) haps, got "
            f"{tuple(read_codes.shape)} and {tuple(hap_codes.shape)}"
        )
    if algo == "striped":
        from .pairhmm_striped import striped_forward

        return striped_forward(
            as_t(read_codes, torch.int32).contiguous(),
            as_t(read_omq, torch.float32).contiguous(),
            as_t(read_q3, torch.float32).contiguous(),
            as_t(hap_codes, torch.int32).contiguous(),
            as_t(read_lens, torch.int32).contiguous(),
            as_t(hap_lens, torch.int32).contiguous(),
            as_t(init_y, torch.float32).contiguous(), trans, stripe,
        )
    rows = torch.stack(
        [
            base_mask(read_codes),
            as_t(read_omq, torch.float32).view(torch.int32),
            as_t(read_q3, torch.float32).view(torch.int32),
        ]
    ).permute(2, 0, 1).contiguous()  # (r_pad, 3, B)
    hap = base_mask(as_t(hap_codes, torch.int32)).t().contiguous()
    return ppe_forward(
        rows, hap, as_t(read_lens, torch.int32).contiguous(),
        as_t(hap_lens, torch.int32).contiguous(),
        as_t(init_y, torch.float32).contiguous(), trans, ppe_rows,
    )
