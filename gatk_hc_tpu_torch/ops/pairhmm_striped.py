"""PairHMM forward on PyTorch, striped: the striped CUDA kernel's wrapper,
its plain PyTorch version, and the raw-byte glue around them.

The kernel (csrc/pairhmm_striped.cu) replaces the TPU kernel
gatk_hc_tpu/ops/pairhmm_pallas.py::_kernel behind
_pallas_forward(algo="striped"): H lanes of a warp own one (read, hap)
pair (a warp holds 32 / H pairs), each lane holds K consecutive read rows
(``striped_rows_per_lane``), and the segment sweeps the DP matrix along
anti-diagonals in stripes of H K rows, handing a stripe's last row to the
next through shared memory when one stripe does not cover r_pad.  It
computes the same function as the ppe kernel (ops/pairhmm_torch.py), bit
for bit.  Its inputs are pair-major, as _pallas_forward takes them:

* ``read_codes`` (B, r_pad) i32 base codes A0 C1 T2 G3 N4, ``read_omq`` and
  ``read_q3`` (B, r_pad) f32 1 - q and q / 3;
* ``hap_codes`` (B, c_pad) i32 base codes;
* ``rlen``, ``clen`` (B,) i32 and ``init_y`` (B,) f32 = INITIAL / haplen.

``striped_forward`` launches the kernel on CUDA tensors and runs the plain
version on CPU tensors; nothing else picks between them.

The runner's entry is ``striped_forward_unique``: the kernel's unique-rows
entry (``pairhmm_striped_forward_unique``), one launch per chunk that
reads the group's shipped raw packed rows itself (ops/pairhmm_front.py's
``Segment``s and segment table, the packed layout), through the ppe
kernel's 768-entry ``ppe_element_table``, so that no pair-major copy of
the inputs is written to device memory.  It replaces the glue in front of
the reference's striped kernel, which stays here as torch ops for the
entry's plain version, with the reference package's signatures:
``unpack_u8`` / ``prepare_tables_striped`` / ``dispatch_pairs_striped`` /
``pairhmm_unique`` are the counterparts of _unpack_u8 /
prepare_tables_striped / dispatch_pairs_striped / pairhmm_pallas_unique.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .pairhmm_front import Segment, check, segment_rows
from .pairhmm_torch import LAUNCHES, _flush

# stripe heights the CUDA kernel is built for
KERNEL_STRIPES = (8, 16, 32)
# the most read rows one lane holds, per stripe height (registers); the
# kernel's KMAX_32 / KMAX_16 / KMAX_8
MAX_ROWS_PER_LANE = {8: 28, 16: 20, 32: 8}


def striped_rows_per_lane(stripe: int, r_pad: int, kmax: int = 0) -> int:
    """K, the read rows each lane of the striped kernel holds: the fewest
    stripes of ``stripe`` lanes with at most ``kmax`` rows each (default
    MAX_ROWS_PER_LANE[stripe]) that cover r_pad, then the fewest rows per
    lane that cover r_pad in that many stripes (no stripe computes more
    rows than it must).  -> 3 / 5 / 7 at the buckets 96 / 160 / 224 with H
    32 (one stripe); 6 / 10 / 14 with H 16 and 12 / 20 / 28 with H 8."""
    stripes = -(-r_pad // (stripe * (kmax or MAX_ROWS_PER_LANE[stripe])))
    return -(-r_pad // (stripe * stripes))


def striped_stripes(stripe: int, k: int, r_pad: int) -> int:
    """Stripes of ``stripe`` k rows the kernel needs to cover r_pad; above
    one, each stripe's last row is carried to the next in shared memory."""
    return -(-r_pad // (stripe * k))


def striped_tables(base_table: np.ndarray, ph2pr_f32: np.ndarray):
    """The raw-encoding lookup tables: byte -> base code (256,) i32,
    Phred -> 1 - ph2pr (128,) f32 and Phred -> ph2pr / 3 (128,) f32.  The
    subtraction and division happen here, on the host, once."""
    ph2pr = np.asarray(ph2pr_f32, np.float32)
    return (
        np.asarray(base_table).astype(np.int32),
        (np.float32(1.0) - ph2pr).astype(np.float32),
        (ph2pr / np.float32(3.0)).astype(np.float32),
    )


def element_tables(table: torch.Tensor):
    """``striped_tables`` read back from the 768-entry ppe_element_table
    (masks, 1 - q bits, q / 3 bits by byte) on its device: byte -> base
    code (256,) i32 (mask 1 / 2 / 4 / 8 / 15 -> code 0 / 1 / 2 / 3 / 4),
    Phred -> 1 - q and q / 3 (128,) f32 (the table's quality entries
    repeat with period 128).  Raises on a mask that is no base's."""
    dev = table.device
    lut = torch.full((16,), -1, dtype=torch.int32, device=dev)
    lut[torch.tensor([1, 2, 4, 8, 15], device=dev)] = torch.arange(
        5, dtype=torch.int32, device=dev)
    masks = table[:256].to(torch.int64)
    codes = lut[masks.clamp(0, 15)]
    if bool(((codes < 0) | (masks != masks.clamp(0, 15))).any()):
        raise ValueError("the table's mask entries are not base masks")
    return (codes, table[256:384].view(torch.float32),
            table[512:640].view(torch.float32))


# ---------------------------------------------------------------------------
# The striped forward: plain version and kernel wrapper.


def striped_forward_plain(read_codes, read_omq, read_q3, hap_codes, rlen,
                          clen, init_y, trans, stripe: int) -> torch.Tensor:
    """Plain PyTorch version of the striped kernel, same inputs, same (B,)
    f32 result bit for bit.

    Follows the kernel's structure: a loop over stripes of ``stripe`` rows
    and, inside, over wavefront steps t, vectorised over the stripe's rows
    (row i of the stripe computes column t - i at step t) and over pairs.
    "Up" is the row above's cell of the step before (row 0 of a stripe
    takes it from the previous stripe's last row, carried by column), the
    diagonal is the row's own "up" of the step before, "left" its own cell
    of the step before.  Every multiply and add is its own tensor op
    followed by an explicit flush, so each cell's expression tree is the
    kernel's.  Any stripe height that divides r_pad is accepted."""
    B, R = read_codes.shape
    C = hap_codes.shape[1]
    H = int(stripe)
    if H < 1 or R % H:
        raise ValueError(f"stripe {H} must divide r_pad {R}")
    dev = read_codes.device
    f32 = torch.float32
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = (
        torch.tensor(float(t), dtype=f32, device=dev) for t in trans
    )
    rl = rlen.to(torch.int64)
    cl = torch.clamp(clen.to(torch.int64), max=C)
    ok = (rl >= 1) & (rl <= R)
    n_stripes = torch.where(ok, (rl + H - 1) // H, 0)
    acc_m = torch.zeros(B, dtype=f32, device=dev)
    acc_x = torch.zeros(B, dtype=f32, device=dev)
    if B == 0:
        return acc_m
    # the previous stripe's last row by column 0..C (row 0 to begin with:
    # M = X = 0, Y = init_y)
    carry_m = torch.zeros((C + 1, B), dtype=f32, device=dev)
    carry_x = torch.zeros((C + 1, B), dtype=f32, device=dev)
    carry_y = init_y.to(f32)[None, :].repeat(C + 1, 1)
    hap_t = hap_codes.t()
    lane = torch.arange(H, device=dev)[:, None]  # (H, 1)
    zeros = torch.zeros((H, B), dtype=f32, device=dev)
    for s in range(int(n_stripes.max())):
        live = s < n_stripes  # (B,)
        rows = slice(s * H, (s + 1) * H)
        rcode = read_codes[:, rows].t()
        om = read_omq[:, rows].t()
        qq = read_q3[:, rows].t()
        cl_live = torch.where(live, cl, 0)[None, :]  # (1, B)
        cap_lane = (rl - 1 - s * H).clamp(0, H - 1)[None, :]
        takes = live & ((rl - 1) // H == s) & ok
        steps = int((cl_live[0] + H - 1).max()) if bool(live.any()) else 0
        m_prev, x_prev, y_prev = zeros, zeros, zeros
        dm, dx, dy = zeros, zeros, zeros.clone()
        if s == 0:
            dy[0] = init_y  # Y(0, 0) = init_y: the diagonal of (1, 1)
        for t in range(1, steps + 1):
            c = t - lane  # (H, 1)
            active = (c >= 1) & (c <= cl_live)  # (H, B)
            if t <= C:
                head_m, head_x, head_y = carry_m[t], carry_x[t], carry_y[t]
            else:
                head_m = head_x = head_y = zeros[0]
            um = torch.cat([head_m[None], m_prev[:-1]])
            ux = torch.cat([head_x[None], x_prev[:-1]])
            uy = torch.cat([head_y[None], y_prev[:-1]])
            um = torch.where(active, um, 0.0)
            ux = torch.where(active, ux, 0.0)
            uy = torch.where(active, uy, 0.0)
            h = hap_t.index_select(0, (c[:, 0] - 1).clamp(0, C - 1))
            match = (rcode == h) | (rcode == 4) | (h == 4)
            dist = torch.where(match, om, qq)
            t1 = _flush(dm * p_mm)
            t2 = _flush(dx * p_gapm)
            t3 = _flush(dy * p_gapm)
            M = _flush(_flush(_flush(t1 + t2) + t3) * dist)
            X = _flush(_flush(um * p_mx) + _flush(ux * p_xx))
            Y = _flush(_flush(m_prev * p_my) + _flush(y_prev * p_yy))
            M = torch.where(active, M, 0.0)
            X = torch.where(active, X, 0.0)
            Y = torch.where(active, Y, 0.0)
            take = takes & active.gather(0, cap_lane)[0]
            acc_m = _flush(acc_m + torch.where(take, M.gather(0, cap_lane)[0], 0.0))
            acc_x = _flush(acc_x + torch.where(take, X.gather(0, cap_lane)[0], 0.0))
            c_last = t - (H - 1)  # the stripe's last row hands its cell on
            if 1 <= c_last <= C:
                keep = active[H - 1]
                carry_m[c_last] = torch.where(keep, M[H - 1], carry_m[c_last])
                carry_x[c_last] = torch.where(keep, X[H - 1], carry_x[c_last])
                carry_y[c_last] = torch.where(keep, Y[H - 1], carry_y[c_last])
            dm, dx, dy = um, ux, uy
            m_prev, x_prev, y_prev = M, X, Y
    return _flush(acc_m + acc_x)


def _check_inputs(read_codes, read_omq, read_q3, hap_codes, rlen, clen,
                  init_y) -> None:
    if read_codes.dim() != 2:
        raise ValueError(
            f"read_codes must be (B, r_pad), got {tuple(read_codes.shape)}"
        )
    B, R = read_codes.shape
    if hap_codes.dim() != 2 or hap_codes.shape[0] != B:
        raise ValueError(
            f"hap_codes must be ({B}, c_pad), got {tuple(hap_codes.shape)}"
        )
    for name, t, dtype, shape in (
        ("read_codes", read_codes, torch.int32, (B, R)),
        ("read_omq", read_omq, torch.float32, (B, R)),
        ("read_q3", read_q3, torch.float32, (B, R)),
        ("hap_codes", hap_codes, torch.int32, tuple(hap_codes.shape)),
        ("rlen", rlen, torch.int32, (B,)),
        ("clen", clen, torch.int32, (B,)),
        ("init_y", init_y, torch.float32, (B,)),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != read_codes.device:
            raise ValueError(
                f"{name} is on {t.device}, read_codes on {read_codes.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def striped_forward(read_codes, read_omq, read_q3, hap_codes, rlen, clen,
                    init_y, trans, stripe: int = 32) -> torch.Tensor:
    """Raw forward probabilities (B,) f32 for pair-major inputs.

    CUDA tensors launch the CUDA kernel for ``stripe`` (8, 16 or 32; it
    must divide r_pad) with ``striped_rows_per_lane`` rows per lane and
    count the launch under ``striped<stripe>``; CPU tensors run
    ``striped_forward_plain``.  Does not synchronise.  A failed build or
    launch raises.  A pair with rlen outside 1..r_pad gives 0.  The domain
    of clen is 1..c_pad (the runner never passes more; a larger clen sums
    the first c_pad columns)."""
    _check_inputs(read_codes, read_omq, read_q3, hap_codes, rlen, clen,
                  init_y)
    if read_codes.device.type == "cpu":
        return striped_forward_plain(
            read_codes, read_omq, read_q3, hap_codes, rlen, clen, init_y,
            trans, stripe,
        )
    if read_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {read_codes.device}")
    out = launch_striped(read_codes, read_omq, read_q3, hap_codes, rlen, clen,
                         init_y, trans, stripe)
    LAUNCHES[f"striped{stripe}"] += 1
    return out


def launch_striped(read_codes, read_omq, read_q3, hap_codes, rlen, clen,
                   init_y, trans, stripe: int) -> torch.Tensor:
    """The striped kernel's launch on checked CUDA tensors, uncounted:
    what ``striped_forward`` counts, and the runner's warm-up launches do
    not."""
    B, r_pad = read_codes.shape
    c_pad = hap_codes.shape[1]
    if stripe not in KERNEL_STRIPES or r_pad % stripe:
        raise ValueError(
            f"the striped kernel takes stripe in {KERNEL_STRIPES} dividing "
            f"r_pad, got stripe {stripe}, r_pad {r_pad}"
        )
    from . import _kernels

    lib = _kernels.load("pairhmm_striped")
    out = torch.empty(B, dtype=torch.float32, device=read_codes.device)
    err = lib.pairhmm_striped_forward(
        read_codes.data_ptr(), read_omq.data_ptr(), read_q3.data_ptr(),
        hap_codes.data_ptr(), rlen.data_ptr(), clen.data_ptr(),
        init_y.data_ptr(), out.data_ptr(), B, r_pad, c_pad, stripe,
        striped_rows_per_lane(stripe, r_pad), *(float(t) for t in trans),
        torch.cuda.current_stream(read_codes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pairhmm_striped_forward launch failed: CUDA error {err}"
        )
    return out


def launch_shape(r_pad: int, c_pad: int, stripe: int,
                 packed: bool = False) -> Dict[str, int]:
    """How ``striped_forward`` (or, with ``packed``,
    ``striped_forward_unique``: its own instance) launches at (r_pad,
    c_pad, stripe) on the current card: rows per lane, stripes, warps per
    block, dynamic shared memory per block (bytes) and the blocks an SM
    holds at once.  Needs a card."""
    from . import _kernels

    lib = _kernels.load("pairhmm_striped")
    k = striped_rows_per_lane(stripe, r_pad)
    out = (ctypes.c_int * 3)()
    query = (lib.pairhmm_striped_unique_launch_shape if packed
             else lib.pairhmm_striped_launch_shape)
    err = query(r_pad, c_pad, stripe, k, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{query.__name__}: CUDA error {err}")
    return {"rows_per_lane": k, "stripes": striped_stripes(stripe, k, r_pad),
            "warps_per_block": out[0], "smem_per_block": out[1],
            "blocks_per_sm": out[2]}


# ---------------------------------------------------------------------------
# Raw-byte glue (the XLA programs around the striped kernel, as torch ops).


def unpack_u8(u8buf, i32buf, base_table, ph2pr_omq, ph2pr_q3,
              nr_pad: int, nh_pad: int, r_pad: int, c_pad: int):
    """Raw-encoding unpack on the buffers' device.  ``u8buf`` is
    [reads | quals | haps] (uint8, 0-padded rows), ``i32buf`` starts with
    [read lens (nr_pad) | hap lens (nh_pad) | init_y bits (nh_pad)].  The
    base and Phred tables are applied with index_select (exact lookups).
    -> (read codes, 1 - q, q / 3, hap codes, read lens, hap lens, init_y)."""
    nrr = nr_pad * r_pad
    read_u8 = u8buf[:nrr]
    qual_u8 = u8buf[nrr : 2 * nrr]
    hap_u8 = u8buf[2 * nrr : 2 * nrr + nh_pad * c_pad]
    q_idx = (qual_u8 & 127).to(torch.int64)
    rc = base_table.index_select(0, read_u8.to(torch.int64))
    omq = ph2pr_omq.index_select(0, q_idx)
    q3 = ph2pr_q3.index_select(0, q_idx)
    hc = base_table.index_select(0, hap_u8.to(torch.int64))
    read_lens = i32buf[:nr_pad]
    hap_lens = i32buf[nr_pad : nr_pad + nh_pad]
    init_y = i32buf[nr_pad + nh_pad : nr_pad + 2 * nh_pad].view(torch.float32)
    return (
        rc.view(nr_pad, r_pad), omq.view(nr_pad, r_pad),
        q3.view(nr_pad, r_pad), hc.view(nh_pad, c_pad),
        read_lens, hap_lens, init_y,
    )


def prepare_tables_striped(u8buf, i32buf, base_table, ph2pr_omq, ph2pr_q3,
                           nr_pad: int, nh_pad: int, r_pad: int, c_pad: int):
    """Unique tables in the striped kernel's raw encodings (codes + f32),
    once per group."""
    return unpack_u8(u8buf, i32buf, base_table, ph2pr_omq, ph2pr_q3,
                     nr_pad, nh_pad, r_pad, c_pad)


def gather_pairs_striped(rc, omq, q3, hc, read_lens, hap_lens, init_y, pairs):
    """Per-pair expansion of the unique tables (exact index ops).
    ``pairs`` is (2, B) [read index; hap index].  -> the kernel's
    pair-major inputs (read codes, 1 - q, q / 3, hap codes, rlen, clen,
    init_y)."""
    pr = pairs[0].to(torch.int64)
    ph = pairs[1].to(torch.int64)
    return (
        rc.index_select(0, pr), omq.index_select(0, pr),
        q3.index_select(0, pr), hc.index_select(0, ph),
        read_lens.index_select(0, pr).contiguous(),
        hap_lens.index_select(0, ph).contiguous(),
        init_y.index_select(0, ph).contiguous(),
    )


def dispatch_pairs_striped(rc, omq, q3, hc, read_lens, hap_lens, init_y,
                           pairs, trans: Tuple, r_pad: int, c_pad: int,
                           stripe: int) -> torch.Tensor:
    """One chunk: gather its pairs from the unique tables and run the
    striped forward.  -> (B,) f32 on the tables' device."""
    args = gather_pairs_striped(rc, omq, q3, hc, read_lens, hap_lens,
                                init_y, pairs)
    if args[0].shape[1] != r_pad or args[3].shape[1] != c_pad:
        raise ValueError(f"tables are not ({r_pad}, {c_pad})-padded")
    return striped_forward(*args, trans, stripe)


def pairhmm_unique(read_u8, qual_u8, read_lens, hap_u8, hap_lens, hap_init_y,
                   pair_read, pair_hap, base_table, ph2pr_omq, ph2pr_q3,
                   trans: Tuple, r_pad: int, c_pad: int,
                   stripe: int = 8) -> torch.Tensor:
    """Unique reads (NR, r_pad) and haplotypes (NH, c_pad) as uint8 ASCII,
    their lengths and INITIAL / haplen, and (B,) pair indices -> (B,) f32:
    the table lookups run on the unique rows, then pairs are gathered on
    the device and the striped forward runs."""
    q_idx = (qual_u8 & 127).to(torch.int64)
    tables = (
        base_table[read_u8.to(torch.int64)],
        ph2pr_omq[q_idx], ph2pr_q3[q_idx],
        base_table[hap_u8.to(torch.int64)],
        read_lens, hap_lens, hap_init_y,
    )
    return dispatch_pairs_striped(
        *tables, torch.stack([pair_read, pair_hap]), trans, r_pad, c_pad,
        stripe,
    )


# ---------------------------------------------------------------------------
# The unique-rows entry: one launch per chunk from the shipped raw rows.


def _segment_pairs(seg: Segment) -> torch.Tensor:
    """A segment's (2, count) read / hap indices, a view of its shipped
    pair indices."""
    return seg.views[2][: 2 * seg.total].view(2, seg.total)[
        :, seg.start : seg.start + seg.count]


def check_unique(segments: Sequence[Segment], table, stripe: int) -> None:
    """Types, shapes and devices of one launch of the unique-rows entry
    (``pairhmm_front.check`` on the packed layout), one segment (the
    striped path launches one chunk of one group: it never fuses), the
    stripe height and r_pad % stripe; on CPU tensors also each pair's
    indices inside nr_pad x nh_pad (on the card the kernel checks them
    with no synchronisation here: a pair outside traps, see
    ``striped_forward_unique``).  Raises on what the entry does not
    take."""
    check("packed", segments, table)
    if len(segments) != 1:
        raise ValueError(f"the striped entry launches one segment, got "
                         f"{len(segments)}")
    r_pad = segments[0].dims[2]
    if table.device.type == "cuda" and stripe not in KERNEL_STRIPES:
        raise ValueError(f"the striped kernel takes stripe in "
                         f"{KERNEL_STRIPES}, got {stripe}")
    if stripe < 1 or r_pad % stripe:
        raise ValueError(f"stripe {stripe} must divide r_pad {r_pad}")
    if table.device.type != "cpu":
        return
    seg = segments[0]
    pairs = _segment_pairs(seg)
    if pairs.numel() and (
            int(pairs.min()) < 0 or int(pairs[0].max()) >= seg.dims[0]
            or int(pairs[1].max()) >= seg.dims[1]):
        raise ValueError(f"pair indices outside {seg.dims[0]} reads x "
                         f"{seg.dims[1]} haps")


def segment_inputs_striped(seg: Segment, tables) -> Tuple[torch.Tensor, ...]:
    """One segment's pair-major striped inputs through the plain glue:
    ``prepare_tables_striped`` on its shipped bytes, then
    ``gather_pairs_striped`` of its pairs.  ``tables`` is
    ``element_tables`` of the entry's table."""
    u8, lens, _pairs = seg.views
    unique = prepare_tables_striped(u8, lens, *tables, *seg.dims)
    return gather_pairs_striped(*unique, _segment_pairs(seg))


def striped_forward_unique_plain(segments: Sequence[Segment], table, trans,
                                 stripe: int) -> torch.Tensor:
    """Plain version of the unique-rows entry: the segment's pair-major
    inputs through the plain glue, then ``striped_forward_plain``; the
    same (count,) f32 bit for bit."""
    (seg,) = segments
    args = segment_inputs_striped(seg, element_tables(table))
    return striped_forward_plain(*args, trans, stripe)


def launch_striped_unique(segments: Sequence[Segment], table, trans,
                          stripe: int) -> torch.Tensor:
    """One launch of the unique-rows entry on checked CUDA tensors,
    uncounted: what ``striped_forward_unique`` counts, and the runner's
    warm-up launches do not.  -> (count,) f32."""
    from . import _kernels

    lib = _kernels.load("pairhmm_striped")
    r_pad, c_pad = segments[0].dims[2:]
    rows = segment_rows("packed", segments)
    dev = table.device
    out = torch.empty(int(rows[0, 1]), dtype=torch.float32, device=dev)
    err = lib.pairhmm_striped_forward_unique(
        rows.ctypes.data, table.data_ptr(), out.data_ptr(),
        r_pad, c_pad, stripe, striped_rows_per_lane(stripe, r_pad),
        *(float(t) for t in trans), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pairhmm_striped_forward_unique launch failed: CUDA error {err}")
    return out


def striped_forward_unique(segments: Sequence[Segment], table, trans,
                           stripe: int = 32) -> torch.Tensor:
    """Raw forward probabilities (count,) f32 of one chunk read from its
    group's shipped raw packed rows: ``segments`` holds one segment (the
    runner's chunk of a group; the striped path never fuses groups).

    ``table`` is the 768-entry ppe_element_table.  CUDA tensors launch the
    striped kernel's unique-rows entry once (``stripe`` 8, 16 or 32,
    dividing r_pad; ``striped_rows_per_lane`` rows per lane) and count the
    launch under ``striped<stripe>`` and ``striped_front_packed``; CPU
    tensors run ``striped_forward_unique_plain``.  Does not synchronise
    and allocates nothing but the result.  A failed build or launch
    raises.  On the card the pair indices are checked by the kernel, not
    here (that would synchronise): a pair outside nr_pad x nh_pad traps,
    which reads nothing out of bounds but ends the process's CUDA context,
    so every later CUDA call of the process fails too; on CPU tensors
    ``check_unique`` raises ``ValueError`` instead."""
    segments: List[Segment] = list(segments)
    check_unique(segments, table, stripe)
    if table.device.type == "cpu":
        return striped_forward_unique_plain(segments, table, trans, stripe)
    out = launch_striped_unique(segments, table, trans, stripe)
    LAUNCHES[f"striped{stripe}"] += 1
    LAUNCHES["striped_front_packed"] += 1
    return out
