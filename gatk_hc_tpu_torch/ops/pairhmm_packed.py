"""The packed and nib shipping paths in front of the ppe kernel: the
prologue CUDA kernel's wrappers and their plain PyTorch versions.

The runner (ops/runner.py) ships a group's unique rows as bytes and lets
the card apply the lookups:

* **packed**: u8 [reads | quals | haps] (2 B per read base) plus the (B,)
  pair indices; the 768-entry ``ppe_element_table`` maps bytes to planes;
* **nib**: u8 [nib reads | haps], each read byte ``(seq_idx << 5) |
  qual_idx`` into a per-group 72-entry mini-table (1 B per read base), and
  a span table of (read_base, hap_base, nr, nh) rows in place of the pair
  indices, expanded on the card.

``prologue_packed`` and ``prologue_nib`` turn them into the ppe kernel's
pair-minor inputs (ops/pairhmm_torch.py) in one pass: on CUDA tensors they
launch csrc/pairhmm_prologue.cu and count the launch under
``prologue_packed`` / ``prologue_nib``; on CPU tensors they run the plain
versions below, which are literal translations of the reference package's
jnp glue: ``unpack_u8_ppe`` (pairhmm_pallas.py::_unpack_u8_ppe and
prepare_tables_ppe, its jit wrapper), ``expand_pairs_from_spans``
(_expand_pairs_from_spans), ``unpack_nib_ppe`` (_unpack_nib_ppe) and the
gathers of dispatch_pairs_ppe (pairhmm_torch.py::gather_unique).  Both
write pairs off .. off + n - 1 of outputs ``stride`` pairs wide, so the
groups of a fused launch share one buffer.  Everything here is exact
integer index work: no float is computed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .pairhmm_torch import LAUNCHES, gather_unique

Outputs = Tuple[torch.Tensor, ...]  # rows, hap, rlen, clen, init_y


def empty_outputs(r_pad: int, c_pad: int, stride: int, device) -> Outputs:
    """Uninitialised ppe inputs for ``stride`` pairs: rows (r_pad, 3,
    stride) i32, hap (c_pad, stride) i32, rlen / clen (stride,) i32,
    init_y (stride,) f32."""
    i32 = torch.int32
    return (
        torch.empty((r_pad, 3, stride), dtype=i32, device=device),
        torch.empty((c_pad, stride), dtype=i32, device=device),
        torch.empty(stride, dtype=i32, device=device),
        torch.empty(stride, dtype=i32, device=device),
        torch.empty(stride, dtype=torch.float32, device=device),
    )


def write_at(out: Outputs, off: int, vals: Outputs) -> Outputs:
    """Copy one group's pair-minor inputs into pairs off.. of ``out``."""
    n = vals[2].shape[0]
    out[0][:, :, off : off + n] = vals[0]
    out[1][:, off : off + n] = vals[1]
    for dst, src in zip(out[2:], vals[2:]):
        dst[off : off + n] = src
    return out


# ---------------------------------------------------------------------------
# Plain versions (the reference's jnp glue, op for op).


def _lens_init(i32buf, nr_pad, nh_pad):
    read_lens = i32buf[:nr_pad]
    hap_lens = i32buf[nr_pad : nr_pad + nh_pad]
    init_y = i32buf[nr_pad + nh_pad : nr_pad + 2 * nh_pad].view(torch.float32)
    return read_lens, hap_lens, init_y


def unpack_u8_ppe(u8buf, i32buf, ppe_table, nr_pad, nh_pad, r_pad, c_pad):
    """Two-gather unpack: a source-index gather over [reads | quals |
    haps] (the qual bytes feed both the 1-q and the q/3 segment), then the
    768-entry table.  -> ru (3, NR, R) [masks | omq bits | q3 bits], hu
    (NH, C), read lens, hap lens, init_y."""
    nrr = nr_pad * r_pad
    n = 3 * nrr + nh_pad * c_pad
    pos = torch.arange(n, dtype=torch.int64, device=u8buf.device)
    offs = torch.where(
        (pos >= nrr) & (pos < 2 * nrr), 256,
        torch.where((pos >= 2 * nrr) & (pos < 3 * nrr), 512, 0),
    )
    src = torch.where(pos >= 2 * nrr, pos - nrr, pos)
    flat = ppe_table.index_select(
        0, u8buf.index_select(0, src).to(torch.int64) + offs
    )
    ru = flat[: 3 * nrr].view(3, nr_pad, r_pad)
    hu = flat[3 * nrr :].view(nh_pad, c_pad)
    return (ru, hu, *_lens_init(i32buf, nr_pad, nh_pad))


def expand_pairs_from_spans(spans, n_pairs: int):
    """(S, 4) i32 span rows [read_base, hap_base, nr, nh] -> (pair reads,
    pair haps), each (n_pairs,) i32: read-major within each span, spans in
    order, positions past the total padded with pair (0, 0); zero-count
    rows are skipped (searchsorted side "right")."""
    spans = spans.to(torch.int64)
    counts = spans[:, 2] * spans[:, 3]
    starts = torch.cumsum(counts, 0) - counts
    total = starts[-1] + counts[-1]
    i = torch.arange(n_pairs, dtype=torch.int64, device=spans.device)
    j = torch.clamp(
        torch.searchsorted(starts, i, right=True) - 1, 0, spans.shape[0] - 1
    )
    nh = torch.clamp(spans[j, 3], min=1)
    local = i - starts[j]
    pr = spans[j, 0] + torch.div(local, nh, rounding_mode="floor")
    ph = spans[j, 1] + torch.remainder(local, nh)
    valid = i < total
    zero = torch.zeros((), dtype=torch.int64, device=spans.device)
    return (
        torch.where(valid, pr, zero).to(torch.int32),
        torch.where(valid, ph, zero).to(torch.int32),
    )


def unpack_nib_ppe(u8buf, i32buf, minitab, ppe_table, nr_pad, nh_pad,
                   r_pad, c_pad):
    """Nibble-dictionary unpack of [nib reads (NR*R) | haps (NH*C)]:
    minitab [0:8] seq masks, [8:40] 1-q bits, [40:72] q/3 bits; hap bytes
    through the 768 table's mask segment.  -> as unpack_u8_ppe."""
    nrr = nr_pad * r_pad
    nb = u8buf[:nrr].to(torch.int64)
    masks = minitab.index_select(0, nb >> 5)
    omq = minitab.index_select(0, (nb & 31) + 8)
    q3 = minitab.index_select(0, (nb & 31) + 40)
    ru = torch.cat([masks, omq, q3]).view(3, nr_pad, r_pad)
    hu = ppe_table.index_select(
        0, u8buf[nrr : nrr + nh_pad * c_pad].to(torch.int64)
    ).view(nh_pad, c_pad)
    return (ru, hu, *_lens_init(i32buf, nr_pad, nh_pad))


def prologue_packed_plain(u8buf, i32buf, pair_read, pair_hap, ppe_table,
                          nr_pad, nh_pad, r_pad, c_pad) -> Outputs:
    """Plain version of the packed prologue: unpack, then the gathers."""
    tables = unpack_u8_ppe(u8buf, i32buf, ppe_table, nr_pad, nh_pad, r_pad,
                           c_pad)
    return gather_unique(*tables, pair_read, pair_hap)


def prologue_nib_plain(u8buf, i32buf, minitab, ppe_table, spans,
                       n_pairs: int, nr_pad, nh_pad, r_pad,
                       c_pad) -> Outputs:
    """Plain version of the nib prologue: unpack, expand the spans, then
    the gathers."""
    tables = unpack_nib_ppe(u8buf, i32buf, minitab, ppe_table, nr_pad,
                            nh_pad, r_pad, c_pad)
    return gather_unique(*tables, *expand_pairs_from_spans(spans, n_pairs))


# ---------------------------------------------------------------------------
# Kernel wrappers.


def _check(u8buf, i32buf, tables, n, dims, out, off, u8_rows):
    """Types, shapes and devices; raises on what the kernel does not take.
    ``u8_rows`` is how many (nr_pad, r_pad) byte planes precede the haps."""
    nr_pad, nh_pad, r_pad, c_pad = dims
    dev = u8buf.device
    if u8buf.dtype != torch.uint8 or u8buf.dim() != 1:
        raise TypeError("u8buf must be a 1-D uint8 tensor")
    if u8buf.numel() < u8_rows * nr_pad * r_pad + nh_pad * c_pad:
        raise ValueError("u8buf is shorter than its tables")
    if i32buf.dtype != torch.int32 or i32buf.numel() < nr_pad + 2 * nh_pad:
        raise ValueError("i32buf must hold int32 [rlens | hlens | init_y]")
    for name, t in tables:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    want = ((r_pad, 3), (c_pad,), (), (), ())
    dtypes = (torch.int32,) * 4 + (torch.float32,)
    for k, (t, lead) in enumerate(zip(out, want)):
        if t.dtype != dtypes[k]:
            raise TypeError(f"output {k} must be {dtypes[k]}, got {t.dtype}")
        if tuple(t.shape[:-1]) != lead or not t.is_contiguous():
            raise ValueError(f"output {k} must be a contiguous {lead} x stride")
        if t.shape[-1] != out[0].shape[-1]:
            raise ValueError("outputs must share one stride")
    if off < 0 or off + n > out[0].shape[-1]:
        raise ValueError(f"pairs {off}..{off + n} exceed stride {out[0].shape[-1]}")
    for t in (i32buf, *(t for _, t in tables), *out):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, u8buf on {dev}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if dev.type == "cuda" and (r_pad % 4 or c_pad % 4 or u8buf.data_ptr() % 4):
        raise ValueError(
            "the prologue kernel reads 4 bytes at a time: r_pad and c_pad "
            "must be multiples of 4 and u8buf 4-byte aligned"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def prologue_packed(u8buf, i32buf, pair_read, pair_hap, ppe_table, nr_pad,
                    nh_pad, r_pad, c_pad, out=None, off: int = 0) -> Outputs:
    """Packed prologue of the (n,) pairs into pairs off .. off + n - 1 of
    ``out`` (allocated n wide when None); returns ``out``.  CUDA tensors
    launch the kernel (counted under ``prologue_packed``), CPU tensors run
    ``prologue_packed_plain``.  Does not synchronise."""
    n = pair_read.numel()
    dims = (nr_pad, nh_pad, r_pad, c_pad)
    if out is None:
        out = empty_outputs(r_pad, c_pad, n, u8buf.device)
    _check(u8buf, i32buf, (("pair_read", pair_read), ("pair_hap", pair_hap),
                           ("ppe_table", ppe_table)), n, dims, out, off, 2)
    if pair_hap.numel() != n or ppe_table.numel() != 768:
        raise ValueError("pair arrays must match; ppe_table has 768 entries")
    if u8buf.device.type == "cpu":
        return write_at(out, off, prologue_packed_plain(
            u8buf, i32buf, pair_read, pair_hap, ppe_table, *dims))
    launch_prologue("packed", u8buf, i32buf, pair_read, pair_hap, ppe_table,
                    n, *dims, out=out, off=off)
    LAUNCHES["prologue_packed"] += 1
    return out


def prologue_nib(u8buf, i32buf, minitab, ppe_table, spans, n_pairs: int,
                 nr_pad, nh_pad, r_pad, c_pad, out=None,
                 off: int = 0) -> Outputs:
    """Nib prologue of ``n_pairs`` pairs, expanded from the (S, 4) span
    table, into pairs off .. off + n_pairs - 1 of ``out`` (allocated when
    None); returns ``out``.  CUDA tensors launch the kernel (counted under
    ``prologue_nib``), CPU tensors run ``prologue_nib_plain``."""
    dims = (nr_pad, nh_pad, r_pad, c_pad)
    if out is None:
        out = empty_outputs(r_pad, c_pad, n_pairs, u8buf.device)
    _check(u8buf, i32buf, (("minitab", minitab), ("ppe_table", ppe_table),
                           ("spans", spans)), n_pairs, dims, out, off, 1)
    if minitab.numel() != 72 or ppe_table.numel() != 768:
        raise ValueError("minitab has 72 entries and ppe_table 768")
    if spans.dim() != 2 or spans.shape[1] != 4 or spans.shape[0] < 1:
        raise ValueError(f"spans must be (S, 4), got {tuple(spans.shape)}")
    if u8buf.device.type == "cpu":
        return write_at(out, off, prologue_nib_plain(
            u8buf, i32buf, minitab, ppe_table, spans, n_pairs, *dims))
    launch_prologue("nib", u8buf, i32buf, minitab, ppe_table, spans,
                    spans.shape[0], n_pairs, *dims, out=out, off=off)
    LAUNCHES["prologue_nib"] += 1
    return out


def launch_prologue(kind: str, *tensors_and_ints, out, off: int) -> None:
    """One prologue launch ("packed" or "nib") on checked CUDA tensors,
    uncounted: what the wrappers count, and the runner's warm-up launches
    do not.  Tensors are passed as pointers, ints as they are, in the
    order of pairhmm_prologue_<kind> (csrc/pairhmm_prologue.cu)."""
    from . import _kernels

    lib = _kernels.load("pairhmm_prologue")
    fn = getattr(lib, f"pairhmm_prologue_{kind}")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
            for a in tensors_and_ints]
    err = fn(*args, *(t.data_ptr() for t in out), out[0].shape[-1], off,
             torch.cuda.current_stream(out[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"pairhmm_prologue_{kind} launch failed: CUDA error {err}")
