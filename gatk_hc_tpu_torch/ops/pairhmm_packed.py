"""The packed and nib shipping encodings' glue in front of the ppe kernel,
as plain PyTorch: the plain half of the ppe kernel's unique-rows entry
(ops/pairhmm_front.py, csrc/pairhmm_ppe.cu), which reads the same bytes
on the card.

The runner (ops/runner.py) ships a group's unique rows as bytes:

* **packed**: u8 [reads | quals | haps] (2 B per read base) plus the (B,)
  pair indices; the 768-entry ``ppe_element_table`` maps bytes to planes;
* **nib**: u8 [nib reads | haps], each read byte ``(seq_idx << 5) |
  qual_idx`` into a per-group 72-entry mini-table (1 B per read base), and
  a span table of (read_base, hap_base, nr, nh) rows in place of the pair
  indices.

The functions below are literal translations of the reference package's
jnp glue: ``unpack_u8_ppe`` (pairhmm_pallas.py::_unpack_u8_ppe and
prepare_tables_ppe, its jit wrapper), ``expand_pairs_from_spans``
(_expand_pairs_from_spans), ``unpack_nib_ppe`` (_unpack_nib_ppe) and the
gathers of dispatch_pairs_ppe (pairhmm_torch.py::gather_unique).
``prologue_packed_plain`` / ``prologue_nib_plain`` compose them into the
ppe kernel's pair-minor inputs.  Everything here is exact integer index
work: no float is computed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .pairhmm_torch import gather_unique

Outputs = Tuple[torch.Tensor, ...]  # rows, hap, rlen, clen, init_y


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
    """The packed path's pair-minor ppe inputs: unpack, then the
    gathers."""
    tables = unpack_u8_ppe(u8buf, i32buf, ppe_table, nr_pad, nh_pad, r_pad,
                           c_pad)
    return gather_unique(*tables, pair_read, pair_hap)


def prologue_nib_plain(u8buf, i32buf, minitab, ppe_table, spans,
                       n_pairs: int, nr_pad, nh_pad, r_pad,
                       c_pad) -> Outputs:
    """The nib path's pair-minor ppe inputs for pairs 0 .. n_pairs - 1:
    unpack, expand the spans, then the gathers."""
    tables = unpack_nib_ppe(u8buf, i32buf, minitab, ppe_table, nr_pad,
                            nh_pad, r_pad, c_pad)
    return gather_unique(*tables, *expand_pairs_from_spans(spans, n_pairs))
