"""The ppe kernel's unique-rows entry: one launch per launch unit on every
shipping path, its wrapper and its plain PyTorch version.

The runner (ops/runner.py) ships a group's unique reads and haplotypes
once, in one of three encodings, and the ppe kernel (csrc/pairhmm_ppe.cu,
``pairhmm_ppe_forward_unique``) reads them itself: each warp finds its
(read, hap) pair, loads its read rows from the unique read row and stages
its hap from the unique hap row, so no per-pair copy of the inputs is
written to device memory and no other launch precedes the kernel's.  It
replaces the XLA glue in front of the reference's _pallas_call_ppe
(gatk_hc_tpu/ops/pairhmm_pallas.py): _unpack_planes with the gathers of
pairhmm_pallas_planes / _fused, _unpack_u8_ppe with dispatch_pairs_ppe
(pairhmm_pallas_packed / _fused) and _unpack_nib_ppe with
_expand_pairs_from_spans (pairhmm_pallas_packed_nib / _fused).

A launch unit is a list of ``Segment``s, one per group (k of them in a
fused launch; one chunk of a large group is one segment that starts at
its first pair), all at one (r_pad, c_pad).  A segment's views are its
group's shipped arrays, as ``_HostBuffer.ship`` gives them:

* ``planes``: i32 [rlens | hlens | init_y bits | ru (3, nr_pad, r_pad) |
  hu (nh_pad, c_pad)], i32 pairs (2, total);
* ``packed``: u8 [reads | quals | haps], i32 [rlens | hlens | init_y
  bits], i32 pairs (2, total);
* ``nib``: u8 [nib reads | haps], i32 lengths as packed, i32 mini-table
  (72), i32 span table (S, 4) and i32 ``nib_starts`` of it (S + 1).

``ppe_forward_unique`` launches the entry on CUDA tensors and counts the
launch under ``ppe<NR>`` and ``ppe_front_<path>``; on CPU tensors it runs
``ppe_forward_unique_plain``: the plain glue (ops/pairhmm_packed.py,
``gather_unique``) per segment, then ``ppe_forward_plain``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .pairhmm_packed import prologue_nib_plain, prologue_packed_plain
from .pairhmm_torch import (
    LAUNCHES, gather_unique, ppe_forward_plain, rows_per_lane, select_rows,
    unpack_planes,
)

# the kernel's Src codes (csrc/pairhmm_ppe.cu)
SOURCES = {"planes": 1, "packed": 2, "nib": 3}
MAX_SEGMENTS = 16  # segments of one launch: the largest fuse_groups
SEG_FIELDS = 14  # int64 values per segment row
MINITAB = 72
TABLE = 768


@dataclasses.dataclass(frozen=True)
class Segment:
    """One group's share of a launch: launch pairs (in segment order) are
    the group's pairs ``start`` .. ``start + count - 1`` of ``total``."""

    views: Tuple[torch.Tensor, ...]
    dims: Tuple[int, int, int, int]  # nr_pad, nh_pad, r_pad, c_pad
    total: int  # the group's pairs: width of its (2, total) pair indices
    start: int = 0
    n: Optional[int] = None  # pairs in this launch; None: total - start

    @property
    def count(self) -> int:
        return self.total - self.start if self.n is None else self.n


def nib_starts(spans: np.ndarray) -> np.ndarray:
    """(S, 4) span rows [read_base, hap_base, nr, nh] -> (S + 1,) i32: the
    exclusive starts of nr * nh, then their total (what
    expand_pairs_from_spans computes per call, shipped once)."""
    counts = spans[:, 2].astype(np.int64) * spans[:, 3].astype(np.int64)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _wanted(path: str, seg: Segment):
    """(name, dtype, least elements) of each view of a segment."""
    nr_pad, nh_pad, r_pad, c_pad = seg.dims
    nrr, hc, lens = nr_pad * r_pad, nh_pad * c_pad, nr_pad + 2 * nh_pad
    i32, u8 = torch.int32, torch.uint8
    if path == "planes":
        return [("planes", i32, lens + 3 * nrr + hc),
                ("pairs", i32, 2 * seg.total)]
    if path == "packed":
        return [("u8", u8, 2 * nrr + hc), ("lens", i32, lens),
                ("pairs", i32, 2 * seg.total)]
    n_spans = max(1, seg.views[3].numel() // 4) if len(seg.views) > 3 else 1
    return [("u8", u8, nrr + hc), ("lens", i32, lens),
            ("minitab", i32, MINITAB), ("spans", i32, 4),
            ("starts", i32, n_spans + 1)]


def check(path: str, segments: Sequence[Segment], ppe_table) -> None:
    """Types, shapes and devices of one launch; raises on what the kernel
    does not take."""
    if path not in SOURCES:
        raise ValueError(f"unknown path {path!r}: one of {sorted(SOURCES)}")
    if not segments:
        raise ValueError("a launch needs at least one segment")
    dev = ppe_table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if ppe_table.dtype != torch.int32 or ppe_table.numel() != TABLE:
        raise ValueError("ppe_table must be the 768-entry int32 table")
    if dev.type == "cuda" and len(segments) > MAX_SEGMENTS:
        raise ValueError(f"{len(segments)} segments: at most {MAX_SEGMENTS}")
    pads = segments[0].dims[2:]
    for seg in segments:
        if len(seg.dims) != 4 or min(seg.dims) < 1:
            raise ValueError(f"bad dims {seg.dims}")
        if seg.dims[2:] != pads:
            raise ValueError("the segments of a launch share (r_pad, c_pad)")
        if not 0 <= seg.start <= seg.start + seg.count <= seg.total:
            raise ValueError(f"pairs {seg.start}..{seg.start + seg.count} "
                             f"exceed the group's {seg.total}")
        want = _wanted(path, seg)
        if len(seg.views) != len(want):
            raise ValueError(f"{path} takes {len(want)} views, "
                             f"got {len(seg.views)}")
        for view, (name, dtype, least) in zip(seg.views, want):
            if view.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {view.dtype}")
            if view.dim() != 1 or view.numel() < least:
                raise ValueError(f"{name} is shorter than its tables "
                                 f"({view.numel()} < {least})")
            if view.device != dev:
                raise ValueError(f"{name} is on {view.device}, "
                                 f"ppe_table on {dev}")
            if not view.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if path == "nib" and seg.views[3].numel() % 4:
            raise ValueError("spans must hold (S, 4) rows")


# ---------------------------------------------------------------------------
# Plain version.


def segment_inputs(path: str, seg: Segment, ppe_table) -> Tuple[torch.Tensor, ...]:
    """One segment's pair-minor ppe inputs (rows, hap, rlen, clen, init_y)
    through the plain glue."""
    a, b = seg.start, seg.start + seg.count
    if path == "nib":
        u8, lens, mini, spans, _starts = seg.views
        out = prologue_nib_plain(u8, lens, mini, ppe_table, spans.view(-1, 4),
                                 b, *seg.dims)
        return tuple(t[..., a:].contiguous() for t in out)
    pairs = seg.views[-1][: 2 * seg.total].view(2, seg.total)[:, a:b]
    if path == "planes":
        return gather_unique(*unpack_planes(seg.views[0], *seg.dims),
                             pairs[0], pairs[1])
    return prologue_packed_plain(seg.views[0], seg.views[1], pairs[0],
                                 pairs[1], ppe_table, *seg.dims)


def ppe_forward_unique_plain(path: str, segments: Sequence[Segment],
                             ppe_table, trans) -> torch.Tensor:
    """Plain version of the unique-rows entry: every segment's pair-minor
    inputs, end to end, through ``ppe_forward_plain``; same (sum of
    counts,) f32 bit for bit."""
    parts = [segment_inputs(path, seg, ppe_table) for seg in segments]
    args = parts[0] if len(parts) == 1 else [
        torch.cat([p[k] for p in parts], dim=-1) for k in range(5)]
    return ppe_forward_plain(*args, trans)


# ---------------------------------------------------------------------------
# Kernel wrapper.


def segment_rows(path: str, segments: Sequence[Segment]) -> np.ndarray:
    """The C entry's segment table: (n, SEG_FIELDS) int64 rows [first, n,
    src, lens, rows, haps, pairs, stride, mini, spans, starts, nr_pad,
    nh_pad, n_spans], pointers as the views' addresses."""
    rows = np.zeros((len(segments), SEG_FIELDS), np.int64)
    first = 0
    for row, seg in zip(rows, segments):
        nr_pad, nh_pad, r_pad, c_pad = seg.dims
        nrr = nr_pad * r_pad
        v = seg.views
        row[:3] = first, seg.count, seg.start
        row[11:13] = nr_pad, nh_pad
        if path == "planes":
            base = v[0].data_ptr()
            row[3] = base
            row[4] = base + 4 * (nr_pad + 2 * nh_pad)
            row[5] = row[4] + 4 * 3 * nrr
            row[6:8] = v[1].data_ptr(), seg.total
        else:
            row[3] = v[1].data_ptr()
            row[4] = v[0].data_ptr()
            row[5] = row[4] + (2 if path == "packed" else 1) * nrr
            if path == "packed":
                row[6:8] = v[2].data_ptr(), seg.total
            else:
                row[8:11] = [t.data_ptr() for t in v[2:5]]
                row[13] = v[3].numel() // 4
        first += seg.count
    return rows


def launch_ppe_unique(path: str, segments: Sequence[Segment], ppe_table,
                      trans, ppe_rows: int) -> torch.Tensor:
    """One launch of the entry on checked CUDA tensors, uncounted: what
    ``ppe_forward_unique`` counts, and the runner's warm-up launches do
    not.  -> (sum of counts,) f32."""
    from . import _kernels

    lib = _kernels.load("pairhmm_ppe")
    r_pad, c_pad = segments[0].dims[2:]
    nr = select_rows(ppe_rows, r_pad)
    rows = segment_rows(path, segments)
    dev = ppe_table.device
    out = torch.empty(int(rows[:, 1].sum()), dtype=torch.float32, device=dev)
    err = lib.pairhmm_ppe_forward_unique(
        SOURCES[path], rows.ctypes.data, len(segments), ppe_table.data_ptr(),
        out.data_ptr(), r_pad, c_pad, rows_per_lane(nr, r_pad),
        *(float(t) for t in trans), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"pairhmm_ppe_forward_unique launch failed: CUDA error {err}")
    return out


def ppe_forward_unique(path: str, segments: Sequence[Segment], ppe_table,
                       trans, ppe_rows: int = 4) -> torch.Tensor:
    """Raw forward probabilities (sum of the segments' counts,) f32 of a
    launch unit read from its unique rows, segment after segment.

    ``path`` is "planes", "packed" or "nib"; CUDA tensors launch the ppe
    kernel once (NR from ``select_rows``) and count the launch under
    ``ppe<NR>`` and ``ppe_front_<path>``; CPU tensors run
    ``ppe_forward_unique_plain``.  Does not synchronise and allocates
    nothing but the result.  A failed build or launch raises."""
    segments: List[Segment] = list(segments)
    check(path, segments, ppe_table)
    if ppe_table.device.type == "cpu":
        return ppe_forward_unique_plain(path, segments, ppe_table, trans)
    out = launch_ppe_unique(path, segments, ppe_table, trans, ppe_rows)
    LAUNCHES[f"ppe{select_rows(ppe_rows, segments[0].dims[2])}"] += 1
    LAUNCHES[f"ppe_front_{path}"] += 1
    return out
