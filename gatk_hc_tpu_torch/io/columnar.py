"""Columnar read store — the production data path.

Parses a SAM file once in C++ (native/hc_native.cpp::hc_sam_parse) into
struct-of-arrays form, builds per-contig positional CSR indexes for the
deterministic downsampler, and prepares each window's reads (filters +
soft-clip reversion + interval hard clip) with one native call per window.

This replaces the per-record Python objects of io/sam.py on the hot path —
they remain the semantic oracle (tests/test_columnar.py checks the two
pipelines produce identical reads for every window).  Mirrors the
reference's C++ data layer: sam.hpp:100-114 (parse), haplotypecaller.hpp:
24-50 (bucketing + downsampling), read_filter.hpp:8-38, read_clipper.hpp:
32-91.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import HCConfig
from ..utils.interval import Interval


@dataclasses.dataclass(eq=False)  # ndarray fields: no field-wise __eq__
class PreparedRead:
    """A window-ready read: clipped bases/quals + post-revert alignment span.

    Quacks like io/sam.py::SAMRecord for every downstream consumer (the
    assembler and PairHMM engines read sequence data; the genotyper reads
    interval; likelihood normalization reads len).  Bases/quals are held as
    zero-copy uint8 views into the window's native output blob — the hot
    consumers take arrays directly; ``seq``/``qual`` decode on demand."""

    seq_u8: np.ndarray
    qual_u8: np.ndarray
    rname: str
    alignment_begin: int
    alignment_end: int

    @property
    def seq(self) -> str:
        return self.seq_u8.tobytes().decode("ascii")

    @property
    def qual(self) -> str:
        return self.qual_u8.tobytes().decode("ascii")

    @property
    def interval(self) -> Interval:
        return Interval(self.rname, self.alignment_begin, self.alignment_end)

    def __len__(self) -> int:
        return len(self.seq_u8)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized models/downsampler.py::_splitmix64 (must match bit-for-bit)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


class _ContigIndex:
    """Positional CSR over one contig's store rows (parse order preserved)."""

    def __init__(self, store_rows: np.ndarray, begins: np.ndarray, size: int):
        valid = (begins >= 0) & (begins < size)
        rows = store_rows[valid]
        begins = begins[valid]
        # coordinate-sorted SAMs (the common case) skip the argsort; the
        # stable sort preserves parse order within a start position either
        # way (the downsampler's tie-break rule)
        if begins.size and np.any(begins[1:] < begins[:-1]):
            order = np.argsort(begins, kind="stable")
            rows = rows[order]
        self.rows = np.ascontiguousarray(rows, dtype=np.int64)
        self.counts = np.bincount(begins, minlength=size)
        self.starts = np.zeros(size + 1, dtype=np.int64)
        np.cumsum(self.counts, out=self.starts[1:])
        self.size = size

    def select(self, begin: int, end: int, cfg: HCConfig) -> np.ndarray:
        """Store rows of the downsampled reads in [begin, end), one per
        non-empty start position, in position order (downsampler.py)."""
        lo, hi = max(begin, 0), min(end, self.size)
        if hi <= lo:
            return np.empty(0, dtype=np.int64)
        counts = self.counts[lo:hi]
        positions = np.nonzero(counts)[0] + lo
        if cfg.downsample_mode == "first":
            offsets = np.zeros(len(positions), dtype=np.int64)
        elif cfg.downsample_mode == "seeded":
            # match downsampler.py exactly: (seed*0x10001 + pos) mod 2^64,
            # with arbitrary (incl. negative) Python int seeds
            base = (cfg.downsample_seed * 0x10001) & 0xFFFFFFFFFFFFFFFF
            with np.errstate(over="ignore"):
                h = _splitmix64_np(
                    np.uint64(base) + positions.astype(np.uint64)
                )
            offsets = (h % self.counts[positions].astype(np.uint64)).astype(
                np.int64
            )
        else:
            raise ValueError(
                f"unknown downsample_mode {cfg.downsample_mode!r}"
            )
        return self.rows[self.starts[positions] + offsets]


def _count_lines(buf: np.ndarray, chunk: int = 1 << 26) -> int:
    """Newline count in bounded-temporary chunks (a whole-buffer == would
    materialize a bool array the size of the file)."""
    total = 0
    for i in range(0, len(buf), chunk):
        total += int(np.count_nonzero(buf[i : i + chunk] == 10))
    return total


def map_sam_bytes(sam_path: str) -> np.ndarray:
    """The SAM text as a read-only uint8 memmap: the kernel pages the file
    in and out on demand, so scanning/parsing never holds a second full
    copy of the text in RSS (the previous handle.read() did)."""
    if os.path.getsize(sam_path) == 0:
        return np.zeros(0, dtype=np.uint8)
    return np.memmap(sam_path, dtype=np.uint8, mode="r")


def _contig_name_blob(names: Sequence[str]):
    blob = (
        np.frombuffer("".join(names).encode(), dtype=np.uint8)
        if names
        else np.zeros(1, dtype=np.uint8)
    )
    offs = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(n.encode()) for n in names], out=offs[1:])
    return blob, offs


def _keep_arrays(
    names: Sequence[str],
    contig_sizes: Dict[str, int],
    start_ranges: Optional[Dict[str, Tuple[int, int]]],
):
    """Per-contig [lo, hi) 0-based start-position keep ranges.  None means
    keep every position; contigs absent from an explicit ``start_ranges``
    keep nothing (they belong to another shard)."""
    lo = np.zeros(len(names), np.int64)
    hi = np.zeros(len(names), np.int64)
    for i, name in enumerate(names):
        if start_ranges is None:
            lo[i], hi[i] = 0, contig_sizes[name]
        elif name in start_ranges:
            a, b = start_ranges[name]
            lo[i], hi[i] = max(0, int(a)), min(contig_sizes[name], int(b))
        else:
            lo[i], hi[i] = 0, 0
    return lo, hi


class SamLayout:
    """One ranged scan over the SAM text: per-contig allocation counts and
    the byte range covering each contig's kept records.

    Built once, it lets a streaming caller (cfg.stream_contigs) or a
    multi-host shard parse each contig's slice without re-scanning the
    file.  ``rows[c] = (reads, cigar-op bound, seq bytes, byte_lo,
    byte_hi)`` with byte_lo/byte_hi == -1 when contig c kept nothing."""

    def __init__(
        self,
        sam_path: str,
        contig_sizes: Dict[str, int],
        start_ranges: Optional[Dict[str, Tuple[int, int]]] = None,
        threads: int = 1,
    ):
        """``threads`` > 1 runs the scan over newline-aligned byte blocks
        in parallel (hc_sam_scan_ranges_mt) — identical rows for any
        thread count; 0 = one thread per CPU."""
        from .. import native

        lib = native._load()
        buf = map_sam_bytes(sam_path)
        names = list(contig_sizes)
        blob, offs = _contig_name_blob(names)
        lo, hi = _keep_arrays(names, contig_sizes, start_ranges)
        rows = np.zeros((max(len(names), 1), 5), np.int64)
        c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        i64 = ctypes.c_int64
        n_threads = threads if threads > 0 else (os.cpu_count() or 1)
        common = (
            c(buf, ctypes.c_uint8), i64(len(buf)),
            c(blob, ctypes.c_uint8), c(offs, i64), ctypes.c_int32(len(names)),
            c(lo, i64), c(hi, i64),
        )
        if n_threads > 1:
            lib.hc_sam_scan_ranges_mt(
                *common, ctypes.c_int32(n_threads), c(rows, i64)
            )
        else:
            lib.hc_sam_scan_ranges(*common, c(rows, i64))
        self.sam_path = sam_path
        self.contig_sizes = dict(contig_sizes)
        self.names = names
        self.rows = rows[: len(names)]
        self.keep_lo = lo
        self.keep_hi = hi
        self.start_ranges = start_ranges

    def contig_range(self, name: str) -> Tuple[int, int]:
        """The kept start-position range for one contig."""
        i = self.names.index(name)
        return int(self.keep_lo[i]), int(self.keep_hi[i])

    def store_for(self, *names: str, threads: int = 1) -> "ColumnarReadStore":
        """A store holding only the named contigs' kept reads, parsed from
        their byte slices (no re-scan)."""
        ranges = {n: self.contig_range(n) for n in names}
        return ColumnarReadStore(
            self.sam_path, self.contig_sizes, start_ranges=ranges,
            layout=self, threads=threads,
        )


class ColumnarReadStore:
    """The SAM file (or one shard/contig slice of it) in struct-of-arrays
    form (C++ parsed).

    ``start_ranges`` restricts the store to records whose 0-based start
    position falls inside a per-contig [lo, hi) range — the multi-host
    shard parse (each process materializes only the reads its padded
    windows can select, SURVEY.md §7 step 7) and the contig-streaming
    bounded-memory mode both use this.  Window results are identical to a
    full store for any window whose padded interval lies inside the kept
    ranges: the deterministic downsampler only consults per-start-position
    counts, which the range filter preserves (tests/test_sharding.py)."""

    def __init__(
        self,
        sam_path: str,
        contig_sizes: Dict[str, int],
        start_ranges: Optional[Dict[str, Tuple[int, int]]] = None,
        layout: Optional[SamLayout] = None,
        threads: int = 1,
    ):
        """``threads`` > 1 parses the keep-everything path with
        hc_sam_parse_mt (newline-aligned byte blocks, exact per-block
        counting, parallel fill) — byte-identical output for any thread
        count (tests/test_columnar.py), same malformed-line error
        contract.  0 = one thread per CPU.  Ranged/slice parses stay
        single-threaded (they are per-contig and already overlap assembly
        via parse-ahead)."""
        from .. import native

        lib = native._load()
        buf = map_sam_bytes(sam_path)
        names = list(contig_sizes)
        blob, offs = _contig_name_blob(names)

        c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        i64 = ctypes.c_int64
        ranged = start_ranges is not None or layout is not None
        if not ranged:
            # keep-everything path: unknown-contig records are kept with
            # rname_id = -1 (full validation, exact Python-loader parity).
            # Allocation uses cheap UPPER BOUNDS instead of a counting scan
            # pass — np.zeros pages lazily (calloc), so untouched slack
            # costs no physical memory and the 4+ GB text is traversed
            # once, not twice.  Bounds: records <= lines; every cigar op
            # is >= 2 bytes of its line; seq+qual bytes <= file bytes.
            n = _count_lines(buf) + 1
            ops = max(len(buf) // 2, 1)
            nbytes = max(len(buf), 1)
            byte_lo, byte_hi = 0, len(buf)
            keep_lo = keep_hi = None
        else:
            keep_lo, keep_hi = _keep_arrays(names, contig_sizes, start_ranges)
            if layout is None:
                layout = SamLayout(sam_path, contig_sizes, start_ranges)
            # a layout scanned with wider ranges still sizes correctly:
            # only rows of contigs this store keeps contribute
            active = keep_hi > keep_lo
            rows = layout.rows[active]
            matched = rows[:, 3] >= 0
            n = int(rows[:, 0].sum())
            ops = int(rows[:, 1].sum())
            nbytes = int(rows[:, 2].sum())
            if matched.any():
                byte_lo = int(rows[matched, 3].min())
                byte_hi = int(rows[matched, 4].max())
            else:
                byte_lo = byte_hi = 0
        self.pos = np.zeros(n, np.int32)
        self.flag = np.zeros(n, np.int32)
        self.mapq = np.zeros(n, np.int32)
        self.rnext_eq = np.zeros(n, np.uint8)
        self.rname_id = np.zeros(n, np.int32)
        self.cig_off = np.zeros(n + 1, np.int64)
        self.cig_op = np.zeros(max(ops, 1), np.uint8)
        self.cig_len = np.zeros(max(ops, 1), np.int32)
        self.seq_off = np.zeros(n + 1, np.int64)
        self.seq = np.zeros(max(nbytes, 1), np.uint8)
        self.qual = np.zeros(max(nbytes, 1), np.uint8)
        sl = buf[byte_lo:byte_hi] if byte_hi > byte_lo else np.zeros(
            0, dtype=np.uint8
        )
        common = (
            c(sl, ctypes.c_uint8), i64(len(sl)),
            c(blob, ctypes.c_uint8), c(offs, i64), ctypes.c_int32(len(names)),
        )
        outs = (
            c(self.pos, ctypes.c_int32), c(self.flag, ctypes.c_int32),
            c(self.mapq, ctypes.c_int32), c(self.rnext_eq, ctypes.c_uint8),
            c(self.rname_id, ctypes.c_int32),
            c(self.cig_off, i64), c(self.cig_op, ctypes.c_uint8),
            c(self.cig_len, ctypes.c_int32),
            c(self.seq_off, i64), c(self.seq, ctypes.c_uint8),
            c(self.qual, ctypes.c_uint8),
        )
        n_threads = threads if threads > 0 else (os.cpu_count() or 1)
        if not ranged:
            if n_threads > 1:
                parsed = lib.hc_sam_parse_mt(
                    *common, ctypes.c_int32(n_threads), *outs
                )
            else:
                parsed = lib.hc_sam_parse(*common, *outs)
        elif n_threads > 1:
            parsed = lib.hc_sam_parse_ranges_mt(
                *common, c(keep_lo, i64), c(keep_hi, i64),
                ctypes.c_int32(n_threads), *outs
            )
        else:
            parsed = lib.hc_sam_parse_ranges(
                *common, c(keep_lo, i64), c(keep_hi, i64), *outs
            )
        if parsed < 0:
            # native line numbers are relative to the parsed slice
            line = -parsed + _count_lines(buf[:byte_lo])
            raise ValueError(
                f"malformed SAM line {line} in {sam_path} "
                "(fewer than 11 fields)"
            )
        if not ranged:
            # shrink the upper-bound allocations to the parsed reality
            # (zero-copy views; the untouched calloc slack stays unmapped)
            n = int(parsed)
            self.pos = self.pos[:n]
            self.flag = self.flag[:n]
            self.mapq = self.mapq[:n]
            self.rnext_eq = self.rnext_eq[:n]
            self.rname_id = self.rname_id[:n]
            self.cig_off = self.cig_off[: n + 1]
            self.cig_op = self.cig_op[: max(int(self.cig_off[n]), 1)]
            self.cig_len = self.cig_len[: max(int(self.cig_off[n]), 1)]
            self.seq_off = self.seq_off[: n + 1]
            self.seq = self.seq[: max(int(self.seq_off[n]), 1)]
            self.qual = self.qual[: max(int(self.seq_off[n]), 1)]
        else:
            assert parsed == n, (parsed, n)
        self.n_reads = n
        self._names = names
        self._lib = lib
        # store-array pointers bound once: 10 ctypes wraps per
        # prepare_window call added ~0.7s over a 2Mb contig's 8k regions
        self._static_ptrs = (
            c(self.pos, ctypes.c_int32), c(self.flag, ctypes.c_int32),
            c(self.mapq, ctypes.c_int32), c(self.rnext_eq, ctypes.c_uint8),
            c(self.cig_off, i64), c(self.cig_op, ctypes.c_uint8),
            c(self.cig_len, ctypes.c_int32),
            c(self.seq_off, i64), c(self.seq, ctypes.c_uint8),
            c(self.qual, ctypes.c_uint8),
        )
        self._indexes: Dict[str, _ContigIndex] = {}
        begins = self.pos.astype(np.int64) - 1
        for cid, name in enumerate(names):
            mask = self.rname_id == cid
            self._indexes[name] = _ContigIndex(
                np.nonzero(mask)[0], begins[mask], contig_sizes[name]
            )
        # reads that landed in a known contig's positional index — the same
        # population the Python loader buckets (its reads_parsed counter)
        self.n_bucketed = sum(
            int(idx.rows.size) for idx in self._indexes.values()
        )

    def window_buffers(self, sel: np.ndarray):
        """Output buffers for a window's prepared reads: (out_seq, out_qual,
        out_off, out_ab, out_ae, cap).  Shared by prepare_window and the
        fused native window path."""
        cap = int((self.seq_off[sel + 1] - self.seq_off[sel]).sum())
        return (
            np.empty(max(cap, 1), np.uint8),
            np.empty(max(cap, 1), np.uint8),
            np.empty(len(sel) + 1, np.int64),
            np.empty(len(sel), np.int64),
            np.empty(len(sel), np.int64),
            cap,
        )

    def prepare_window(
        self, contig: str, begin: int, end: int, cfg: HCConfig
    ):
        """Downsample + filter + revert-softclip + hard-clip, one native call.

        Returns (reads, n_downsampled) — the second value distinguishes
        empty-after-downsample (logged as 'Ignore' by the caller,
        haplotypecaller.hpp:145) from empty-after-filtering."""
        sel = self._indexes[contig].select(begin, end, cfg)
        if sel.size == 0:
            return [], 0
        out_seq, out_qual, out_off, out_ab, out_ae, cap = self.window_buffers(sel)
        c = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        i64 = ctypes.c_int64
        kept = self._lib.hc_prepare_window(
            *self._static_ptrs,
            c(sel, i64), ctypes.c_int32(len(sel)),
            ctypes.c_int32(cfg.min_mapping_quality),
            ctypes.c_int32(cfg.min_read_length_after_trimming),
            i64(begin), i64(end),
            c(out_seq, ctypes.c_uint8), c(out_qual, ctypes.c_uint8),
            c(out_off, i64), c(out_ab, i64), c(out_ae, i64),
        )
        reads = reads_from_window_outputs(
            contig, out_seq, out_qual, out_off, out_ab, out_ae, kept, cap
        )
        return reads, int(sel.size)


class ReadPairs:
    """Sequence[(seq_u8, qual_u8)] over one window's columnar (CSR) read
    buffers — the zero-object form of PairHMMJob.reads.

    Generic consumers (tests, the native/striped engines) index and
    iterate it like a list of per-read tuples; the batched runner's group
    packing recognizes ``flat_seq``/``flat_qual``/``off`` and builds its
    row tables from whole-window scatters instead of per-read views
    (~1.2 us/read of view+concat glue saved at WGS scale)."""

    __slots__ = ("flat_seq", "flat_qual", "off", "_lengths")

    def __init__(self, flat_seq, flat_qual, off):
        self.flat_seq = flat_seq
        self.flat_qual = flat_qual
        self.off = off
        self._lengths = None

    def __len__(self) -> int:
        return len(self.off) - 1

    @property
    def lengths(self) -> np.ndarray:
        if self._lengths is None:
            self._lengths = np.diff(self.off)
        return self._lengths

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if len(self) else 0

    def __getitem__(self, k: int):
        if k < 0:
            k += len(self)
        if not 0 <= k < len(self):
            raise IndexError(k)
        lo, hi = self.off[k], self.off[k + 1]
        return (self.flat_seq[lo:hi], self.flat_qual[lo:hi])

    def __iter__(self):
        for k in range(len(self)):
            yield self[k]


class WindowReads:
    """One window's prepared reads in columnar (CSR) form — the fused
    path's zero-object alternative to a list of PreparedRead.

    Materializing a PreparedRead per read cost ~3.5 us/read and was ~15%
    of the 60 Mb host pipeline; the hot consumers only ever need arrays:
    job packing slices (seq, qual) views, the genotyper reads the
    alignment-span arrays, likelihood normalization reads lengths.  Lazy
    __getitem__/__iter__ keep it quacking like Sequence[PreparedRead] for
    any remaining generic consumer."""

    __slots__ = ("contig", "seq", "qual", "off", "abegin", "aend")

    def __init__(self, contig, seq, qual, off, abegin, aend):
        self.contig = contig
        self.seq = seq
        self.qual = qual
        self.off = off
        self.abegin = abegin
        self.aend = aend

    def __len__(self) -> int:
        return len(self.off) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.off)

    def read_arrays(self):
        """[(seq_u8, qual_u8), ...] views for PairHMMJob packing."""
        off = self.off
        return [
            (self.seq[off[k] : off[k + 1]], self.qual[off[k] : off[k + 1]])
            for k in range(len(self))
        ]

    def pair_view(self) -> "ReadPairs":
        """O(1) Sequence[(seq_u8, qual_u8)] over the columnar buffers —
        what PairHMMJob carries.  Unlike read_arrays() nothing per-read is
        materialized; the runner's group packing detects the flat CSR
        attributes and scatters whole windows at once (ops/runner.py)."""
        return ReadPairs(self.seq, self.qual, self.off)

    def __getitem__(self, k: int) -> PreparedRead:
        if k < 0:
            k += len(self)
        return PreparedRead(
            seq_u8=self.seq[self.off[k] : self.off[k + 1]],
            qual_u8=self.qual[self.off[k] : self.off[k + 1]],
            rname=self.contig,
            alignment_begin=int(self.abegin[k]),
            alignment_end=int(self.aend[k]),
        )

    def __iter__(self):
        for k in range(len(self)):
            yield self[k]

    def select(self, indices) -> "WindowReads":
        """Kept-subset (normalize_and_filter's surviving reads), preserving
        order.  The all-kept case (the norm) is free."""
        indices = np.asarray(indices, dtype=np.int64)
        if len(indices) == len(self):
            return self
        lens = self.off[indices + 1] - self.off[indices]
        off = np.zeros(len(indices) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        if len(indices):
            seq = np.concatenate(
                [self.seq[self.off[i] : self.off[i + 1]] for i in indices]
            )
            qual = np.concatenate(
                [self.qual[self.off[i] : self.off[i + 1]] for i in indices]
            )
        else:
            seq = qual = np.zeros(0, dtype=np.uint8)
        return WindowReads(
            self.contig, seq, qual, off,
            self.abegin[indices], self.aend[indices],
        )


def window_reads_from_outputs(
    contig: str, out_seq, out_qual, out_off, out_ab, out_ae, kept: int,
) -> WindowReads:
    """WindowReads over COPIES of a window's native output blobs (the
    output scratch is reused across regions, so views must not escape)."""
    kept_bytes = int(out_off[kept]) if kept else 0
    return WindowReads(
        contig,
        out_seq[:kept_bytes].copy(),
        out_qual[:kept_bytes].copy(),
        out_off[: kept + 1].copy(),
        out_ab[:kept].copy(),
        out_ae[:kept].copy(),
    )


def reads_from_window_outputs(
    contig: str, out_seq, out_qual, out_off, out_ab, out_ae, kept: int,
    cap: int,
):
    """PreparedRead views over a window's native output blobs, right-sized
    so the views do not pin the pre-filter superset allocation."""
    kept_bytes = int(out_off[kept]) if kept else 0
    if kept_bytes < cap:
        out_seq = out_seq[:kept_bytes].copy()
        out_qual = out_qual[:kept_bytes].copy()
    return [
        PreparedRead(
            seq_u8=out_seq[out_off[k] : out_off[k + 1]],
            qual_u8=out_qual[out_off[k] : out_off[k + 1]],
            rname=contig,
            alignment_begin=int(out_ab[k]),
            alignment_end=int(out_ae[k]),
        )
        for k in range(kept)
    ]


def columnar_available() -> bool:
    from .. import native

    return native.available()
