"""Cross-region PairHMM dispatch runner on the card — the production device
path, and the only part of the runner that imports torch.

The region pipeline produces many small (reads × haps) jobs; launching each
separately would drown in per-launch overhead.  ``TorchPairHMMRunner``:

1. ``submit`` returns a handle at once; everything below runs on one FIFO
   daemon worker thread (``_DaemonWorker``) under the runner's CUDA
   stream, so the caller's thread keeps feeding the host pipeline;
2. groups jobs greedily until a launch fills up (pair budget / unique-read
   budget / unique-hap budget);
3. packs each group's UNIQUE reads and haplotypes once on the host into one
   pinned buffer, in the shipping encoding ``DispatchPathController``
   picks (cfg.dispatch_mode): "planes", i32 planes with the table lookups
   applied on the host (12 B per read base), or "packed", the raw bytes
   (2 B per read base) or, with cfg.packed_nib, nibble-dictionary bytes
   (1 B per read base) and a span table instead of the pair indices; the
   striped kernel (cfg.pallas_algo "striped") ships raw bytes.  One
   native pass a group (native.pack_rows, the GIL released) writes the
   rows straight from the jobs' flat buffers into the buffer in that
   encoding; the numpy pack (``_unique_rows`` and the ``_pack_*``
   writers), which ships the same bytes, runs when the library cannot
   load;
4. on the stream: one H2D copy, then one ppe launch per chunk that reads
   the group's unique rows itself, in every encoding (lookups and, for
   nib, the pair expansion included: ops/pairhmm_front.py) — or, with
   fusion (cfg.fuse_groups, cfg.fuse_auto), one copy and one launch for
   k same-path groups; on the striped path one launch of the striped
   kernel's unique-rows entry per chunk, unfused, which reads the raw
   rows itself too (ops/pairhmm_striped.py::striped_forward_unique) —
   then one D2H copy of the submit's outputs;
5. ``drain`` resolves the handle (re-raising any error of the worker),
   waits for the D2H copy and finalizes log10 likelihoods per job
   (sentinel or exact host float64 rescue for underflowed pairs,
   cfg.f64_rescue).  A resolve or wait that passes cfg.device_timeout_s
   while a fresh probe of the card cannot finish either raises
   ``DeviceWedgedError``: the card's work is never handed to the CPU.

Several devices (every visible card by default, or an explicit list that
may repeat a device): each launch unit (a group, k fused groups, or a
group's chunks) goes to the next slot in turn, on that slot's own stream;
the one FIFO worker keeps the placement order that of a synchronous submit,
and ``drain`` reads each slot's results back once per submit.  Units are
independent, so placement never changes a result.

``BackgroundRunner`` (ops/runner.py) imports this module on its build
thread; the torch-free parts of the runner (jobs, the worker, the path
controller, the native runner) live in ops/runner.py.

This is the GPU counterpart of gatk_hc_tpu/ops/runner.py::
PallasPairHMMRunner and JnpPairHMMRunner, and of the reference's flat
testcase batch + OpenMP loop (intel_pairhmm.hpp:115-203).
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import threading
import time
from contextlib import ExitStack, nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..config import HCConfig
from ..utils.logging import process_age_s as _process_age_s
from ..utils.logging import span
from ..utils.quality import INITIAL_CONSTANT_F32
from .runner import (
    DeviceWedgedError,
    DispatchPathController,
    PairHMMJob,
    _bucket,
    _DaemonWorker,
    _register_exit_wait,
    _StillRunning,
    _WorkerFuture,
)

# "submit" is the caller's time inside submit(), per submit; "d2h" is per
# submit and slot; "pack" and its parts per group ("unique_rows" and
# "encode" are host-clock spans inside it, "pack_cpu" the dispatch thread's
# CPU time over it); the others per launch unit (a group, or k fused
# groups).  "launch" is the host's time enqueuing the unit's H2D copy and
# kernel launches; "h2d" and "kernel" are stream time between CUDA events,
# so when the stream starves they hold the host's enqueue gaps too (the
# card's own time is the profiler's).  No path has a stage between H2D and
# kernel: each kernel reads the shipped rows itself.
STAGES = ("submit", "pack", "unique_rows", "encode", "pack_cpu", "launch",
          "h2d", "kernel", "d2h", "finalize")


class _Stamp:
    """A point in a stage timeline: a CUDA event on the runner's stream, or
    a host clock reading on the CPU path (where every step is synchronous)."""

    __slots__ = ("event", "t")

    def __init__(self, stream):
        if stream is None:
            self.event, self.t = None, time.perf_counter()
        else:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(stream)

    def ms_until(self, other: "_Stamp") -> float:
        if self.event is None:
            return (other.t - self.t) * 1e3
        return self.event.elapsed_time(other.event)


_ALIGN = 16  # bytes: every array of a host buffer starts on this boundary
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32}


class _HostBuffer:
    """Arrays laid out in one uint8 host buffer at 16-byte offsets, pinned
    on the CUDA path, so that one non-blocking copy ships them all.  The
    buffer must outlive that copy: the batch keeps it until drain."""

    def __init__(self, specs, pinned: bool):
        self.specs = [(np.dtype(d), int(n)) for d, n in specs]
        self.offsets = []
        at = 0
        for dtype, count in self.specs:
            self.offsets.append(at)
            at += -(-dtype.itemsize * count // _ALIGN) * _ALIGN
        self.host = torch.empty(max(at, _ALIGN), dtype=torch.uint8,
                                pin_memory=pinned)
        self._np = self.host.numpy()

    def array(self, k: int) -> np.ndarray:
        """Writable numpy view of array k."""
        dtype, count = self.specs[k]
        at = self.offsets[k]
        return self._np[at : at + dtype.itemsize * count].view(dtype)

    def ship(self, device: torch.device) -> List[torch.Tensor]:
        """One copy to ``device`` (none on the CPU) -> a view per array."""
        dev = (self.host if device.type == "cpu"
               else self.host.to(device, non_blocking=True))
        return [
            dev[at : at + dtype.itemsize * count].view(_TORCH_DTYPES[dtype])
            for (dtype, count), at in zip(self.specs, self.offsets)
        ]


@dataclasses.dataclass
class _Unique:
    """A group's unique rows as bytes (the host side of every encoding)."""

    dims: Tuple[int, int, int, int]  # nr_pad, nh_pad, r_pad, c_pad
    read_u8: np.ndarray  # (nr_pad * r_pad,) u8
    qual_u8: np.ndarray
    hap_u8: np.ndarray  # (nh_pad * c_pad,) u8
    read_lens: np.ndarray  # (nr_pad,) i32, padding rows 1
    hap_lens: np.ndarray  # (nh_pad,) i32
    hap_init_y: np.ndarray  # (nh_pad,) f32
    spans: List[Tuple[int, int, int, int]]  # (job, start, nr, nh)
    bases: List[Tuple[int, int]]  # (first unique read, first unique hap)
    total: int

    def lens_into(self, out: np.ndarray) -> None:
        """[read lens | hap lens | init_y bits] into an i32 array."""
        nr_pad, nh_pad = self.dims[:2]
        out[:nr_pad] = self.read_lens
        out[nr_pad : nr_pad + nh_pad] = self.hap_lens
        out[nr_pad + nh_pad :] = self.hap_init_y.view(np.int32)

    def pairs_into(self, out: np.ndarray) -> None:
        """(2, total) pair indices (read-major per job, jobs in group
        order) into a flat i32 array."""
        total = self.total
        for (_g, start, nr, nh), (rb, hb) in zip(self.spans, self.bases):
            n = nr * nh
            out[start : start + n] = np.repeat(
                np.arange(rb, rb + nr, dtype=np.int32), nh)
            out[total + start : total + start + n] = np.tile(
                np.arange(hb, hb + nh, dtype=np.int32), nr)


@dataclasses.dataclass
class _Sources:
    """A group's unique rows where its jobs hold them: what the native
    pack (native.pack_rows) reads to write any encoding's rows straight
    into the host buffer, and the same lengths and spans as ``_Unique``."""

    dims: Tuple[int, int, int, int]  # nr_pad, nh_pad, r_pad, c_pad
    jobs: np.ndarray  # (n_jobs, 4) i64: bases address, quals address,
    # reads, haps (the addresses point into ``keep``)
    row_lens: np.ndarray  # (n_reads,) i64
    hap_flat: np.ndarray  # u8, the haps end to end, unclipped
    hap_row_lens: np.ndarray  # (n_haps,) i64, unclipped
    read_lens: np.ndarray  # (nr_pad,) i32, padding rows 1
    hap_lens: np.ndarray  # (nh_pad,) i32, clipped to c_pad
    hap_init_y: np.ndarray  # (nh_pad,) f32
    spans: List[Tuple[int, int, int, int]]  # (job, start, nr, nh)
    bases: List[Tuple[int, int]]  # (first unique read, first unique hap)
    total: int
    keep: List[np.ndarray]  # the arrays the job addresses point into

    lens_into = _Unique.lens_into


_NO_BYTES = np.zeros(0, np.uint8)
_NO_LENS = np.zeros(0, np.int64)


@dataclasses.dataclass
class _Payload:
    """One group packed for shipping: its arrays in one host buffer."""

    path: str  # "planes" | "packed" | "packednib"
    dims: Tuple[int, int, int, int]
    buf: _HostBuffer
    spans: List[Tuple[int, int, int, int]]
    total: int
    # the group's per-group stages (STAGES) in ms, set once it is packed
    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Entry:
    """One launch unit of a submit (a group, or k fused groups) with its
    stage timeline."""

    spans: List[Tuple[int, int, int, int]]  # (job, start in entry, nr, nh)
    total: int
    group_ms: List[Dict[str, float]]  # per group: its per-group stages
    launch_ms: float
    h2d: Tuple[_Stamp, _Stamp]
    chunks: List[Tuple[_Stamp, _Stamp]]  # per launch: start, end
    outs: Optional[List[torch.Tensor]]  # the launches' results (until D2H)
    keep: object  # the host buffer, alive until the batch is drained
    slot: int = 0  # the runner's slot it ran on
    start: int = 0  # offset in the submit's output


@dataclasses.dataclass
class _Batch:
    jobs: Sequence[PairHMMJob]
    entries: List[_Entry]
    host_out: torch.Tensor  # (n_pairs,) f32, pinned on the CUDA path
    d2h: List[Tuple[_Stamp, _Stamp]]  # one copy per slot used (CUDA)


@dataclasses.dataclass
class _Slot:
    """One place launch units go: a device, its own stream (None on the
    CPU) and the device's table."""

    index: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"]
    ppe_tab: torch.Tensor  # the 768-entry table both kernels read bytes by

    def active(self):
        """The slot's device and stream made current (nothing on the
        CPU)."""
        if self.stream is None:
            return nullcontext()
        stack = ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


def local_devices(device="cuda", devices=None) -> List[torch.device]:
    """The devices a runner spreads its work over: ``devices`` as given (a
    device may repeat), else ``device``; "cuda" without an index means
    every visible card.  Raises when a CUDA device is asked for and no card
    is visible, and on a mix of CPU and CUDA devices."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices must name at least one device")
    else:
        out = [torch.device(device)]
    types = {d.type for d in out}
    if not types <= {"cuda", "cpu"} or len(types) > 1:
        raise ValueError(f"unsupported devices {[str(d) for d in out]}")
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gatk_hc_tpu_torch: no CUDA device is available (pass "
                "device='cpu' to run the kernels' plain versions)")
        if devices is None and out[0].index is None:
            out = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        out = [torch.device("cuda", torch.cuda.current_device())
               if d.index is None else d for d in out]
    return out


# fused-launch labels per path, as the reference's dispatch_profile
_FUSE_LABEL = {"planes": "fused", "packed": "packedfused",
               "packednib": "packednibfused"}
# the ppe kernel's source per path (ops/pairhmm_front.py)
_FRONT = {"planes": "planes", "packed": "packed", "packednib": "nib"}


def join_payloads(payloads: Sequence[_Payload], pinned: bool) -> _HostBuffer:
    """One host buffer holding every payload's arrays in turn (a fused
    launch's single H2D copy)."""
    buf = _HostBuffer([s for p in payloads for s in p.buf.specs], pinned)
    at = 0
    for p in payloads:
        for j in range(len(p.buf.specs)):
            buf.array(at + j)[:] = p.buf.array(j)
        at += len(p.buf.specs)
    return buf


def segments_of(payloads: Sequence[_Payload], views):
    """The ppe kernel's segments of k payloads whose arrays, shipped as
    ``join_payloads`` laid them out, are ``views``: one whole group each."""
    from .pairhmm_front import Segment

    segments, at = [], 0
    for p in payloads:
        n = len(p.buf.specs)
        segments.append(Segment(tuple(views[at : at + n]), p.dims, p.total))
        at += n
    return segments


class TorchPairHMMRunner:
    """Batches PairHMMJobs into PairHMM kernel launches: the ppe kernel, or
    the striped one when cfg.pallas_algo is "striped".

    ``device`` is "cuda" (the default: the CUDA kernels on every visible
    card; raises when none is) or "cpu" (the same worker, packing and
    finalize around the kernels' plain PyTorch versions — what the tests
    run).  ``devices`` lists the slots explicitly instead (``local_devices``;
    e.g. ``["cpu"] * 8``, or ``["cuda:0", "cuda:0"]``): launch units go to
    them round-robin, and ``placements`` records the slot of each in launch
    order.  ``tables`` replaces the numeric tables (ops/pairhmm_torch.py::
    make_tables layout, e.g. from convert.tables_from_reference)."""

    # Grouping limits.  One group is one launch unless a single job
    # overflows the pair budget, which is then also the most pairs of one
    # launch (a chunk).  The ppe kernel runs one warp per pair in blocks of
    # 4 warps: a group of 65,536 pairs is 16,384 blocks, and at K 5 (r_pad
    # 160) an SM holds 8 of them (32 pairs) at once, so one launch is ~15.5
    # waves over an H100's 132 SMs.  At 30x coverage a region contributes
    # ~300 pairs from ~80 reads, so the read and hap budgets below do not
    # cut groups short first.
    READ_BUCKETS = (4096, 16384)
    HAP_BUCKETS = (1024, 4096)
    GROUP_PAIRS = 65536
    ROW_ALIGN = 8  # ppe: r_pad past the buckets rounds to the largest NR
    # How many extra full budgets drain grants when a batch timed out but
    # a probe shows the card alive (throttled, not wedged).  Bounds the
    # wait so that a deadlock still raises DeviceWedgedError eventually.
    MAX_SLOW_EXTENSIONS = 3

    def __init__(self, cfg: HCConfig, device="cuda",
                 pair_budget: Optional[int] = None, tables=None,
                 devices=None):
        from .pairhmm_torch import make_tables

        self.devices = local_devices(device, devices)
        self.device = self.devices[0]
        self._pinned = self.device.type == "cuda"
        self.cfg = cfg
        if tables is None:
            tables = make_tables(cfg, "cpu")
        host = {k: v.cpu().numpy() for k, v in tables.items()}
        self._mask_tab = host["mask"]
        self._omq_bits_tab = host["omq_bits"]
        self._q3_bits_tab = host["q3_bits"]
        self.trans = tuple(np.float32(t) for t in host["trans"])
        self.striped = cfg.pallas_algo == "striped"
        # the 768-entry combined table the ppe kernel reads packed and nib
        # bytes through, and the striped kernel raw bytes
        # (ppe_element_table layout: the three plane tables end to end),
        # once per device
        ppe_tab = np.concatenate(
            [self._mask_tab, self._omq_bits_tab, self._q3_bits_tab]
        ).astype(np.int32)
        self._host_tab = ppe_tab  # the native pack's planes lookups
        per_device: Dict[torch.device, torch.Tensor] = {}
        self._slots: List[_Slot] = []
        for index, dev in enumerate(self.devices):
            if dev not in per_device:
                per_device[dev] = torch.from_numpy(ppe_tab).to(dev)
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            self._slots.append(_Slot(index, dev, stream, per_device[dev]))
        self._ppe_tab = self._slots[0].ppe_tab
        self._next_slot = 0
        # the slot of every launch unit, in launch order (all submits)
        self.placements: List[int] = []
        self.pair_budget = pair_budget or self.GROUP_PAIRS
        self._path_ctl = DispatchPathController(
            forced=None if cfg.dispatch_mode == "adaptive" else cfg.dispatch_mode
        )
        # ONE dispatch worker (started at the first submit): packing, H2D,
        # launches and the D2H copy of a submit run there, FIFO,
        # so they overlap the caller's host work and the card's compute
        self._submit_pool: Optional[_DaemonWorker] = None
        self._fetch_pool: Optional[_DaemonWorker] = None
        # "dispatch" or "fetch" once a wait of that stage passed
        # cfg.device_timeout_s with a failed probe
        self._wedged: Optional[str] = None
        self._prewarm_stop = threading.Event()
        self._prewarm_exc: Optional[BaseException] = None
        # cold-start attribution, surfaced as init_profile in --stats
        self.init_profile: Dict[str, object] = {}
        # launches by path, surfaced as dispatch_profile in --stats
        self.dispatch_counts: Dict[str, int] = {}
        # groups by padded shape (r_pad, c_pad): the bucket shapes launched
        self.bucket_counts: Dict[Tuple[int, int], int] = {}
        # stage times in ms (STAGES)
        self.stage_ms: Dict[str, List[float]] = {s: [] for s in STAGES}
        # whether the pack writes through the native library (None until
        # known: BackgroundRunner loads it on its build thread, else the
        # first pack does), and the groups packed per encoding by each
        # route, {"planes" | "packed" | "packednib": {"native": n,
        # "numpy": n}}, surfaced as stage_medians' pack_profile
        self._native: Optional[bool] = None
        self.pack_counts: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[PairHMMJob]) -> None:
        """Compute results for all jobs in-place (submit + drain)."""
        self.drain([self.submit(jobs)])

    def submit(self, jobs: Sequence[PairHMMJob]) -> _WorkerFuture:
        """Enqueue all device work for ``jobs`` WITHOUT waiting: the whole
        body (group planning, packing, H2D, launches, D2H) runs
        on the dispatch worker, so this returns at once.  Errors surface
        at drain().  Pass the handle(s) to drain() to collect."""
        t0 = time.perf_counter()
        self._raise_if_wedged()
        if self._submit_pool is None:
            self._submit_pool = _DaemonWorker("hc-dispatch")
        handle = self._submit_pool.submit(self._submit_batch, jobs)
        self.stage_ms["submit"].append((time.perf_counter() - t0) * 1e3)
        return handle

    def _submit_batch(self, jobs: Sequence[PairHMMJob]) -> _Batch:
        """The worker's body of one submit."""
        if self._prewarm_exc is not None:
            raise self._prewarm_exc
        first = "first_submit_batch_s" not in self.init_profile
        if first:
            self.init_profile["first_submit_at_age_s"] = round(
                _process_age_s(), 3)
        with span("runner.batch") as whole:
            with span("runner.plan"):
                groups = self._plan_groups(jobs)
            # fuse_auto: fusion engages on the controller's measured DEEP
            # degradation (DispatchPathController.deeply_degraded), not
            # statically (HCConfig.fuse_auto)
            fuse_on = self.cfg.fuse_groups > 1 and (
                not self.cfg.fuse_auto or self._path_ctl.deeply_degraded()
            )
            sink: Optional[List[_Payload]] = [] if fuse_on else None
            entries: List[_Entry] = []
            for group in groups:
                entry = self._submit_group(jobs, group, sink)
                if entry is not None:
                    entries.append(entry)
            if sink:
                entries.extend(self._dispatch_fused(sink))
            with span("runner.read_back"):
                batch = self._read_back(jobs, entries)
        if first:
            self.init_profile["first_submit_batch_s"] = round(
                whole.seconds, 3)
        return batch

    def _read_back(self, jobs, entries: List[_Entry]) -> _Batch:
        """The submit's output laid out slot by slot (launch order within
        a slot): on the CPU one tensor, on CUDA one pinned host buffer that
        each slot fills with one copy on its own stream."""
        by_slot: Dict[int, List[_Entry]] = {}
        for entry in entries:
            by_slot.setdefault(entry.slot, []).append(entry)
        outs: Dict[int, List[torch.Tensor]] = {}
        start = 0
        for index in sorted(by_slot):
            outs[index] = []
            for entry in by_slot[index]:
                entry.start = start
                start += entry.total
                outs[index].extend(entry.outs)
                entry.outs = None
        if not start:
            return _Batch(jobs, entries, torch.zeros(0), [])
        if not self._pinned:
            flat = [o for index in sorted(outs) for o in outs[index]]
            return _Batch(jobs, entries,
                          flat[0] if len(flat) == 1 else torch.cat(flat), [])
        host_out = torch.empty(start, dtype=torch.float32, pin_memory=True)
        d2h = []
        at = 0
        for index in sorted(outs):
            slot = self._slots[index]
            with slot.active():
                parts = outs[index]
                dev_out = parts[0] if len(parts) == 1 else torch.cat(parts)
                d0 = _Stamp(slot.stream)
                host_out[at : at + dev_out.numel()].copy_(dev_out,
                                                         non_blocking=True)
                d2h.append((d0, _Stamp(slot.stream)))
            at += dev_out.numel()
        return _Batch(jobs, entries, host_out, d2h)

    def drain(self, batches) -> None:
        """Wait for each submitted batch's transfer back, then finalize its
        jobs.  Accepts submit() handles (resolved here — this is where an
        error of the worker raises) or resolved batches.

        Wedge check: if resolving a handle or waiting for its D2H copy
        passes cfg.device_timeout_s and a fresh probe of the card cannot
        finish either, DeviceWedgedError raises (and so does every later
        submit and drain).  An error of the worker raises as itself."""
        self._raise_if_wedged()
        timeout = self.cfg.device_timeout_s or None
        with span("runner.wait"):
            resolved = [
                self._wait(b, "dispatch", timeout)
                if isinstance(b, _WorkerFuture) else b
                for b in batches
            ]
        if not resolved:
            return
        first_fetch = "first_drain_fetch_s" not in self.init_profile
        with span("runner.fetch") as fetch:
            self._fetch(resolved, timeout)
        if first_fetch:
            self.init_profile["first_drain_fetch_s"] = round(fetch.seconds, 3)
        for batch in resolved:
            for d0, d1 in batch.d2h:
                self.stage_ms["d2h"].append(d0.ms_until(d1))
            probs = batch.host_out.numpy()
            for e in batch.entries:
                with span("runner.finalize", self.stage_ms["finalize"]):
                    self._finalize_group(
                        batch.jobs, probs[e.start : e.start + e.total],
                        e.spans)
                for times in e.group_ms:
                    for stage, ms in times.items():
                        self.stage_ms[stage].append(ms)
                self.stage_ms["launch"].append(e.launch_ms)
                self.stage_ms["h2d"].append(e.h2d[0].ms_until(e.h2d[1]))
                self.stage_ms["kernel"].append(
                    sum(a.ms_until(b) for a, b in e.chunks))

    def _fetch(self, batches: Sequence[_Batch], timeout: Optional[float]):
        """Wait for the batches' D2H copies within the wedge budget.  With
        a budget the wait runs on a side thread, so that a blocked one can
        be abandoned."""
        if timeout is None:
            self._sync_d2h(batches)
            return
        if self._fetch_pool is None:
            self._fetch_pool = _DaemonWorker("hc-fetch")
        self._wait(self._fetch_pool.submit(self._sync_d2h, batches), "fetch",
                   timeout)

    @staticmethod
    def _sync_d2h(batches: Sequence[_Batch]) -> None:
        for b in batches:
            for _d0, d1 in b.d2h:
                d1.event.synchronize()

    def _wait(self, fut: _WorkerFuture, where: str, timeout: Optional[float]):
        """fut's result within the wedge budget.  A card that is alive but
        slow (the probe finishes) gets MAX_SLOW_EXTENSIONS more budgets; a
        failed probe, or the extensions running out, raises
        DeviceWedgedError."""
        for attempt in range(self.MAX_SLOW_EXTENSIONS + 1):
            try:
                return fut.result(timeout)
            except _StillRunning:
                if not self._probe_device_alive():
                    break
                self._note_slow(where, attempt)
        self._wedged = where
        for pool in (self._submit_pool, self._fetch_pool):
            if pool is not None:
                pool.abandoned = True
        self._raise_if_wedged()

    def _raise_if_wedged(self) -> None:
        if self._wedged:
            probed = ", ".join(str(d) for d in dict.fromkeys(self.devices))
            raise DeviceWedgedError(
                f"gatk_hc_tpu_torch: device {self._wedged} unresponsive: "
                f"nothing within {self.cfg.device_timeout_s:.0f}s and a fresh "
                f"probe of {probed} failed, or {self.MAX_SLOW_EXTENSIONS}"
                " more budgets ran out; the card's work is not moved to the "
                "CPU (rerun, or --pairhmm native)")

    def _probe_device_alive(self, timeout_s: float = 30.0) -> bool:
        """One tiny H2D + D2H round trip per device on a fresh daemon
        thread and fresh streams: True means every card is alive (merely
        slow); False (a probe cannot finish) confirms a wedge.  A fresh
        thread each time: the dispatch and fetch workers may be the blocked
        ones."""
        ok = threading.Event()

        def probe():
            try:
                alive = True
                for dev in dict.fromkeys(self.devices):
                    x = torch.ones(8)
                    if dev.type == "cuda":
                        with torch.cuda.device(dev), torch.cuda.stream(
                                torch.cuda.Stream(dev)):
                            x = x.to(dev).cpu()
                    alive = alive and bool(x.sum() == 8)
                if alive:
                    ok.set()
            except Exception:  # noqa: BLE001 - an erroring probe after a
                pass  # timeout is as good as a wedged one

        t = threading.Thread(target=probe, daemon=True, name="hc-probe")
        t.start()
        # deliberately NOT exit-registered: a live probe finishes at once,
        # and a blocked one is exactly the wedge we refuse to wait for
        return ok.wait(timeout_s)

    def _note_slow(self, where: str, attempt: int) -> None:
        print(
            f"[gatk_hc_tpu_torch] device {where} exceeded "
            f"{self.cfg.device_timeout_s:.0f}s but the device probes alive "
            f"(throttled phase) — waiting up to "
            f"{self.MAX_SLOW_EXTENSIONS - attempt} more budget(s)",
            file=sys.stderr, flush=True,
        )

    def stage_medians(self) -> Dict[str, object]:
        """Median ms of each stage (per launch unit; "pack" per group,
        "submit" and "d2h" per submit), the summed ms of each stage, and
        the device the times were taken on."""
        out: Dict[str, object] = {
            s: round(statistics.median(v), 4)
            for s, v in self.stage_ms.items()
            if v
        }
        out["sum_ms"] = {
            s: round(sum(v), 3) for s, v in self.stage_ms.items() if v
        }
        out["groups"] = len(self.stage_ms["pack"])
        out["pack_profile"] = {p: dict(n) for p, n in self.pack_counts.items()}
        out["device"] = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda"
            else "cpu"
        )
        return out

    # ------------------------------------------------------------------
    def prewarm(self, shapes=None, block: bool = False):
        """Launch each kernel instance the first bucket shapes use once, on
        a tiny input and uncounted, on a daemon thread that overlaps the
        host's parse and assembly: CUDA loads a kernel lazily at its first
        launch, and this takes that cost off the first group.  ``shapes``
        is an iterable of (r_pad, c_pad), by default every read bucket at
        the first hap bucket.  An error is raised at the next submit."""
        if shapes is None:
            shapes = [(r, self.cfg.hap_pad_buckets[0])
                      for r in self.cfg.read_pad_buckets]

        def work():
            if not self._pinned:
                return  # the plain versions load nothing
            try:
                n = 0
                # a kernel loads once per device: warm the first slot of each
                firsts = {}
                for slot in self._slots:
                    firsts.setdefault(slot.device, slot)
                for slot in firsts.values():
                    with slot.active():
                        for r_pad, c_pad in shapes:
                            if self._prewarm_stop.is_set():
                                break
                            n += self._warm(slot, self._round_rows(r_pad),
                                            c_pad)
                    slot.stream.synchronize()
                self.init_profile["prewarm_launches"] = n
            except Exception as exc:  # noqa: BLE001 - raised at next submit
                self._prewarm_exc = exc

        thread = threading.Thread(target=work, daemon=True, name="hc-prewarm")
        thread.start()
        _register_exit_wait(
            lambda timeout: None if self._wedged else thread.join(timeout)
        )
        if block:
            thread.join()
        return thread

    def stop_prewarm(self) -> None:
        """Skip any prewarm shapes not yet started (called once the
        pipeline has drained — further warming is pure exit latency)."""
        self._prewarm_stop.set()

    def _warm(self, slot: _Slot, r_pad: int, c_pad: int) -> int:
        """One uncounted launch on ``slot`` of each kernel instance the
        shape uses, on one pair -> the number of launches."""
        from .pairhmm_front import Segment, launch_ppe_unique
        from .pairhmm_striped import launch_striped_unique

        # one pair of one read and one hap, raw packed: every source of the
        # ppe kernel runs the same instance
        dev = slot.device
        u8 = torch.zeros(2 * r_pad + c_pad, dtype=torch.uint8, device=dev)
        lens = torch.ones(3, dtype=torch.int32, device=dev)
        pairs = torch.zeros(2, dtype=torch.int32, device=dev)
        segs = [Segment((u8, lens, pairs), (1, 1, r_pad, c_pad), 1)]
        if self.striped:
            launch_striped_unique(segs, slot.ppe_tab, self.trans,
                                  self.cfg.stripe_height)
        else:
            launch_ppe_unique("packed", segs, slot.ppe_tab, self.trans,
                              self.cfg.ppe_rows)
        return 1

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        for slot in self._slots:
            if slot.stream is not None:
                slot.stream.synchronize()

    def _take_slot(self) -> _Slot:
        """The slot of the next launch unit (round-robin), recorded in
        ``placements``."""
        slot = self._slots[self._next_slot % len(self._slots)]
        self._next_slot += 1
        self.placements.append(slot.index)
        return slot

    def _round_rows(self, r: int) -> int:
        # striped: a multiple of the stripe height, which then divides r_pad
        a = self.cfg.stripe_height if self.striped else self.ROW_ALIGN
        return ((r + a - 1) // a) * a

    def _pads_for_group(self, jobs, group):
        """Per-group padded shapes: tightest bucket over the group's actual
        lengths (fewer wasted cells than one global shape)."""
        max_r = max(
            (
                jobs[g].reads.max_len
                if hasattr(jobs[g].reads, "max_len")
                else max((len(b) for b, _ in jobs[g].reads), default=1)
            )
            for g in group
        ) if group else 1
        max_c = max((len(h) for g in group for h in jobs[g].haps), default=1)
        return self._pads(max_r, max_c)

    def _pads(self, max_r: int, max_c: int) -> Tuple[int, int]:
        """(r_pad, c_pad) of a group whose longest read and hap are max_r
        and max_c long."""
        max_r = max(max_r, 1)
        r_pad = next(
            (b for b in self.cfg.read_pad_buckets if max_r <= b),
            self._round_rows(max_r),
        )
        r_pad = self._round_rows(r_pad)
        c_pad = next(
            (b for b in self.cfg.hap_pad_buckets if max_c <= b),
            ((max_c + 127) // 128) * 128,
        )
        return r_pad, c_pad

    def _plan_groups(self, jobs: Sequence[PairHMMJob]) -> List[List[int]]:
        groups: List[List[int]] = []
        current: List[int] = []
        pairs = reads = haps = 0
        for idx, job in enumerate(jobs):
            jp = len(job.reads) * len(job.haps)
            if jp == 0:
                job.result = np.zeros((len(job.reads), len(job.haps)))
                continue
            if jp > self.pair_budget:
                # oversized region: its own group (multiple launches inside)
                if current:
                    groups.append(current)
                    current, pairs, reads, haps = [], 0, 0, 0
                groups.append([idx])
                continue
            if (
                current
                and (
                    pairs + jp > self.pair_budget
                    or reads + len(job.reads) > self.READ_BUCKETS[-1]
                    or haps + len(job.haps) > self.HAP_BUCKETS[-1]
                )
            ):
                groups.append(current)
                current, pairs, reads, haps = [], 0, 0, 0
            current.append(idx)
            pairs += jp
            reads += len(job.reads)
            haps += len(job.haps)
        if current:
            groups.append(current)
        return groups

    def _submit_group(self, jobs: Sequence[PairHMMJob], group: List[int],
                      sink: Optional[List[_Payload]]) -> Optional[_Entry]:
        """Pack one group in the chosen encoding and launch it, or, when
        ``sink`` is given (fusion on) and the group is one chunk, defer its
        payload there for _dispatch_fused."""
        if self.striped:
            path, calibrate = "striped", False
        else:
            path, calibrate = self._path_ctl.choose()
        if calibrate:
            # time this group alone: pack to kernel end on the stream
            self._sync()
        with span("runner.pack") as pack:
            cpu0 = time.thread_time_ns()
            native = self.native_ready()
            with span("runner.pack.unique_rows") as unique:
                # the native route sizes the pads from the lengths it
                # gathers anyway
                u = (self._row_sources(jobs, group) if native else
                     self._unique_rows(jobs, group,
                                       *self._pads_for_group(jobs, group)))
            r_pad, c_pad = u.dims[2:]
            self.bucket_counts[r_pad, c_pad] = (
                self.bucket_counts.get((r_pad, c_pad), 0) + 1)
            n_chunks = -(-u.total // self.pair_budget)
            with span("runner.pack.encode") as encode:
                payload = self._encode(u, path, n_chunks)
            cpu_ms = (time.thread_time_ns() - cpu0) / 1e6
        counts = self.pack_counts.setdefault(payload.path,
                                             {"native": 0, "numpy": 0})
        counts["native" if native else "numpy"] += 1
        payload.stage_ms = {"pack": pack.seconds * 1e3,
                            "unique_rows": unique.seconds * 1e3,
                            "encode": encode.seconds * 1e3,
                            "pack_cpu": cpu_ms}
        if self.striped or n_chunks > 1:
            entry = self._launch_chunks(payload)
        elif sink is not None and not calibrate:
            sink.append(payload)
            return None
        else:
            entry = self._launch(payload.path, [payload])
        if calibrate:
            self._sync()
            self._path_ctl.record(
                path, (time.perf_counter() - pack.start) / max(u.total, 1))
        return entry

    def native_ready(self) -> bool:
        """Whether the pack writes through the native library: loaded (and
        built when missing) at the first call, numpy when it cannot be."""
        if self._native is None:
            self._native = native.available()
        return self._native

    def _encode(self, u, path: str, n_chunks: int) -> _Payload:
        """The group's unique rows (``_Unique``, or ``_Sources`` for the
        native pack) in ``path``'s encoding, in one host buffer; a child
        span names the encoding that ran (nib's dictionary pass,
        ``_nib_encode`` or ``_nib_dictionary``, is its parent's own
        time)."""
        if path == "packed":
            nib = None
            if self.cfg.packed_nib and n_chunks == 1:
                nib = (self._nib_dictionary(u) if isinstance(u, _Sources)
                       else self._nib_encode(u.read_u8, u.qual_u8))
            # nib when the group's alphabets fit; otherwise (and for a
            # group of several chunks) raw packed, counted as "packed"
            if nib is not None:
                with span("runner.pack.encode.nib"):
                    return self._pack_nib(u, *nib)
        elif path == "planes":
            with span("runner.pack.encode.planes"):
                return self._pack_planes(u)
        with span("runner.pack.encode.bytes"):
            return self._pack_bytes(u)

    def _unique_rows(self, jobs, group, r_pad, c_pad) -> _Unique:
        """The group's unique reads and haps as 0-padded byte rows, their
        lengths, INITIAL / haplen, and the per-job spans: the numpy pack's
        rows (``_row_sources`` is the native pack's)."""
        n_reads = sum(len(jobs[g].reads) for g in group)
        n_haps = sum(len(jobs[g].haps) for g in group)
        nr_pad = _bucket(n_reads, self.READ_BUCKETS)
        nh_pad = _bucket(n_haps, self.HAP_BUCKETS)

        # Per-JOB read collection: columnar ReadPairs jobs contribute their
        # whole flat CSR buffers (no per-read views), generic tuple-list
        # jobs stay per-read.  No clipping is needed on this side:
        # _pads_for_group sizes r_pad from the group's max read length.
        len_parts: List[np.ndarray] = []
        seq_parts: List[np.ndarray] = []
        qual_parts: List[np.ndarray] = []
        for g in group:
            r = jobs[g].reads
            if hasattr(r, "flat_seq"):
                nb = int(r.off[-1])
                len_parts.append(np.asarray(r.lengths, dtype=np.int64))
                seq_parts.append(r.flat_seq[:nb])
                qual_parts.append(r.flat_qual[:nb])
            else:
                len_parts.append(np.fromiter(
                    (len(b) for b, _ in r), dtype=np.int64, count=len(r)
                ))
                seq_parts.extend(b for b, _ in r)
                qual_parts.extend(q for _, q in r)
        lens = (
            np.concatenate(len_parts)
            if len_parts
            else np.zeros(0, dtype=np.int64)
        )
        rpos = self._row_positions(lens, r_pad)
        read_lens = np.ones(nr_pad, dtype=np.int32)
        read_lens[: lens.size] = lens.astype(np.int32)

        # haps are clipped to c_pad (a vectorized fill: a python per-row
        # loop costs ~1.5 us a row); padding rows default to length 1
        hclip = [h[:c_pad] for g in group for h in jobs[g].haps]
        hlens = np.fromiter((len(h) for h in hclip), dtype=np.int64,
                            count=len(hclip))
        hpos = self._row_positions(hlens, c_pad)
        hap_lens = np.ones(nh_pad, dtype=np.int32)
        hap_lens[: hlens.size] = hlens.astype(np.int32)

        read_u8 = np.zeros(nr_pad * r_pad, dtype=np.uint8)
        qual_u8 = np.zeros(nr_pad * r_pad, dtype=np.uint8)
        hap_u8 = np.zeros(nh_pad * c_pad, dtype=np.uint8)
        if lens.size:
            read_u8[rpos] = (
                seq_parts[0] if len(seq_parts) == 1
                else np.concatenate(seq_parts)
            )
            qual_u8[rpos] = (
                qual_parts[0] if len(qual_parts) == 1
                else np.concatenate(qual_parts)
            )
        if hclip:
            hap_u8[hpos] = np.concatenate(hclip)
        hap_init_y = (
            INITIAL_CONSTANT_F32 / hap_lens.astype(np.float32)
        ).astype(np.float32)

        spans: List[Tuple[int, int, int, int]] = []  # (job, start, nr, nh)
        bases: List[Tuple[int, int]] = []
        total = rb = hb = 0
        for g in group:
            nr, nh = len(jobs[g].reads), len(jobs[g].haps)
            spans.append((g, total, nr, nh))
            bases.append((rb, hb))
            total += nr * nh
            rb += nr
            hb += nh
        return _Unique((nr_pad, nh_pad, r_pad, c_pad), read_u8, qual_u8,
                       hap_u8, read_lens, hap_lens, hap_init_y, spans, bases,
                       total)

    @staticmethod
    def _row_positions(lens: np.ndarray, width: int) -> np.ndarray:
        """Flat positions of each row's bytes in a (rows, width) table."""
        starts = np.arange(lens.size, dtype=np.int64) * width
        within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        return np.repeat(starts, lens) + within

    def _row_sources(self, jobs, group, r_pad=None, c_pad=None) -> _Sources:
        """The group's unique reads and haps where its jobs hold them, for
        the native pack: per job the addresses of its read bases and
        qualities (a columnar ReadPairs' own flat buffers; a tuple-list
        job's reads joined), every read's length, the haps end to end;
        and, as ``_unique_rows``, the lengths, INITIAL / haplen and the
        per-job spans.  The pads default to ``_pads_for_group``'s."""
        table: List[int] = []
        lens: List[np.ndarray] = []
        haps: List[np.ndarray] = []
        keep: List[np.ndarray] = []
        for g in group:
            r = jobs[g].reads
            first = 0
            if hasattr(r, "flat_seq"):
                seq, qual, n = r.flat_seq, r.flat_qual, r.lengths
                first, end = int(r.off[0]), int(r.off[-1])
                if end > min(seq.size, qual.size):
                    raise ValueError(f"job {g}: its reads' offsets run past "
                                     "its flat bases or qualities")
            elif len(r):
                seq = np.concatenate([b for b, _ in r])
                qual = np.concatenate([q for _, q in r])
                n = np.fromiter((len(b) for b, _ in r), np.int64, len(r))
                if qual.size != seq.size:
                    raise ValueError(f"job {g}: its reads' bases and "
                                     "qualities differ in length")
            else:
                seq, qual, n = _NO_BYTES, _NO_BYTES, _NO_LENS
            seq = np.ascontiguousarray(seq, dtype=np.uint8)
            qual = np.ascontiguousarray(qual, dtype=np.uint8)
            keep += (seq, qual)
            table += (seq.ctypes.data + first, qual.ctypes.data + first,
                      len(r), len(jobs[g].haps))
            lens.append(n)
            haps.extend(jobs[g].haps)
        per_job = np.array(table, dtype=np.int64).reshape(-1, 4)
        nr, nh = per_job[:, 2], per_job[:, 3]
        nr_pad = _bucket(int(nr.sum()), self.READ_BUCKETS)
        nh_pad = _bucket(int(nh.sum()), self.HAP_BUCKETS)
        row_lens = (np.concatenate(lens) if lens else _NO_LENS).astype(
            np.int64, copy=False)
        hap_row_lens = np.fromiter((len(h) for h in haps), dtype=np.int64,
                                   count=len(haps))
        hap_flat = (np.concatenate(haps) if haps else _NO_BYTES).astype(
            np.uint8, copy=False)
        if r_pad is None:
            r_pad, c_pad = self._pads(int(row_lens.max(initial=0)),
                                      int(hap_row_lens.max(initial=1)))
        read_lens = np.ones(nr_pad, dtype=np.int32)
        read_lens[: row_lens.size] = row_lens
        hap_lens = np.ones(nh_pad, dtype=np.int32)
        hap_lens[: hap_row_lens.size] = np.minimum(hap_row_lens, c_pad)
        hap_init_y = (
            INITIAL_CONSTANT_F32 / hap_lens.astype(np.float32)
        ).astype(np.float32)
        pairs = nr * nh
        starts = np.cumsum(pairs) - pairs
        spans = list(zip(group, starts.tolist(), nr.tolist(), nh.tolist()))
        bases = list(zip((np.cumsum(nr) - nr).tolist(),
                         (np.cumsum(nh) - nh).tolist()))
        return _Sources((nr_pad, nh_pad, r_pad, c_pad), per_job, row_lens,
                        hap_flat, hap_row_lens, read_lens, hap_lens,
                        hap_init_y, spans, bases, int(pairs.sum()), keep)

    def _write_rows(self, s: _Sources, encoding: str, out_reads, out_haps,
                    pairs=None, tab=None) -> None:
        """The native pack's one pass: ``s``'s padded rows in ``encoding``
        (native.PACK_ENCODINGS) into the host buffer's arrays."""
        nr_pad, nh_pad, r_pad, c_pad = s.dims
        native.pack_rows(s.jobs, s.row_lens, nr_pad, r_pad, s.hap_flat,
                         s.hap_row_lens, nh_pad, c_pad, encoding, tab,
                         out_reads, out_haps, pairs)

    def _pack_planes(self, u) -> _Payload:
        """[planes (i32, _build_planes' layout) | pairs (2, total) i32] of
        ``_Unique`` or ``_Sources`` rows."""
        nr_pad, nh_pad, r_pad, c_pad = u.dims
        n_planes = nr_pad + 2 * nh_pad + 3 * nr_pad * r_pad + nh_pad * c_pad
        buf = _HostBuffer([(np.int32, n_planes), (np.int32, 2 * u.total)],
                          self._pinned)
        if isinstance(u, _Sources):
            planes = buf.array(0)
            head = nr_pad + 2 * nh_pad
            nrr3 = head + 3 * nr_pad * r_pad
            u.lens_into(planes[:head])
            self._write_rows(u, "planes", planes[head:nrr3], planes[nrr3:],
                             buf.array(1), self._host_tab)
        else:
            self._build_planes(u.read_u8, u.qual_u8, u.hap_u8, u.read_lens,
                               u.hap_lens, u.hap_init_y, *u.dims,
                               out=buf.array(0))
            u.pairs_into(buf.array(1))
        return _Payload("planes", u.dims, buf, u.spans, u.total)

    def _pack_bytes(self, u) -> _Payload:
        """Raw packed (and the striped path's shipping): [reads | quals |
        haps] u8, [rlens | hlens | init_y bits] i32, pairs (2, total) i32,
        of ``_Unique`` or ``_Sources`` rows."""
        nr_pad, nh_pad, r_pad, c_pad = u.dims
        nrr = nr_pad * r_pad
        buf = _HostBuffer([(np.uint8, 2 * nrr + nh_pad * c_pad),
                           (np.int32, nr_pad + 2 * nh_pad),
                           (np.int32, 2 * u.total)], self._pinned)
        u8 = buf.array(0)
        if isinstance(u, _Sources):
            self._write_rows(u, "bytes", u8[: 2 * nrr], u8[2 * nrr :],
                             buf.array(2))
        else:
            u8[:nrr] = u.read_u8
            u8[nrr : 2 * nrr] = u.qual_u8
            u8[2 * nrr :] = u.hap_u8
            u.pairs_into(buf.array(2))
        u.lens_into(buf.array(1))
        return _Payload("packed", u.dims, buf, u.spans, u.total)

    def _pack_nib(self, u, nib: np.ndarray, minitab: np.ndarray) -> _Payload:
        """Nib: [nib reads | haps] u8, [rlens | hlens | init_y bits] i32,
        the 72-entry mini-table, the span table [read_base, hap_base, nr,
        nh] padded to a power of two of at least 8 rows (zero rows), and
        its exclusive starts and total (pairhmm_front.nib_starts).
        ``nib``: the group's nib bytes (``_Unique`` rows, from
        ``_nib_encode``) or the dictionaries' byte -> index tables
        (``_Sources``, from ``_nib_dictionary``: the native pass writes
        the bytes)."""
        from .pairhmm_front import nib_starts

        nr_pad, nh_pad, r_pad, c_pad = u.dims
        nrr = nr_pad * r_pad
        n_spans = 8
        while n_spans < len(u.spans):
            n_spans *= 2
        buf = _HostBuffer([(np.uint8, nrr + nh_pad * c_pad),
                           (np.int32, nr_pad + 2 * nh_pad), (np.int32, 72),
                           (np.int32, 4 * n_spans), (np.int32, n_spans + 1)],
                          self._pinned)
        u8 = buf.array(0)
        if isinstance(u, _Sources):
            self._write_rows(u, "nib", u8[:nrr], u8[nrr:], tab=nib)
        else:
            u8[:nrr] = nib
            u8[nrr:] = u.hap_u8
        u.lens_into(buf.array(1))
        buf.array(2)[:] = minitab
        table = buf.array(3).reshape(n_spans, 4)
        table[:] = 0
        for k, ((_g, _s, nr, nh), (rb, hb)) in enumerate(zip(u.spans, u.bases)):
            table[k] = (rb, hb, nr, nh)
        buf.array(4)[:] = nib_starts(table)
        return _Payload("packednib", u.dims, buf, u.spans, u.total)

    def _nib_encode(self, read_u8, qual_u8):
        """Nibble-dictionary encoding of a group's read planes, or None
        when the group's alphabets overflow (seq > 8 or qual > 32 distinct
        bytes — never for ACGTN reads with binned qualities).  Byte 0 is
        forced into both dictionaries at index 0 so the zero padding bytes
        map to the exact values the raw-u8 encodings produce for them.
        Returns ((nr_pad * r_pad,) u8 nibble bytes, (72,) i32 mini-table)."""
        cs = np.bincount(read_u8.ravel(), minlength=256)
        cs[0] += 1
        seq_vals = np.nonzero(cs)[0]
        if seq_vals.size > 8:
            return None
        cq = np.bincount(qual_u8.ravel(), minlength=256)
        cq[0] += 1
        qual_vals = np.nonzero(cq)[0]
        if qual_vals.size > 32:
            return None
        lut_s = np.zeros(256, np.uint8)
        lut_s[seq_vals] = np.arange(seq_vals.size, dtype=np.uint8)
        lut_q = np.zeros(256, np.uint8)
        lut_q[qual_vals] = np.arange(qual_vals.size, dtype=np.uint8)
        nib = (lut_s[read_u8] << np.uint8(5)) | lut_q[qual_u8]
        return nib, self._minitab(seq_vals, qual_vals)

    def _nib_dictionary(self, s: _Sources):
        """``_nib_encode``'s dictionaries from the native histogram pass
        over the group's flat read bytes, or None when they overflow.
        Returns ((512,) u8 byte -> index tables, seq then qual, for the
        native pass to write the nib bytes with; (72,) i32 mini-table)."""
        dicts = np.empty(42, np.int32)
        luts = np.empty(512, np.uint8)
        if not native.pack_dict(s.jobs, s.row_lens, dicts, luts):
            return None
        n_seq, n_qual = int(dicts[0]), int(dicts[1])
        return luts, self._minitab(dicts[2 : 2 + n_seq],
                                   dicts[10 : 10 + n_qual])

    def _minitab(self, seq_vals, qual_vals) -> np.ndarray:
        """The 72-entry nib mini-table: mask of each seq value, omq and q3
        bits of each qual value."""
        minitab = np.zeros(72, np.int32)
        minitab[: seq_vals.size] = self._mask_tab[seq_vals]
        minitab[8 : 8 + qual_vals.size] = self._omq_bits_tab[qual_vals]
        minitab[40 : 40 + qual_vals.size] = self._q3_bits_tab[qual_vals]
        return minitab

    def _launch(self, path: str, payloads: List[_Payload]) -> _Entry:
        """k single-chunk groups of one path and one (r_pad, c_pad): one
        host buffer and one H2D copy, then ONE ppe launch that reads each
        group's unique rows, the groups' pairs end to end.  k = 1 is the
        unfused launch."""
        from .pairhmm_front import ppe_forward_unique

        k = len(payloads)
        label = path if k == 1 else _FUSE_LABEL[path] + str(k)
        self.dispatch_counts[label] = self.dispatch_counts.get(label, 0) + 1
        if k == 1:
            buf = payloads[0].buf
        else:
            # the join is packing: each group's pack and pack_cpu take an
            # equal share of it
            t0, cpu0 = time.perf_counter(), time.thread_time_ns()
            buf = join_payloads(payloads, self._pinned)
            share = (time.perf_counter() - t0) * 1e3 / k
            cpu_share = (time.thread_time_ns() - cpu0) / 1e6 / k
            for p in payloads:
                p.stage_ms["pack"] += share
                p.stage_ms["pack_cpu"] += cpu_share
        spans, off = [], 0
        for p in payloads:
            spans.extend((g, off + s, nr, nh) for g, s, nr, nh in p.spans)
            off += p.total
        slot = self._take_slot()
        stream = slot.stream
        with span("runner.launch") as launch, slot.active():
            h0 = _Stamp(stream)
            views = buf.ship(slot.device)
            h1 = _Stamp(stream)
            res = ppe_forward_unique(
                _FRONT[path], segments_of(payloads, views), slot.ppe_tab,
                self.trans, self.cfg.ppe_rows)
            k1 = _Stamp(stream)
        return _Entry(spans, off, [p.stage_ms for p in payloads],
                      launch.seconds * 1e3, (h0, h1), [(h1, k1)], [res], buf,
                      slot=slot.index)

    def _launch_chunks(self, p: _Payload) -> _Entry:
        """A group of several chunks (one oversized job), or any group on
        the striped path (the reference runner's raw-byte branch, never
        fused): one H2D copy, then per chunk one launch over the chunk's
        pairs that reads the group's unique rows itself — the ppe entry
        ("planes", or raw packed as "packed-split") or the striped
        kernel's ("striped", raw packed)."""
        from .pairhmm_front import Segment, ppe_forward_unique
        from .pairhmm_striped import striped_forward_unique

        slot = self._take_slot()
        stream = slot.stream
        label = ("striped" if self.striped else
                 "planes" if p.path == "planes" else "packed-split")
        outs, chunks = [], []
        with span("runner.launch") as launch, slot.active():
            h0 = _Stamp(stream)
            views = tuple(p.buf.ship(slot.device))
            h1 = _Stamp(stream)
            for off in range(0, p.total, self.pair_budget):
                size = min(self.pair_budget, p.total - off)
                seg = [Segment(views, p.dims, p.total, off, size)]
                k0 = _Stamp(stream)
                outs.append(
                    striped_forward_unique(seg, slot.ppe_tab, self.trans,
                                           self.cfg.stripe_height)
                    if self.striped else
                    ppe_forward_unique(_FRONT[p.path], seg, slot.ppe_tab,
                                       self.trans, self.cfg.ppe_rows))
                chunks.append((k0, _Stamp(stream)))
                self.dispatch_counts[label] = (
                    self.dispatch_counts.get(label, 0) + 1)
        return _Entry(p.spans, p.total, [p.stage_ms], launch.seconds * 1e3,
                      (h0, h1), chunks, outs, p.buf, slot=slot.index)

    def _dispatch_fused(self, payloads: List[_Payload]) -> List[_Entry]:
        """Launch deferred single-chunk groups, fusing up to
        cfg.fuse_groups of the same path and the same (r_pad, c_pad) into
        one launch each.  The port's groups launch exact sizes, so no
        chunk size enters the key."""
        buckets: Dict[Tuple[str, int, int], List[_Payload]] = {}
        for p in payloads:
            buckets.setdefault((p.path, *p.dims[2:]), []).append(p)
        width = self.cfg.fuse_groups
        return [
            self._launch(path, ps[i : i + width])
            for (path, _r, _c), ps in buckets.items()
            for i in range(0, len(ps), width)
        ]

    def _build_planes(self, read_u8, qual_u8, hap_u8, read_lens, hap_lens,
                      hap_init_y, nr_pad, nh_pad, r_pad, c_pad, out=None):
        """Host-side plane buffer for pairhmm_planes:
        [rlens | hlens | iy bits | read masks | omq bits | q3 bits | hap
        masks], all int32."""
        nrr = nr_pad * r_pad
        head = nr_pad + 2 * nh_pad
        size = head + 3 * nrr + nh_pad * c_pad
        buf = np.empty(size, np.int32) if out is None else out
        if buf.shape != (size,) or buf.dtype != np.int32:
            raise ValueError(f"plane buffer must be ({size},) int32")
        buf[:nr_pad] = read_lens
        buf[nr_pad : nr_pad + nh_pad] = hap_lens
        buf[nr_pad + nh_pad : head] = hap_init_y.view(np.int32)
        np.take(self._mask_tab, read_u8, out=buf[head : head + nrr])
        np.take(self._omq_bits_tab, qual_u8, out=buf[head + nrr : head + 2 * nrr])
        np.take(self._q3_bits_tab, qual_u8, out=buf[head + 2 * nrr : head + 3 * nrr])
        np.take(self._mask_tab, hap_u8, out=buf[head + 3 * nrr :])
        return buf

    def _finalize_group(self, jobs, probs, spans) -> None:
        # scatter back + finalize with f64 rescue
        from .pairhmm_oracle import finalize_log10

        for g, start, nr, nh in spans:
            job = jobs[g]
            raw = probs[start : start + nr * nh]

            def rescue(indices, job=job, nh=nh):
                from .pairhmm_torch import _host_f64_rescue

                local_read = (indices // nh).astype(np.int64)
                local_hap = (indices % nh).astype(np.int64)
                return _host_f64_rescue(
                    self.cfg, list(job.reads), list(job.haps),
                    local_read, local_hap,
                )

            job.result = finalize_log10(
                raw, rescue, mode=self.cfg.f64_rescue
            ).reshape(nr, nh)


def torch_pairhmm_engine(cfg: HCConfig, device="cuda"):
    """Per-region engine: a single-job run through the batched runner
    (call_batched's cross-region batching is the production path)."""
    from .engines import _to_arrays

    runner = TorchPairHMMRunner(cfg, device=device)

    def engine(reads, haplotypes):
        read_arrays, hap_arrays = _to_arrays(reads, haplotypes)
        job = PairHMMJob(read_arrays, hap_arrays)
        runner.run([job])
        return job.result

    return engine


class DiagPairHMMRunner:
    """Batch runner over the anti-diagonal PyTorch-ops forward
    (ops/pairhmm_diag.py) — what ``--pairhmm diag`` means in call_batched:
    one engine call per job, on ``device``.  The counterpart of the
    reference's JnpPairHMMRunner; an independent cross-check of the CUDA
    kernels, so it shares none of their code."""

    def __init__(self, cfg: HCConfig, device="cuda"):
        from .pairhmm_diag import diag_pairhmm_engine

        self.cfg = cfg
        self._engine = diag_pairhmm_engine(cfg, device=device)

    def run(self, jobs: Sequence[PairHMMJob]) -> None:
        for job in jobs:
            nr, nh = len(job.reads), len(job.haps)
            if nr * nh == 0:
                job.result = np.zeros((nr, nh))
                continue
            job.result = self._engine(job.reads, job.haps)
