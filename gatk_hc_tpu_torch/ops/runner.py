"""Cross-region PairHMM dispatch runner: the torch-free layer.

The region pipeline produces many small (reads x haps) jobs; a runner
batches them.  This module holds what every engine shares and imports no
torch, as the reference's runner imports no JAX
(gatk_hc_tpu/ops/runner.py:19-30): ``PairHMMJob``, the FIFO daemon worker
(``_DaemonWorker``) and its bounded exit wait, the planes-vs-packed
``DispatchPathController``, ``DeviceWedgedError``, ``NativePairHMMRunner``
(the C++ engine over a host thread pool) and ``BackgroundRunner``.

The runner on the card (``TorchPairHMMRunner``, ``DiagPairHMMRunner``,
``local_devices`` and the host buffers and payloads of the dispatch
worker) lives in ops/torch_runner.py.  ``BackgroundRunner`` imports torch
and that module on its build thread, so that the import overlaps the
host's parse and assembly, as the reference's build thread imports JAX;
a ``--pairhmm native`` or ``python`` run never loads torch.  The names of
ops/torch_runner.py still resolve from here (``__getattr__``, PEP 562),
importing torch at that first access.

Together with ops/torch_runner.py this is the counterpart of
gatk_hc_tpu/ops/runner.py.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import HCConfig
from ..utils.logging import process_age_s as _process_age_s

ReadArray = Tuple[np.ndarray, np.ndarray]  # (bases u8, quals u8)

# the names that live in ops/torch_runner.py (torch at first access)
_TORCH_NAMES = frozenset({
    "STAGES", "TorchPairHMMRunner", "DiagPairHMMRunner", "local_devices",
    "torch_pairhmm_engine", "join_payloads", "segments_of", "_Stamp",
    "_HostBuffer", "_Unique", "_Payload", "_Entry", "_Batch", "_Slot",
    "_ALIGN", "_TORCH_DTYPES", "_FUSE_LABEL", "_FRONT",
})


def __getattr__(name: str):
    if name in _TORCH_NAMES:
        from . import torch_runner

        return getattr(torch_runner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class PairHMMJob:
    """One region's likelihood request.

    Every read and haplotype must be non-empty (the pipeline's
    min_read_length_after_trimming filter guarantees this on the production
    path; the check makes the public API safe too — a zero-length row would
    otherwise hit the underflow-rescue path with an undefined likelihood).

    NOTE on ``result``: under the default cfg.f64_rescue="sentinel", entries
    whose f32 forward probability underflowed MIN_ACCEPTED hold
    RESCUE_SENTINEL_LOG10 (-100.0) instead of the reference's exact f64
    recompute.  This is provably VCF-neutral through normalize_and_filter,
    but any NEW consumer of raw likelihoods (annotations, QUAL refinement)
    must either tolerate sentinels below -64.1 or run with
    f64_rescue="exact".
    """

    reads: Sequence[ReadArray]
    haps: Sequence[np.ndarray]
    # filled by the runner: read-major log10 matrix (n_reads, n_haps).
    # CAVEAT: with cfg.f64_rescue="sentinel" (default), underflowed entries
    # hold RESCUE_SENTINEL_LOG10 (-100.0), not exact values — see the class
    # docstring before consuming raw likelihoods downstream.
    result: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        off = getattr(self.reads, "off", None)
        if off is not None:  # columnar ReadPairs: vectorized check (the
            # cached .lengths diff is reused by group packing later)
            reads_ok = len(off) < 2 or int(self.reads.lengths.min()) > 0
        else:
            reads_ok = all(len(b) for b, _ in self.reads)
        if not reads_ok or any(len(h) == 0 for h in self.haps):
            raise ValueError("PairHMMJob rows must be non-empty")


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


class DispatchPathController:
    """Measured planes-vs-packed selection of the shipping encoding.

    Which encoding is cheaper depends on the host, the link and the card:
    planes ship 12 B per read base and need no lookups on the card; packed
    ships 2 B (1 B with the nib encoding) and the ppe kernel applies the
    lookups as it loads its rows, so the paths differ in pack and H2D.
    Instead of a cost model, the runner times one END-TO-END group per path
    (pack + H2D + kernel, synchronised on its stream) and keeps
    choosing the measured winner, re-timing the staler path every
    ``recal_every`` groups so that a change of phase flips the choice
    within one calibration cycle.

    Short runs never pay for this: calibration starts only after
    ``min_groups`` groups (a chrM-sized run has ~5), so the planes default
    serves small inputs untouched."""

    PATHS = ("planes", "packed")

    def __init__(self, forced: Optional[str] = None, min_groups: int = 32,
                 recal_every: int = 32):
        self.forced = forced
        self.min_groups = min_groups
        self.recal_every = recal_every
        self.groups = 0
        # path -> (seconds per pair, group index of the measurement)
        self.measured: Dict[str, Tuple[float, int]] = {}

    def choose(self) -> Tuple[str, bool]:
        """-> (path, calibrate): when calibrate is True the caller times
        the group synchronously and reports via record()."""
        if self.forced is not None:
            return self.forced, False
        self.groups += 1
        if self.groups < self.min_groups:
            return "planes", False
        for path in self.PATHS:
            if path not in self.measured:
                return path, True
        stale = min(self.PATHS, key=lambda p: self.measured[p][1])
        if self.groups - self.measured[stale][1] >= self.recal_every:
            return stale, True
        return min(self.PATHS, key=lambda p: self.measured[p][0]), False

    def record(self, path: str, sec_per_pair: float) -> None:
        self.measured[path] = (sec_per_pair, self.groups)

    def degraded(self, factor: float = 2.0) -> bool:
        """True once measurements show a slow phase (the winner's per-pair
        cost more than ``factor``x its best historical).  The reference
        also coarsens its padded tail chunk on this; the port launches
        exact sizes and has no such chunk, so here it only gates fusion
        (through ``deeply_degraded``)."""
        if not self.measured:
            return False
        best_now = min(v[0] for v in self.measured.values())
        floor = getattr(self, "_best_ever", None)
        if floor is None or best_now < floor:
            self._best_ever = floor = best_now
        return best_now > factor * floor

    # Fusion gate: the calibration measurement is synchronous, so it
    # includes latency, and fusion pays only when launch THROUGHPUT
    # collapses, which shows as a much larger multiple of the best-ever
    # per-pair cost; the fuse_auto gate therefore requires a DEEP
    # degradation (the reference's threshold).
    DEEP_DEGRADATION_FACTOR = 6.0

    def deeply_degraded(self) -> bool:
        return self.degraded(self.DEEP_DEGRADATION_FACTOR)


class DeviceWedgedError(RuntimeError):
    """The card stopped answering: a batch, its copy back or the kernel
    build ran past cfg.device_timeout_s and a fresh probe of the card could
    not finish either.  The run stops here; its work is not recomputed on
    the CPU (the reference fails over to its C++ engine instead)."""


class _StillRunning(TimeoutError):
    """A wait on a worker task ran out of time (distinct from a
    TimeoutError the task itself raised, which drain re-raises)."""


class _WorkerFuture:
    """Minimal future for _DaemonWorker tasks; submit() returns one as the
    handle that drain() resolves."""

    __slots__ = ("_done", "_result", "_exc")

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc = None

    def _set(self, result=None, exc=None):
        self._result, self._exc = result, exc
        self._done.set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise _StillRunning("worker task still running")
        if self._exc is not None:
            raise self._exc
        return self._result


# Bounded exit policy for every device-touching helper thread: all are
# DAEMON (a call wedged inside one must not block process exit, so that
# a DeviceWedgedError ends the process), but an atexit hook waits up to
# _EXIT_JOIN_S for them to go idle, so that in the healthy case interpreter
# teardown never runs while a CUDA call is in flight; a wedged thread is
# abandoned after the bound instead of hanging exit forever.
_EXIT_JOIN_S = 120.0
_EXIT_WAITERS: List = []  # callables: (timeout) -> None
_EXIT_LOCK = threading.Lock()


def _join_device_threads() -> None:
    deadline = time.monotonic() + _EXIT_JOIN_S
    for wait in list(_EXIT_WAITERS):
        try:
            wait(max(0.0, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 - exit must go on
            pass


def _register_exit_wait(wait_fn) -> None:
    with _EXIT_LOCK:
        if not _EXIT_WAITERS:
            import atexit
            import weakref

            # weakref.finalize registers its exit hook with its first
            # finalizer.  A torch import that first creates one while exit
            # waits here (a short run that ends as the build thread imports
            # torch) registers it too late to run, and torch.library's
            # finalizers then fire during module teardown, on cleared
            # globals.  One finalizer now registers the hook first, so it
            # runs after this wait (atexit is last in, first out).
            weakref.finalize(_join_device_threads, lambda: None)
            atexit.register(_join_device_threads)
        _EXIT_WAITERS.append(wait_fn)


class _DaemonWorker:
    """Single FIFO DAEMON worker thread.  Unlike ThreadPoolExecutor, whose
    workers are joined at interpreter exit, a task wedged inside a blocked
    device call cannot keep the process from exiting after a
    DeviceWedgedError.  The module atexit hook still waits, bounded, for
    the worker to go idle."""

    def __init__(self, name: str):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._pending = 0
        self._idle = threading.Event()
        self._idle.set()
        self.abandoned = False  # set on a declared wedge: exit must
        # not wait for a worker known to be blocked in a dead device call
        self._t = threading.Thread(target=self._loop, name=name, daemon=True)
        self._t.start()
        _register_exit_wait(self.wait_idle)

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, fut = item
            try:
                fut._set(result=fn(*args))
            except BaseException as exc:  # delivered at fut.result()
                fut._set(exc=exc)
            finally:
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def submit(self, fn, *args) -> _WorkerFuture:
        fut = _WorkerFuture()
        with self._lock:
            self._pending += 1
            self._idle.clear()
        self._q.put((fn, args, fut))
        return fut

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        if self.abandoned:
            return True
        return self._idle.wait(timeout)


class BackgroundRunner:
    """Cold-start overlap: on a background thread ("hc-build"), imports
    torch and the runner's torch modules, builds and loads the kernel
    libraries (ops/_kernels.py), initialises the CUDA context and the device
    tables (the TorchPairHMMRunner constructor), and starts the runner's
    prewarm, so that those seconds run concurrently with the host's parse
    and assembly.  The first submit/drain/run joins the build.  A build or
    CUDA error is stored and raised at first use; a build still running
    after cfg.device_timeout_s raises DeviceWedgedError there.

    The build thread is the run's first importer of torch and of the
    runner's torch modules: nothing else of the run touches them before
    ``_get()`` has joined the build, so no other thread waits on their
    module locks while holding one the build needs."""

    def __init__(self, cfg: HCConfig, device="cuda", devices=None):
        self.cfg = cfg
        self._runner = None
        self._exc: Optional[BaseException] = None
        self._stop_requested = False

        def build():
            try:
                t0 = time.perf_counter()
                age0 = _process_age_s()
                preloaded = "torch" in sys.modules
                import torch  # noqa: F401 - the import this thread overlaps

                from . import pairhmm_front, pairhmm_striped  # noqa: F401
                from . import torch_runner

                import_s = time.perf_counter() - t0
                # a replacement set on this module (as the tests do) wins
                runner_cls = globals().get("TorchPairHMMRunner",
                                           torch_runner.TorchPairHMMRunner)
                t1 = time.perf_counter()
                runner = runner_cls(cfg, device=device, devices=devices)
                runner.init_profile.update(
                    build_start_at_age_s=round(age0, 3),
                    torch_preloaded=preloaded,
                    torch_import_s=round(import_s, 3),
                    runner_ctor_s=round(time.perf_counter() - t1, 3))
                if runner.device.type == "cuda":
                    from . import _kernels

                    t2 = time.perf_counter()
                    _kernels.build_all()  # one nvcc per source, together
                    for name in _kernels.KERNELS:
                        _kernels.load(name)
                    runner.init_profile["kernel_build_load_s"] = round(
                        time.perf_counter() - t2, 3)
                    runner.init_profile["kernel_cache"] = _kernels.cache_report()
                self._runner = runner
                if self._stop_requested:
                    runner.stop_prewarm()
                else:
                    t3 = time.perf_counter()
                    runner.prewarm()
                    runner.init_profile["prewarm_kickoff_s"] = round(
                        time.perf_counter() - t3, 3)
            except BaseException as exc:  # surfaced on first use
                self._exc = exc

        # daemon + bounded atexit join: a build wedged in a dead device
        # call must not block process exit
        self._build_abandoned = False
        self._thread = threading.Thread(target=build, daemon=True,
                                        name="hc-build")
        self._thread.start()
        _register_exit_wait(
            lambda timeout: None
            if self._build_abandoned
            else self._thread.join(timeout)
        )

    def _get(self):
        if self._exc is None:
            timeout = self.cfg.device_timeout_s or None
            self._thread.join(timeout)
            # a thread still alive with the runner built is only starting
            # its prewarm: usable
            if self._runner is None and self._thread.is_alive():
                self._build_abandoned = True
                self._exc = DeviceWedgedError(
                    f"gatk_hc_tpu_torch: device backend init unresponsive "
                    f"for {timeout:.0f}s (kernel build, CUDA context or "
                    "device tables); the card's work is not moved to the CPU")
        if self._exc is not None:
            raise self._exc
        return self._runner

    @property
    def runner(self):
        """The built runner (joins the build)."""
        return self._get()

    def built(self):
        """The runner if its build has ended without error, else None;
        never waits for the build (the counterpart of the reference's
        ``getattr(runner, "_runner", None)``)."""
        return self._runner if self._exc is None else None

    def submit(self, jobs):
        return self._get().submit(jobs)

    def drain(self, batches):
        return self._get().drain(batches)

    def run(self, jobs):
        return self._get().run(jobs)

    def prewarm(self, *args, **kwargs):  # already warming in the build thread
        return None

    def stop_prewarm(self) -> None:
        self._stop_requested = True
        if self._runner is not None:
            self._runner.stop_prewarm()


class NativePairHMMRunner:
    """CPU batch runner over the C++ PairHMM engine — same job interface and
    exact semantics (f32 + FTZ with f64 rescue below MIN_ACCEPTED) as the
    CUDA runner, for call_batched with cfg.pairhmm_engine == 'native'.

    Jobs fan out over a host thread pool (cfg.host_threads, 0 = one per
    CPU): the C++ compute releases the GIL, so this is the CPU-engine
    equivalent of the reference's OpenMP `parallel for` over testcases
    (intel_pairhmm.hpp:128-131).  Each job's result is written to its own
    slot, so scheduling cannot affect output."""

    def __init__(self, cfg: HCConfig):
        self.cfg = cfg

    def run(self, jobs: Sequence[PairHMMJob]) -> None:
        n_workers = (
            self.cfg.host_threads
            if self.cfg.host_threads > 0
            else (os.cpu_count() or 1)
        )
        if n_workers > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(n_workers) as pool:
                list(pool.map(self._run_one, jobs))
        else:
            for job in jobs:
                self._run_one(job)

    def _run_one(self, job: PairHMMJob) -> None:
        from .. import native
        from .pairhmm_oracle import finalize_log10

        gop, gcp = self.cfg.gop_char, self.cfg.gcp_char
        nr, nh = len(job.reads), len(job.haps)
        if nr * nh == 0:
            job.result = np.zeros((nr, nh))
            return
        r_stride = max(len(b) for b, _ in job.reads)
        rb = np.zeros((nr, r_stride), dtype=np.uint8)
        rq = np.zeros((nr, r_stride), dtype=np.uint8)
        rl = np.zeros(nr, dtype=np.int32)
        for i, (b, q) in enumerate(job.reads):
            rb[i, : len(b)] = b
            rq[i, : len(q)] = q
            rl[i] = len(b)
        h_stride = max(len(h) for h in job.haps)
        hb = np.zeros((nh, h_stride), dtype=np.uint8)
        hl = np.zeros(nh, dtype=np.int32)
        for i, h in enumerate(job.haps):
            hb[i, : len(h)] = h
            hl[i] = len(h)
        pr = np.repeat(np.arange(nr, dtype=np.int32), nh)
        ph = np.tile(np.arange(nh, dtype=np.int32), nr)
        raw = native.pairhmm_raw_native(rb, rq, rl, hb, hl, pr, ph, gop, gcp)

        def rescue(indices, pr=pr, ph=ph):
            return native.pairhmm_raw_native(
                rb, rq, rl, hb, hl,
                pr[indices], ph[indices], gop, gcp, dtype=np.float64,
            )

        job.result = finalize_log10(
            raw, rescue, mode=self.cfg.f64_rescue
        ).reshape(nr, nh)
