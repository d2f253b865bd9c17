"""Region-job streams through the port's PairHMM runner, as the caller
drives it (``gatk_hc_tpu_torch/models/caller.py::call_batched``).

The system under test is ``TorchPairHMMRunner`` built through
``ops/runner.py::BackgroundRunner`` with the port's default ``HCConfig``
(adaptive dispatch path, fusion only on a measured deep degradation, the
nib encoding, the ppe kernel with 4 rows per lane, the sentinel finalize):
no arm is forced.  Each submit hands it ``regions_per_submit`` region jobs
(``PairHMMJob`` over columnar ``ReadPairs``); when a submit puts more than
``max_in_flight`` in flight, the oldest is drained.  The mix's file holds
these two numbers (512 and 4, the caller's values when the benchmark was
written), so a later change to the caller does not move the yardstick.

Set-up: the runner builds on its "hc-build" thread while this thread makes
the seed's pool of regions (every region of the mix's recorded shapes
for the configuration, at least twice what is in flight, cycled); then ``warmup_submits`` submits of
the pool run through the same loop, which launches every kernel instance
and bucket shape the cell uses and passes the dispatch controller's first
calibration.  The window starts at the first submit after that.  After
``seconds`` nothing new is submitted, everything in flight is drained, and
the window closes at the last drain.  Every job's result is reset before
it is submitted; the runner caches nothing by content.

Around the window the process is read on its host (``host.py``: each
thread's CPU seconds and last CPU, load, clock, switches), and the window's
rate is kept by tenths, so that a slow run shows where it lost its time.
After the window: the device's peak is read, the runner is let go, and
the check compares every pair of a sample of the window's regions (drawn
from the seed, the region with the most true cells always in it) with the
plain reference (``hcbench/reference.py``) on the card.  Every region
submitted in the window must come back with a finite (reads x haplotypes)
matrix.
"""

from __future__ import annotations

import collections
import contextlib
import os
import resource
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from hcbench import gen, host, reference, roofline, trace

# the runner's host-clock stages recorded here (``pack`` and ``finalize``
# are read by metrics; the pack's parts and its CPU time show where a slow
# run lost its time)
STAGES = ("pack", "unique_rows", "encode", "pack_cpu", "launch", "finalize")


def open_runner(devices: Sequence[str]):
    """The port's default runner on ``devices``, built on its own thread."""
    from gatk_hc_tpu_torch.config import HCConfig
    from gatk_hc_tpu_torch.ops.runner import BackgroundRunner

    return BackgroundRunner(HCConfig(), device=devices[0],
                            devices=list(devices))


def make_jobs(pool: Sequence[gen.Region]):
    """The pool as the caller's jobs, and each job's work."""
    from gatk_hc_tpu_torch.io.columnar import ReadPairs
    from gatk_hc_tpu_torch.ops.runner import PairHMMJob

    jobs, work = [], []
    for seq, qual, off, haps in pool:
        jobs.append(PairHMMJob(ReadPairs(seq, qual, off), haps))
        work.append(roofline.job_work(int(off[-1]),
                                      sum(h.size for h in haps),
                                      off.size - 1, len(haps)))
    return jobs, work


class Stream:
    """The caller's submit / drain loop over a cycled pool of jobs."""

    def __init__(self, runner, jobs, traffic: Dict):
        self.runner = runner
        self.jobs = jobs
        self.per_submit = traffic["regions_per_submit"]
        self.depth = traffic["max_in_flight"]
        if len(jobs) < 2 * self.per_submit * self.depth:
            raise ValueError("the pool must hold at least twice what is "
                             "in flight")
        self.at = 0
        self.reset()

    def reset(self) -> None:
        self.spans: List[tuple] = []  # (name, t0, t1) on perf_counter
        self.submitted: List[int] = []  # pool index of every job submitted
        self.missing = 0
        self.inflight: collections.deque = collections.deque()

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(trace.SPAN_PREFIX + name):
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def _submit(self) -> None:
        n = len(self.jobs)
        idx = [(self.at + k) % n for k in range(self.per_submit)]
        self.at = (self.at + self.per_submit) % n
        chunk = [self.jobs[i] for i in idx]
        for job in chunk:
            job.result = None
        with self._span("submit"):
            handle = self.runner.submit(chunk)
        self.inflight.append((handle, idx))
        self.submitted.extend(idx)

    def _drain_oldest(self) -> None:
        handle, idx = self.inflight.popleft()
        with self._span("drain"):
            self.runner.drain([handle])
        for i in idx:
            job = self.jobs[i]
            r = job.result
            if (r is None or r.shape != (len(job.reads), len(job.haps))
                    or not np.isfinite(r).all()):
                self.missing += 1

    def run(self, seconds: float = None, submits: int = None):
        """Submits until ``seconds`` have passed (or ``submits`` are
        made), then drains everything -> (start, end) on perf_counter."""
        t0 = time.perf_counter()
        deadline = t0 + (seconds if seconds is not None else float("inf"))
        made = 0
        while time.perf_counter() < deadline and (submits is None
                                                  or made < submits):
            self._submit()
            made += 1
            while len(self.inflight) > self.depth:
                self._drain_oldest()
        while self.inflight:
            self._drain_oldest()
        return t0, time.perf_counter()


def sample(seed: int, processed: Sequence[int], work, k: int) -> List[int]:
    """``k`` of the processed pool indices drawn from the seed, and the one
    with the most true cells."""
    processed = np.unique(np.asarray(processed, np.int64))
    rng = np.random.default_rng([seed & gen.SEED_MASK, 0x636865636B])
    pick = rng.choice(processed, size=min(k, processed.size), replace=False)
    longest = max(processed, key=lambda i: work[i]["cells"])
    return sorted({int(i) for i in pick} | {int(longest)})


def check(pool, jobs, picked: Sequence[int], limit: float, device):
    """The program's answers for the picked regions against the plain
    reference (an answer missing reads NaN, whose gap is inf) -> the
    reference's check dict."""
    pairs = reference.PairSet([pool[i] for i in picked])
    answers = []
    for i in picked:
        r = jobs[i].result
        shape = (len(jobs[i].reads), len(jobs[i].haps))
        answers.append(np.full(shape, np.nan) if r is None or r.shape != shape
                       else r)
    return reference.check(
        pairs, np.concatenate([a.ravel() for a in answers]), limit, device,
        [a.size for a in answers])


def _usage() -> Dict[str, float]:
    """This process's CPU seconds so far, in user space and in the
    kernel."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}


def _rate_by_tenth(stream: Stream, work, t0: float, t1: float):
    """Gcells/s drained in each tenth of the window: drains are in submit
    order, each of ``per_submit`` jobs."""
    cells = [0.0] * 10
    drains = [b for name, _a, b in stream.spans if name == "drain"]
    for k, end in enumerate(drains):
        idx = stream.submitted[k * stream.per_submit:
                               (k + 1) * stream.per_submit]
        tenth = min(9, int(10 * (end - t0) / (t1 - t0)))
        cells[tenth] += sum(work[i]["cells"] for i in idx)
    return [c / ((t1 - t0) / 10) / 1e9 for c in cells]


def _stage_sums(runner, before: Dict[str, int]) -> Dict[str, float]:
    return {s: float(sum(runner.stage_ms[s][n:])) for s, n in before.items()}


def _delta(now: Dict, before: Dict) -> Dict[str, int]:
    return {str(k): v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def run(config: Dict, traffic: Dict, seed: int, seconds: float,
        traced: bool, devices: Sequence[str]) -> Dict:
    """One run of the cell: set-up, the window, the check.  -> the run's
    record, which the metric readers read."""
    on_card = torch.device(devices[0]).type == "cuda"
    parts = {}
    t = time.perf_counter()
    bg = open_runner(devices)
    pool = gen.make_pool(config, traffic, seed)
    parts["pool_s"] = time.perf_counter() - t
    jobs, work = make_jobs(pool)
    stream = Stream(bg, jobs, traffic)
    t = time.perf_counter()
    runner = bg.runner
    parts["build_wait_s"] = time.perf_counter() - t
    t = time.perf_counter()
    stream.run(submits=traffic["warmup_submits"])
    if on_card:
        torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    for job in jobs:
        job.result = None
    stream.reset()
    before = {s: len(runner.stage_ms[s]) for s in STAGES
              if s in runner.stage_ms}
    dispatch0 = dict(runner.dispatch_counts)
    buckets0 = dict(runner.bucket_counts)
    profiler = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        *([torch.profiler.ProfilerActivity.CUDA] if on_card else [])])
        if traced else contextlib.nullcontext())
    host0 = host.snapshot()
    usage0 = _usage()
    with profiler:
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            t0, t1 = stream.run(seconds=seconds)
    usage = {k: v - usage0[k] for k, v in _usage().items()}
    host_window = host.window(host0, host.snapshot())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    reduced = None
    if traced:
        with tempfile.TemporaryDirectory(prefix="hcbench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            profiler.export_chrome_trace(path)
            reduced = trace.reduce(trace.load(path))
    total: Dict[str, int] = {}
    for i in stream.submitted:
        roofline.add_work(total, work[i])
    record = {
        "window_start": t0,
        "window_s": t1 - t0,
        "work": total,
        "attempted": len(stream.submitted),
        "missing": stream.missing,
        "spans_ms": {
            name: 1e3 * sum(b - a for n, a, b in stream.spans if n == name)
            for name in ("submit", "drain")},
        "stage_sums_ms": _stage_sums(runner, before),
        "memory_peak_bytes": peak,
        "trace": reduced,
        "program": {
            "setup_parts": parts,
            "window_usage": usage,
            "host": {**host_window, "pool_s": parts["pool_s"]},
            "rate_by_tenth": _rate_by_tenth(stream, work, t0, t1),
            "dispatch": _delta(runner.dispatch_counts, dispatch0),
            "buckets": _delta(runner.bucket_counts, buckets0),
            "init_profile": {k: v for k, v in runner.init_profile.items()
                             if k in ("torch_import_s", "runner_ctor_s",
                                      "kernel_build_load_s")},
            "kernel_cache": {
                name: rec.get("status") for name, rec in
                runner.init_profile.get("kernel_cache", {}).get(
                    "libraries", {}).items()},
        },
    }
    picked = sample(seed, stream.submitted, work, traffic["check_regions"])
    bg.stop_prewarm()
    del runner, bg, stream
    if on_card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    record["check"] = check(pool, jobs, picked,
                            config["check"]["max_log10_gap"], devices[0])
    record["check"]["regions"] = len(picked)
    record["check_s"] = time.perf_counter() - c0
    return record
