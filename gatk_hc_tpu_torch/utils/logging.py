"""Observability: progress logging, stage timers, run counters.

The reference prints per-window progress to stdout (haplotypecaller.hpp:97-98,
145, assembler.hpp:38-48, graph_wrapper.hpp:228-230) and has compile-time-only
profiling hooks (PairWiseSW.h PERF_DEBUG).  Here:

* ``HCLogger`` reproduces those progress lines under ``verbosity >= 1``
  (quiet by default);
* ``StageTimers`` accumulates wall-clock per pipeline stage (parse,
  downsample+clip, assemble, pairhmm, genotype, io);
* ``RunCounters`` tracks regions/reads/pairs/cell-updates/variants and
  renders a one-line JSON summary (the CLI --stats source of truth);
* ``trace_annotation`` / ``maybe_profile`` wrap torch.profiler when
  profiling is enabled (GATK_HC_TPU_TORCH_PROFILE_DIR env): the whole run is
  traced on the host and the card and written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional


@dataclasses.dataclass
class RunCounters:
    regions: int = 0
    regions_skipped: int = 0
    regions_failed: int = 0
    reads_parsed: int = 0
    reads_used: int = 0
    haplotypes: int = 0
    pairs: int = 0
    cell_updates: int = 0
    rescued_pairs: int = 0
    variants: int = 0
    # --genotyper cuda on its f32 path (use_f64=False): sites whose GT/GQ
    # decision was not provably stable under the f32 error bound and re-ran
    # on the exact host f64 path (models/genotyper.py::
    # genotype_regions_device guard)
    gq_host_verified: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def process_age_s() -> float:
    """Seconds since THIS process started (procfs) — attributes the
    interpreter + site-import cost that no in-process timer can see (the
    gap between process_age and the CLI's own wall clock).  NaN where
    /proc is unavailable."""
    try:
        with open("/proc/self/stat") as handle:
            rest = handle.read().rsplit(")", 1)[1].split()
        start_jiffies = float(rest[19])  # field 22: starttime
        clk = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as handle:
            uptime = float(handle.read().split()[0])
        return uptime - start_jiffies / clk
    except Exception:
        return float("nan")


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def add(self, name: str, seconds: float) -> None:
        """Accumulate a duration measured elsewhere (e.g. inside a host
        worker thread).  With >1 host threads the per-stage totals are
        summed thread time and can exceed wall-clock."""
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def summary(self) -> Dict[str, float]:
        return {name: round(value, 4) for name, value in self.totals.items()}


class HCLogger:
    """Reference-style progress lines; verbosity 0=quiet, 1=progress, 2=debug."""

    def __init__(self, verbosity: int = 0, stream=None):
        self.verbosity = verbosity
        self.stream = stream or sys.stderr

    def _emit(self, text: str) -> None:
        self.stream.write(text + "\n")

    def region_start(self, origin, padded, n_reads: int) -> None:
        if self.verbosity >= 1:
            self._emit("-" * 82)
            self._emit(
                f"Assembling {origin.to_string()} with {n_reads} reads:    "
                f"(with overlap region = {padded.to_string()})"
            )

    def region_ignored(self, origin, padded) -> None:
        if self.verbosity >= 1:
            self._emit(
                f"Ignore {origin.to_string()}:    "
                f"(with overlap region = {padded.to_string()})"
            )

    def region_failed(self, origin, reason: str) -> None:
        # always emitted: a skipped-on-error region should never be silent
        self._emit(f"WARNING: skipping {origin.to_string()}: {reason}")

    def kmer_rejected(self, kmer_size: int, reason: str) -> None:
        if self.verbosity >= 1:
            self._emit(
                f"Not using kmer size of {kmer_size} in assembler because it {reason}"
            )

    def kmer_accepted(self, kmer_size: int) -> None:
        if self.verbosity >= 1:
            self._emit(f"Using kmer size of {kmer_size} in assembler")

    def haplotypes_found(self, count: int) -> None:
        if self.verbosity >= 1:
            if count > 1:
                self._emit(f"Found {count} candidate haplotypes.")
            else:
                self._emit("Found only the reference haplotype in the assembly graph.")

    def debug(self, text: str) -> None:
        if self.verbosity >= 2:
            self._emit(text)

    def done(self) -> None:
        if self.verbosity >= 1:
            self._emit("HaplotypeCaller done.")


NULL_LOGGER = HCLogger(verbosity=0)

PROFILE_DIR = os.environ.get("GATK_HC_TPU_TORCH_PROFILE_DIR")


@contextlib.contextmanager
def trace_annotation(name: str):
    """torch.profiler range (recorded only while a profile is active)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def maybe_profile():
    """Whole-run host + CUDA profile when GATK_HC_TPU_TORCH_PROFILE_DIR is set;
    the trace lands in that directory as trace.json (chrome://tracing)."""
    if not PROFILE_DIR:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(PROFILE_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(PROFILE_DIR, "trace.json"))
