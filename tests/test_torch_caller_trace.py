"""The caller's spans and its count of the work it hands the runner, on a
seeded 40 kb fixture at 2x151 through the C++ host engine: every
``hc.caller.*`` span in a profile of every thread, one
``hc.caller.assemble`` a region; ``RunCounters``' pairs and cell
updates against ``hcbench/roofline.py::job_work`` over the jobs that
reached the runner, on the run path, the one-submit path and the
submit / drain path with chunks drained mid-walk; ``--stats`` keeping
its fields; the VCF the same with the spans recording, idle, or
replaced by bare clocks."""

import contextlib
import io
import json
import time

import pytest
import torch

from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import HCConfig
from gatk_hc_tpu_torch.models import caller
from gatk_hc_tpu_torch.ops.runner import NativePairHMMRunner
from gatk_hc_tpu_torch.tools import make_fixture
from gatk_hc_tpu_torch.utils import logging as hc_logging
from gatk_hc_tpu_torch.utils.logging import RunCounters, StageTimers
from hcbench import roofline

NATIVE = HCConfig(pairhmm_engine="native", host_threads=2)
SPANS = ("parse", "assemble", "pairhmm", "genotype", "io")


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard151")
    make_fixture.main([str(d), "--length", "40000", "--name", "s40k",
                       "--seed", "20261019"])
    return str(d / "s40k.sam"), str(d / "s40k.fa")


class Runner(NativePairHMMRunner):
    """The C++ engine behind submit / drain, or ``run`` alone; keeps
    every job handed to it."""

    def __init__(self, overlap: bool):
        super().__init__(NATIVE)
        self.seen = []
        if overlap:
            self.submit = self._submit
            self.drain = lambda handles: None

    def _submit(self, jobs):
        self.seen.extend(jobs)
        super().run(jobs)
        return len(self.seen)

    def run(self, jobs):
        self.seen.extend(jobs)
        super().run(jobs)


def call(shard, out, runner=None, **kwargs):
    sam, fasta = shard
    return caller.call_batched(sam, fasta, str(out), cfg=NATIVE,
                               runner=runner or Runner(overlap=True),
                               device="cpu", **kwargs)


def every_thread():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def test_every_caller_span_is_in_the_profile(shard, tmp_path):
    timers = StageTimers()
    with every_thread() as prof:
        results = call(shard, tmp_path / "out.vcf", timers=timers)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    names = [e["name"] for e in events
             if str(e.get("name", "")).startswith("hc.caller.")]
    assert {f"hc.caller.{s}" for s in SPANS} <= set(names)
    # one assembly a window, on the host threads
    assert names.count("hc.caller.assemble") == len(results)
    assert {e["tid"] for e in events if e.get("name")
            == "hc.caller.assemble"} - {e["tid"] for e in events if e.get(
                "name") == "hc.caller.parse"}
    assert set(SPANS) <= set(timers.totals)


@pytest.mark.parametrize("path", ["run", "one_submit", "chunked"])
def test_the_counters_hold_the_jobs_work(shard, tmp_path, monkeypatch,
                                         path):
    if path == "chunked":
        monkeypatch.setattr(caller, "SUBMIT_CHUNK_REGIONS", 8)
        monkeypatch.setattr(caller, "MAX_INFLIGHT_BATCHES", 2)
    runner = Runner(overlap=path != "run")
    counters = RunCounters()
    call(shard, tmp_path / "out.vcf", runner=runner, counters=counters)
    total = {}
    for job in runner.seen:
        roofline.add_work(total, roofline.job_work(
            sum(len(b) for b, _ in job.reads), sum(len(h) for h in job.haps),
            len(job.reads), len(job.haps)))
    assert len(runner.seen) > 8
    assert (counters.pairs, counters.cell_updates) == (total["pairs"],
                                                       total["cells"])


def test_stats_keeps_its_fields(shard, tmp_path):
    sam, fasta = shard
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["-I", sam, "-R", fasta, "-O",
                         str(tmp_path / "o.vcf"), "--pairhmm", "native",
                         "--stats"]) == 0
    stats = json.loads(out.getvalue().splitlines()[0])
    assert set(stats) == {
        "regions", "variants", "cell_updates", "wall_s", "cells_per_s",
        "engine", "genotyper", "stages", "peak_rss_mb", "process_age_s",
        "pre_main_s", "host_profile"}
    assert set(stats["stages"]) == {"parse", "downsample_clip", "assemble",
                                    "pairhmm", "genotype", "io"}


class BareClock:
    """A span that only reads the clock, as the stage timers did."""

    def __init__(self, name, sink=None):
        pass

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start


def test_the_vcf_is_the_same_with_the_spans(shard, tmp_path, monkeypatch):
    call(shard, tmp_path / "idle.vcf")
    with every_thread():
        call(shard, tmp_path / "recording.vcf")
    monkeypatch.setattr(caller, "span", BareClock)
    monkeypatch.setattr(hc_logging, "span", BareClock)
    call(shard, tmp_path / "bare.vcf")
    vcfs = {name: open(tmp_path / f"{name}.vcf").read()
            for name in ("idle", "recording", "bare")}
    assert vcfs["idle"].count("\n") > 50
    assert vcfs["idle"] == vcfs["recording"] == vcfs["bare"]
