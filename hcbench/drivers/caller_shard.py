"""Whole WGS shards through the port's caller, as one process of a
scattered germline pipeline calls them
(``gatk_hc_tpu_torch/models/caller.py::call_batched``).

The system under test is ``call_batched`` with the port's default
``HCConfig`` and a ``BackgroundRunner``, as ``cli.py`` builds them: the
columnar parse, window prep and native assembly on one host thread per
CPU, the runner fed by the caller's own submits, host genotyping and the
written VCF.  The configuration states the engines it expects, and a run
whose port defaults differ stops before it starts.

Set-up: the runner builds on its "hc-build" thread while this thread
makes the seed's shard (``hcbench/shard_gen.py``) in a temporary
directory; then ``warmup_passes`` whole passes run, which launch every
bucket the shard uses and pass the dispatch controller's calibration.
The window is a closed loop of whole passes, each ``call_batched`` from
the SAM to its written VCF; no pass starts after ``seconds``, and the
window closes at the end of the last one.  Its work is the pairs and
true cells the caller counts in its ``RunCounters`` for the jobs it hands
the runner, so ``gcells_per_s`` reads the whole shard's throughput in the
likelihood stage's unit.

A pass-through runner (``Recorder``) keeps the job lists of the pass in
flight, one append a submit.  The check, after the window:

* (a) every pair of ``check_regions`` regions of the last pass drawn from
  the seed, and of its region with the most true cells, against the plain
  reference (``hcbench/reference.py``, float64, on the card);
* (b) every pass's VCF against the VCF the port writes for the same shard
  with its C++ host PairHMM engine (``pairhmm_engine="native"``, bit-exact
  with the kernel), byte for byte;
* (c) every pass answered every region job: as many jobs as the most any
  pass made, each with a finite (reads x haplotypes) matrix;
* (d) the last pass's VCF against the planted truth, in
  ``tools/check_truth.py``'s measure: the share of planted variants
  called at least ``min_sensitivity``, and the share of records within 5
  bp of a planted variant at least ``min_calls_within_5bp``.  (b) holds
  the runner to the C++ engine; (d) holds assembly, genotyping and the
  writer, which both VCFs share, to the truth.

A region that fails (b) or (c), and where (d) reads below a limit each
region holding a planted variant missed or a record far from any, is a
region without a right answer: it counts in ``missing`` and in
``check.regions_past_limit``.

    python3 -m hcbench.drivers.caller_shard --seeds 1,2,3 [--out FILE]

runs the control on the card: the same sample of one pass's jobs,
answered by the reference in bfloat16 in the program's place
(``reference.control_answers``), beside the program's own gap.
"""

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import types
from typing import Dict, List, Sequence

import numpy as np
import torch

from hcbench import host, reference, roofline, shard_gen, trace
from hcbench.drivers import runner_stream as rs

# the caller's stages (StageTimers), each also a span caller.<stage>
STAGES = ("parse", "downsample_clip", "assemble", "pairhmm", "genotype",
          "io")
DIFF_LINES = 20  # differing VCF records kept in the record


def port():
    """The port's ``HCConfig``, ``call_batched``, ``StageTimers`` and
    ``RunCounters``."""
    from gatk_hc_tpu_torch.config import HCConfig
    from gatk_hc_tpu_torch.models.caller import call_batched
    from gatk_hc_tpu_torch.utils import logging as hc_logging

    return types.SimpleNamespace(
        HCConfig=HCConfig, call_batched=call_batched,
        StageTimers=hc_logging.StageTimers,
        RunCounters=hc_logging.RunCounters)


def stated(config: Dict, cfg) -> None:
    """Raises where the port's defaults are not what the configuration
    states it runs."""
    want = dict(config["engines"], region_size=config["region_size"],
                padding_size=config["padding_size"],
                max_num_haplotypes=config["max_haplotypes"])
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise RuntimeError(f"the port's defaults {got} are not the "
                           f"configuration's {want}")


class Recorder:
    """The runner, passed through: keeps each submit's job list."""

    def __init__(self, runner):
        self.runner = runner
        self.submits: List[list] = []

    def submit(self, jobs):
        self.submits.append(jobs)
        return self.runner.submit(jobs)

    def drain(self, batches):
        return self.runner.drain(batches)

    def stop_prewarm(self) -> None:
        self.runner.stop_prewarm()

    def jobs(self) -> list:
        return [job for jobs in self.submits for job in jobs]


@dataclasses.dataclass
class Pass:
    start: float
    end: float
    regions: int
    variants: int
    work: Dict[str, int]  # jobs, pairs, cells handed to the runner
    stages_s: Dict[str, float]
    answers: list  # each job's result, in submit order
    vcf: str


def one_pass(port, shard, recorder: Recorder, vcf: str, device) -> Pass:
    """``call_batched`` once over the shard, through ``recorder``."""
    recorder.submits = []
    timers, counters = port.StageTimers(), port.RunCounters()
    t0 = time.perf_counter()
    results = port.call_batched(shard.sam, shard.fasta, vcf,
                                cfg=port.HCConfig(), runner=recorder,
                                timers=timers, counters=counters,
                                device=device)
    t1 = time.perf_counter()
    jobs = recorder.jobs()
    work = {"jobs": len(jobs), "pairs": counters.pairs,
            "cells": counters.cell_updates}
    return Pass(t0, t1, len(results), sum(len(r.variants) for r in results),
                work, dict(timers.totals), [job.result for job in jobs], vcf)


def as_region(job):
    """A job as the reference's region: (flat_seq, flat_qual, off,
    [haplotype])."""
    reads = job.reads
    if hasattr(reads, "off"):
        return (reads.flat_seq, reads.flat_qual,
                np.asarray(reads.off, np.int64), list(job.haps))
    lens = [len(b) for b, _ in reads]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return (np.concatenate([b for b, _ in reads]),
            np.concatenate([q for _, q in reads]), off, list(job.haps))


def job_work(job) -> Dict[str, int]:
    _, _, off, haps = as_region(job)
    return roofline.job_work(int(off[-1] - off[0]),
                             sum(len(h) for h in haps), off.size - 1,
                             len(haps))


def unanswered(answers: Sequence, shapes: Sequence, expected: int) -> int:
    """Jobs of one pass without a finite matrix of the job's shape, and
    the jobs it made fewer than ``expected``."""
    bad = max(0, expected - len(answers))
    for r, shape in zip(answers, shapes):
        if r is None or r.shape != shape or not np.isfinite(r).all():
            bad += 1
    return bad


def vcf_regions(text: str, truth_text: str, region_size: int):
    """-> (regions whose records differ, the differing records marked
    ``+`` (this VCF only) or ``-`` (the other only)); a difference outside
    any record, such as the header, counts as one region."""
    if text == truth_text:
        return 0, []
    mine = collections.Counter(text.splitlines())
    theirs = collections.Counter(truth_text.splitlines())
    diff = ([("+", line) for line in (mine - theirs).elements()]
            + [("-", line) for line in (theirs - mine).elements()])
    regions = {(int(line.split("\t")[1]) - 1) // region_size
               if not line.startswith("#") and line.count("\t") > 1 else -1
               for _, line in diff}
    return max(1, len(regions)), [s + line for s, line in diff]


def truth_check(text: str, truth, limits: Dict, region_size: int):
    """(d): -> (the measure with its limits, regions past a limit): where
    the share called is below ``min_sensitivity``, each region holding a
    planted variant missed; where the share of records near a planted
    variant is below ``min_calls_within_5bp``, each region holding a
    record far from all."""
    out = shard_gen.sensitivity(text, truth)
    missed, far = out.pop("missed"), out.pop("far")
    bad = set()
    if (out["sensitivity"] is not None
            and out["sensitivity"] < limits["min_sensitivity"]):
        bad.update(p // region_size for p in missed)
    if (out["calls_within_5bp_of_truth"] is not None
            and out["calls_within_5bp_of_truth"]
            < limits["min_calls_within_5bp"]):
        bad.update((q - 1) // region_size for q in far)
    out.update(missed=len(missed), far=len(far),
               min_sensitivity=limits["min_sensitivity"],
               min_calls_within_5bp=limits["min_calls_within_5bp"],
               regions_past_limit=len(bad))
    return out, len(bad)


def sample_and_check(seed: int, jobs: list, work: list, k: int,
                     limit: float, device):
    """(a): the seed's sample of ``jobs`` (``work``: each one's
    ``job_work``) against the reference -> (picked indices, {index:
    region}, the check dict)."""
    picked = rs.sample(seed, range(len(jobs)), work, k)
    regions = {i: as_region(jobs[i]) for i in picked}
    return picked, regions, rs.check(regions, jobs, picked, limit, device)


def run(config: Dict, traffic: Dict, seed: int, seconds: float,
        traced: bool, devices: Sequence[str]) -> Dict:
    """One run of the cell: set-up, the window, the check.  -> the run's
    record, which the metric readers read."""
    the_port = port()
    stated(config, the_port.HCConfig())
    with tempfile.TemporaryDirectory(prefix="hcbench_shard_") as tmp:
        return _run(config, traffic, seed, seconds, traced, devices,
                    the_port, tmp)


def _run(config, traffic, seed, seconds, traced, devices, the_port,
         tmp) -> Dict:
    on_card = torch.device(devices[0]).type == "cuda"
    parts = {}
    t = time.perf_counter()
    bg = rs.open_runner(devices)
    shard = shard_gen.make_shard(config, traffic, seed, tmp)
    parts["shard_s"] = time.perf_counter() - t
    t = time.perf_counter()
    runner = bg.runner
    parts["build_wait_s"] = time.perf_counter() - t
    recorder = Recorder(bg)
    t = time.perf_counter()
    warm = [one_pass(the_port, shard, recorder,
                     os.path.join(tmp, "warm.vcf"), devices[0])
            for _ in range(traffic["warmup_passes"])]
    if on_card:
        torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    before = {s: len(runner.stage_ms[s]) for s in rs.STAGES
              if s in runner.stage_ms}
    dispatch0 = dict(runner.dispatch_counts)
    buckets0 = dict(runner.bucket_counts)
    profiler = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if on_card else [])],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))
        if traced else contextlib.nullcontext())
    passes: List[Pass] = []
    host0 = host.snapshot()
    usage0 = rs._usage()
    with profiler:
        with torch.profiler.record_function(trace.SPAN_PREFIX + "window"):
            deadline = time.perf_counter() + seconds
            while not passes or time.perf_counter() < deadline:
                with torch.profiler.record_function(trace.SPAN_PREFIX
                                                    + "pass"):
                    passes.append(one_pass(
                        the_port, shard, recorder,
                        os.path.join(tmp, f"pass{len(passes)}.vcf"),
                        devices[0]))
    usage = {k: v - usage0[k] for k, v in rs._usage().items()}
    host_window = host.window(host0, host.snapshot())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    reduced, spans = None, None
    if traced:
        path = os.path.join(tmp, "trace.json")
        profiler.export_chrome_trace(path)
        events = trace.load(path)
        reduced = trace.reduce(events)
        spans = _caller_spans(events)
        del events
        os.remove(path)
    stage_sums = rs._stage_sums(runner, before)
    program = {
        "setup_parts": parts,
        "window_usage": usage,
        "host": {**host_window, "shard_s": parts["shard_s"]},
        "shard": {"bp": shard.length, "reads": shard.reads,
                  "planted": len(shard.truth)},
        "passes": [_pass_row(p) for p in passes],
        "dispatch": rs._delta(runner.dispatch_counts, dispatch0),
        "buckets": rs._delta(runner.bucket_counts, buckets0),
        "init_profile": {k: v for k, v in runner.init_profile.items()
                         if k in ("torch_import_s", "runner_ctor_s",
                                  "kernel_build_load_s")},
        "kernel_cache": {
            name: rec.get("status") for name, rec in
            runner.init_profile.get("kernel_cache", {}).get(
                "libraries", {}).items()},
    }
    if spans is not None:
        program["trace_spans"] = spans
    jobs = recorder.jobs()
    bg.stop_prewarm()
    del runner, bg, recorder
    if on_card:
        torch.cuda.empty_cache()
    total: Dict[str, int] = {}
    for p in passes:
        roofline.add_work(total, p.work)
    work = [job_work(job) for job in jobs]
    record = {
        "window_start": passes[0].start,
        "window_s": passes[-1].end - passes[0].start,
        "work": total,
        "attempted": total["jobs"],
        "spans_ms": {s: 1e3 * sum(p.stages_s.get(s, 0.0) for p in passes)
                     for s in STAGES},
        "stage_sums_ms": stage_sums,
        "memory_peak_bytes": peak,
        "trace": reduced,
        "program": program,
    }
    c0 = time.perf_counter()
    record.update(check(config, traffic, seed, the_port, shard, tmp, jobs,
                        work, warm + passes, devices[0]))
    record["check_s"] = time.perf_counter() - c0
    return record


def check(config, traffic, seed, the_port, shard, tmp, jobs, work, every,
          device) -> Dict:
    """(a) to (d) of the module docstring over the passes ``every``, the
    last one's ``jobs`` and their ``work`` -> {"check", "missing"}."""
    picked, _, out = sample_and_check(
        seed, jobs, work, traffic["check_regions"],
        config["check"]["max_log10_gap"], device)
    out["regions"] = len(picked)
    native_vcf = os.path.join(tmp, "native.vcf")
    the_port.call_batched(
        shard.sam, shard.fasta, native_vcf,
        cfg=the_port.HCConfig(pairhmm_engine="native"), device="cpu")
    with open(native_vcf) as handle:
        native = handle.read()
    shapes = [(len(job.reads), len(job.haps)) for job in jobs]
    expected = max(len(p.answers) for p in every)
    lost = sum(unanswered(p.answers, shapes, expected) for p in every)
    differing, records = 0, []
    for k, p in enumerate(every):
        with open(p.vcf) as handle:
            n, lines = vcf_regions(handle.read(), native,
                                   config["region_size"])
        differing += n
        records += [f"{os.path.basename(p.vcf)} {line}" for line in lines]
    out.update(unanswered_jobs=lost, vcf_regions_differing=differing,
               vcf_records_differing=records[:DIFF_LINES],
               passes_checked=len(every))
    with open(every[-1].vcf) as handle:
        truth, off_truth = truth_check(handle.read(), shard.truth,
                                       config["check"],
                                       config["region_size"])
    out["regions_past_limit"] += lost + differing + off_truth
    return {"check": {**out, "truth": truth},
            "missing": lost + differing + off_truth}


def _pass_row(p: Pass) -> Dict:
    s = p.end - p.start
    return {"s": s, "regions": p.regions, **p.work,
            "variants": p.variants, "gcells_per_s": p.work["cells"] / s / 1e9}


def _caller_spans(events) -> Dict[str, Dict[str, float]]:
    """The trace's ``hc.caller.*`` ranges: count and summed ms by name."""
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith("hc.caller."):
            row = out.setdefault(name, {"count": 0, "ms": 0.0})
            row["count"] += 1
            row["ms"] += float(e.get("dur", 0.0)) * 1e-3
    return out


def control(config, traffic, seeds, device):
    """Yields, per seed, the program's widest gap and the control's on
    the same sample of one warm pass's jobs."""
    the_port = port()
    stated(config, the_port.HCConfig())
    bg = rs.open_runner([device])
    recorder = Recorder(bg)
    limit = config["check"]["max_log10_gap"]
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="hcbench_shard_") as tmp:
            shard = shard_gen.make_shard(config, traffic, seed, tmp)
            for name in ("warm", "pass"):
                p = one_pass(the_port, shard, recorder,
                             os.path.join(tmp, name + ".vcf"), device)
        jobs = recorder.jobs()
        picked, regions, program = sample_and_check(
            seed, jobs, [job_work(job) for job in jobs],
            traffic["check_regions"], limit, device)
        pairs = reference.PairSet([regions[i] for i in picked])
        sizes = [len(jobs[i].reads) * len(jobs[i].haps) for i in picked]
        ctrl = reference.check(pairs, reference.control_answers(pairs,
                                                                device),
                               limit, device, sizes)
        yield {"seed": seed, "regions": len(picked), "pass_s":
               p.end - p.start, "program": program, "control": ctrl}
    bg.stop_prewarm()


def main(argv=None) -> int:
    from hcbench import run as hrun

    ap = argparse.ArgumentParser(description="the bfloat16 control of "
                                 "the shard cell's check, on the card")
    ap.add_argument("--workload", default="shard151.human")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = {w["name"]: w for w in hrun.load_spec()["workloads"]}[
        args.workload]
    hrun.set_environment()
    if not torch.cuda.is_available():
        print("caller_shard: no CUDA device is available", file=sys.stderr)
        return 2
    config = hrun.load_json("configs", cell["config"])
    traffic = hrun.load_json("traffic", cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        for row in control(config, traffic, seeds, "cuda:0"):
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
