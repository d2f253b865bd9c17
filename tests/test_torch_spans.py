"""The runner's spans and the stages they feed, on the CPU runner: the
pack's parts per group, the dispatch thread's CPU time, the launch
enqueue; the spans in a profile of every thread, and none entered while
no profile records; the CLI's whole-run profile; the build's
init_profile keys."""

import contextlib
import dataclasses
import io
import json
import random

import pytest
import torch

from gatk_hc_tpu_torch import cli
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.ops.runner import (
    STAGES, BackgroundRunner, TorchPairHMMRunner)
from gatk_hc_tpu_torch.utils import logging as hc_logging
from gatk_hc_tpu_torch.utils.logging import span
from tests.test_torch_e2e import FASTA, SAM
from tests.test_torch_runner import (  # noqa: F401 - autouse
    TINY_CFG, make_job, one_torch_thread)

PARTS = ("unique_rows", "encode", "pack_cpu")
# configurations of every encoding and launch path: planes (the adaptive
# default below 32 groups), nib, raw packed, fused, striped
PATHS = {
    "planes": {},
    "nib": {"dispatch_mode": "packed"},
    "packed": {"dispatch_mode": "packed", "packed_nib": False},
    "fused": {"dispatch_mode": "packed", "fuse_groups": 2,
              "fuse_auto": False},
    "striped": {"pallas_algo": "striped", "stripe_height": 8},
}


def small_runner(**changes):
    """The CPU runner at tiny buckets, groups of at most 24 pairs."""
    runner = TorchPairHMMRunner(dataclasses.replace(TINY_CFG, **changes),
                                device="cpu", pair_budget=24)
    runner.READ_BUCKETS = (8, 16)
    runner.HAP_BUCKETS = (8, 16)
    return runner


def every_thread():
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def run_jobs(runner, seed=7, submits=2):
    rng = random.Random(seed)
    handles = []
    for _ in range(submits):
        jobs = [make_job(rng, rng.randint(1, 5), rng.randint(1, 3))
                for _ in range(6)]
        handles.append(runner.submit(jobs))
    runner.drain(handles)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_stages_hold_the_pack_parts_per_group(path):
    runner = small_runner(**PATHS[path])
    run_jobs(runner)
    ms = runner.stage_ms
    groups = len(ms["pack"])
    assert groups > 2
    assert all(len(ms[s]) == groups for s in PARTS)
    # one launch stage per launch unit: a group, or k fused groups
    assert len(ms["launch"]) == len(ms["h2d"]) == len(ms["kernel"])
    assert (len(ms["launch"]) < groups) == (path == "fused")
    for pack, unique, encode, cpu in zip(*(ms[s] for s in ("pack",) + PARTS)):
        assert 0 < unique and 0 < encode and unique + encode <= pack
        assert 0 <= cpu <= pack + 0.05  # two clocks: a small tolerance
    assert all(v > 0 for v in ms["launch"])
    med = runner.stage_medians()
    assert set(STAGES) - {"d2h"} <= set(med) and set(PARTS) <= set(
        med["sum_ms"])


def spans_of(path):
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("name", "")).startswith("hc.")]


def inside(child, parent):
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
            + 1e-3)


def test_a_profile_of_every_thread_holds_the_workers_spans(tmp_path):
    runner = small_runner(dispatch_mode="packed")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=every_thread()) as prof:
        run_jobs(runner)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = spans_of(path)
    named = lambda n: [e for e in spans if e["name"] == n]  # noqa: E731
    packs, batches = named("hc.runner.pack"), named("hc.runner.batch")
    assert len(packs) == len(runner.stage_ms["pack"])
    assert len(batches) == 2
    worker = {e["tid"] for e in batches}
    assert len(worker) == 1 and {e["tid"] for e in packs} == worker
    # the caller's steps are on the thread that drained
    caller = {e["tid"] for e in named("hc.runner.finalize")}
    assert caller and not caller & worker
    assert {e["tid"] for e in named("hc.runner.wait")} == caller
    for pack in packs:
        kids = [e for e in spans if e is not pack and inside(e, pack)]
        names = sorted(e["name"] for e in kids)
        assert names == ["hc.runner.pack.encode", "hc.runner.pack.encode.nib",
                         "hc.runner.pack.unique_rows"]
        assert any(inside(pack, b) for b in batches)
    for name in ("hc.runner.plan", "hc.runner.launch", "hc.runner.read_back"):
        assert named(name) and {e["tid"] for e in named(name)} == worker


def test_no_range_without_a_profile(monkeypatch):
    """A span enters a record_function range only while a profile
    records; it times itself either way."""
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    sink = []
    with span("runner.x", sink) as s:
        pass
    run_jobs(small_runner(), submits=1)
    assert entered == [] and sink == [s.seconds * 1e3]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=every_thread()):
        with span("runner.x"):
            pass
        run_jobs(small_runner(), submits=1)
    assert entered[0] == "hc.runner.x" and "hc.runner.pack" in entered


def test_cli_profile_holds_the_runners_spans(tmp_path, monkeypatch):
    """GATK_HC_TPU_TORCH_PROFILE_DIR: the whole-run trace holds the build
    thread's and the dispatch worker's spans, and the VCF is the host
    engine's."""
    monkeypatch.setattr(hc_logging, "PROFILE_DIR", str(tmp_path / "prof"))
    args = ["-I", SAM, "-R", FASTA, "-L", "chrM:0-1500"]
    out, want = tmp_path / "cuda.vcf", tmp_path / "native.vcf"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(args + ["-O", str(out), "--device", "cpu"]) == 0
    names = {e["name"] for e in spans_of(tmp_path / "prof" / "trace.json")}
    assert {"hc.build.runner", "hc.build.prewarm", "hc.runner.batch",
            "hc.runner.pack", "hc.runner.pack.unique_rows",
            "hc.runner.finalize"} <= names
    monkeypatch.setattr(hc_logging, "PROFILE_DIR", None)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(args + ["-O", str(want), "--pairhmm", "native"]) == 0
    assert out.read_text() == want.read_text()


def test_the_build_keeps_its_init_profile_keys():
    """The build spans feed the keys the build had, and no new one."""
    bg = BackgroundRunner(DEFAULT_CONFIG, device="cpu")
    run_jobs(bg.runner, submits=1)
    assert set(bg.runner.init_profile) == {
        "build_start_at_age_s", "torch_preloaded", "torch_import_s",
        "runner_ctor_s", "prewarm_kickoff_s", "first_submit_at_age_s",
        "first_submit_batch_s", "first_drain_fetch_s"}
    assert all(v >= 0 for k, v in bg.runner.init_profile.items()
               if k != "torch_preloaded")
