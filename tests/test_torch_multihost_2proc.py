"""Real two-process runs of the port's multi-process pipeline: two OS
processes join a gloo process group over 127.0.0.1, call their contiguous
region blocks, all-gather the encoded variant records, and process 0
writes the VCF — byte-identical to the single-process result.  The
counterpart of tests/test_multihost_2proc.py (jax.distributed there).

Each process has its own ``communicate(timeout=...)``; a timeout kills
both and fails the test."""

import dataclasses
import json
import os
import random
import socket
import subprocess
import sys

import pytest

from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.parallel.multihost import run_multihost
from tests.test_multicontig import write_two_contig_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fixtures")
SAM = os.path.join(FIXTURES, "chrM.sam")
FASTA = os.path.join(FIXTURES, "chrM.fa")
GOLDEN = os.path.join(FIXTURES, "chrM.golden.vcf")
TIMEOUT_S = 300

# run_multihost in a worker process, as a library caller drives it: the
# engine from argv, the shardmap engine on a 2 x 2 grid of CPU slots, then
# the collective stats merge
_WORKER = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.parallel import multihost
from gatk_hc_tpu_torch.utils.logging import RunCounters, StageTimers

pid, engine, sam, fa, out, coord, lo, hi = sys.argv[1:]
pid, lo, hi = int(pid), int(lo), int(hi)
cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine=engine)
runner = None
if engine == "shardmap":
    from gatk_hc_tpu_torch.parallel.sharded_step import (
        ShardMapPairHMMRunner, make_mesh)
    runner = ShardMapPairHMMRunner(
        cfg, mesh=make_mesh(4, hap_parallel=2, devices=["cpu"] * 4))
counters, timers = RunCounters(), StageTimers()
try:
    results, merged = multihost.run_multihost(
        sam, fa, out if pid == 0 else None, cfg, coordinator=coord,
        num_processes=2, process_id=pid, counters=counters, timers=timers,
        region_filter=(lambda i: lo <= i < hi) if hi > lo else None,
        runner=runner, device="cpu")
    stats = multihost.gather_stats(counters, timers)
finally:
    multihost.shutdown()
print(json.dumps({"pid": pid, "own_regions": len(results),
                  "merged_variants": len(merged), "cluster": stats}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(argv_of):
    """Start two processes (``argv_of(pid)``), each with its own
    communicate timeout; kill both if either times out.  -> their stdouts,
    after asserting both exited 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(argv_of(pid), env=env, cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outputs = []
    try:
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                pytest.fail("multi-process worker timed out")
            outputs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, text[-3000:]
    return outputs


def worker_pair(engine, sam, fasta, out, lo=0, hi=0):
    coord = f"127.0.0.1:{_free_port()}"
    outputs = run_pair(lambda pid: [
        sys.executable, "-c", _WORKER, str(pid), engine, sam, fasta, out,
        coord, str(lo), str(hi)])
    return [json.loads(text.strip().splitlines()[-1]) for text in outputs]


def test_two_process_cli_matches_golden(tmp_path):
    """Two CLI processes (--num-processes 2 --process-id i --coordinator)
    with --pairhmm native: process 0's VCF is the golden file, and only
    process 0 prints --stats, with the merged cluster view over all 68
    regions, more than its own."""
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"p{pid}.vcf") for pid in (0, 1)]
    outputs = run_pair(lambda pid: [
        sys.executable, "-m", "gatk_hc_tpu_torch.cli", "-I", SAM, "-R",
        FASTA, "-O", outs[pid], "--pairhmm", "native", "--stats",
        "--num-processes", "2", "--process-id", str(pid),
        "--coordinator", coord])
    assert open(outs[0]).read() == open(GOLDEN).read()
    assert not os.path.exists(outs[1])
    stats = json.loads(next(line for line in outputs[0].splitlines()
                            if line.startswith("{")))
    cluster = stats["cluster"]
    assert cluster["processes"] == 2
    assert cluster["counters"]["regions"] == 68 > stats["regions"]
    assert cluster["counters"]["variants"] == 35
    assert set(cluster["timers_max"]) == set(cluster["timers"])
    assert not any(line.startswith("{") for line in outputs[1].splitlines())


def test_two_process_multicontig_matches_single(tmp_path):
    """A 2-contig input over 2 processes: the global (contig-major) region
    ids shard without dropping the later contig, and the gathered VCF is
    the single-process run's."""
    sam, fasta, _contigs = write_two_contig_fixture(tmp_path, random.Random(7))
    cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
    single = str(tmp_path / "single.vcf")
    run_multihost(sam, fasta, single, cfg)
    single_text = open(single).read()
    body = [line for line in single_text.splitlines()
            if not line.startswith("#")]
    assert {line.split("\t")[0] for line in body} == {"ctgA", "ctgB"}
    out = str(tmp_path / "mh.vcf")
    reports = worker_pair("native", sam, fasta, out)
    assert open(out).read() == single_text
    for report in reports:
        assert report["cluster"]["processes"] == 2
        assert report["merged_variants"] == len(body)


def test_two_process_shardmap_matches_single(tmp_path):
    """Each process runs the shardmap engine on a 2 x 2 grid of CPU slots
    over its part of regions 32-35 (two each): the gathered VCF is the
    single-process run of the same regions."""
    lo, hi = 32, 36
    cfg = dataclasses.replace(DEFAULT_CONFIG, pairhmm_engine="native")
    single = str(tmp_path / "single.vcf")
    run_multihost(SAM, FASTA, single, cfg,
                  region_filter=lambda i: lo <= i < hi)
    out = str(tmp_path / "mh.vcf")
    reports = worker_pair("shardmap", SAM, FASTA, out, lo, hi)
    assert open(out).read() == open(single).read()
    assert [r["own_regions"] for r in reports] == [2, 2]
    assert reports[0]["cluster"]["counters"]["regions"] == hi - lo
    assert reports[0]["merged_variants"] == 3
