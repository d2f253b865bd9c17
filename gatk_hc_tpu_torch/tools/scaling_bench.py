"""Scaling measurement: the production runner over several devices, the
sharded step over a device grid, and two region-sharded processes.

    python -m gatk_hc_tpu_torch.tools.scaling_bench [--counts 1,2,4,8]
        [--skip-dcn] [--sam S --fa F] [--device cuda|cpu]

The counterpart of tools/scaling_bench.py.  Prints ONE JSON line with
three sections:

* ``runner_weak_scaling``: ``TorchPairHMMRunner(devices=...)`` over the
  first N cards (``_runner_jobs``: 8 jobs a device, one group each through
  a small pair budget, launch units round-robin over the slots, as
  call_batched's runner places them); efficiency t(1) / t(N), best of 3;
* ``sharded_step_weak_scaling``: the sharded raw step
  (parallel/sharded_step.py) over an N x 1 (data, hap) grid at r_pad 32,
  c_pad 128, 256 reads a device x 8 haps; efficiency t(1) / t(N), mean of
  5 steps;
* ``dcn_2proc``: chrM through ``run_multihost`` with the native engine in
  one process, then in two processes joined by torch.distributed (gloo
  over loopback TCP); strong-scaling efficiency t1 / (2 t2).  torch is
  imported before each process's clock starts, as the reference's worker
  imports jax first.

A device count past the visible cards is not run: its row says
"not measured: N card(s) visible" (repeated slots of one card are not
scaling).  On one H100 only the count of 1 and the two processes measure
anything; with 8 cores the two processes' ceiling is 1.0 x 0.8.
``--device cpu`` runs N CPU slots (the plain versions, as
``entry.dryrun_multichip`` does on the CPU): that checks the mechanism, and
its times are the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

from . import _timing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COUNTS = (1, 2, 4, 8)


def slots(n: int, device: str):
    """N slots: N CPU slots, or the first N cards; None when fewer than N
    cards are visible."""
    import torch

    if device == "cpu":
        return [torch.device("cpu")] * n
    if n > torch.cuda.device_count():
        return None
    return [torch.device("cuda", i) for i in range(n)]


def not_measured() -> str:
    import torch

    return f"not measured: {torch.cuda.device_count()} card(s) visible"


def _runner_jobs(n_jobs: int, seed: int = 0):
    """The reference's jobs (tools/scaling_bench.py:56-72): per job a
    120 bp hap and its first 100 bp, and 16 reads of 24 bp from the hap."""
    from ..ops.runner import PairHMMJob

    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n_jobs):
        hap = np.frombuffer(
            np.array([65, 67, 71, 84], np.uint8)[rng.integers(0, 4, 120)]
            .tobytes(),
            np.uint8,
        )
        reads = [
            (hap[s : s + 24].copy(), np.full(24, ord("I"), np.uint8))
            for s in rng.integers(0, 90, 16)
        ]
        jobs.append(PairHMMJob(reads, [hap, hap[:100].copy()]))
    return jobs


def _efficiency(rows, per_device):
    """The section: the per-device size, seconds (or "not measured") per
    count, and t(smallest measured count) / t(N) where measured."""
    measured = {k: v for k, v in rows.items() if not isinstance(v, str)}
    out = {per_device[0]: per_device[1],
           "seconds": {str(k): v for k, v in rows.items()}}
    if measured:
        base = measured[min(measured)]
        out["efficiency"] = {str(k): base / v for k, v in measured.items()}
    return out


def bench_runner_weak_scaling(counts, device="cuda"):
    """The production runner, one group per job through a small pair
    budget, jobs per device fixed (weak scaling)."""
    from ..config import DEFAULT_CONFIG
    from ..ops.torch_runner import TorchPairHMMRunner

    jobs_per_dev = 8
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, read_pad_buckets=(32,), hap_pad_buckets=(128,),
        stripe_height=8, device_timeout_s=0.0,  # no failover in a benchmark
    )
    rows = {}
    for n_dev in counts:
        devs = slots(n_dev, device)
        if devs is None:
            rows[n_dev] = not_measured()
            continue
        runner = TorchPairHMMRunner(cfg, pair_budget=128, devices=devs)
        runner.READ_BUCKETS = (16,)
        runner.HAP_BUCKETS = (4,)
        runner.run(_runner_jobs(n_dev * jobs_per_dev))  # warm
        best = float("inf")
        for _ in range(3):
            jobs = _runner_jobs(n_dev * jobs_per_dev)
            t0 = time.perf_counter()
            runner.run(jobs)
            best = min(best, time.perf_counter() - t0)
        if len(set(runner.placements)) != min(n_dev, len(runner.placements)):
            raise AssertionError(f"{n_dev} slots: placements "
                                 f"{sorted(set(runner.placements))}")
        rows[n_dev] = best
    return _efficiency(rows, ("jobs_per_device", jobs_per_dev))


def bench_sharded_step_weak_scaling(counts, device="cuda"):
    """The sharded raw step over an N x 1 grid, reads per device fixed."""
    from ..config import DEFAULT_CONFIG
    from ..ops.pairhmm_torch import transition_constants
    from ..parallel.sharded_step import (
        HAP_SPECS, READ_SPECS, make_mesh, make_sharded_raw_step,
        shard_inputs,
    )

    trans = transition_constants(ord("I"), ord("+"))
    r_pad, c_pad = 32, 128
    reads_per_dev, n_haps = 256, 8
    rng = np.random.default_rng(0)
    rows = {}
    for n_dev in counts:
        devs = slots(n_dev, device)
        if devs is None:
            rows[n_dev] = not_measured()
            continue
        mesh = make_mesh(n_dev, hap_parallel=1, devices=devs)
        n_reads = reads_per_dev * n_dev
        hc = rng.integers(0, 4, (n_haps, c_pad)).astype(np.int32)
        hl = np.full(n_haps, c_pad - 8, np.int32)
        rc = np.stack(
            [hc[i % n_haps, 3 : 3 + r_pad] for i in range(n_reads)]
        ).astype(np.int32)
        q = np.float32(1e-4)
        omq = np.full((n_reads, r_pad), 1.0 - q, np.float32)
        q3 = np.full((n_reads, r_pad), q / 3.0, np.float32)
        rl = np.full(n_reads, r_pad - 2, np.int32)
        iy = (np.float32(2.0**120) / hl.astype(np.float32)).astype(np.float32)
        step = make_sharded_raw_step(mesh, trans, r_pad, c_pad,
                                     DEFAULT_CONFIG)
        args = shard_inputs(
            mesh, (rc, omq, q3, rl, hc, hl, iy), READ_SPECS + HAP_SPECS
        )
        step(*args)  # warm; the step reads its results back
        t0 = time.perf_counter()
        for _ in range(5):
            step(*args)
        rows[n_dev] = (time.perf_counter() - t0) / 5
    return _efficiency(rows, ("reads_per_device", reads_per_dev))


_DCN_WORKER = r"""
import sys, time, resource
sys.path.insert(0, {repo!r})
import torch  # before the clock, as the reference's worker imports jax
import dataclasses
from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
from gatk_hc_tpu_torch.parallel.multihost import run_multihost, shutdown
from gatk_hc_tpu_torch.utils.logging import StageTimers
cfg = dataclasses.replace(
    DEFAULT_CONFIG, pairhmm_engine="native", assembler_engine="native"
)
pid = int(sys.argv[1]); n = int(sys.argv[2])
timers = StageTimers()
t0 = time.perf_counter()
run_multihost({sam!r}, {fa!r}, None, cfg,
              coordinator={coord!r} if n > 1 else None,
              num_processes=n if n > 1 else None,
              process_id=pid if n > 1 else None,
              timers=timers)
wall = time.perf_counter() - t0
if n > 1:
    shutdown()
rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
print(f"WALL {{wall:.6f}} "
      f"PARSE {{timers.totals.get('parse', 0.0):.6f}} RSS {{rss_mb:.0f}}")
"""


def bench_dcn_2proc(sam=None, fa=None, timeout_s: float = 1800.0):
    """chrM (or ``sam`` / ``fa``) through run_multihost in one process,
    then in two joined over loopback -> the section's dict."""
    sam = sam or os.path.join(ROOT, "fixtures", "chrM.sam")
    fa = fa or os.path.join(ROOT, "fixtures", "chrM.fa")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def wall_of(outputs):
        for line in outputs.splitlines():
            if line.startswith("WALL "):
                parts = line.split()
                return {"wall": float(parts[1]), "parse": float(parts[3]),
                        "rss_mb": float(parts[5])}
        raise RuntimeError(outputs[-2000:])

    script = _DCN_WORKER.format(repo=ROOT, sam=sam, fa=fa, coord="")
    out = subprocess.run(
        [sys.executable, "-c", script, "0", "1"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout_s,
    )
    if out.returncode != 0:
        raise RuntimeError(out.stdout[-2000:] + out.stderr[-4000:])
    m1 = wall_of(out.stdout)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = _DCN_WORKER.format(repo=ROOT, sam=sam, fa=fa,
                                coord=f"127.0.0.1:{port}")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid), "2"], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    metrics = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise RuntimeError(stdout[-4000:])
            metrics.append(wall_of(stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t1 = m1["wall"]
    t2 = max(m["wall"] for m in metrics)
    n_cores = os.cpu_count() or 1
    expected = min(1.0, n_cores / 2) * 0.8
    measured = t1 / (2 * t2)
    return {
        "t_1proc_s": t1,
        "t_2proc_s": t2,
        # strong scaling over a fixed workload: ideal halves the time
        "efficiency": measured,
        "expected_efficiency": expected,
        "efficiency_vs_expected": measured / expected,
        # each process should parse about half the bytes of one process
        "parse_1proc_s": m1["parse"],
        "parse_2proc_s": [m["parse"] for m in metrics],
        "rss_1proc_mb": m1["rss_mb"],
        "rss_2proc_mb": [m["rss_mb"] for m in metrics],
        "note": f"{os.path.basename(sam)}, native engine, gloo over "
                f"loopback, {n_cores} core(s): the CPU-bound ceiling is "
                f"~{min(1.0, n_cores / 2):.2f} on this host",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", default=",".join(map(str, COUNTS)))
    ap.add_argument("--skip-dcn", action="store_true")
    ap.add_argument("--sam", default=None, help="two-process fixture SAM")
    ap.add_argument("--fa", default=None, help="two-process fixture FASTA")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    missing = _timing.card_missing(args.device)
    if missing:
        print(f"scaling_bench: {missing}", file=sys.stderr)
        return 1
    import torch

    counts = tuple(int(x) for x in args.counts.split(","))
    on_card = args.device == "cuda"
    result = {
        "device": args.device,
        "nvidia_smi": _timing.nvidia_smi() if on_card else None,
        "visible_cards": torch.cuda.device_count() if on_card else 0,
        "runner_weak_scaling": bench_runner_weak_scaling(counts, args.device),
        "sharded_step_weak_scaling": bench_sharded_step_weak_scaling(
            counts, args.device),
    }
    if not args.skip_dcn:
        result["dcn_2proc"] = bench_dcn_2proc(args.sam, args.fa)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
