"""Open-ended e2e differential fuzzer over fresh simulated genomes.

Each iteration generates a seeded random fixture (make_fixture's simulator:
planted SNP/ins/del mix, base errors, soft clips; 1-3 contigs, uniform or
homopolymer-rich) and requires every arm to write the byte-identical VCF:

  python     — per-record data pipeline, Python assembler + SW, per-site
               genotyper (``call``; ``call_batched`` with every engine set
               to python on multi-contig fixtures): the semantic reference
  native     — columnar C++ parse, fused window prep/assembly/SW, batched
               genotyper (``call_batched``), the C++ PairHMM
  native_mt  — the same with host_threads=4 (worker pool, multi-threaded
               parse, genotype worker)
  stream, stream_mt — the same with stream_contigs (the contig switch, the
               per-contig slice parse, the parse-ahead thread)

and the device arms, each with its own runner for the life of the process
(kernels build and warm up once; the dispatch path controller carries its
state from seed to seed):

  cuda           — BackgroundRunner around TorchPairHMMRunner: the ppe
                   kernel (NR 4) through its unique-rows entry
  cuda_striped   — the same runner class with pallas_algo="striped"
  cuda_stream_mt — the cuda runner with stream_contigs and host_threads=4:
                   the contig switch with the dispatch worker in flight
  diag           — the anti-diagonal forward in PyTorch ops
  shardmap       — the sharded step over a 2x2 (data, hap) grid of slots
                   of the one device
  genotyper_cuda — the cuda runner and the CUDA genotype kernel (f64)

The device arms run on the card (``--device cuda``, the default: they raise
without one and never fall back) or, with ``--device cpu``, through the
kernels' plain PyTorch versions.  A divergence copies the fixture and every
arm's VCF to --keep-dir and exits 1.  Seed N draws the same genome as the
JAX package's tools/fuzz_differential.py; ``--length`` / ``--depth``
override the draw only to shrink a genome for a CPU run.  ``--read-length``
(default 151, not drawn) makes the reads longer: past the largest read
bucket (224) the ppe kernel runs in stripes with a carry, and the default
arms drop shardmap, whose bucketed planes raise there in both packages (an
explicit ``--arms shardmap`` runs it and fails with that error).

Usage: python -m gatk_hc_tpu_torch.tools.fuzz_differential --start 1000 --count 50
       python -m gatk_hc_tpu_torch.tools.fuzz_differential --minutes 30
       python -m gatk_hc_tpu_torch.tools.fuzz_differential --device cpu \\
           --length 3000 --depth 8 --arms python,native,cuda --count 2
       python -m gatk_hc_tpu_torch.tools.fuzz_differential --read-length 250
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from ..config import DEFAULT_CONFIG, HCConfig
from ..io.fasta import FastaRecord, write_fasta
from ..models.caller import call, call_batched
from .make_fixture import (READ_LEN, make_reference, plant_variants,
                           simulate_reads)

BASE_ARMS = ("python", "native", "native_mt", "stream", "stream_mt")
DEVICE_ARMS = ("cuda", "cuda_striped", "cuda_stream_mt", "diag", "shardmap",
               "genotyper_cuda")
ARMS = BASE_ARMS + DEVICE_ARMS


def draw(seed: int) -> dict:
    """The genome seed ``seed`` stands for: the JAX package's draw (length,
    depth, downsample mode, contigs, profile), in its order."""
    rng = random.Random(seed ^ 0x5EED)
    length = rng.choice((6_000, 12_000, 20_000))
    depth = rng.choice((8, 18, 30))
    mode = rng.choice(("first", "seeded"))
    n_contigs = rng.choice((1, 1, 2, 3))
    # homopolymer-rich / indel-heavy genomes are the classic PairHMM +
    # assembly stress profile
    profile = rng.choice(("uniform", "uniform", "homopolymer"))
    return {"length": length, "depth": depth, "mode": mode,
            "contigs": n_contigs, "profile": profile}


# arms that cannot run reads past the largest read bucket, and why
LONG_READ_DROPS = {
    "shardmap": "reads past the largest read bucket raise in both packages",
}


def default_arms(read_len: int = READ_LEN) -> tuple:
    """-> (the arms run when none are named, {dropped arm: why})."""
    if read_len <= max(DEFAULT_CONFIG.read_pad_buckets):
        return ARMS, {}
    return (tuple(a for a in ARMS if a not in LONG_READ_DROPS),
            dict(LONG_READ_DROPS))


def write_fixture(dirpath, seed, length, depth, n_contigs=1, profile="uniform",
                  read_len=READ_LEN):
    rng = random.Random(seed)
    records, all_lines = [], []
    for c in range(n_contigs):
        name = f"fuzz{c}"
        ref = make_reference(rng, length, profile=profile)
        alt, _truth, anchors = plant_variants(rng, ref, profile=profile)
        records.append(FastaRecord(name, "fuzz fixture", ref))
        all_lines.append(
            simulate_reads(rng, name, ref, alt, depth=depth, anchors=anchors,
                           read_len=read_len)
        )
    fa = os.path.join(dirpath, f"fuzz{seed}.fa")
    write_fasta(fa, records)
    sam = os.path.join(dirpath, f"fuzz{seed}.sam")
    with open(sam, "w") as handle:
        handle.write("@HD\tVN:1.6\tSO:coordinate\n")
        for rec in records:
            handle.write(f"@SQ\tSN:{rec.name}\tLN:{len(rec.seq)}\n")
        for lines in all_lines:
            for line in lines:
                handle.write(line + "\n")
    return sam, fa


def arm_config(arm: str, mode: str = DEFAULT_CONFIG.downsample_mode) -> HCConfig:
    """The config of ``arm`` with downsample ``mode``."""
    if arm == "python":
        return dataclasses.replace(
            DEFAULT_CONFIG, pairhmm_engine="native",
            assembler_engine="python", sw_engine="python",
            data_engine="python", downsample_mode=mode,
        )
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, pairhmm_engine="native",
        assembler_engine="native", sw_engine="native",
        data_engine="native", downsample_mode=mode,
    )
    return {
        "native": cfg,
        "native_mt": dataclasses.replace(cfg, host_threads=4),
        "stream": dataclasses.replace(cfg, stream_contigs=True),
        "stream_mt": dataclasses.replace(cfg, stream_contigs=True,
                                         host_threads=4),
        "cuda": dataclasses.replace(cfg, pairhmm_engine="cuda"),
        "cuda_striped": dataclasses.replace(cfg, pairhmm_engine="cuda",
                                            pallas_algo="striped"),
        "cuda_stream_mt": dataclasses.replace(
            cfg, pairhmm_engine="cuda", stream_contigs=True, host_threads=4),
        "diag": dataclasses.replace(cfg, pairhmm_engine="diag"),
        "shardmap": dataclasses.replace(cfg, pairhmm_engine="shardmap"),
        "genotyper_cuda": dataclasses.replace(cfg, pairhmm_engine="cuda",
                                              genotyper_engine="cuda"),
    }[arm]


class ArmRunners:
    """One PairHMM runner per device arm, built at the arm's first use on
    ``device`` ("cuda": the card, raising without one; "cpu": the kernels'
    plain versions) and reused for every later seed."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._runners: Dict[str, object] = {}

    def get(self, arm: str):
        if arm not in self._runners:
            cfg = arm_config(arm)
            if cfg.pairhmm_engine == "cuda":
                from ..ops.runner import BackgroundRunner

                runner = BackgroundRunner(cfg, device=self.device)
            elif arm == "diag":
                from ..ops.torch_runner import DiagPairHMMRunner

                runner = DiagPairHMMRunner(cfg, device=self.device)
            elif arm == "shardmap":
                from ..ops.torch_runner import local_devices
                from ..parallel.sharded_step import (ShardMapPairHMMRunner,
                                                     make_mesh)

                dev = local_devices(self.device)[0]
                runner = ShardMapPairHMMRunner(
                    cfg, mesh=make_mesh(4, hap_parallel=2, devices=[dev] * 4))
            else:
                raise ValueError(f"arm {arm!r} has no device runner")
            self._runners[arm] = runner
        return self._runners[arm]

    @staticmethod
    def counts(runner) -> dict:
        """(buckets by "r_padxc_pad", dispatch labels) the runner has
        counted so far."""
        inner = getattr(runner, "runner", runner)  # BackgroundRunner
        buckets = {f"{r}x{c}": n
                   for (r, c), n in getattr(inner, "bucket_counts", {}).items()}
        return {"buckets": buckets,
                "dispatch": dict(getattr(inner, "dispatch_counts", {}))}


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in sorted(after.items())
            if n - before.get(k, 0)}


def run_seed(seed: int, keep_dir: str, arms: Optional[Sequence[str]] = None,
             length: Optional[int] = None, depth: Optional[int] = None,
             device: str = "cuda", runners: Optional[ArmRunners] = None,
             workdir: Optional[str] = None,
             read_len: int = READ_LEN) -> dict:
    """Every arm of ``arms`` (default: ``default_arms(read_len)``) on
    seed's genome with reads of ``read_len`` bases; ok when each VCF equals
    the first arm's byte for byte.  A divergence copies the fixture and the
    VCFs to ``keep_dir``/seed<N>.  ``workdir``: where the fixture and VCFs
    are written and left (default: a temporary directory, removed).  ->
    the seed's JSON report, with each device arm's kernel launches, bucket
    shapes and dispatch labels, and the default arms it dropped."""
    from ..ops import pairhmm_torch as pt

    dropped = {}
    if arms is None:
        arms, dropped = default_arms(read_len)
    genome = draw(seed)
    genome["length"] = length or genome["length"]
    genome["depth"] = depth or genome["depth"]
    mode, n_contigs = genome["mode"], genome["contigs"]
    runners = runners or ArmRunners(device)
    tmp = workdir or tempfile.mkdtemp(prefix=f"fuzzdiff{seed}_")
    try:
        sam, fa = write_fixture(tmp, seed, genome["length"], genome["depth"],
                                n_contigs, genome["profile"], read_len)
        vcfs, seconds, device_runs = {}, {}, {}
        for arm in arms:
            out = os.path.join(tmp, f"{arm}.vcf")
            cfg = arm_config(arm, mode)
            t0 = time.perf_counter()
            if arm == "python" and n_contigs == 1:
                call(sam, fa, out, cfg)
            elif arm in DEVICE_ARMS:
                runner = runners.get(arm)
                before = ArmRunners.counts(runner)
                pt.reset_launches()
                call_batched(sam, fa, out, cfg, runner=runner,
                             device=runners.device)
                after = ArmRunners.counts(runner)
                device_runs[arm] = {
                    "kernel_launches": {k: n for k, n in pt.LAUNCHES.items()
                                        if n},
                    **{k: _delta(after[k], before[k]) for k in after},
                }
            else:
                call_batched(sam, fa, out, cfg)
            seconds[arm] = round(time.perf_counter() - t0, 3)
            with open(out, "rb") as handle:
                vcfs[arm] = handle.read()
        baseline = vcfs[arms[0]]
        differ = [arm for arm, data in vcfs.items() if data != baseline]
        if differ:
            os.makedirs(keep_dir, exist_ok=True)
            shutil.copytree(tmp, os.path.join(keep_dir, f"seed{seed}"),
                            dirs_exist_ok=True)
        report = {
            "seed": seed, **genome, "read_length": read_len,
            "variants": sum(1 for line in baseline.splitlines()
                            if not line.startswith(b"#")),
            "ok": not differ, "differ": differ, "arm_s": seconds,
            "device": device_runs,
        }
        if dropped:
            report["dropped"] = dropped
        return report
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, default=1000)
    ap.add_argument("--count", type=int, default=0, help="0 = unbounded")
    ap.add_argument("--minutes", type=float, default=0.0, help="0 = unbounded")
    ap.add_argument("--keep-dir", default=os.path.join(
        tempfile.gettempdir(), "fuzz_differential_failures"))
    ap.add_argument("--arms", default=None,
                    help="comma-separated arms; every VCF must equal the "
                    f"first one's (default: all, {','.join(ARMS)}; without "
                    "shardmap past the largest read bucket)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the device arms run: the card (default) or "
                    "the CPU through the kernels' plain versions")
    ap.add_argument("--length", type=int, default=None,
                    help="contig length instead of the seed's draw (to "
                    "shrink a genome for a CPU run)")
    ap.add_argument("--depth", type=int, default=None,
                    help="depth instead of the seed's draw")
    ap.add_argument("--read-length", type=int, default=READ_LEN,
                    help="bases per read (default %(default)s; not drawn, "
                    "so a seed's genome is the reference's)")
    args = ap.parse_args(argv)
    arms = None if args.arms is None else [a for a in args.arms.split(",")
                                           if a]
    names = default_arms(args.read_length)[0] if arms is None else arms
    unknown = sorted(set(names) - set(ARMS))
    if unknown or not names:
        ap.error(f"unknown arms {unknown}; choose from {','.join(ARMS)}")

    runners = ArmRunners(args.device)
    deadline = time.time() + args.minutes * 60 if args.minutes else None
    seed = args.start
    done = 0
    total_variants = 0
    while True:
        if args.count and done >= args.count:
            break
        if deadline and time.time() > deadline:
            break
        r = run_seed(seed, args.keep_dir, arms, args.length, args.depth,
                     args.device, runners, read_len=args.read_length)
        total_variants += r["variants"]
        print(json.dumps(r), flush=True)
        if not r["ok"]:
            print(json.dumps({"FAILED_SEED": seed, "kept": args.keep_dir}))
            sys.exit(1)
        seed += 1
        done += 1
    print(json.dumps({
        "fuzz_ok": True, "seeds": done, "first": args.start,
        "total_variants": total_variants, "arms": list(names),
        "read_length": args.read_length,
        "device": args.device,
    }))


if __name__ == "__main__":
    main()
