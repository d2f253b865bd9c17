"""The multi-contig scale check on one card: a whole-genome-shaped fixture
(make_fixture --contigs N --length L, 30x) called with --stream-contigs
through the default cuda engine and through the native C++ engine, each in
its own CLI process; the two VCFs must be identical.

Prints one JSON line: the card's name and power limit, the fixture's
generation time and SAM size, per engine the process wall and the CLI's
--stats (wall_s, stages, device_stages_ms, kernel_launches,
cuda_max_memory_allocated_mb, peak_rss_mb), whether the VCFs are
identical, and check_truth's sensitivity of the cuda VCF.  Exits 1 when
the VCFs differ or a run fails.

Usage: python -m gatk_hc_tpu_torch.tools.scale_run [--length 15000000]
           [--contigs 4] [--dir DIR] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ._timing import nvidia_smi
from .check_truth import check

# seconds each process (fixture, each engine's run) may take
TIMEOUT_S = 3000
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _run(argv, timeout):
    """A module of the port in its own process -> (stdout, wall seconds).
    Raises when it fails."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{argv[0]} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--length", type=int, default=15_000_000,
                    help="bp per contig (default: 4 x 15 Mb = 60 Mb)")
    ap.add_argument("--contigs", type=int, default=4)
    ap.add_argument("--dir", default=None,
                    help="where the fixture and VCFs go (default: a new "
                    "temporary directory, removed)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cuda engine runs: the card (default) or "
                    "the CPU through the kernel's plain version (tiny sizes)")
    args = ap.parse_args(argv)

    smi = None
    if args.device == "cuda":
        smi = nvidia_smi()
    with tempfile.TemporaryDirectory(prefix="scale_run_") as scratch:
        work = args.dir or scratch
        os.makedirs(work, exist_ok=True)
        _out, gen_s = _run(
            ["gatk_hc_tpu_torch.tools.make_fixture", work, "--contigs",
             str(args.contigs), "--length", str(args.length), "--name",
             "scale"], TIMEOUT_S)
        sam = os.path.join(work, "scale.sam")
        row = {"nvidia_smi": smi, "contigs": args.contigs,
               "length": args.length, "depth": 30,
               "fixture_gen_s": round(gen_s, 1),
               "sam_mb": round(os.path.getsize(sam) / 1e6, 1)}
        vcfs = {}
        for engine in ("cuda", "native"):
            vcf = os.path.join(work, f"scale.{engine}.vcf")
            out, wall = _run(
                ["gatk_hc_tpu_torch.cli", "-I", sam, "-R",
                 os.path.join(work, "scale.fa"), "-O", vcf, "--pairhmm",
                 engine, "--stream-contigs", "--stats", "--device",
                 args.device], TIMEOUT_S)
            stats = json.loads(next(line for line in out.splitlines()
                                    if line.startswith("{")))
            row[engine] = {"process_wall_s": round(wall, 3), **stats}
            with open(vcf, "rb") as handle:
                vcfs[engine] = handle.read()
        row["identical"] = vcfs["cuda"] == vcfs["native"]
        row["check_truth"] = check(os.path.join(work, "scale.cuda.vcf"),
                                   os.path.join(work, "scale.truth.txt"))
    line = json.dumps(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as handle:
            handle.write(line + "\n")
    print(line)
    return 0 if row["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
