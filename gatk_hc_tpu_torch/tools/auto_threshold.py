"""Walls of the native C++ engine against the cuda engine by input size:
the measurement behind config.AUTO_NATIVE_MAX_SAM_BYTES (--pairhmm auto).

    python -m gatk_hc_tpu_torch.tools.auto_threshold \\
        [--lengths 50000,100000,250000,500000,1000000,2000000,4000000,8000000] \\
        [--rounds 3] [--out auto_threshold.jsonl]

Inputs: the chrM fixture and one contig at 30x per length
(tools/make_fixture.py --length L --name chr20sim, default seed, generated
in parallel into a temporary directory).  Each run is its own process
(``python -m gatk_hc_tpu_torch.cli ... --pairhmm {native,cuda} --stats``),
as a user runs the CLI, so the process wall counts interpreter start,
imports, the CUDA context and the kernels' load.  One cuda run on chrM
first builds the kernels (not recorded).  Per round every size runs
native and cuda, native first in even rounds and cuda first in odd ones.
Every cuda VCF must equal the native one of its size.  One JSON line per
run (SAM bytes, engine, process wall, the CLI's wall_s), then one summary
line per size (median process walls, the winner), then the smallest SAM
size from which cuda wins at every larger size too.  The card's name and
power limit (nvidia-smi) lead.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from ._timing import nvidia_smi

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENGINES = ("native", "cuda")


def cli(sam, fasta, out, engine, timeout=1800):
    """One CLI process -> (process wall s, --stats JSON)."""
    cmd = [sys.executable, "-m", "gatk_hc_tpu_torch.cli", "-I", sam,
           "-R", fasta, "-O", out, "--pairhmm", engine, "--stats"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{proc.stderr}")
    return wall, json.loads(proc.stdout.splitlines()[0])


def make_inputs(tmp, lengths):
    """[(label, sam, fasta)]: chrM, then one generated contig per length
    (the generators run in parallel)."""
    fixtures = os.path.join(ROOT, "fixtures")
    inputs = [("chrM", os.path.join(fixtures, "chrM.sam"),
               os.path.join(fixtures, "chrM.fa"))]
    procs = []
    for length in lengths:
        out = os.path.join(tmp, f"len{length}")
        procs.append((length, out, subprocess.Popen(
            [sys.executable, "-m", "gatk_hc_tpu_torch.tools.make_fixture",
             out, "--length", str(length), "--name", "chr20sim"],
            cwd=ROOT, stdout=subprocess.DEVNULL)))
    for length, out, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"make_fixture --length {length} failed")
        inputs.append((str(length), os.path.join(out, "chr20sim.sam"),
                       os.path.join(out, "chr20sim.fa")))
    return inputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lengths",
                    default="50000,100000,250000,500000,1000000,2000000,"
                    "4000000,8000000")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    import torch

    if not torch.cuda.is_available():
        print("auto_threshold: no CUDA device", file=sys.stderr)
        return 1
    emit({"nvidia_smi": nvidia_smi()})
    lengths = [int(x) for x in args.lengths.split(",") if x]
    walls = {}
    with tempfile.TemporaryDirectory(prefix="auto_threshold_") as tmp:
        t0 = time.perf_counter()
        inputs = make_inputs(tmp, lengths)
        emit({"fixtures_s": round(time.perf_counter() - t0, 1)})
        _label, sam, fasta = inputs[0]
        cli(sam, fasta, os.path.join(tmp, "warm.vcf"), "cuda")  # build
        for rnd in range(args.rounds):
            order = ENGINES if rnd % 2 == 0 else ENGINES[::-1]
            for label, sam, fasta in inputs:
                vcfs = {}
                for engine in order:
                    out = os.path.join(tmp, f"{label}.{engine}.vcf")
                    wall, stats = cli(sam, fasta, out, engine)
                    with open(out, "rb") as handle:
                        vcfs[engine] = handle.read()
                    walls.setdefault((label, engine), []).append(wall)
                    emit({"round": rnd, "input": label,
                          "sam_bytes": os.path.getsize(sam),
                          "engine": engine, "process_wall_s": round(wall, 3),
                          "wall_s": stats["wall_s"],
                          "regions": stats["regions"],
                          "variants": stats["variants"]})
                if vcfs["native"] != vcfs["cuda"]:
                    raise AssertionError(f"{label}: cuda VCF differs from "
                                         "native")
        sizes = {label: os.path.getsize(sam) for label, sam, _f in inputs}
    summary = []
    for label, _sam, _fasta in inputs:
        med = {e: statistics.median(walls[(label, e)]) for e in ENGINES}
        row = {"input": label, "sam_bytes": sizes[label],
               **{f"{e}_median_s": round(med[e], 3) for e in ENGINES},
               **{f"{e}_s": [round(w, 3) for w in walls[(label, e)]]
                  for e in ENGINES},
               "cuda_wins": med["cuda"] < med["native"]}
        summary.append(row)
        emit(row)
    # the smallest size from which cuda wins at it and every larger one
    ordered = sorted(summary, key=lambda r: r["sam_bytes"])
    from_bytes = None
    for i, row in enumerate(ordered):
        if all(r["cuda_wins"] for r in ordered[i:]):
            from_bytes = row["sam_bytes"]
            break
    emit({"cuda_wins_from_sam_bytes": from_bytes})
    if sink is not None:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
