"""Record the shapes of the region jobs the port's caller makes, as a
traffic mix's data: ``hcbench/traffic/<mix>/<configuration>.jsonl``.

    python3 -m hcbench.record_shapes --read-length 151 \
        --out hcbench/traffic/wgs/wgs30x_2x151.jsonl [--length 2000000]

Generates the port's seeded fixture genome (``tools/make_fixture.py``:
``--length`` bp of random sequence, a diploid donor with a SNP, insertion
or deletion every 300-700 bp, reads at 30x of ``--read-length``) into a
temporary directory, then runs the port's ``models/caller.py::call_batched``
over it with a runner that keeps each job's haplotype and read lengths
(and answers a flat likelihood, so genotyping emits nothing).  One line a
region, in the order the caller submitted them (``gen.encode``).  Runs on
the CPU in about a minute; the benchmark's runs only read its output.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

from hcbench import gen


class ShapeRecorder:
    """A runner that keeps every job's sizes and answers -1 for each pair."""

    def __init__(self):
        self.lines = []

    def submit(self, jobs):
        for job in jobs:
            self.lines.append(gen.encode(
                [len(h) for h in job.haps],
                [len(seq) for seq, _qual in job.reads]))
            job.result = np.full((len(job.reads), len(job.haps)), -1.0)
        return jobs

    def drain(self, tokens):
        pass


def record(read_length: int, length: int, seed: int, tmp: str):
    """-> the recorded lines of one seeded fixture."""
    from gatk_hc_tpu_torch.config import HCConfig
    from gatk_hc_tpu_torch.models.caller import call_batched

    name = "shapes"
    subprocess.run(
        [sys.executable, "-m", "gatk_hc_tpu_torch.tools.make_fixture", tmp,
         "--length", str(length), "--read-length", str(read_length),
         "--seed", str(seed), "--name", name], check=True)
    rec = ShapeRecorder()
    call_batched(os.path.join(tmp, name + ".sam"),
                 os.path.join(tmp, name + ".fa"), None,
                 HCConfig(pairhmm_engine="cuda"), runner=rec, device="cpu")
    return rec.lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--read-length", type=int, required=True)
    ap.add_argument("--length", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="hcbench_shapes_") as tmp:
        lines = record(args.read_length, args.length, args.seed, tmp)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as handle:
        handle.writelines(line + "\n" for line in lines)
    print(f"{args.out}: {len(lines)} regions", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
