"""Host-pipeline profiler: run parse + window prep + assembly + genotyping
with a stub PairHMM runner and print the stage timers plus the native
per-phase assembly profile (hc_prof_read).

It isolates the host stages from the card: the stub fills every job with
a flat likelihood matrix, so genotyping runs its real batched code path
(on the host, or through the CUDA genotype kernel with ``--genotyper
cuda``) but emits no variants.  Set its wall beside a real run's to read
what share of the real wall the host stages take, and run ``--repeat 2``
to compare a run in a cold process with the same run in a warm one.

Usage:
  python -m gatk_hc_tpu_torch.tools.host_profile SAM FASTA
  python -m gatk_hc_tpu_torch.tools.host_profile SAM FASTA --threads 4 \\
      --stream --repeat 2 [--genotyper cuda [--device cpu]]
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np

from .. import native
from ..config import HCConfig
from ..models.caller import call_batched
from ..utils.logging import RunCounters, StageTimers


class StubRunner:
    """Fills each job with a flat log10 matrix; no device."""

    def submit(self, jobs):
        for job in jobs:
            job.result = np.full(
                (len(job.reads), len(job.haps)), -1.0, dtype=np.float64
            )
        return jobs

    def drain(self, tokens):
        pass


def profile(sam: str, fasta: str, threads: int = 1, stream: bool = False,
            repeat: int = 1, genotyper: str = "host", device: str = "cuda"):
    """``repeat`` runs of the host pipeline in this process -> one dict per
    run: wall_s, stages, host_profile (native.profile_read), regions,
    reads_parsed and the process's peak_rss_mb so far.  ``device`` is
    where ``genotyper="cuda"`` runs ("cuda" or "cpu")."""
    cfg = HCConfig(
        pairhmm_engine="cuda",  # irrelevant: the runner is the stub
        host_threads=threads,
        stream_contigs=stream,
        genotyper_engine=genotyper,
    )
    out = []
    for rep in range(repeat):
        native.profile_read(reset=True)
        timers = StageTimers()
        counters = RunCounters()
        t0 = time.perf_counter()
        call_batched(
            sam, fasta, None, cfg, runner=StubRunner(), timers=timers,
            counters=counters, device=device,
        )
        wall = time.perf_counter() - t0
        out.append({
            "rep": rep,
            "wall_s": round(wall, 2),
            "stages": {k: round(v, 2) for k, v in timers.summary().items()},
            "host_profile": {
                k: round(v, 2) if isinstance(v, float) else v
                for k, v in native.profile_read().items()
            },
            "regions": counters.regions,
            "reads_parsed": counters.reads_parsed,
            "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            // 1024,
        })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("sam")
    ap.add_argument("fasta")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--stream", action="store_true")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--genotyper", default="host", choices=("host", "cuda"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --genotyper cuda runs: the card (default) "
                    "or the CPU through the kernel's plain version")
    args = ap.parse_args(argv)
    for row in profile(args.sam, args.fasta, args.threads, args.stream,
                       args.repeat, args.genotyper, args.device):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
