"""Walls and stage times of the 2 Mb / 30x contig through each dispatch mode
of the CLI, for one or more checkouts, in turns.

    python -m gatk_hc_tpu_torch.tools.dispatch_modes \\
        [--tree parent=DIR] [--tree change=.] [--rounds 2] \\
        [--out dispatch_modes.jsonl]

Each run is its own process (``python -m gatk_hc_tpu_torch.cli ...
--stats`` from the tree's root), so a tree measures its own code.  A tree
first runs chrM once per kernel (builds its kernels; not recorded).  Then,
per round, every tree runs every mode its CLI knows — trees and modes
forward in even rounds, backward in odd ones (parent, change, change,
parent) — so that a drift of the card or the host falls on both.  Every
VCF is compared with the first tree's native C++ engine's.  One JSON line
per run (wall, launches, dispatch_profile, init_profile, the runner's
stage sums and medians, device busy = the sum of the device stages (H2D,
kernel, D2H, and the gather of trees whose kernels do not read the
unique rows themselves) / wall, and the device-memory peak), then one
summary line per (tree, mode) with every stage its runs report; the
card's name and power limit (nvidia-smi) lead.  Needs a CUDA card.

The counterpart of tools/dispatch_ab.py, which replays the 2 Mb fixture's
PairHMM jobs through forced planes, forced packed and adaptive dispatch in
ONE process.  This tool runs each mode as its own CLI process instead, so
each wall holds the whole run (parse, assembly, genotyping) of its mode;
tools/sustained_sweep.py and tools/bench.py A/B the encodings in one
process on the bench workload.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

from ._timing import nvidia_smi

# mode -> CLI flags; "default" is the CLI with no dispatch flag
MODES = {
    "default": [],
    "planes": ["--dispatch-mode", "planes"],
    "packed": ["--dispatch-mode", "packed", "--no-packed-nib"],
    "nib": ["--dispatch-mode", "packed"],
    "fused": ["--dispatch-mode", "packed", "--no-fuse-auto"],
    "striped": ["--pallas-algo", "striped"],
}
# the runner's host stages: every other stage a tree reports is the card's
HOST_STAGES = ("submit", "pack", "unique_rows", "encode", "pack_cpu",
               "launch", "finalize")


def cli(tree, argv, timeout=1800):
    """One CLI process from ``tree`` -> its --stats JSON (None without)."""
    env = dict(os.environ, PYTHONPATH=tree)
    proc = subprocess.run(
        [sys.executable, "-m", "gatk_hc_tpu_torch.cli", *argv],
        cwd=tree, env=env, capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"cli in {tree} {argv} exited {proc.returncode}:"
                           f"\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    return None


def knows_dispatch_flags(tree) -> bool:
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run(
        [sys.executable, "-m", "gatk_hc_tpu_torch.cli", "--help"],
        cwd=tree, env=env, capture_output=True, text=True, timeout=300,
    ).stdout
    return "--dispatch-mode" in out


def record(tree_label, mode, stats, vcf_bytes, want):
    stages = stats.get("device_stages_ms") or {}
    sums = stages.get("sum_ms", {})
    busy_ms = sum(v for s, v in sums.items() if s not in HOST_STAGES)
    return {
        "tree": tree_label, "mode": mode, "wall_s": stats["wall_s"],
        "identical_to_native": vcf_bytes == want,
        "kernel_launches": stats.get("kernel_launches"),
        "dispatch_profile": stats.get("dispatch_profile"),
        "init_profile": stats.get("init_profile"),
        "stage_sum_ms": sums,
        "stage_median_ms": {k: v for k, v in stages.items()
                            if k not in ("sum_ms", "device")},
        "groups": stages.get("groups"),
        "device_busy_frac": busy_ms / (1e3 * stats["wall_s"]),
        "host_stages_s": stats.get("stages"),
        "cuda_max_memory_allocated_mb": stats.get(
            "cuda_max_memory_allocated_mb"),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        metavar="LABEL=DIR",
                        help="a checkout to measure (default: change=.)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--length", type=int, default=2_000_000)
    parser.add_argument("--modes", default=",".join(MODES),
                        help="comma-separated subset of " + ",".join(MODES))
    parser.add_argument("--out", default=None, help="also write the lines here")
    args = parser.parse_args(argv)
    trees = [t.split("=", 1) for t in (args.tree or ["change=."])]
    trees = [(label, os.path.abspath(path)) for label, path in trees]
    modes = args.modes.split(",")
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit({"nvidia_smi": nvidia_smi()})
    with tempfile.TemporaryDirectory(prefix="dispatch_modes_") as tmp:
        first = trees[0][1]
        fix = os.path.join(tmp, "chr20sim")
        subprocess.run(
            [sys.executable, "-m", "gatk_hc_tpu_torch.tools.make_fixture",
             fix, "--length", str(args.length), "--name", "chr20sim"],
            cwd=first, env=dict(os.environ, PYTHONPATH=first), check=True,
            capture_output=True, timeout=1800,
        )
        base = ["-I", os.path.join(fix, "chr20sim.sam"),
                "-R", os.path.join(fix, "chr20sim.fa")]
        native_vcf = os.path.join(tmp, "native.vcf")
        native = cli(first, base + ["-O", native_vcf, "--pairhmm", "native",
                                    "--stats"])
        with open(native_vcf, "rb") as handle:
            want = handle.read()
        emit({"tree": trees[0][0], "mode": "native",
              "wall_s": native["wall_s"]})
        plan = []
        for label, tree in trees:
            known = [m for m in modes
                     if knows_dispatch_flags(tree) or not MODES[m]
                     or m == "striped"]
            for flags in ([], MODES["striped"]):  # build the kernels
                cli(tree, ["-I", os.path.join(tree, "fixtures", "chrM.sam"),
                           "-R", os.path.join(tree, "fixtures", "chrM.fa"),
                           "-O", os.path.join(tmp, "warm.vcf")] + flags)
            plan.append((label, tree, known))
        runs = {}
        for rnd in range(args.rounds):
            order = plan if rnd % 2 == 0 else plan[::-1]
            for label, tree, known in order:
                for mode in (known if rnd % 2 == 0 else known[::-1]):
                    vcf = os.path.join(tmp, f"{label}.{mode}.{rnd}.vcf")
                    load = os.getloadavg()[0]  # the host's load before it
                    stats = cli(tree, base + ["-O", vcf, "--stats"]
                                + MODES[mode])
                    with open(vcf, "rb") as handle:
                        row = record(label, mode, stats, handle.read(), want)
                    row["round"], row["loadavg_1m_before"] = rnd, load
                    emit(row)
                    runs.setdefault((label, mode), []).append(row)
    for (label, mode), rows in runs.items():
        sums = [r["stage_sum_ms"] for r in rows]
        emit({
            "summary": True, "tree": label, "mode": mode,
            "wall_s": [r["wall_s"] for r in rows],
            "wall_s_mean": statistics.mean(r["wall_s"] for r in rows),
            "identical_to_native": all(r["identical_to_native"] for r in rows),
            "device_busy_frac": [round(r["device_busy_frac"], 4) for r in rows],
            **{f"{s}_sum_ms": [x.get(s) for x in sums]
               for s in dict.fromkeys(s for x in sums for s in x)},
            "pack_median_ms": [r["stage_median_ms"].get("pack") for r in rows],
            "cuda_max_memory_allocated_mb": [
                r["cuda_max_memory_allocated_mb"] for r in rows],
            "dispatch_profile": rows[0]["dispatch_profile"],
        })
    if sink:
        sink.close()
    bad = [k for k, rows in runs.items()
           if not all(r["identical_to_native"] for r in rows)]
    if bad:
        print(f"dispatch_modes: VCF differs in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
