"""Device time of one ppe launch unit on each shipping path, for one or
more checkouts, in turns.

    python -m gatk_hc_tpu_torch.tools.front_compare \\
        [--tree parent=DIR] [--tree change=.] [--kernel ppe|striped] \\
        [--reps 10] [--out FILE]

Each tree runs in its own process (this file, run by path, with the tree
first on the import path), trees forward then backward (parent, change,
change, parent), on the same seeded groups: chip_smoke.py::main_group of
this checkout (65,536 pairs, 16,384 unique reads, 1,024 unique haps) at
every default bucket shape, packed by the tree's own runner in each
encoding (planes, packed, nib) and shipped to the card.  A launch unit is
what the tree's runner launches for such a group: the ppe kernel's
unique-rows entry where the tree has it (ops/pairhmm_front.py), else the
runner's gather or prologue (``_prologue``) followed by the pair-minor
ppe launch.  Per (tree, shape, encoding) one JSON line: median ms of the
unit (CUDA events, warmed up), of the front and the ppe launch alone
where they are separate, the device-memory peak of one unit above what
was allocated before it, and a digest of the raw results; then one
summary line per (shape, encoding) with every tree's times.

``--kernel striped`` times the striped kernel's pair-major entry
(``pairhmm_striped.striped_forward``) instead, at H 8, 16 and 32, on
chip_smoke.py::make_pairs's seeded pairs (B = the runner's group size) at
REPORT_SHAPE and LONG_SHAPE, one line per (tree, shape, H) with its
median ms as ``unit_ms`` and ``path`` ``pair_major_striped<H>``: what a
change to the kernel's shared code costs the entry it did not target.

Results must be bit-equal across trees, else it exits 1.  The card's name and power
limit (nvidia-smi) lead.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PATHS = ("planes", "packed", "nib")
_SOURCE = {"planes": "planes", "packed": "packed", "packednib": "nib"}


def _chip_smoke():
    """chip_smoke.py of this checkout (its seeded groups and timers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def striped_worker(tree: str, reps: int, seed: int) -> None:
    """One tree's pair-major striped kernel, one JSON line per (shape,
    H)."""
    sys.path.insert(0, tree)
    import numpy as np

    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.ops import _kernels
    from gatk_hc_tpu_torch.ops import pairhmm_striped as ps
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
    from gatk_hc_tpu_torch.ops.torch_runner import TorchPairHMMRunner

    cs = _chip_smoke()
    _kernels.build_all()
    trans = pt.transition_constants(DEFAULT_CONFIG.gop_char,
                                    DEFAULT_CONFIG.gcp_char)
    B = TorchPairHMMRunner.GROUP_PAIRS
    rng = np.random.default_rng(seed)
    for r_pad, c_pad in (cs.REPORT_SHAPE, cs.LONG_SHAPE):
        args = cs.striped_inputs(*cs.make_pairs(rng, B, r_pad, c_pad),
                                 "cuda")
        for h in ps.KERNEL_STRIPES:
            def unit():
                return ps.striped_forward(*args, trans, h)

            out = unit()
            row = {"tree": tree, "r_pad": r_pad, "c_pad": c_pad,
                   "path": f"pair_major_striped{h}", "B": B,
                   "digest": hashlib.sha1(
                       out.cpu().numpy().tobytes()).hexdigest(),
                   "unit_ms": cs.time_ms(unit, reps)}
            print(json.dumps(row), flush=True)


def worker(tree: str, reps: int, seed: int) -> None:
    """One tree's measurements, one JSON line per (shape, encoding)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.ops import _kernels
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
    from gatk_hc_tpu_torch.ops.torch_runner import TorchPairHMMRunner

    try:
        from gatk_hc_tpu_torch.ops import pairhmm_front as pf
    except ImportError:  # a tree before the unique-rows entry
        pf = None
    cs = _chip_smoke()
    _kernels.build_all()
    runner = TorchPairHMMRunner(DEFAULT_CONFIG, device="cuda")
    trans, tab, nr = runner.trans, runner._ppe_tab, DEFAULT_CONFIG.ppe_rows
    rng = np.random.default_rng(seed)

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**20

    for r_pad in DEFAULT_CONFIG.read_pad_buckets:
        for c_pad in DEFAULT_CONFIG.hap_pad_buckets:
            u = cs.main_group(rng, r_pad, c_pad)
            for path in PATHS:
                payload = cs.pack_group(runner, path, u)
                views = payload.buf.ship(runner.device)
                row = {"tree": tree, "r_pad": r_pad, "c_pad": c_pad,
                       "path": path, "B": payload.total}
                if pf is not None:
                    seg = pf.Segment(tuple(views), payload.dims,
                                     payload.total)

                    def unit():
                        return pf.ppe_forward_unique(
                            _SOURCE[payload.path], [seg], tab, trans, nr)
                else:
                    def front():
                        return runner._prologue(payload, views, None, 0)

                    def unit():
                        return pt.ppe_forward(*front(), trans, nr)

                    args = front()
                    row["front_ms"] = cs.time_ms(front, reps)
                    row["ppe_ms"] = cs.time_ms(
                        lambda: pt.ppe_forward(*args, trans, nr), reps)
                    del args
                out, row["peak_mb"] = peak_mb(unit)
                row["digest"] = hashlib.sha1(
                    out.cpu().numpy().tobytes()).hexdigest()
                del out
                row["unit_ms"] = cs.time_ms(unit, reps)
                print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        metavar="LABEL=DIR",
                        help="a checkout to measure (default: change=.)")
    parser.add_argument("--kernel", default="ppe", choices=("ppe", "striped"))
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--seed", type=int, default=20261017)
    parser.add_argument("--out", default=None, help="also write the lines here")
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        run = striped_worker if args.kernel == "striped" else worker
        run(args.worker, args.reps, args.seed)
        return 0
    # here, not at the top: a tree's worker runs this file by path, outside
    # the package
    from ._timing import nvidia_smi

    trees = [t.split("=", 1) for t in (args.tree or ["change=."])]
    trees = [(label, os.path.abspath(path)) for label, path in trees]
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit({"nvidia_smi": nvidia_smi()})
    rows = {}
    for rnd, (label, tree) in enumerate(trees + trees[::-1]):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--kernel", args.kernel, "--reps", str(args.reps),
             "--seed", str(args.seed)],
            cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"worker for {label} exited {proc.returncode}:"
                               f"\n{proc.stdout}\n{proc.stderr}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                row.update(tree=label, round=rnd)
                emit(row)
                key = (row["r_pad"], row["c_pad"], row["path"])
                rows.setdefault(key, []).append(row)
    bad = []
    for (r_pad, c_pad, path), done in rows.items():
        summary = {"summary": True, "r_pad": r_pad, "c_pad": c_pad,
                   "path": path,
                   "bit_equal": len({r["digest"] for r in done}) == 1}
        for label, _tree in trees:
            mine = [r for r in done if r["tree"] == label]
            for key in ("unit_ms", "front_ms", "ppe_ms", "peak_mb"):
                vals = [r[key] for r in mine if key in r]
                if vals:
                    summary[f"{label}_{key}"] = vals
                    summary[f"{label}_{key}_median"] = statistics.median(vals)
        emit(summary)
        if not summary["bit_equal"]:
            bad.append((r_pad, c_pad, path))
    if sink:
        sink.close()
    if bad:
        print(f"front_compare: results differ across trees at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
