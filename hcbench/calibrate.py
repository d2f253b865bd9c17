"""The readings that a cell's correctness limit is set from, on the card.

    python3 -m hcbench.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 4] [--out chiprun_out/x.jsonl]

In one process, so that set-up is paid once: for each of ``--seeds``, the
seed's pool through one warmed runner for a short window at the cell's own
load (its submits of 512 regions, 4 in flight), then the same check a
benchmark run makes (``drivers/runner_stream.py::sample`` and ``check``):
the program's widest log10 gap, the lower reading.  For each of
``--control-seeds``, the same sample of the seed's pool answered by the
control, the reference in bfloat16 in the program's place
(``reference.control_answers``): the upper reading.  One JSON line per
seed (``kind`` "program" or "control"), to standard output and to
``--out``.  The benchmark's own runs never run the control.  Runs only on
the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(config, traffic, seeds, control_seeds, seconds, devices):
    """Yields one dict per seed: the program's, then the control's."""
    import torch

    from hcbench import gen, reference
    from hcbench.drivers import runner_stream as rs

    limit = config["check"]["max_log10_gap"]
    bg = rs.open_runner(devices)
    for seed in seeds:
        t0 = time.perf_counter()
        pool = gen.make_pool(config, traffic, seed)
        jobs, work = rs.make_jobs(pool)
        stream = rs.Stream(bg, jobs, traffic)
        stream.run(submits=1)
        stream.reset()
        w0, w1 = stream.run(seconds=seconds)
        picked = rs.sample(seed, stream.submitted, work,
                           traffic["check_regions"])
        c0 = time.perf_counter()
        out = rs.check(pool, jobs, picked, limit, devices[0])
        yield {"kind": "program", "seed": seed, **out,
               "missing": stream.missing, "regions": len(picked),
               "window_s": w1 - w0, "check_s": time.perf_counter() - c0,
               "seed_s": time.perf_counter() - t0}
    bg.stop_prewarm()
    del bg
    if torch.device(devices[0]).type == "cuda":
        torch.cuda.empty_cache()
    for seed in control_seeds:
        pool = gen.make_pool(config, traffic, seed)
        _, work = rs.make_jobs(pool)
        picked = rs.sample(seed, range(len(pool)), work,
                           traffic["check_regions"])
        pairs = reference.PairSet([pool[i] for i in picked])
        c0 = time.perf_counter()
        answers = reference.control_answers(pairs, devices[0])
        sizes = [(pool[i][2].size - 1) * len(pool[i][3]) for i in picked]
        out = reference.check(pairs, answers, limit, devices[0], sizes)
        yield {"kind": "control", "seed": seed, **out,
               "regions": len(picked), "check_s": time.perf_counter() - c0}


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    from hcbench import run as hrun

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = {w["name"]: w for w in hrun.load_spec()["workloads"]}[
        args.workload]
    hrun.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
        return 2
    config = hrun.load_json("configs", cell["config"])
    traffic = hrun.load_json("traffic", cell["traffic"])
    out = open(args.out, "a") if args.out else None
    try:
        for row in readings(config, traffic, args.seeds, args.control_seeds,
                            args.seconds, [f"cuda:{i}" for i in
                                           range(cell["chips"])]):
            row["workload"] = args.workload
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
