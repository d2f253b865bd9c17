"""Kernel-only PairHMM microbenchmark: device-resident inputs, no host link.

    python -m gatk_hc_tpu_torch.tools.kernel_bench [--pairs 16384]
        [--rpad 160] [--rlen 151] [--cpad 448] [--clen 415]
        [--algos ppe,striped] [--ppe-rows 1,2,4,8] [--stripes 8,16,32]
        [--iters 10] [--device cuda|cpu]

The counterpart of tools/kernel_bench.py.  The inputs are the reference's
(seed 0, ``make_inputs``): random base codes, q = 1e-4 on every read base,
every pair rlen / clen long and INITIAL / clen as init_y.  Each instance —
the ppe kernel's pair-minor entry at NR 1, 2, 4, 8 (``ppe_forward``) and
the striped kernel at H 8, 16, 32 (``striped_forward``), each counted in
the launch counters — runs ``--iters`` times back to back between two CUDA
events (``_timing.time_ms_queued``) after a warm-up; the reference reads
the result back through its relay instead.  Every instance must give the
same result bit for bit.

Prints one JSON line: the card's name and power limit, and per instance ms
per call, true and padded cells/s, the operations / bytes bound
(``_timing.ppe_bound``) and the share of it the launch reaches.
``tools/bench.py`` takes its kernel-only number from ``measure_kernel``.
With ``--device cpu`` the plain PyTorch versions run on CPU tensors, timed
by the host clock: what the tests run, at tiny sizes; those times are not
the card's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import _timing

PPE_ROWS = (1, 2, 4, 8)
STRIPES = (8, 16, 32)


def make_inputs(pairs=16384, r_pad=160, rlen=151, c_pad=448, clen=415):
    """The reference tool's seeded inputs (tools/kernel_bench.py:40-50), as
    numpy: (read codes (B, r_pad) i32, 1 - q, q / 3 (B, r_pad) f32, rlen
    (B,) i32, hap codes (B, c_pad) i32, clen (B,) i32, init_y (B,) f32)."""
    B, R, C = pairs, r_pad, c_pad
    rng = np.random.default_rng(0)
    rc = rng.integers(0, 4, (B, R)).astype(np.int32)
    q = np.float32(1e-4)
    omq = np.full((B, R), 1.0 - q, np.float32)
    q3 = np.full((B, R), q / 3.0, np.float32)
    rl = np.full(B, rlen, np.int32)
    hc = rng.integers(0, 4, (B, C)).astype(np.int32)
    hl = np.full(B, clen, np.int32)
    iy = np.full(B, np.float32(2.0**120) / clen, np.float32)
    return rc, omq, q3, rl, hc, hl, iy


def kernel_call(arrays, algo: str, param: int, device):
    """-> a no-argument function launching one instance on ``arrays``
    (``make_inputs``) put on ``device`` once: the ppe kernel's pair-minor
    entry with ``ppe_rows=param`` (the forward_batch layout: (r_pad, 3, B)
    read rows, (c_pad, B) hap masks), or the striped kernel with
    ``stripe=param``."""
    import torch

    from ..ops.pairhmm_striped import striped_forward
    from ..ops.pairhmm_torch import base_mask, ppe_forward, transition_constants

    trans = transition_constants(ord("I"), ord("+"))
    rc, omq, q3, rl, hc, hl, iy = (torch.from_numpy(a).to(device)
                                   for a in arrays)
    if algo == "striped":
        return lambda: striped_forward(rc, omq, q3, hc, rl, hl, iy, trans,
                                       param)
    if algo != "ppe":
        raise ValueError(f"unknown algo {algo!r}")
    rows = torch.stack([base_mask(rc), omq.view(torch.int32),
                        q3.view(torch.int32)]).permute(2, 0, 1).contiguous()
    hap = base_mask(hc).t().contiguous()
    return lambda: ppe_forward(rows, hap, rl, hl, iy, trans, param)


def measure_kernel(pairs=16384, r_pad=160, rlen=151, c_pad=448, clen=415,
                   algo="ppe", param=4, iters=10, device="cuda"):
    """One instance on the reference's inputs -> dict: instance name, ms
    per call, true and padded cells/s, bound ms and what sets it, the share
    of the bound, and ``out``, the (B,) raw f32 result as numpy."""
    import torch

    arrays = make_inputs(pairs, r_pad, rlen, c_pad, clen)
    device = torch.device(device)
    fn = kernel_call(arrays, algo, param, device)
    if device.type == "cuda":
        ms = _timing.time_ms_queued(fn, iters)
        out = fn().cpu().numpy()
    else:
        out = fn().numpy()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    bound_ms, bound_by = _timing.ppe_bound(arrays[3], arrays[5], c_pad)
    return {
        "instance": f"ppe{param}" if algo == "ppe" else f"striped{param}",
        "pairs": pairs, "r_pad": r_pad, "rlen": rlen, "c_pad": c_pad,
        "clen": clen, "ms": ms,
        "true_cells_per_s": pairs * rlen * clen / (ms * 1e-3),
        "padded_cells_per_s": pairs * r_pad * c_pad / (ms * 1e-3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "pct_of_bound": 100.0 * bound_ms / ms, "out": out,
    }


def instances(algos, ppe_rows, stripes):
    """(algo, param) of every instance asked for, in the reference's
    order (ppe first)."""
    out = []
    for algo in algos:
        params = ppe_rows if algo == "ppe" else stripes
        out.extend((algo, p) for p in params)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=16384)
    ap.add_argument("--rpad", type=int, default=160)
    ap.add_argument("--rlen", type=int, default=151)
    ap.add_argument("--cpad", type=int, default=448)
    ap.add_argument("--clen", type=int, default=415)
    ap.add_argument("--algos", default="ppe,striped")
    ap.add_argument("--ppe-rows", default=",".join(map(str, PPE_ROWS)),
                    help="comma list of NR for the ppe kernel")
    ap.add_argument("--stripes", default=",".join(map(str, STRIPES)),
                    help="comma list of stripe heights H for striped")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    missing = _timing.card_missing(args.device)
    if missing:
        print(f"kernel_bench: {missing}", file=sys.stderr)
        return 1
    rows = []
    first = None
    for algo, param in instances(
            args.algos.split(","),
            [int(x) for x in args.ppe_rows.split(",")],
            [int(x) for x in args.stripes.split(",")]):
        row = measure_kernel(args.pairs, args.rpad, args.rlen, args.cpad,
                             args.clen, algo, param, args.iters, args.device)
        out = row.pop("out")
        if first is None:
            first = out
        elif not np.array_equal(out.view(np.int32), first.view(np.int32)):
            print(f"kernel_bench: {row['instance']} differs from "
                  f"{rows[0]['instance']}", file=sys.stderr)
            return 1
        rows.append(row)
    print(json.dumps({
        "nvidia_smi": _timing.nvidia_smi() if args.device == "cuda" else None,
        "device": args.device, "iters": args.iters,
        "results_bitwise_equal_across_instances": True,
        "instances": rows,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
