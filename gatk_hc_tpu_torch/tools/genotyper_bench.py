"""Device-genotyper dispatch A/B: serial per-bucket readback vs pipelined.

    python -m gatk_hc_tpu_torch.tools.genotyper_bench [--rounds 5]
        [--buckets 6] [--sites 192] [--f32] [--device cuda|cpu]

The counterpart of tools/genotyper_bench.py.  K buckets of wgs-shaped
(S, R, H) tiles (``make_buckets``: the reference's seed and bytes) go
through the genotype kernel (``ops/genotyper_cuda.py::
genotype_sites_device``, the float64 instance, or float32 with ``--f32``)
in two patterns, interleaved per round so a drift of the card or the host
falls on both:

* ``run_serial``: each bucket's copy, launch and readback (best and GQ,
  and the genotype likelihoods on f32) before the next bucket starts;
* ``run_pipelined``: every bucket copied and launched on one stream, then
  every bucket's best and GQ in ONE readback (and the f32 likelihoods in
  one more), as ``models/genotyper.py::genotype_regions_device`` does.

The two patterns must give bit-equal outputs, and the f64 instance must
equal the host genotyper (best genotype and GQ) at every site.  Output:
one JSON line with per-call ms medians (host clock, each call ending in
its readback), the speed-up, the readbacks per call and the card's name
and power limit.  ``--device cpu`` runs the kernel's plain version (the
tests): those times are not the card's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np

from . import _timing

# wgs-shaped bucket tile cycle: (R, H) pads observed in the reference's
# wgs runs
SHAPES = ((32, 8), (64, 8), (64, 16), (128, 16), (32, 16), (128, 32))


def make_buckets(n_buckets: int, sites: int, dtype):
    """The reference's buckets (tools/genotyper_bench.py:37-50), byte for
    byte: (lik (S, R, H) ``dtype``, hap -> allele, read keep, hap valid,
    allele counts) per bucket."""
    rng = np.random.default_rng(20260820)
    buckets = []
    for i in range(n_buckets):
        R, H = SHAPES[i % len(SHAPES)]
        lik = rng.uniform(-30.0, -0.1, (sites, R, H))
        h2a = np.minimum(
            np.arange(H, dtype=np.int32), 3
        )[None].repeat(sites, 0)
        keep = np.ones((sites, R), bool)
        hv = np.ones((sites, H), bool)
        ac = np.full(sites, 2, np.int32)
        buckets.append((lik.astype(dtype), h2a, keep, hv, ac))
    return buckets


def _stream(device):
    """A stream of its own on a card (as the genotyper has), nothing on
    the CPU."""
    import torch

    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


def run_serial(buckets, device):
    """One bucket at a time: copy, launch, read back best and GQ (and the
    likelihoods on f32) before the next -> [(best, gq, gl or None)]."""
    import torch

    from ..ops.genotyper_cuda import genotype_sites_device

    device = torch.device(device)
    outs = []
    with _stream(device):
        for lik, h2a, keep, hv, ac in buckets:
            gl, best, gq = genotype_sites_device(lik, h2a, keep, hv, ac,
                                                 device)
            f64 = lik.dtype == np.float64
            outs.append((best.cpu().numpy(), gq.cpu().numpy(),
                         None if f64 else gl.cpu().numpy()))
    return outs


def run_pipelined(buckets, device):
    """Every bucket copied and launched on one stream, then one readback
    of every best and GQ (and one of every f32 likelihood tile) ->
    [(best, gq, gl or None)]."""
    import torch

    from ..ops.genotyper_cuda import genotype_sites_device

    device = torch.device(device)
    f64 = buckets[0][0].dtype == np.float64
    with _stream(device):
        pend = [genotype_sites_device(*b, device) for b in buckets]
        sizes = [int(p[1].shape[0]) for p in pend]
        ints = torch.cat([p[1] for p in pend]
                         + [p[2] for p in pend]).cpu().numpy()
        gl_all = None if f64 else torch.cat([p[0] for p in pend]).cpu().numpy()
    off = np.cumsum([0] + sizes)
    total = int(off[-1])
    return [
        (ints[off[i]:off[i + 1]], ints[total + off[i]:total + off[i + 1]],
         None if f64 else gl_all[off[i]:off[i + 1]])
        for i in range(len(pend))
    ]


def host_genotypes(buckets, max_gq: int = 99):
    """The host genotyper's (best, gq) per bucket (float64)."""
    from ..models.genotyper import _genotype_sites_numpy

    out = []
    for lik, h2a, keep, hv, ac in buckets:
        counts = np.unique(ac)
        if counts.size != 1:
            raise ValueError("make_buckets gives one allele count a bucket")
        out.append(_genotype_sites_numpy(lik.astype(np.float64), h2a, keep,
                                         hv, int(counts[0]), max_gq))
    return out


def same_outputs(a, b) -> bool:
    """Bit-equality of two runs' [(best, gq, gl or None)]."""
    return all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        and (x[2] is None) == (y[2] is None)
        and (x[2] is None or np.array_equal(x[2].view(np.uint8),
                                            y[2].view(np.uint8)))
        for x, y in zip(a, b)
    ) and len(a) == len(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--buckets", type=int, default=6)
    ap.add_argument("--sites", type=int, default=192)
    ap.add_argument("--f32", action="store_true",
                    help="the float32 instance (default: float64)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    missing = _timing.card_missing(args.device)
    if missing:
        print(f"genotyper_bench: {missing}", file=sys.stderr)
        return 1
    f64 = not args.f32
    buckets = make_buckets(args.buckets, args.sites,
                           np.float64 if f64 else np.float32)
    # warm both patterns (loads the kernel library), then hold them equal
    ref = run_serial(buckets, args.device)
    if not same_outputs(ref, run_pipelined(buckets, args.device)):
        print("genotyper_bench: serial and pipelined outputs differ",
              file=sys.stderr)
        return 1
    equal_to_host = None
    if f64:
        host = host_genotypes(buckets)
        equal_to_host = all(
            np.array_equal(best, hb) and np.array_equal(gq, hg)
            for (best, gq, _gl), (hb, hg) in zip(ref, host))
    times = {"serial": [], "pipelined": []}
    for _ in range(args.rounds):  # interleaved: the same drift for both
        for name, run in (("serial", run_serial),
                          ("pipelined", run_pipelined)):
            t0 = time.perf_counter()
            out = run(buckets, args.device)
            times[name].append(time.perf_counter() - t0)
            if not same_outputs(ref, out):
                print(f"genotyper_bench: {name} outputs changed",
                      file=sys.stderr)
                return 1
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(json.dumps({
        "device": args.device,
        "nvidia_smi": _timing.nvidia_smi() if args.device == "cuda" else None,
        "dtype": "float64" if f64 else "float32",
        "buckets": args.buckets,
        "sites_per_bucket": args.sites,
        "rounds": args.rounds,
        "serial_ms": med["serial"],
        "pipelined_ms": med["pipelined"],
        "speedup": med["serial"] / med["pipelined"],
        "all_ms": {k: [t * 1e3 for t in v] for k, v in times.items()},
        # readbacks per call: serial, per bucket best + GQ (+ likelihoods
        # on f32); pipelined, one of the ints (+ one of the likelihoods)
        "serial_fetches": args.buckets * (2 if f64 else 3),
        "pipelined_fetches": 1 if f64 else 2,
        "bitwise_equal": True,
        "equal_to_host": equal_to_host,
    }))
    return 0 if equal_to_host in (None, True) else 1


if __name__ == "__main__":
    sys.exit(main())
