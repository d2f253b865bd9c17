"""Entry points of the port for a harness, the counterparts of the
repository's ``__graft_entry__.py``:

* ``entry()`` -> (fn, example_args): the batched PairHMM forward on the ppe
  kernel (``forward_batch``) and a batch of 1,024 pairs on the card;
* ``dryrun_multichip(n_devices)``: the sharded likelihood step over an
  n-slot (data, hap) grid, checked against the unsharded forward bit for
  bit, then the production runner driven over the same n slots.

    python -m gatk_hc_tpu_torch.entry [N] [--device cpu]

runs both (N defaults to the visible cards).  On the card (the default)
they need N cards and raise with fewer; ``device="cpu"`` runs N CPU slots
through the kernels' plain versions, which is what the tests call.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .config import DEFAULT_CONFIG
from .ops.pairhmm_torch import forward_batch, transition_constants
from .ops.torch_runner import local_devices

TRANS = transition_constants(ord("I"), ord("+"))


def _example_batch(n_pairs=1024, r_pad=32, c_pad=128, seed=0,
                   device="cuda"):
    rng = np.random.default_rng(seed)
    rc = rng.integers(0, 4, (n_pairs, r_pad)).astype(np.int32)
    q = np.float32(1e-4)
    omq = np.full((n_pairs, r_pad), 1.0 - q, np.float32)
    q3 = np.full((n_pairs, r_pad), q / 3.0, np.float32)
    rl = np.full(n_pairs, r_pad - 4, np.int32)
    hc = rng.integers(0, 4, (n_pairs, c_pad)).astype(np.int32)
    hl = np.full(n_pairs, c_pad - 8, np.int32)
    iy = (np.float32(2.0**120) / hl.astype(np.float32)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (rc, omq, q3, rl, hc, hl, iy))


def entry(device="cuda"):
    """(fn, example_args): fn(rc, omq, q3, rl, hc, hl, iy) -> (B,) raw f32,
    the ppe kernel through ``forward_batch`` on the arguments' device (its
    plain version on CPU tensors).  Raises without a card unless
    ``device="cpu"``."""
    dev = local_devices(device)[0]
    r_pad, c_pad = 32, 128

    def fn(rc, omq, q3, rl, hc, hl, iy):
        return forward_batch(rc, omq, q3, rl, hc, hl, iy, TRANS, r_pad,
                             c_pad, ppe_rows=DEFAULT_CONFIG.ppe_rows,
                             algo="ppe")

    return fn, _example_batch(1024, r_pad, c_pad, device=dev)


def _grid_devices(n_devices: int, device) -> list:
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n_devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n_devices:
        raise RuntimeError(
            f"dryrun_multichip needs {n_devices} cards but {visible} are "
            "visible (device='cpu' runs it on CPU slots)")
    return [torch.device("cuda", i) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sharded raw step over an n-slot grid (2 hap slots when n is
    even) at r_pad 16, c_pad 128, reads taken from the haps: the raw grid
    must be finite and positive, ``best`` its row max, nothing under
    MIN_ACCEPTED, and the grid bit-equal to the unsharded forward of the
    same inputs on the first slot.  Then the production runner over the
    same n slots must place its launch units on min(n, units) of them.
    Raises on any failure -> a summary dict."""
    from .parallel.sharded_step import (
        HAP_SPECS, READ_SPECS, _forward_local, make_mesh,
        make_sharded_raw_step, shard_inputs,
    )
    from .utils.quality import LOG10_INITIAL_CONSTANT_F32

    devices = _grid_devices(n_devices, device)
    hap_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, hap_parallel=hap_parallel, devices=devices)
    r_pad, c_pad = 16, 128
    data_parallel = n_devices // hap_parallel
    n_reads = 4 * data_parallel
    n_haps = 2 * hap_parallel

    rng = np.random.default_rng(0)
    hc = rng.integers(0, 4, (n_haps, c_pad)).astype(np.int32)
    hl = np.full(n_haps, c_pad - 8, np.int32)
    # reads are substrings of haplotypes so likelihoods pass the
    # poorly-modeled-read filter (as in real regions)
    rc = np.stack(
        [hc[i % n_haps, 3 : 3 + r_pad] for i in range(n_reads)]
    ).astype(np.int32)
    q = np.float32(1e-4)
    omq = np.full((n_reads, r_pad), 1.0 - q, np.float32)
    q3 = np.full((n_reads, r_pad), q / 3.0, np.float32)
    rl = np.full(n_reads, r_pad - 2, np.int32)
    iy = (np.float32(2.0**120) / hl.astype(np.float32)).astype(np.float32)
    arrays = (rc, omq, q3, rl, hc, hl, iy)

    cfg = DEFAULT_CONFIG
    step = make_sharded_raw_step(mesh, TRANS, r_pad, c_pad, cfg)
    raw, best, n_rescue = step(*shard_inputs(mesh, arrays,
                                             READ_SPECS + HAP_SPECS))
    assert raw.shape == (n_reads, n_haps)
    assert np.isfinite(raw).all() and (raw > 0).all()
    # the host finalize the shardmap runner applies to the raw grid
    lik = np.log10(raw, dtype=np.float32) - LOG10_INITIAL_CONSTANT_F32
    assert np.isfinite(lik).all()
    assert int(n_rescue[0]) == 0, "unexpected underflow on dryrun"
    np.testing.assert_array_equal(best, raw.max(axis=1))
    # the same inputs unsharded on the first slot: a sharding fault that
    # permutes or perturbs pair values fails here (each pair is computed
    # alone, so the grid must be bit-identical)
    first = devices[0]
    ref = _forward_local(
        *(torch.from_numpy(a).to(first) for a in arrays), TRANS, r_pad,
        c_pad, algo=cfg.pallas_algo, ppe_rows=cfg.ppe_rows,
        stripe=cfg.stripe_height,
    ).cpu().numpy()
    np.testing.assert_array_equal(
        raw, ref, err_msg="sharded raw grid != single-device computation")
    print(
        f"dryrun_multichip OK: grid={mesh.shape}, raw pair grid "
        f"{raw.shape}, host-finalized lik range "
        f"[{lik.min():.2f}, {lik.max():.2f}]"
    )
    hit, units = _dryrun_production_runner(devices)
    print(f"dryrun production runner OK: {hit}/{n_devices} slots hit by "
          f"{units} launch units")
    return {"grid": mesh.shape, "raw_shape": list(raw.shape),
            "slots_hit": hit, "launch_units": units}


def _dryrun_production_runner(devices) -> tuple:
    """The runner call_batched uses, over ``devices``: 2 jobs per group
    (a read budget of 4), so 2n jobs make n launch units -> (slots hit,
    launch units)."""
    from .ops.runner import PairHMMJob
    from .ops.torch_runner import TorchPairHMMRunner

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, read_pad_buckets=(32,), hap_pad_buckets=(128,),
    )
    runner = TorchPairHMMRunner(cfg, pair_budget=128, devices=devices)
    runner.READ_BUCKETS = (4,)
    runner.HAP_BUCKETS = (4,)
    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for _ in range(2 * len(devices)):
        hap = acgt[rng.integers(0, 4, 60)]
        read = hap[5:29].copy()
        quals = np.full(24, ord("I"), np.uint8)
        jobs.append(
            PairHMMJob([(read, quals), (read[:20], quals[:20])], [hap, hap[:50]])
        )
    runner.run(jobs)
    for job in jobs:
        assert job.result.shape == (2, 2)
        assert np.isfinite(job.result).all()
    units = len(runner.placements)
    hit = len(set(runner.placements))
    assert hit == min(len(devices), units), (
        f"launch units hit {hit} slots, expected {min(len(devices), units)}")
    return hit, units


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gatk_hc_tpu_torch.entry",
        description="dryrun_multichip(N) then entry() on the card or CPU")
    parser.add_argument("n", type=int, nargs="?", default=None,
                        help="grid slots (default: the visible cards; 8 on "
                        "the CPU)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    n = args.n
    if n is None:
        n = 8 if args.device == "cpu" else len(local_devices(args.device))
    dryrun_multichip(n, device=args.device)
    fn, example = entry(device=args.device)
    out = fn(*example)
    print("entry() check:", tuple(out.shape),
          bool(torch.isfinite(out).all()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
