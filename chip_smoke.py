#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds every CUDA kernel of the port
from the checkout's sources, holds each kernel against its plain PyTorch
version (and the NumPy oracle) at the shapes the main path gives it and
at one shape with reads longer than 256 rows, then
holds the ppe kernel's unique-rows entry (one launch that reads a group's
shipped unique rows itself) against its plain version for each shipping
encoding (planes, packed, nib) at every bucket shape and at that long
shape, fused over three groups and on a chunk of one, holds both
instances of the genotype kernel (f64, f32) against their plain version
and the f64 one against the host genotyper on seeded tiles of the
genotyper's bucket grid (and, after the runs below, on every tile the
main path gave the kernel), then drives the
port's main path — the CLI, SAM + FASTA -> VCF with the CUDA PairHMM
behind the runner's dispatch worker, through the ppe kernel (the default,
adaptive shipping), each shipping path (--dispatch-mode planes / packed,
with and without --no-packed-nib, fused with --no-fuse-auto), the
striped kernel (--pallas-algo striped) and the genotype kernel
(--genotyper cuda) — on the chrM fixture (byte-identical to the golden
VCF; also through --pairhmm native --genotyper cuda, the f32 genotyper
path, --pairhmm diag and --pairhmm auto) and on a 2 Mb contig at 30x
(byte-identical to the port's native C++ engine).  Last, the multi-device
and multi-process paths on the one card: the sharded step on a 1x1 and a
2x2 grid of cuda:0 (bit-equal to the unsharded forward, its plain version
and the runner), dryrun_multichip(1), --pairhmm shardmap on chrM (golden)
and on the 2 Mb contig, the runner over two slots of cuda:0 and two CLI
processes joined by gloo over loopback on the 2 Mb contig (each identical
to native).  Then the port's correctness tools (phase_tools): the
differential fuzzer's eleven arms (python, native, streamed and
multi-threaded host arms; cuda, cuda_striped, cuda_stream_mt, diag,
shardmap on a 2x2 grid of the card, genotyper_cuda) on seven seeded
genomes of 1-3 contigs, byte-identical per seed; a 4 x 500 kb fixture
through --stream-contigs with the cuda runner, unstreamed and native
(identical, with check_truth's sensitivity); and host_profile (the device
stubbed out) on the 2 Mb contig beside the default run's stages.  Last,
the cold start (phase_cold), each run a fresh process: ``import torch``
alone; chrM through --pairhmm native, which never loads torch; the 2 Mb
contig through the default cuda CLI twice (torch imported on the
runner's build thread, every kernel library a cache hit, identical to
native); tools/warm_cache.py into an empty kernel cache, then chrM on
that cache (every library a hit, no nvcc, golden).
Every phase prints one JSON line and raises on failure.  The last lines are
the card's name and power limit (nvidia-smi), one JSON object per kernel
with its times, launches and bound, and ``{"ok": true, "device": ...}``.

It needs one card and exits non-zero, printing no result, without one.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): f32 and f64 outside
# the tensor cores (an FMA counted as two operations) and HBM bandwidth,
# used for each kernel's least time.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12
PPE_SOURCE = "gatk_hc_tpu_torch/csrc/pairhmm_ppe.cu"
PPE_REPLACES = {
    1: "gatk_hc_tpu/ops/pairhmm_pallas.py:176",
    2: "gatk_hc_tpu/ops/pairhmm_pallas.py:306",
    4: "gatk_hc_tpu/ops/pairhmm_pallas.py:588",
    8: "gatk_hc_tpu/ops/pairhmm_pallas.py:589",
}
# the jnp glue each source of the unique-rows entry replaces (not Pallas
# kernels): _unpack_planes + the gathers of pairhmm_pallas_planes,
# _unpack_u8_ppe + dispatch_pairs_ppe, _unpack_nib_ppe +
# _expand_pairs_from_spans
FRONTS = ("planes", "packed", "nib")
FRONT_REPLACES = {
    "planes": "gatk_hc_tpu/ops/pairhmm_pallas.py:935",
    "packed": "gatk_hc_tpu/ops/pairhmm_pallas.py:1034",
    "nib": "gatk_hc_tpu/ops/pairhmm_pallas.py:1254",
}
GENOTYPER_SOURCE = "gatk_hc_tpu_torch/csrc/genotyper.cu"
GENOTYPER_REPLACES = "gatk_hc_tpu/ops/genotyper_jax.py:53"
# seeded genotype kernel tiles (S, R, H) from the genotyper's bucket grid
# (models/genotyper.py _S/_R/_H_BUCKETS); the kernels line reports the
# tiles the main path's runs give the kernel (phase_genotyper_main)
GENOTYPE_TILES = ((1024, 128, 16), (256, 512, 32), (64, 2048, 128),
                  (2, 64, 16))
STRIPED_SOURCE = "gatk_hc_tpu_torch/csrc/pairhmm_striped.cu"
STRIPED_REPLACES = "gatk_hc_tpu/ops/pairhmm_pallas.py:59"
STRIPES = (8, 16, 32)
# the kernel line reports the shape most main-path groups run at
# (151 bp reads -> r_pad 160, 415 bp windows -> c_pad 448)
REPORT_SHAPE = (160, 448)
# a long-haplotype shape, where the reference package routes to striped
# (c_pad > 640): both kernels are timed there
LONG_SHAPE = (160, 768)
# reads longer than 256 rows: the ppe kernel runs two stripes of 256 rows
# and carries a row between them, striped32 two of 160 (K 5) and striped8
# two of 144 (K 18); striped16 runs one of 288 (K 18) (off the main path:
# B cut to a quarter)
CARRY_SHAPE = (288, 448)
LAUNCH_KEYS = ("rows_per_lane", "stripes", "warps_per_block", "blocks_per_sm")
# the kernels line's names, in its order: one per launch counter
KERNEL_NAMES = tuple(
    [f"ppe{nr}" for nr in PPE_REPLACES] + [f"striped{h}" for h in STRIPES]
    + [f"ppe_front_{path}" for path in FRONTS]
    + ["genotype_f64", "genotype_f32"])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card():
    import torch

    smi = nvidia_smi()
    from gatk_hc_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build_all()  # one nvcc per source, started together
    for name in _kernels.KERNELS:
        _kernels.load(name)
    build_s = time.perf_counter() - t0
    emit({
        "phase": "card", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "kernels": list(_kernels.KERNELS), "build_s": round(build_s, 3),
        "compiled": {name: compiler_report(_kernels, name)
                     for name in _kernels.KERNELS},
    })
    return smi


def instance_name(mangled: str) -> str:
    """A kernel instance's short name from its mangled symbol:
    ppe_forward_kernel<5, false> -> "ppe_k5", <8, true> -> "ppe_k8_carry",
    striped_forward_kernel<16, 10, false> -> "striped16_k10", <8, 16, true>
    -> "striped8_k16_carry"."""
    import re

    m = re.search(r"striped_forward_kernelILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return (f"striped{m.group(1)}_k{m.group(2)}"
                + ("_carry" if m.group(3) == "1" else ""))
    m = re.search(r"ppe_forward_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return f"ppe_k{m.group(1)}" + ("_carry" if m.group(2) == "1" else "")
    m = re.search(r"genotype_kernelI([df])E", mangled)
    if m:
        return "genotype_f64" if m.group(1) == "d" else "genotype_f32"
    return mangled


def expected_instances(name: str):
    """Every instance a kernel library must hold: ppe K 1-8 with and
    without the carry (both entries, every source, share them); striped
    per H, K 1..KMAX(H), and K > KMAX(H) / 2 with the carry (the
    rows-per-lane rule carries only there)."""
    if name == "pairhmm_ppe":
        return {f"ppe_k{k}{c}" for k in range(1, 9) for c in ("", "_carry")}
    if name == "genotyper":
        return {"genotype_f64", "genotype_f32"}
    from gatk_hc_tpu_torch.ops.pairhmm_striped import MAX_ROWS_PER_LANE

    return {f"striped{h}_k{k}{c}" for h, kmax in MAX_ROWS_PER_LANE.items()
            for k in range(1, kmax + 1)
            for c in ("", "_carry") if not c or 2 * k > kmax}


def compiler_report(_kernels, name):
    """Registers, stack, static shared and local memory per kernel
    instantiation (shared memory is dynamic: the kernel phase reports it
    per shape), and the f32 and f64 multiply / add / fused multiply-add
    instructions in its machine code, read with cuobjdump from the library
    just built.  Raises on any FFMA or DFMA (the exactness rules forbid
    mul+add contraction), on local memory or stack, and on a missing
    instance."""
    out = instance_report(_kernels, _kernels.library_path(name))
    if any(info.get("FFMA") or info.get("DFMA") for info in out.values()):
        raise AssertionError(f"{name}: fused multiply-add in SASS: {out}")
    if any(info.get("local") or info.get("stack") for info in out.values()):
        raise AssertionError(f"{name}: spills to local memory / stack: {out}")
    want = expected_instances(name)
    if not want <= set(out):
        raise AssertionError(f"{name}: missing instances {want - set(out)}")
    return out


def instance_report(_kernels, lib):
    """{instance: registers, stack, shared, local, FMUL/FADD/FFMA and
    DMUL/DADD/DFMA count} of the kernel library ``lib``, read with
    cuobjdump."""
    import re

    tool = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, check=True, timeout=120).stdout

    out, fn = {}, None
    for line in dump("--dump-resource-usage").splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            fn = out.setdefault(instance_name(m.group(1)), {})
            continue
        for key in ("REG", "STACK", "SHARED", "LOCAL"):
            m = re.search(rf"\b{key}:(\d+)", line)
            if m and fn is not None:
                fn[key.lower()] = int(m.group(1))
    fn = None
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = out.setdefault(instance_name(m.group(1)), {})
            continue
        m = re.search(r"\b(FMUL|FADD|FFMA|DMUL|DADD|DFMA)\b", line)
        if m and fn is not None:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    return out


def make_pairs(rng, B, r_pad, c_pad):
    """Seeded main-path-like pairs: 3/4 reads drawn from their haplotype
    with ~1% substitutions and a few N bases, 1/4 unrelated pairs (which
    underflow); qualities from the fixture's range (Q28-40, some Q5-20);
    rlen and clen drawn inside the pads.  -> ASCII arrays + lengths."""
    import numpy as np

    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    clen = rng.integers(max(1, c_pad - 64), c_pad + 1, B).astype(np.int32)
    rlen = rng.integers(max(1, r_pad - 63), r_pad + 1, B).astype(np.int32)
    unrelated = rng.random(B) < 0.25
    clen[unrelated] = rng.integers(1, c_pad + 1, int(unrelated.sum()))
    rlen[unrelated] = rng.integers(1, r_pad + 1, int(unrelated.sum()))
    hap = acgtn[rng.integers(0, 4, (B, c_pad))]
    hap[rng.random((B, c_pad)) < 0.002] = ord("N")
    start = rng.integers(0, np.maximum(clen - rlen, 0) + 1)
    cols = np.minimum(start[:, None] + np.arange(r_pad)[None, :], c_pad - 1)
    read = np.take_along_axis(hap, cols, axis=1)
    sub = rng.random((B, r_pad)) < 0.01
    read[sub] = acgtn[rng.integers(0, 4, int(sub.sum()))]
    read[rng.random((B, r_pad)) < 0.002] = ord("N")
    read[unrelated] = acgtn[rng.integers(0, 5, (int(unrelated.sum()), r_pad))]
    qual = rng.integers(28, 41, (B, r_pad))
    low = rng.random((B, r_pad)) < 0.03
    qual[low] = rng.integers(5, 21, int(low.sum()))
    qual = (qual + 33).astype(np.uint8)
    col = np.arange(r_pad)[None, :]
    read[col >= rlen[:, None]] = 0
    qual[col >= rlen[:, None]] = 0
    hap[np.arange(c_pad)[None, :] >= clen[:, None]] = 0
    return read, qual, rlen, hap, clen


def ppe_bound(rlen, clen, c_pad):
    """The least time of one ppe launch on these pairs, in ms, and what
    sets it.  Operations: the f32 work the function needs, 8 multiplies +
    4 adds per true cell, 2 adds per column of row rlen (its M and X summed
    in column order) and 1 add per pair; over the f32 peak.  Bytes: each
    pair's rlen rows of the three read planes, clen hap masks, rlen, clen
    and init_y read once, its result written once; over HBM bandwidth."""
    import numpy as np

    rl = np.asarray(rlen, np.int64)
    cl = np.minimum(np.asarray(clen, np.int64), c_pad)
    B = rl.size
    ops = 12 * int(rl @ cl) + 2 * int(cl.sum()) + B
    nbytes = 4 * (3 * int(rl.sum()) + int(cl.sum()) + 3 * B) + 4 * B
    bound_s = {"bytes": nbytes / PEAK_HBM_BYTES,
               "operations": ops / PEAK_F32_FLOPS}
    by = max(bound_s, key=bound_s.get)
    return 1e3 * bound_s[by], by


def kernel_inputs(read, qual, rlen, hap, clen, device):
    """Pair-minor ppe inputs on ``device`` (the runner's plane tables)."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.ops.pairhmm_torch import plane_tables
    from gatk_hc_tpu_torch.utils.quality import (
        BASE_TABLE, INITIAL_CONSTANT_F32, PH2PR_F32,
    )

    mask, omq_bits, q3_bits = plane_tables(BASE_TABLE, PH2PR_F32)
    rows = np.stack([mask[read], omq_bits[qual], q3_bits[qual]])  # (3, B, R)
    init_y = (INITIAL_CONSTANT_F32 / clen.astype(np.float32)).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (
        to(rows.transpose(2, 0, 1)), to(mask[hap].T), to(rlen), to(clen),
        to(init_y),
    )


def time_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` on the current stream, CUDA events, warmed up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms_queued(fn, reps: int) -> float:
    """ms per call of ``fn`` run ``reps`` times back to back between two
    CUDA events, warmed up: the host enqueues ahead of the card, so the
    wrapper's own time hides behind the kernels' (``time_ms`` waits for
    each call and counts it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def striped_inputs(read, qual, rlen, hap, clen, device):
    """Pair-major striped inputs on ``device``: base codes, 1 - q, q / 3
    (the runner's host tables), lengths and INITIAL / haplen."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.ops.pairhmm_striped import striped_tables
    from gatk_hc_tpu_torch.utils.quality import (
        BASE_TABLE, INITIAL_CONSTANT_F32, PH2PR_F32,
    )

    base, omq, q3 = striped_tables(BASE_TABLE, PH2PR_F32)
    q = qual & 127
    init_y = (INITIAL_CONSTANT_F32 / clen.astype(np.float32)).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (to(base[read]), to(omq[q]), to(q3[q]), to(base[hap]), to(rlen),
            to(clen), to(init_y))


def timed_once(fn):
    """(result, ms) of one call, CUDA events (for the plain versions,
    which have nothing to warm up)."""
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_kernels():
    """Every ppe NR instance against the plain version (bit for bit, all
    pairs) and the NumPy oracle (bit for bit, 64 sampled pairs), and every
    striped H instance against the ppe kernel (bit for bit, all pairs), at
    every (r_pad, c_pad) of the default buckets and at LONG_SHAPE, B = the
    runner's group size, and at CARRY_SHAPE, B a quarter of it.  The
    default H is also held against the striped plain version and the
    oracle at every shape; every H against its plain version at
    REPORT_SHAPE.  Each ppe and striped row carries its launch shape (rows
    per lane, stripes, warps per block, blocks per SM)."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.ops import pairhmm_striped as ps
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
    from gatk_hc_tpu_torch.ops.pairhmm_oracle import pairhmm_prob
    from gatk_hc_tpu_torch.ops.runner import TorchPairHMMRunner

    group = TorchPairHMMRunner.GROUP_PAIRS
    trans = pt.transition_constants(DEFAULT_CONFIG.gop_char,
                                    DEFAULT_CONFIG.gcp_char)
    default_h = DEFAULT_CONFIG.stripe_height
    shapes = [(r, c) for r in DEFAULT_CONFIG.read_pad_buckets
              for c in DEFAULT_CONFIG.hap_pad_buckets]
    shapes += [LONG_SHAPE, CARRY_SHAPE]
    rng = np.random.default_rng(20261016)
    results = {}
    for r_pad, c_pad in shapes:
        B = group // 4 if (r_pad, c_pad) == CARRY_SHAPE else group
        read, qual, rlen, hap, clen = make_pairs(rng, B, r_pad, c_pad)
        args = kernel_inputs(read, qual, rlen, hap, clen, "cuda")
        plain, plain_ms = timed_once(lambda: pt.ppe_forward_plain(*args, trans))
        sample = rng.choice(B, 64, replace=False)
        want = np.array([
            np.float32(pairhmm_prob(
                read[k, : rlen[k]], qual[k, : rlen[k]], hap[k, : clen[k]],
                DEFAULT_CONFIG.gop_char, DEFAULT_CONFIG.gcp_char,
                np.float32, ftz=True,
            ))
            for k in sample
        ], np.float32)
        true_cells = int(rlen.astype(np.int64) @ clen.astype(np.int64))
        bound_ms, bound_by = ppe_bound(rlen, clen, c_pad)
        common = {"B": B, "r_pad": r_pad, "c_pad": c_pad,
                  "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
                  "library_ms": None}

        def check(name, got, plain, plain_ms, oracle=True):
            """One instance's row: bit equality with ``plain`` (all pairs)
            and the oracle (the sample), its ms per launch.  Raises on a
            difference."""
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), plain.view(torch.int32))
            got_np = got.cpu().numpy()
            oracle_same = bool(np.array_equal(
                got_np[sample].view(np.int32), want.view(np.int32)
            )) if oracle else None
            row = {
                "phase": "kernel", "name": name, **common,
                "bit_equal_plain": same, "bit_equal_oracle_64": oracle_same,
                "max_abs_err": float((got - plain).abs().max()),
                "underflowed_frac": round(float((got_np == 0).mean()), 4),
                "plain_ms": None if plain_ms is None else round(plain_ms, 3),
            }
            if not same or oracle_same is False:
                emit(row)
                raise AssertionError(
                    f"{name} at r_pad={r_pad} c_pad={c_pad}: kernel differs "
                    f"from plain ({same}) or oracle ({oracle_same})"
                )
            return row

        def timed(row, fn):
            ms = time_ms(fn, 10)
            row.update({
                "ms": round(ms, 4),
                "true_cells_per_s": true_cells / (ms / 1e3),
                "padded_cells_per_s": B * r_pad * c_pad / (ms / 1e3),
            })
            emit(row)
            results[(row["name"], r_pad, c_pad)] = row

        ppe_out = {}
        for nr in (1, 2, 4, 8):
            assert pt.select_rows(nr, r_pad) == nr
            ppe_out[nr] = pt.ppe_forward(*args, trans, nr)
            row = check(f"ppe{nr}", ppe_out[nr], plain, plain_ms)
            row.update(pt.ppe_launch_shape(r_pad, c_pad, nr))
            timed(row, lambda: pt.ppe_forward(*args, trans, nr))

        # striped: every H against the ppe kernel (NR 4, the default); the
        # default H (every shape) and every H (REPORT_SHAPE) against the
        # striped plain version, which hands rows between stripes
        sargs = striped_inputs(read, qual, rlen, hap, clen, "cuda")
        for h in STRIPES:
            got = ps.striped_forward(*sargs, trans, h)
            row = check(f"striped{h}", got, ppe_out[4], None,
                        oracle=h == default_h)
            row["bit_equal_ppe"] = row.pop("bit_equal_plain")
            row.update(ps.launch_shape(r_pad, c_pad, h))
            if h == default_h or (r_pad, c_pad) == REPORT_SHAPE:
                splain, splain_ms = timed_once(
                    lambda: ps.striped_forward_plain(*sargs, trans, h))
                own = check(f"striped{h}", got, splain, splain_ms,
                            oracle=False)
                row.update(
                    bit_equal_plain=own["bit_equal_plain"],
                    plain_ms=own["plain_ms"],
                    max_abs_err=max(row["max_abs_err"], own["max_abs_err"]),
                )
            timed(row, lambda: ps.striped_forward(*sargs, trans, h))
    return results


def main_group(rng, r_pad, c_pad):
    """One main-path-sized group as the runner packs it: 256 jobs of 64
    reads x 4 haps (65,536 pairs, 16,384 unique reads, 1,024 unique haps),
    bytes from make_pairs -> the runner's _Unique rows."""
    import numpy as np

    from gatk_hc_tpu_torch.ops.runner import _Unique
    from gatk_hc_tpu_torch.utils.quality import INITIAL_CONSTANT_F32

    jobs, nr, nh = 256, 64, 4
    n_reads, n_haps = jobs * nr, jobs * nh
    read, qual, rlen, _h, _c = make_pairs(rng, n_reads, r_pad, c_pad)
    _r, _q, _l, hap, clen = make_pairs(rng, n_haps, r_pad, c_pad)
    spans = [(j, j * nr * nh, nr, nh) for j in range(jobs)]
    bases = [(j * nr, j * nh) for j in range(jobs)]
    init_y = (INITIAL_CONSTANT_F32 / clen.astype(np.float32)).astype(np.float32)
    return _Unique((n_reads, n_haps, r_pad, c_pad), read.ravel(),
                   qual.ravel(), hap.ravel(), rlen, clen, init_y, spans,
                   bases, jobs * nr * nh)


def pack_group(runner, path, u):
    """The runner's payload of group ``u`` in ``path``'s encoding."""
    t0 = time.perf_counter()
    if path == "planes":
        return runner._pack_planes(u, t0)
    if path == "packed":
        return runner._pack_bytes(u, t0)
    return runner._pack_nib(u, *runner._nib_encode(u.read_u8, u.qual_u8), t0)


def segment_pairs(u, start, n):
    """(rlen, clen) of pairs start .. start + n - 1 of group ``u``
    (read-major per job, jobs in order)."""
    import numpy as np

    pr = np.concatenate([np.repeat(np.arange(rb, rb + nr), nh)
                         for (_g, _s, nr, nh), (rb, _hb)
                         in zip(u.spans, u.bases)])
    ph = np.concatenate([np.tile(np.arange(hb, hb + nh), nr)
                         for (_g, _s, nr, nh), (_rb, hb)
                         in zip(u.spans, u.bases)])
    sl = slice(start, start + n)
    return u.read_lens[pr[sl]], u.hap_lens[ph[sl]]


def phase_front():
    """The ppe kernel's unique-rows entry against its plain version (the
    plain glue, then ppe_forward_plain, on the card), bit for bit, for
    each shipping encoding on a group packed by the runner's own host
    code: B = 65,536 at every (r_pad, c_pad) of the default buckets and at
    CARRY_SHAPE, then at REPORT_SHAPE three groups in one fused launch and
    pairs 12,345 .. 52,344 of one group as a chunk.  Each row also times
    the pair-minor entry (ppe<NR>) on the glue's inputs, in turns with the
    entry (``time_ms`` and ``time_ms_queued``), and the glue alone, and
    gives the device-memory peak of the entry and of glue + ppe."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.ops import pairhmm_front as pf
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
    from gatk_hc_tpu_torch.ops.runner import (
        TorchPairHMMRunner, join_payloads, segments_of,
    )

    runner = TorchPairHMMRunner(DEFAULT_CONFIG, device="cuda")
    trans, tab, nr = runner.trans, runner._ppe_tab, DEFAULT_CONFIG.ppe_rows
    rng = np.random.default_rng(20261017)
    shapes = [(r, c) for r in DEFAULT_CONFIG.read_pad_buckets
              for c in DEFAULT_CONFIG.hap_pad_buckets] + [CARRY_SHAPE]
    cases = [(shape, "group") for shape in shapes]
    cases += [(REPORT_SHAPE, "fused3"), (REPORT_SHAPE, "chunk")]
    results = {}

    def peak_mb(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**20

    for (r_pad, c_pad), kind in cases:
        groups = [main_group(rng, r_pad, c_pad)
                  for _ in range(3 if kind == "fused3" else 1)]
        for path in FRONTS:
            payloads = [pack_group(runner, path, u) for u in groups]
            buf = join_payloads(payloads, runner._pinned)
            segs = segments_of(payloads, buf.ship(runner.device))
            if kind == "chunk":
                segs = [dataclasses.replace(segs[0], start=12345, n=40000)]
            torch.cuda.synchronize()
            front = lambda: pf.ppe_forward_unique(  # noqa: E731
                path, segs, tab, trans, nr)
            got, front_mb = peak_mb(front)
            want, plain_ms = timed_once(
                lambda: pf.ppe_forward_unique_plain(path, segs, tab, trans))
            def glue():  # the plain glue's pair-minor inputs
                parts = [pf.segment_inputs(path, g, tab) for g in segs]
                return parts[0] if len(parts) == 1 else [
                    torch.cat([p[k] for p in parts], -1) for k in range(5)]

            minor, glue_mb = peak_mb(
                lambda: pt.ppe_forward(*glue(), trans, nr))
            args = glue()
            pair_minor = lambda: pt.ppe_forward(*args, trans, nr)  # noqa: E731
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            same_minor = torch.equal(got.view(torch.int32),
                                     minor.view(torch.int32))
            pairs = [segment_pairs(u, g.start, g.count)
                     for u, g in zip(groups, segs)]
            rlen = np.concatenate([p[0] for p in pairs])
            clen = np.concatenate([p[1] for p in pairs])
            bound_ms, bound_by = ppe_bound(rlen, clen, c_pad)
            name = f"ppe_front_{path}"
            row = {
                "phase": "kernel", "name": name, "case": kind,
                "B": int(got.numel()), "r_pad": r_pad, "c_pad": c_pad,
                "segments": len(segs),
                "nr_pad": groups[0].dims[0], "nh_pad": groups[0].dims[1],
                "bit_equal_plain": same, "bit_equal_pair_minor": same_minor,
                "max_abs_err": float((got - want).abs().max()),
                "plain_ms": round(plain_ms, 3),
                "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
                "library_ms": None,
                "peak_mb_entry": round(front_mb, 1),
                "peak_mb_glue_and_ppe": round(glue_mb, 1),
            }
            if not (same and same_minor):
                emit(row)
                raise AssertionError(
                    f"{name} {kind} at r_pad={r_pad} c_pad={c_pad}: entry "
                    f"differs from plain ({same}) or the pair-minor entry "
                    f"({same_minor})")
            # the entry and ppe<NR> on the glue's inputs in turns, one
            # launch at a time and queued back to back
            turns = {}
            for key, fn in (("", front), ("pair_minor_", pair_minor),
                            ("pair_minor_", pair_minor), ("", front)):
                turns.setdefault(key + "ms", []).append(time_ms(fn, 10))
                turns.setdefault(key + "queued_ms", []).append(
                    time_ms_queued(fn, 10))
            row.update({k: round(statistics.median(v), 4)
                        for k, v in turns.items()})
            row["glue_ms"] = round(time_ms(glue, 10), 4)
            row["pct_of_bound"] = round(100 * row["bound_ms"] / row["ms"], 1)
            emit(row)
            results[(name, r_pad, c_pad, kind)] = row
    return results


def genotype_tile(rng, S, R, H):
    """One seeded tile (S, R, H) as the genotyper pads its sites: per site
    nr reads in (R / 2, R] (the R bucket of nr; 1..64 at the first), nh
    haps in (H / 2, H] (at least 2), allele counts 2-8 with every allele
    on a hap (1 site in 20 leaves its last allele without one), reads kept
    with probability 0.8, and normalized likelihoods on a 0.25 grid (the
    best hap of a read in [-40, -1], the others at most 4.5 below it), so
    that allele maxima and totals tie; 1 site in 16 has every likelihood
    -1.0 (all genotypes tied), and 1 in 8 has 1 in 32 of its likelihoods
    at +-(1e-45 .. 1.2e-38), subnormal in f32 (the f32 instance reads them
    as zero, -ftz=true).  -> (lik f64, h2a, keep, hap_valid, ac)."""
    import numpy as np

    tiny = float(np.finfo(np.float32).tiny)
    lik = np.zeros((S, R, H))
    h2a = np.zeros((S, H), np.int32)
    keep = np.zeros((S, R), bool)
    hv = np.zeros((S, H), bool)
    ac = np.zeros(S, np.int32)
    for s in range(S):
        nr = int(rng.integers(R // 2 + 1 if R > 64 else 1, R + 1))
        nh = int(rng.integers(max(2, H // 2 + 1), H + 1))
        a = min(int(rng.integers(2, 9)), nh)
        mapper = np.concatenate([rng.permutation(a),
                                 rng.integers(0, a, nh - a)])
        if rng.random() < 0.05:
            mapper[mapper == a - 1] = 0
        best = -rng.uniform(1.0, 40.0, nr)
        vals = best[:, None] - rng.uniform(0.0, 4.5, (nr, nh))
        vals[np.arange(nr), rng.integers(0, nh, nr)] = best
        if rng.random() < 1 / 16:
            vals[:] = -1.0
        vals = np.round(vals * 4.0) / 4.0
        if rng.random() < 1 / 8:
            sub = rng.random((nr, nh)) < 1 / 32
            vals[sub] = (rng.choice((-1.0, 1.0), (nr, nh))
                         * rng.uniform(1e-45, tiny, (nr, nh)))[sub]
        lik[s, :nr, :nh] = vals
        h2a[s, :nh] = rng.permutation(mapper)
        keep[s, :nr] = rng.random(nr) < 0.8
        hv[s, :nh] = True
        ac[s] = a
    return lik, h2a, keep, hv, ac


def genotype_table_entries(lik, h2a, keep, hv, ac):
    """How many distinct Jacobian table entries the tile's data indexes:
    per site, the kept reads' allele maxima over valid haps, and for each
    het genotype of the site's alleles the index floor(diff * 1e4 + 0.5)
    where diff < 8, in the likelihoods' type (LOWEST = -DBL_MAX in f64,
    -inf in f32, for an allele without a hap)."""
    import numpy as np

    t = lik.dtype.type
    low = t(-np.inf) if lik.dtype == np.float32 else t(
        -np.finfo(np.float64).max)
    seen = set()
    for s in range(len(ac)):
        a = int(ac[s])
        rows = lik[s][keep[s]]
        al = np.full((rows.shape[0], a), low, lik.dtype)
        for k in range(a):
            cols = hv[s] & (h2a[s] == k)
            if cols.any():
                al[:, k] = rows[:, cols].max(axis=1)
        i1, i2 = np.triu_indices(a, 1)
        l1, l2 = al[:, i1], al[:, i2]
        with np.errstate(invalid="ignore", over="ignore"):
            diff = np.maximum(l1, l2) - np.minimum(l1, l2)
            ind = np.floor(diff[diff < t(8.0)] * t(1e4) + t(0.5))
        seen.update(np.unique(ind).astype(np.int64).tolist())
    return len(seen)


def genotype_bound(lik, h2a, keep, hv, ac):
    """The least time of one genotype launch on this tile (numpy arrays,
    ``lik`` in the instance's type), in ms, and what sets it; both terms
    count what this tile's data needs.  Bytes, each read or written once:
    the likelihoods of kept reads x valid haps, the valid haps' allele
    map, the two masks, the allele counts, the Jacobian table entries the
    tile indexes (genotype_table_entries), and the outputs (36
    likelihoods, best and GQ a site).  Operations: one max per (kept read,
    valid hap); per (kept read, valid genotype) 2 for a hom slot (add, sum)
    and 7 for a het one (max, min, sub, mul, add, table add, sum), 4 more
    per sum on the compensated f32 path; 2 per valid genotype at the end —
    over the f64 (or f32) peak."""
    import numpy as np

    S = lik.shape[0]
    itemsize = lik.dtype.itemsize
    kept = keep.sum(axis=1).astype(np.int64)
    haps = hv.sum(axis=1).astype(np.int64)
    a = ac.astype(np.int64)
    het = a * (a - 1) // 2
    per_sum = 4 if itemsize == 4 else 0
    ops = int(kept @ haps) + int(kept @ (a * (2 + per_sum)
                                          + het * (7 + per_sum)))
    ops += int(2 * (a + het).sum())
    nbytes = (int(kept @ haps) * itemsize + int(haps.sum()) * 4
              + keep.size + hv.size + ac.size * 4
              + genotype_table_entries(lik, h2a, keep, hv, ac) * itemsize
              + S * 36 * itemsize + 2 * S * 4)
    peak = PEAK_F64_FLOPS if itemsize == 8 else PEAK_F32_FLOPS
    bound_s = {"bytes": nbytes / PEAK_HBM_BYTES, "operations": ops / peak}
    by = max(bound_s, key=bound_s.get)
    return 1e3 * bound_s[by], by


def host_genotypes(lik, h2a, keep, hv, ac):
    """The host genotyper on the same tile: (per site, the 36-slot indices
    of its genotypes, their likelihoods from the per-site reductions, the
    best slot and GQ from the batched f64 reduction)."""
    import numpy as np

    from gatk_hc_tpu_torch.models.genotyper import (
        _calculate_genotype_likelihoods, _genotype_sites_numpy,
        _marginalize, _triu_pairs,
    )
    from gatk_hc_tpu_torch.ops.genotyper_cuda import genotype_pair_tables

    a1, a2 = genotype_pair_tables()
    slot_of = {(int(x), int(y)): g for g, (x, y) in enumerate(zip(a1, a2))}
    out = [None] * len(ac)
    for count in np.unique(ac):
        idx = np.nonzero(ac == count)[0]
        best, gq = _genotype_sites_numpy(lik[idx], h2a[idx], keep[idx],
                                         hv[idx], int(count), 99)
        h1, h2 = _triu_pairs(int(count))
        slots = [slot_of[(int(x), int(y))] for x, y in zip(h1, h2)]
        for k, s in enumerate(idx):
            valid = np.nonzero(hv[s])[0]
            allele_lik = _marginalize([int(h2a[s, h]) for h in valid],
                                      int(count), keep[s], lik[s][:, valid])
            gl = np.asarray(_calculate_genotype_likelihoods(allele_lik,
                                                            int(count)))
            out[s] = (slots, gl, slots[int(best[k])], int(gq[k]))
    return out


def genotype_row(tiles, args):
    """One genotype kernel instance (``args[0]``'s dtype picks it) on one
    tile of card tensors (lik, hap_to_allele, read_keep, hap_valid,
    allele_count): bit-equal to the plain version in likelihoods, best and
    GQ at every site, the f64 one also to the host genotyper at every site
    with a hap (every valid slot's likelihood, the best genotype and GQ);
    ms per launch, plain ms, bound.
    ``tiles`` says where the tile comes from.  -> its row; raises on a
    mismatch."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.ops import genotyper_cuda as gc

    S, R, H = args[0].shape
    f64 = args[0].dtype == torch.float64
    name = "genotype_f64" if f64 else "genotype_f32"
    got = gc.genotype_sites_cuda(*args)
    jac = gc.jacobian_table(args[0].dtype, "cuda")
    want, plain_ms = timed_once(lambda: gc.genotype_sites_plain(*args, jac))
    torch.cuda.synchronize()
    ibits = torch.int64 if f64 else torch.int32
    same = (torch.equal(got[0].view(ibits), want[0].view(ibits))
            and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]))
    gl, best, gq = (t.cpu().numpy() for t in got)
    arrays = [t.cpu().numpy() for t in args]
    host_same = None
    if f64:  # the tile's sites (padding sites have no hap)
        real = np.nonzero(arrays[3].any(axis=1))[0]
        host_same = all(
            np.array_equal(gl[s, slots].view(np.int64),
                           want_gl.view(np.int64))
            and best[s] == b and gq[s] == q
            for s, (slots, want_gl, b, q) in zip(
                real, host_genotypes(*(x[real] for x in arrays))))
    finite = np.isfinite(gl) & np.isfinite(want[0].cpu().numpy())
    bound_ms, bound_by = genotype_bound(*arrays)
    row = {
        "phase": "genotyper", "tiles": tiles, "name": name,
        "S": S, "R": R, "H": H,
        "bit_equal_plain": same, "equal_host": host_same,
        "max_abs_err": float(np.abs(
            gl[finite] - want[0].cpu().numpy()[finite]).max(initial=0.0)),
        "plain_ms": round(plain_ms, 3),
        "bound_ms": float(f"{bound_ms:.4g}"), "bound_by": bound_by,
        "library_ms": None,
    }
    if not same or host_same is False:
        emit(row)
        raise AssertionError(
            f"{name} at {(S, R, H)} ({tiles}): kernel differs from plain "
            f"({same}) or host ({host_same})")
    row["ms"] = round(time_ms(lambda: gc.genotype_sites_cuda(*args), 10), 4)
    row["pct_of_bound"] = float(f"{100 * row['bound_ms'] / row['ms']:.3g}")
    emit(row)
    return row


def phase_genotyper():
    """Both instances of the genotype kernel on seeded tiles of the
    genotyper's bucket grid (GENOTYPE_TILES; genotype_row's checks and
    times).  -> {(name, S, R, H): row}"""
    import numpy as np
    import torch

    rng = np.random.default_rng(20261018)
    results = {}
    for S, R, H in GENOTYPE_TILES:
        tile = genotype_tile(rng, S, R, H)
        for dtype in (np.float64, np.float32):
            args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                    for x in (tile[0].astype(dtype),) + tile[1:]]
            row = genotype_row("seeded", args)
            results[(row["name"], S, R, H)] = row
    return results


@contextlib.contextmanager
def recording_genotype_tiles():
    """Inside, every genotype kernel launch is tallied by its tile shape
    (S, R, H), and the inputs of the first launch at each shape are kept
    (cloned on the launching stream, after its copies); the launch and its
    count stay the wrapper's own.  Yields {"shapes": {shape: launches},
    "inputs": {shape: [lik, hap_to_allele, read_keep, hap_valid,
    allele_count]}}."""
    from gatk_hc_tpu_torch.ops import genotyper_cuda as gc

    launch = gc.genotype_sites_cuda
    record = {"shapes": {}, "inputs": {}}

    def recording(*args, **kwargs):
        shape = tuple(args[0].shape)
        record["shapes"][shape] = record["shapes"].get(shape, 0) + 1
        if shape not in record["inputs"]:
            record["inputs"][shape] = [t.clone() for t in args[:5]]
        return launch(*args, **kwargs)

    gc.genotype_sites_cuda = recording
    try:
        yield record
    finally:
        gc.genotype_sites_cuda = launch


def phase_genotyper_main(run, record):
    """The genotype kernel at the main path's own tiles: every shape of
    ``run``'s launches, on the inputs that run first gave the kernel at
    that shape (genotype_row's checks and times).  -> the rows, the most
    common shape's first (of two as common, the larger tile)."""
    import torch

    torch.cuda.synchronize()
    shapes = record["shapes"]
    order = sorted(shapes, key=lambda k: (shapes[k], k[0] * k[1] * k[2]),
                   reverse=True)
    emit({"phase": "genotyper_main_path", "run": run,
          "launches_by_shape": {"x".join(map(str, k)): n
                                for k, n in sorted(shapes.items())},
          "most_common": order[0]})
    return [genotype_row(run, record["inputs"][shape]) for shape in order]


def run_cli(argv):
    """One in-process CLI run (the entry point a user calls) -> its
    --stats JSON, with the PairHMM kernels' launch counts of this run."""
    from gatk_hc_tpu_torch import cli
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt

    pt.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv + ["--stats"])
    launches = dict(pt.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")
    stats = json.loads(out.getvalue().splitlines()[0])
    stats["launches"] = launches
    return stats


# chrM and 2 Mb runs through each shipping path: name -> (flags, the
# kernels it must launch and the only ones it may, the dispatch_profile
# labels it may show).  adaptive calibrates only past 32 groups, so the
# default run may add the nib path on the 2 Mb contig.
PATH_RUNS = {
    "planes": (["--dispatch-mode", "planes"], {"ppe4", "ppe_front_planes"},
               {"ppe4", "ppe_front_planes"}, {"planes"}),
    "nib": (["--dispatch-mode", "packed"], {"ppe4", "ppe_front_nib"},
            {"ppe4", "ppe_front_nib", "ppe_front_packed"},
            {"packednib", "packed"}),
    "packed": (["--dispatch-mode", "packed", "--no-packed-nib"],
               {"ppe4", "ppe_front_packed"}, {"ppe4", "ppe_front_packed"},
               {"packed"}),
    "fused": (["--dispatch-mode", "packed", "--no-fuse-auto"],
              {"ppe4", "ppe_front_nib"},
              {"ppe4", "ppe_front_nib", "ppe_front_packed"},
              {"packednib", "packed", "packednibfused2", "packednibfused3",
               "packednibfused4", "packedfused2", "packedfused3",
               "packedfused4"}),
}


def one_launch_per_unit(name, stats):
    """Every ppe launch of a run is a launch of the unique-rows entry, and
    one per launch unit: the ppe launches equal the front launches and the
    launches the dispatch_profile counts.  Raises otherwise."""
    launches = stats["launches"]
    ppe = sum(n for k, n in launches.items()
              if k.startswith("ppe") and k[3:].isdigit())
    front = sum(n for k, n in launches.items() if k.startswith("ppe_front"))
    units = sum((stats.get("dispatch_profile") or {}).values())
    if not ppe == front == units:
        raise AssertionError(
            f"{name}: ppe launches {ppe}, front launches {front}, launch "
            f"units {units}: {launches}")


def check_run(name, stats, must, may, labels, fused=False):
    """A run's launches and labels against its path: raises on a kernel
    that was not launched or should not have been, on a label of another
    path, on a fused run without a fused label, and on a ppe run whose
    launch units took more than one launch each."""
    launched = {k for k, n in stats["launches"].items() if n}
    profile = set(stats.get("dispatch_profile") or {})
    ok = (must <= launched <= may and profile <= labels
          and (not fused or any("fused" in k for k in profile)))
    if not ok:
        raise AssertionError(
            f"{name}: launches {stats['launches']}, dispatch_profile "
            f"{stats.get('dispatch_profile')}")
    if not any(k.startswith("striped") for k in launched):
        one_launch_per_unit(name, stats)


def phase_chrm(tmp):
    """chrM through the CLI on the card: byte-identical to the golden VCF,
    once per kernel instance (--ppe-rows, --pallas-algo striped
    --stripe-height), each run launching that instance and no other, and
    once per shipping path (PATH_RUNS, planes to fused) launching the
    unique-rows entry with its path's source."""
    fixtures = os.path.join(ROOT, "fixtures")
    with open(os.path.join(fixtures, "chrM.golden.vcf"), "rb") as handle:
        golden = handle.read()
    runs = [("ppe4", [])] + [  # NR 4 is the default
        (f"ppe{nr}", ["--ppe-rows", str(nr)]) for nr in (1, 2, 8)
    ] + [
        (f"striped{h}", ["--pallas-algo", "striped", "--stripe-height", str(h)])
        for h in (32, 8, 16)  # 32 is the default height
    ] + [(name, flags) for name, (flags, *_rest) in PATH_RUNS.items()]
    launches = {}
    for name, flags in runs:
        out = os.path.join(tmp, f"chrM.{name}.vcf")
        stats = run_cli(["-I", os.path.join(fixtures, "chrM.sam"),
                         "-R", os.path.join(fixtures, "chrM.fa"), "-O", out]
                        + flags)
        with open(out, "rb") as handle:
            identical = handle.read() == golden
        emit({"phase": "chrM", "kernel": name, "flags": flags,
              "golden_identical": identical,
              "regions": stats["regions"], "variants": stats["variants"],
              "launches": stats["launches"], "wall_s": stats["wall_s"],
              "dispatch_profile": stats.get("dispatch_profile"),
              "init_profile": stats.get("init_profile"),
              "device_stages_ms": stats.get("device_stages_ms")})
        if not identical:
            raise AssertionError(f"chrM with {name}: not the golden VCF")
        if name in PATH_RUNS:
            _f, must, may, labels = PATH_RUNS[name]
            check_run(f"chrM {name}", stats, must, may, labels)
            for k in must - {"ppe4"}:
                launches[k] = stats["launches"][k]
            continue
        # the default shipping of chrM's one group is planes
        want = {name} if name.startswith("striped") else {
            name, "ppe_front_planes"}
        check_run(f"chrM {name}", stats, want, want, {"planes", "striped"})
        launches[name] = stats["launches"][name]
    return launches


def phase_chrm_engines(tmp):
    """chrM through the engines beside the default kernel path, each
    byte-identical to the golden VCF: --genotyper cuda (the genotype
    kernel's f64 instance; the PairHMM launches of the default and no
    other), --pairhmm native --genotyper cuda (the genotype kernel alone),
    the f32 genotyper path through call_batched (genotype_regions_device
    with use_f64=False: the f32 instance, its stability guard and the
    host recompute of the sites it flags), --pairhmm diag (no kernel at
    all: the anti-diagonal forward in PyTorch ops on the card) and
    --pairhmm auto (chrM resolves to native).  -> (the f32 instance's
    launches, the f32 run's genotype tiles: recording_genotype_tiles)."""
    import functools

    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.models import caller
    from gatk_hc_tpu_torch.models import genotyper as gt
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
    from gatk_hc_tpu_torch.utils.logging import RunCounters

    fixtures = os.path.join(ROOT, "fixtures")
    sam = os.path.join(fixtures, "chrM.sam")
    fasta = os.path.join(fixtures, "chrM.fa")
    with open(os.path.join(fixtures, "chrM.golden.vcf"), "rb") as handle:
        golden = handle.read()
    default_ppe = {"ppe4", "ppe_front_planes"}
    runs = {  # name -> (flags, the launches the run must show, exactly)
        "genotyper_cuda": (["--genotyper", "cuda"],
                           default_ppe | {"genotype_f64"}),
        "native_genotyper_cuda": (
            ["--pairhmm", "native", "--genotyper", "cuda"], {"genotype_f64"}),
        "diag": (["--pairhmm", "diag"], set()),
        "auto": (["--pairhmm", "auto"], set()),
    }
    for name, (flags, want) in runs.items():
        out = os.path.join(tmp, f"chrM.{name}.vcf")
        stats = run_cli(["-I", sam, "-R", fasta, "-O", out] + flags)
        with open(out, "rb") as handle:
            identical = handle.read() == golden
        launched = {k for k, n in stats["launches"].items() if n}
        emit({"phase": "chrM", "kernel": name, "flags": flags,
              "golden_identical": identical, "engine": stats["engine"],
              "engine_requested": stats.get("engine_requested"),
              "genotyper": stats["genotyper"], "variants": stats["variants"],
              "launches": stats["launches"], "wall_s": stats["wall_s"],
              "stages": stats["stages"]})
        if not identical:
            raise AssertionError(f"chrM with {name}: not the golden VCF")
        if launched != want:
            raise AssertionError(f"chrM {name}: launched {launched}, "
                                 f"expected {want}")
        if name == "auto" and (stats["engine"], stats.get(
                "engine_requested")) != ("native", "auto"):
            raise AssertionError(f"chrM auto resolved to {stats['engine']}")
    # the f32 path: call_batched reads genotype_regions_device from its
    # module at each chunk, so a partial with use_f64=False takes its place
    f64_regions = gt.genotype_regions_device
    gt.genotype_regions_device = functools.partial(f64_regions,
                                                   use_f64=False)
    out = os.path.join(tmp, "chrM.genotyper_f32.vcf")
    counters = RunCounters()
    pt.reset_launches()
    try:
        t0 = time.perf_counter()
        with recording_genotype_tiles() as record:
            caller.call_batched(
                sam, fasta, out,
                dataclasses.replace(DEFAULT_CONFIG, genotyper_engine="cuda"),
                counters=counters)
        wall = time.perf_counter() - t0
    finally:
        gt.genotype_regions_device = f64_regions
    launches = dict(pt.LAUNCHES)
    with open(out, "rb") as handle:
        identical = handle.read() == golden
    emit({"phase": "chrM", "kernel": "genotyper_f32",
          "golden_identical": identical,
          "gq_host_verified": counters.gq_host_verified,
          "variants": counters.variants, "launches": launches,
          "wall_s": round(wall, 3)})
    if not identical:
        raise AssertionError("chrM with the f32 genotyper: not the golden VCF")
    if not launches["genotype_f32"] or launches["genotype_f64"]:
        raise AssertionError(f"chrM f32 genotyper: launches {launches}")
    return {"genotype_f32": launches["genotype_f32"]}, record


CONTIG_RUNS = {
    "ppe4": ([], {"ppe4", "ppe_front_planes"},
             {"ppe4", "ppe_front_planes", "ppe_front_nib", "ppe_front_packed"},
             {"planes", "packednib", "packed"}),
    **PATH_RUNS,
    "striped32": (["--pallas-algo", "striped"], {"striped32"}, {"striped32"},
                  {"striped"}),
    "genotyper_cuda": (["--genotyper", "cuda"],
                       {"ppe4", "ppe_front_planes", "genotype_f64"},
                       {"ppe4", "ppe_front_planes", "ppe_front_nib",
                        "ppe_front_packed", "genotype_f64"},
                       {"planes", "packednib", "packed"}),
}


def phase_contig(tmp):
    """2 Mb contig at 30x: the cuda engine through the default (adaptive
    shipping, ppe kernel, host genotyper), each shipping path of
    PATH_RUNS, the striped kernel and the genotype kernel (--genotyper
    cuda), each once and the default first and last (its two runs
    bracket the others), so that their walls and stages.genotype compare
    within one call, each VCF byte-identical to the port's native
    engine's.  -> (each kernel's launches in the first
    run of the path that drives it, the genotype tiles of the first
    --genotyper cuda run: recording_genotype_tiles, the default runs'
    walls and stages)."""
    import torch

    from gatk_hc_tpu_torch.tools import make_fixture

    fix = os.path.join(tmp, "chr20sim")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_fixture.main([fix, "--length", "2000000", "--name", "chr20sim"])
    gen_s = time.perf_counter() - t0
    base = ["-I", os.path.join(fix, "chr20sim.sam"),
            "-R", os.path.join(fix, "chr20sim.fa")]
    order = list(CONTIG_RUNS)
    runs = {name: [] for name in order}
    record = None
    for k, name in enumerate(order + order[:1]):
        vcf = os.path.join(tmp, f"chr20sim.{k}.{name}.vcf")
        torch.cuda.reset_peak_memory_stats()
        recording = contextlib.nullcontext()
        if name == "genotyper_cuda" and record is None:
            recording = recording_genotype_tiles()
        with recording as tiles:
            stats = run_cli(base + ["-O", vcf] + CONTIG_RUNS[name][0])
        record = record or tiles
        stats["cuda_max_memory_allocated_mb"] = round(
            torch.cuda.max_memory_allocated() / 2**20, 1)
        with open(vcf, "rb") as handle:
            stats["vcf"] = handle.read()
        runs[name].append(stats)
    native_vcf = os.path.join(tmp, "chr20sim.native.vcf")
    native = run_cli(base + ["-O", native_vcf, "--pairhmm", "native"])
    with open(native_vcf, "rb") as handle:
        want = handle.read()
    first = runs["ppe4"][0]
    row = {
        "phase": "contig_2mb", "fixture_gen_s": round(gen_s, 1),
        "default_cuda_max_memory_allocated_mb": [
            s["cuda_max_memory_allocated_mb"] for s in runs["ppe4"]],
        "regions": first["regions"], "variants": first["variants"],
        "cell_updates": first["cell_updates"],
        "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
        "native_wall_s": native["wall_s"], "native_stages": native["stages"],
    }
    for name, done in runs.items():
        row[name] = {
            "identical_to_native": [s["vcf"] == want for s in done],
            "wall_s": [s["wall_s"] for s in done],
            "cells_per_s": [s["cells_per_s"] for s in done],
            "stages": [s["stages"] for s in done],
            "device_stages_ms": [s.get("device_stages_ms") for s in done],
            "launches": [s["launches"] for s in done],
            "dispatch_profile": [s.get("dispatch_profile") for s in done],
            "init_profile": [s.get("init_profile") for s in done],
            "cuda_max_memory_allocated_mb": [
                s["cuda_max_memory_allocated_mb"] for s in done],
        }
    row["stages_genotype_s"] = {
        name: [s["stages"].get("genotype") for s in done]
        for name, done in runs.items()}
    emit(row)
    for name, done in runs.items():
        _flags, must, may, labels = CONTIG_RUNS[name]
        for stats in done:
            if stats["vcf"] != want:
                raise AssertionError(f"2 Mb contig with {name}: VCF differs "
                                     "from native")
            check_run(f"2 Mb {name}", stats, must, may, labels,
                      fused=name == "fused")
    return {
        "ppe4": runs["ppe4"][0]["launches"]["ppe4"],
        "striped32": runs["striped32"][0]["launches"]["striped32"],
        "genotype_f64": runs["genotyper_cuda"][0]["launches"]["genotype_f64"],
        **{f"ppe_front_{path}": runs[path][0]["launches"][f"ppe_front_{path}"]
           for path in FRONTS},
    }, record, {"regions": first["regions"],
                "wall_s": [s["wall_s"] for s in runs["ppe4"]],
                "stages": [s["stages"] for s in runs["ppe4"]]}


def region_tile(rng, n_reads, n_haps, read_len, hap_len):
    """Seeded region-like reads and haplotypes as bytes: each read drawn
    from a haplotype with ~1% substitutions, Phred 28-40 qualities (a few
    5-20), and one unrelated read in eight (which underflows on long
    reads).  -> ([(bases, quals)], [hap])."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    haps = [acgt[rng.integers(0, 4, hap_len)] for _ in range(n_haps)]
    reads = []
    for i in range(n_reads):
        hap = haps[i % n_haps]
        start = int(rng.integers(0, hap_len - read_len + 1))
        read = hap[start : start + read_len].copy()
        sub = rng.random(read_len) < 0.01
        read[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
        if i % 8 == 7:
            read = acgt[rng.integers(0, 4, read_len)]
        qual = rng.integers(28, 41, read_len)
        low = rng.random(read_len) < 0.03
        qual[low] = rng.integers(5, 21, int(low.sum()))
        reads.append((read, (qual + 33).astype(np.uint8)))
    return reads, haps


def sharded_check(grid_name, grid, shape, reads, haps, cfg, device="cuda:0"):
    """The sharded raw step on ``grid`` over a region tile, against the
    unsharded forward on the card, its plain version on the CPU and the
    cuda runner on the same pairs (all bit for bit), with ``best`` and
    ``n_rescue`` recomputed on the host.  Raises on a mismatch."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.ops.pairhmm_torch import transition_constants
    from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
    from gatk_hc_tpu_torch.parallel import sharded_step as ss
    from gatk_hc_tpu_torch.utils.quality import MIN_ACCEPTED

    trans = transition_constants(cfg.gop_char, cfg.gcp_char)
    r_pad, c_pad = shape
    nr, nh = len(reads), len(haps)
    nr_pad = ss._pow2_multiple(nr, grid.shape["data"])
    nh_pad = ss._pow2_multiple(nh, grid.shape["hap"])
    arrays = (ss._read_planes(reads, nr_pad, r_pad)
              + ss._hap_planes(haps, nh_pad, c_pad))
    step = ss.make_sharded_raw_step(grid, trans, r_pad, c_pad, cfg)
    inputs = ss.shard_inputs(grid, arrays, ss.READ_SPECS + ss.HAP_SPECS)
    step(*inputs)  # warm
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw, best, n_rescue = step(*inputs)
    step_ms = (time.perf_counter() - t0) * 1e3

    def unsharded(device):
        return ss._forward_local(
            *(torch.from_numpy(a).to(device) for a in arrays), trans, r_pad,
            c_pad, algo=cfg.pallas_algo, ppe_rows=cfg.ppe_rows,
            stripe=cfg.stripe_height).cpu().numpy()

    card = unsharded(device)
    plain = unsharded("cpu")
    runner = TorchPairHMMRunner(cfg, device=device)
    batch = runner.submit([PairHMMJob(reads, haps)]).result()
    runner.drain([batch])
    by_runner = batch.host_out.numpy()[: nr * nh].reshape(nr, nh)
    row = {
        "grid": grid_name, "shape": {"reads": nr, "haps": nh, "r_pad": r_pad,
                                     "c_pad": c_pad},
        "padded": [nr_pad, nh_pad],
        "equal_unsharded_card": bool(np.array_equal(raw, card)),
        "equal_plain": bool(np.array_equal(raw, plain)),
        "equal_runner": bool(np.array_equal(raw[:nr, :nh], by_runner)),
        "best_ok": bool(np.array_equal(best, raw.max(axis=1))),
        "n_rescue": int(n_rescue[0]),
        "n_rescue_ok": int(n_rescue[0]) == int((raw < MIN_ACCEPTED).sum()),
        "finite_positive": bool(np.isfinite(raw).all() and (raw >= 0).all()),
        "step_ms": round(step_ms, 3),
    }
    if not all(row[k] for k in ("equal_unsharded_card", "equal_plain",
                                "equal_runner", "best_ok", "n_rescue_ok",
                                "finite_positive")):
        raise AssertionError(f"sharded step {grid_name} {shape}: {row}")
    return row


def two_process_run(base, tmp, flags=(), timeout_s=900):
    """The CLI in two processes (--num-processes 2, gloo over 127.0.0.1),
    both on the same card, with the default --pairhmm cuda -> (process
    0's VCF path, its --stats, the pair's wall).  A child that fails or
    runs past ``timeout_s`` fails the phase; both are killed then."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(tmp, f"chr20sim.mp{pid}.vcf") for pid in (0, 1)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gatk_hc_tpu_torch.cli", *base, *flags,
             "-O", outs[pid], "--stats", "--num-processes", "2", "--process-id",
             str(pid), "--coordinator", f"127.0.0.1:{port}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    texts = []
    try:
        for proc in procs:
            remaining = max(1.0, timeout_s - (time.perf_counter() - t0))
            stdout, _ = proc.communicate(timeout=remaining)
            texts.append(stdout.decode(errors="replace"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for pid, (proc, text) in enumerate(zip(procs, texts)):
        if proc.returncode != 0:
            raise RuntimeError(f"process {pid} exited {proc.returncode}:\n"
                               f"{text[-3000:]}")
    stats = json.loads(next(line for line in texts[0].splitlines()
                            if line.startswith("{")))
    return outs[0], stats, wall


def phase_multi(tmp):
    """The multi-device and multi-process paths on the one card: (a) the
    sharded step on a 1x1 and a 2x2 grid of cuda:0 at the reference dryrun
    shapes and at one full-width region tile, each bit-equal to the
    unsharded forward, its plain version and the runner, and
    dryrun_multichip(1); (b) chrM through --pairhmm shardmap (golden) and
    the 2 Mb contig (identical to native); (c) the runner over two slots
    of cuda:0 on the 2 Mb contig (identical to native, launch units
    alternating 0, 1); (d) two CLI processes on the 2 Mb contig, gloo over
    loopback (process 0's VCF identical to native, the merged stats over
    all 8,164 regions).  Needs phase_contig's fixture and native VCF in
    ``tmp``.  -> the ppe4 launches of the 2 Mb shardmap run."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch import entry
    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.models.caller import call_batched
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt
    from gatk_hc_tpu_torch.ops.runner import TorchPairHMMRunner
    from gatk_hc_tpu_torch.parallel.sharded_step import make_mesh

    cfg = DEFAULT_CONFIG
    rng = np.random.default_rng(11)
    rows = []
    for name, hap_parallel, n in (("1x1", 1, 1), ("2x2", 2, 4)):
        grid = make_mesh(n, hap_parallel=hap_parallel,
                         devices=["cuda:0"] * n)
        data = n // hap_parallel
        # the reference dryrun: 4 reads per data slot, 2 haps per hap
        # slot, r_pad 16, c_pad 128; then one full-width region tile
        for (nr, nh, rlen, hlen), shape in (
                ((4 * data, 2 * hap_parallel, 14, 120), (16, 128)),
                ((96, 16, 151, 415), (160, 448))):
            reads, haps = region_tile(rng, nr, nh, rlen, hlen)
            rows.append(sharded_check(name, grid, shape, reads, haps, cfg))
    with contextlib.redirect_stdout(io.StringIO()):
        dry = entry.dryrun_multichip(1)
    emit({"phase": "multi_sharded_step", "checks": rows, "dryrun": dry})

    fixtures = os.path.join(ROOT, "fixtures")
    with open(os.path.join(fixtures, "chrM.golden.vcf"), "rb") as handle:
        golden = handle.read()
    out = os.path.join(tmp, "chrM.shardmap.vcf")
    stats = run_cli(["-I", os.path.join(fixtures, "chrM.sam"),
                     "-R", os.path.join(fixtures, "chrM.fa"), "-O", out,
                     "--pairhmm", "shardmap"])
    with open(out, "rb") as handle:
        chrm_ok = handle.read() == golden
    chrm = {"golden_identical": chrm_ok, "wall_s": stats["wall_s"],
            "launches": {k: n for k, n in stats["launches"].items() if n}}
    if not chrm_ok or set(chrm["launches"]) != {"ppe4"}:
        raise AssertionError(f"chrM --pairhmm shardmap: {chrm}")

    fix = os.path.join(tmp, "chr20sim")
    base = ["-I", os.path.join(fix, "chr20sim.sam"),
            "-R", os.path.join(fix, "chr20sim.fa")]
    with open(os.path.join(tmp, "chr20sim.native.vcf"), "rb") as handle:
        native = handle.read()

    def same_as_native(path):
        with open(path, "rb") as handle:
            return handle.read() == native

    torch.cuda.reset_peak_memory_stats()
    vcf = os.path.join(tmp, "chr20sim.shardmap.vcf")
    stats = run_cli(base + ["-O", vcf, "--pairhmm", "shardmap"])
    shardmap = {
        "identical_to_native": same_as_native(vcf),
        "wall_s": stats["wall_s"], "regions": stats["regions"],
        "kernel_launches": stats.get("kernel_launches"),
        "launches": {k: n for k, n in stats["launches"].items() if n},
        "stages": stats["stages"], "peak_rss_mb": stats.get("peak_rss_mb"),
        "cuda_max_memory_allocated_mb": round(
            torch.cuda.max_memory_allocated() / 2**20, 1),
    }
    if (not shardmap["identical_to_native"]
            or set(shardmap["launches"]) != {"ppe4"}):
        raise AssertionError(f"2 Mb --pairhmm shardmap: {shardmap}")

    torch.cuda.reset_peak_memory_stats()
    runner = TorchPairHMMRunner(cfg, devices=["cuda:0", "cuda:0"])
    vcf = os.path.join(tmp, "chr20sim.two_slots.vcf")
    pt.reset_launches()
    t0 = time.perf_counter()
    call_batched(base[1], base[3], vcf, cfg, runner=runner)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in pt.LAUNCHES.items() if n}
    placements = runner.placements
    two_slots = {
        "identical_to_native": same_as_native(vcf), "wall_s": round(wall, 3),
        "launch_units": len(placements),
        "alternating": placements == [i % 2 for i in range(len(placements))],
        "per_slot": [placements.count(0), placements.count(1)],
        "launches": launches, "dispatch_profile": dict(runner.dispatch_counts),
        "cuda_max_memory_allocated_mb": round(
            torch.cuda.max_memory_allocated() / 2**20, 1),
    }
    if not (two_slots["identical_to_native"] and two_slots["alternating"]
            and len(placements) >= 2 and launches.get("ppe4")):
        raise AssertionError(f"2 Mb runner over two slots: {two_slots}")

    vcf, stats, wall = two_process_run(base, tmp)
    cluster = stats.get("cluster") or {}
    two_process = {
        "identical_to_native": same_as_native(vcf), "pair_wall_s":
        round(wall, 3), "process0_wall_s": stats["wall_s"],
        "process0_regions": stats["regions"],
        "processes": cluster.get("processes"),
        "merged_regions": (cluster.get("counters") or {}).get("regions"),
        "timers_max": cluster.get("timers_max"),
        "process0_kernel_launches": stats.get("kernel_launches"),
        "process0_cuda_max_memory_allocated_mb":
        stats.get("cuda_max_memory_allocated_mb"),
    }
    if not (two_process["identical_to_native"]
            and two_process["processes"] == 2
            and two_process["merged_regions"] == 8164
            > two_process["process0_regions"]):
        raise AssertionError(f"2 Mb in two processes: {two_process}")
    emit({"phase": "multi_paths", "chrM_shardmap": chrm,
          "contig_shardmap": shardmap, "contig_two_slots": two_slots,
          "contig_two_processes": two_process})
    return shardmap["launches"]["ppe4"]


# fuzz seeds of the JAX package's draw (tools/fuzz_differential.py
# run_seed), both profiles and 1-3 contigs: seed -> contig kb x contigs,
# depth, profile: 1019 6x1 30x homopolymer, 1010 6x1 30x uniform, 1005
# 6x2 30x homopolymer, 1100 6x2 30x uniform, 1028 6x2 8x homopolymer,
# 1116 6x3 30x homopolymer, 1131 6x3 8x uniform.  The diag arm takes ~0.2
# s a region on the card, most of the phase.
FUZZ_SEEDS = (1019, 1010, 1005, 1100, 1028, 1116, 1131)
# phase_tools' multi-contig fixture: 4 contigs of this length, 2,041
# regions each
CTG4_LENGTH = 500_000
CTG4_REGIONS = 4 * 2041
_PPE_ANY = {"ppe4", "ppe_front_planes", "ppe_front_packed", "ppe_front_nib"}
# each device arm: the kernels it must launch on every seed, and the only
# ones it may
FUZZ_LAUNCHES = {
    "cuda": ({"ppe4"}, _PPE_ANY),
    "cuda_striped": ({"striped32"}, {"striped32"}),
    "cuda_stream_mt": ({"ppe4"}, _PPE_ANY),
    "diag": (set(), set()),
    "shardmap": ({"ppe4"}, {"ppe4"}),
    "genotyper_cuda": ({"ppe4", "genotype_f64"}, _PPE_ANY | {"genotype_f64"}),
}


def vcf_difference(a: bytes, b: bytes, n: int = 6):
    """The first ``n`` lines of each VCF that the other lacks."""
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    sa, sb = set(la), set(lb)
    return ([x for x in la if x not in sb][:n], [x for x in lb if x not in sa][:n])


def phase_tools(tmp, contig_default):
    """The port's correctness tools on the card: (a) the differential
    fuzzer (tools/fuzz_differential.py) on FUZZ_SEEDS with every arm, one
    runner per device arm for all seeds, each seed's VCFs byte-identical
    and each device arm launching its kernels (counts reset before each
    arm, read after it); (b) a 4 x 500 kb contig fixture at 30x through
    --stream-contigs with the default cuda runner and 4 host threads (the
    contig switch and parse-ahead beside the dispatch worker), the same
    unstreamed and --pairhmm native, the three VCFs identical, with
    check_truth's sensitivity; (c) tools/host_profile.py (the device
    stubbed out) on phase_contig's 2 Mb contig beside the default cuda
    runs' walls and stages."""
    import torch

    from gatk_hc_tpu_torch.config import DEFAULT_CONFIG
    from gatk_hc_tpu_torch.tools import check_truth, host_profile, make_fixture
    from gatk_hc_tpu_torch.tools import fuzz_differential as fz

    runners = fz.ArmRunners("cuda")
    keep = os.path.join(tmp, "fuzz_failures")
    t0 = time.perf_counter()
    for seed in FUZZ_SEEDS:
        row = fz.run_seed(seed, keep, fz.ARMS, runners=runners)
        emit({"phase": "tools_fuzz", **row})
        if not row["ok"]:
            kept = os.path.join(keep, f"seed{seed}")
            with open(os.path.join(kept, f"{fz.ARMS[0]}.vcf"), "rb") as handle:
                want = handle.read()
            for arm in row["differ"]:
                with open(os.path.join(kept, f"{arm}.vcf"), "rb") as handle:
                    only_want, only_arm = vcf_difference(want, handle.read())
                emit({"phase": "tools_fuzz_diff", "seed": seed, "arm": arm,
                      "only_python": only_want, "only_arm": only_arm})
            raise AssertionError(f"fuzz seed {seed}: {row['differ']} differ "
                                 "from the python arm")
        for arm, (must, may) in FUZZ_LAUNCHES.items():
            launched = set(row["device"][arm]["kernel_launches"])
            if not must <= launched <= may:
                raise AssertionError(f"fuzz seed {seed} arm {arm}: launched "
                                     f"{launched}, expected {must} <= it <= "
                                     f"{may}")
    fuzz_s = time.perf_counter() - t0

    fix = os.path.join(tmp, "ctg4")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_fixture.main([fix, "--contigs", "4", "--length",
                           str(CTG4_LENGTH), "--name", "ctg4"])
    gen_s = time.perf_counter() - t0
    base = ["-I", os.path.join(fix, "ctg4.sam"),
            "-R", os.path.join(fix, "ctg4.fa")]
    runs = {
        "stream_cuda": ["--stream-contigs", "--host-threads", "4"],
        "unstreamed_cuda": ["--host-threads", "4"],
        "native": ["--pairhmm", "native"],
    }
    done, vcfs = {}, {}
    for name, flags in runs.items():
        vcf = os.path.join(tmp, f"ctg4.{name}.vcf")
        torch.cuda.reset_peak_memory_stats()
        stats = run_cli(base + ["-O", vcf] + flags)
        with open(vcf, "rb") as handle:
            vcfs[name] = handle.read()
        done[name] = {
            "wall_s": stats["wall_s"], "regions": stats["regions"],
            "variants": stats["variants"], "stages": stats["stages"],
            "launches": {k: n for k, n in stats["launches"].items() if n},
            "dispatch_profile": stats.get("dispatch_profile"),
            "device_stages_ms": stats.get("device_stages_ms"),
            "cuda_max_memory_allocated_mb": round(
                torch.cuda.max_memory_allocated() / 2**20, 1),
        }
        if name != "native":
            check_run(f"4 contigs {name}", stats, {"ppe4"}, _PPE_ANY,
                      {"planes", "packednib", "packed"})
    truth = check_truth.check(os.path.join(tmp, "ctg4.stream_cuda.vcf"),
                              os.path.join(fix, "ctg4.truth.txt"))
    identical = {name: vcfs[name] == vcfs["native"] for name in runs}
    emit({"phase": "tools_4contig_stream", "fixture_gen_s": round(gen_s, 1),
          "identical_to_native": identical, "check_truth": truth,
          "fuzz_s": round(fuzz_s, 1), **done})
    if not all(identical.values()):
        raise AssertionError(f"4-contig fixture: VCFs differ {identical}")
    if (done["stream_cuda"]["regions"] != CTG4_REGIONS
            or not truth["sensitivity"]):
        raise AssertionError(f"4-contig fixture: {done['stream_cuda']}, "
                             f"{truth}")

    fix = os.path.join(tmp, "chr20sim")
    prof = host_profile.profile(
        os.path.join(fix, "chr20sim.sam"), os.path.join(fix, "chr20sim.fa"),
        threads=DEFAULT_CONFIG.host_threads)[0]
    emit({"phase": "tools_host_profile", "host_threads":
          DEFAULT_CONFIG.host_threads, "stub": prof,
          "default_cuda": contig_default,
          "stub_wall_over_default_wall": [
              round(prof["wall_s"] / w, 3) for w in contig_default["wall_s"]]})
    if (prof["regions"] != contig_default["regions"]
            or not prof["reads_parsed"]):
        raise AssertionError(f"host_profile on 2 Mb: {prof}")


# phase_long_reads: reads past the largest read bucket (224), as 2x250
# kits and MiSeq 2x300 runs give them (make_fixture --read-length): the
# contig name, its length, the read length, and the r_pad the default ppe
# run and the striped run must launch at (ppe rounds to 8, striped to the
# stripe height: ppe K 8 in one stripe at 256, K 8 in two with a carry at
# 304; striped32 K 8 at 256, K 5 in two stripes with a carry at 320)
LONG_READS = (("lr250", 500_000, 250, 256, 256),
              ("lr300", 250_000, 300, 304, 320))
# --pairhmm diag's window, beside native's on it: ~21 regions of ~0.3 s
LONG_WINDOW = 5_000
# fuzz seeds per read length (the one- and two-contig 6 kb genomes of
# FUZZ_SEEDS, both profiles) and the arms: every device arm but shardmap,
# whose bucketed planes raise past 224 bases in both packages
LONG_FUZZ = ((250, (1019, 1010)), (300, (1019, 1028)))
LONG_FUZZ_ARMS = ("native", "cuda", "cuda_striped", "cuda_stream_mt", "diag",
                  "genotyper_cuda")
LONG_RUNS = {
    "cuda": ([], {"ppe4", "ppe_front_planes"}, _PPE_ANY,
             {"planes", "packednib", "packed"}),
    "striped": (["--pallas-algo", "striped"], {"striped32"}, {"striped32"},
                {"striped"}),
    "genotyper_cuda": (["--genotyper", "cuda"],
                       {"ppe4", "ppe_front_planes", "genotype_f64"},
                       _PPE_ANY | {"genotype_f64"},
                       {"planes", "packednib", "packed"}),
    "native": (["--pairhmm", "native"], set(), set(), set()),
}


@contextlib.contextmanager
def recording_front_units():
    """Inside, every launch of the ppe kernel's unique-rows entry is
    tallied by (r_pad, c_pad, source), and the first launch unit of each
    is kept: its segments with their device views cloned on the launching
    stream (after its copy), the table, the transitions and NR.  The
    launch and its count stay the wrapper's own.  Yields {"units": {key:
    launches}, "inputs": {key: (segments, table, trans, nr)}}."""
    from gatk_hc_tpu_torch.ops import pairhmm_front as pf

    launch = pf.ppe_forward_unique
    record = {"units": {}, "inputs": {}}

    def recording(path, segments, ppe_table, trans, ppe_rows=4):
        segments = list(segments)
        key = (*segments[0].dims[2:], path)
        record["units"][key] = record["units"].get(key, 0) + 1
        if key not in record["inputs"]:
            record["inputs"][key] = ([
                dataclasses.replace(seg, views=tuple(v.clone()
                                                     for v in seg.views))
                for seg in segments], ppe_table, trans, ppe_rows)
        return launch(path, segments, ppe_table, trans, ppe_rows)

    pf.ppe_forward_unique = recording
    try:
        yield record
    finally:
        pf.ppe_forward_unique = launch


def front_unit_row(run, key, launches, inputs):
    """The entry on one recorded launch unit against its plain version,
    bit for bit, with its time (uncounted launches), the plain version's
    and the bound of its pairs (ppe_bound).  Raises when they differ."""
    import numpy as np
    import torch

    from gatk_hc_tpu_torch.ops import pairhmm_front as pf
    from gatk_hc_tpu_torch.ops import pairhmm_torch as pt

    segs, tab, trans, nr = inputs
    r_pad, c_pad, path = key
    pf.check(path, segs, tab)
    unit = lambda: pf.launch_ppe_unique(path, segs, tab, trans, nr)  # noqa: E731
    torch.cuda.synchronize()
    got = unit()
    want, plain_ms = timed_once(
        lambda: pf.ppe_forward_unique_plain(path, segs, tab, trans))
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    parts = [pf.segment_inputs(path, seg, tab) for seg in segs]
    rlen = np.concatenate([p[2].cpu().numpy() for p in parts])
    clen = np.concatenate([p[3].cpu().numpy() for p in parts])
    bound_ms, bound_by = ppe_bound(rlen, clen, c_pad)
    k = pt.rows_per_lane(pt.select_rows(nr, r_pad), r_pad)
    row = {
        "phase": "long_reads_unit", "run": run, "r_pad": r_pad,
        "c_pad": c_pad, "source": path, "launches": launches,
        "segments": len(segs), "B": int(got.numel()),
        "rows_per_lane": k, "stripes": pt.ppe_stripes(k, r_pad),
        "bit_equal_plain": same,
        "max_abs_err": float((got - want).abs().max()),
        "ms": round(time_ms(unit, 10), 4), "plain_ms": round(plain_ms, 3),
        "bound_ms": round(bound_ms, 4), "bound_by": bound_by,
    }
    row["pct_of_bound"] = round(100 * row["bound_ms"] / row["ms"], 1)
    emit(row)
    if not same:
        raise AssertionError(f"{run}: the entry differs from its plain "
                             f"version on the unit at {key}")
    return row


def phase_long_reads(tmp):
    """Reads past the largest read bucket through the main path on the
    card (LONG_READS): (a) a 500 kb contig at 30x with 250 bp reads and a
    250 kb one with 300 bp reads, made together by two make_fixture
    processes; (b) on each, in this process, the default cuda CLI,
    --pallas-algo striped, --genotyper cuda and --pairhmm native, each VCF
    byte-identical to native's, and --pairhmm diag on a LONG_WINDOW window
    identical to native's on it; each run's wall_s, bucket_counts and
    kernel launches printed; the default run must launch the entry at the
    ppe r_pad and the striped run group at the striped r_pad; (c) the entry
    against its plain version on the first unit the default run launched
    at each (r_pad, c_pad, source) (recording_front_units); (d) the fuzzer
    on LONG_FUZZ through LONG_FUZZ_ARMS, each seed identical; (e) a 300 bp
    run through --pairhmm shardmap raises the bucket ValueError, as the
    JAX package's sharded step does.  -> {"units": the (c) rows,
    "striped_groups": the striped runs' long-read groups by shape}."""
    from gatk_hc_tpu_torch.tools import fuzz_differential as fz

    t_phase = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gatk_hc_tpu_torch.tools.make_fixture",
         os.path.join(tmp, name), "--length", str(length), "--read-length",
         str(read_len), "--name", name], cwd=ROOT, stdout=subprocess.DEVNULL)
        for name, length, read_len, _p, _s in LONG_READS]
    for proc in procs:
        if proc.wait(timeout=600) != 0:
            raise RuntimeError(f"make_fixture exited {proc.returncode}")
    gen_s = time.perf_counter() - t_phase

    units, striped_groups = [], {}
    for name, length, read_len, ppe_r, striped_r in LONG_READS:
        fix = os.path.join(tmp, name)
        base = ["-I", os.path.join(fix, f"{name}.sam"),
                "-R", os.path.join(fix, f"{name}.fa")]
        window = ["-L", f"{name}:{length // 2}-{length // 2 + LONG_WINDOW}"]
        runs = {run: flags for run, (flags, *_rest) in LONG_RUNS.items()}
        runs["diag"] = ["--pairhmm", "diag"] + window
        runs["native_window"] = ["--pairhmm", "native"] + window
        done, vcfs, record = {}, {}, None
        for run, flags in runs.items():
            vcf = os.path.join(tmp, f"{name}.{run}.vcf")
            recording = (recording_front_units() if run == "cuda"
                         else contextlib.nullcontext())
            with recording as rec:
                stats = run_cli(base + ["-O", vcf] + flags)
            record = record or rec
            with open(vcf, "rb") as handle:
                vcfs[run] = handle.read()
            done[run] = stats
        identical = {run: vcfs[run] == vcfs["native"] for run in LONG_RUNS}
        identical["diag"] = vcfs["diag"] == vcfs["native_window"]
        entry_units = {f"{r}x{c}:{path}": n
                       for (r, c, path), n in sorted(record["units"].items())}
        emit({"phase": "long_reads", "fixture": name, "length": length,
              "read_length": read_len, "identical_to_native": identical,
              "regions": done["native"]["regions"],
              "variants": done["native"]["variants"],
              "window_regions": done["native_window"]["regions"],
              "entry_units": entry_units,
              **{run: {"wall_s": s["wall_s"],
                       "bucket_counts": s.get("bucket_counts"),
                       "kernel_launches": {k: n for k, n
                                           in s["launches"].items() if n},
                       "dispatch_profile": s.get("dispatch_profile")}
                 for run, s in done.items()}})
        if not all(identical.values()):
            raise AssertionError(f"{name}: VCFs differ from native's "
                                 f"{identical}")
        for run, (_flags, must, may, labels) in LONG_RUNS.items():
            if must:
                check_run(f"{name} {run}", done[run], must, may, labels)
        if {k: n for k, n in done["diag"]["launches"].items() if n}:
            raise AssertionError(f"{name} diag launched kernels")
        if not any(r == ppe_r for r, _c, _p in record["units"]):
            raise AssertionError(f"{name} cuda: no unit at r_pad {ppe_r}: "
                                 f"{entry_units}")
        groups = done["striped"].get("bucket_counts") or {}
        long_groups = {k: n for k, n in groups.items()
                       if int(k.split("x")[0]) == striped_r}
        if not long_groups:
            raise AssertionError(f"{name} striped: no group at r_pad "
                                 f"{striped_r}: {groups}")
        striped_groups.update(long_groups)
        for key in sorted(record["inputs"]):
            units.append(front_unit_row(f"{name} cuda", key,
                                        record["units"][key],
                                        record["inputs"][key]))

    t_fuzz = time.perf_counter()
    runners = fz.ArmRunners("cuda")
    keep = os.path.join(tmp, "long_fuzz_failures")
    for read_len, seeds in LONG_FUZZ:
        for seed in seeds:
            row = fz.run_seed(seed, keep, LONG_FUZZ_ARMS, runners=runners,
                              read_len=read_len)
            emit({"phase": "long_reads_fuzz", **row})
            if not row["ok"]:
                raise AssertionError(f"fuzz seed {seed} at {read_len} bp: "
                                     f"{row['differ']} differ from native")
            for arm in LONG_FUZZ_ARMS[1:]:
                must, may = FUZZ_LAUNCHES[arm]
                launched = set(row["device"][arm]["kernel_launches"])
                if not must <= launched <= may:
                    raise AssertionError(
                        f"fuzz seed {seed} at {read_len} bp arm {arm}: "
                        f"launched {launched}, expected {must} <= it <= {may}")
            if not any(int(k.split("x")[0]) > 224
                       for k in row["device"]["cuda"]["buckets"]):
                raise AssertionError(f"fuzz seed {seed} at {read_len} bp: "
                                     f"cuda buckets {row['device']['cuda']}")
    fuzz_s = time.perf_counter() - t_fuzz

    name, length = LONG_READS[1][:2]
    fix = os.path.join(tmp, name)
    try:
        run_cli(["-I", os.path.join(fix, f"{name}.sam"),
                 "-R", os.path.join(fix, f"{name}.fa"),
                 "-O", os.path.join(tmp, f"{name}.shardmap.vcf"),
                 "--pairhmm", "shardmap",
                 "-L", f"{name}:{length // 2}-{length // 2 + 2000}"])
    except ValueError as exc:
        shardmap_error = str(exc)
    else:
        shardmap_error = None
    emit({"phase": "long_reads_summary", "fixture_gen_s": round(gen_s, 1),
          "fuzz_s": round(fuzz_s, 1), "shardmap_error": shardmap_error,
          "phase_s": round(time.perf_counter() - t_phase, 1)})
    if not shardmap_error or "exceeds largest bucket 224" not in shardmap_error:
        raise AssertionError("300 bp reads through --pairhmm shardmap: "
                             f"expected the bucket ValueError, got "
                             f"{shardmap_error!r}")
    return {"units": units, "striped_groups": striped_groups}


def fresh_process(args, env=None, timeout_s=900):
    """``python args...`` in a fresh process from the checkout's root ->
    (its wall in s, its stdout lines).  Raises when it fails."""
    full_env = dict(os.environ, PYTHONPATH=ROOT)
    full_env.update(env or {})
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{args[:3]} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return wall, proc.stdout.splitlines()


# the CLI in a fresh process that reports, on its last line, whether torch
# was loaded when it ended
CLI_WRAPPER = ("import json, sys\n"
               "from gatk_hc_tpu_torch import cli\n"
               "rc = cli.main(sys.argv[1:])\n"
               "print(json.dumps({'rc': rc, 'torch_loaded': "
               "'torch' in sys.modules}))\n")


def cold_cli(argv, env=None):
    """One CLI run with --stats in a fresh process -> (process wall, its
    --stats, whether torch was loaded at its end)."""
    wall, lines = fresh_process(["-c", CLI_WRAPPER, *argv, "--stats"], env)
    tail = json.loads(lines[-1])
    if tail["rc"] != 0:
        raise RuntimeError(f"cli {argv} exited {tail['rc']}")
    stats = json.loads(next(line for line in lines if line.startswith("{")))
    return wall, stats, tail["torch_loaded"]


def all_hits(name, init):
    """The run found every kernel library in the cache and started no
    nvcc (the cache's own record, init_profile.kernel_cache)."""
    cache = (init or {}).get("kernel_cache") or {}
    libs = cache.get("libraries") or {}
    from gatk_hc_tpu_torch.ops import _kernels

    if (set(libs) != set(_kernels.KERNELS) or cache.get("nvcc_runs") != 0
            or any(rec["status"] != "hit" for rec in libs.values())):
        raise AssertionError(f"{name}: kernel cache {cache}")
    return cache


def phase_cold(tmp, contig_default):
    """The cold start, every run a fresh process: (a) ``import torch``
    alone, twice; (b) chrM through --pairhmm native --stats: the golden
    VCF, torch never loaded; (c) the 2 Mb contig of phase_contig through
    the default cuda CLI, twice: each VCF identical to native, torch
    imported on the build thread (init_profile.torch_import_s,
    torch_preloaded false), every kernel library a cache hit, the walls
    and main-thread stages beside phase_contig's warm in-process runs;
    (d) tools/warm_cache.py into an empty cache
    directory (every library built, every instance bit-equal to its plain
    version), then chrM through the cuda CLI with
    GATK_HC_TPU_TORCH_KERNEL_CACHE on that directory: every library a hit,
    no nvcc, the golden VCF."""
    from gatk_hc_tpu_torch.parallel.compile_cache import CACHE_ENV

    fixtures = os.path.join(ROOT, "fixtures")
    chrm = ["-I", os.path.join(fixtures, "chrM.sam"),
            "-R", os.path.join(fixtures, "chrM.fa")]
    with open(os.path.join(fixtures, "chrM.golden.vcf"), "rb") as handle:
        golden = handle.read()
    row = {"phase": "cold"}

    imports = []
    for _ in range(2):
        wall, lines = fresh_process([
            "-c", "import time; t = time.perf_counter(); import torch; "
            "print(time.perf_counter() - t)"])
        imports.append({"import_s": round(float(lines[-1]), 3),
                        "process_wall_s": round(wall, 3)})
    row["import_torch"] = imports

    out = os.path.join(tmp, "chrM.cold_native.vcf")
    wall, stats, torch_loaded = cold_cli(chrm + ["-O", out, "--pairhmm",
                                                 "native"])
    with open(out, "rb") as handle:
        identical = handle.read() == golden
    row["chrM_native"] = {
        "process_wall_s": round(wall, 3), "wall_s": stats["wall_s"],
        "pre_main_s": stats.get("pre_main_s"), "golden_identical": identical,
        "torch_loaded": torch_loaded}
    if not identical or torch_loaded:
        emit(row)
        raise AssertionError(f"cold chrM native: {row['chrM_native']}")

    fix = os.path.join(tmp, "chr20sim")
    contig = ["-I", os.path.join(fix, "chr20sim.sam"),
              "-R", os.path.join(fix, "chr20sim.fa")]
    with open(os.path.join(tmp, "chr20sim.native.vcf"), "rb") as handle:
        want = handle.read()
    runs = []
    for k in range(2):
        out = os.path.join(tmp, f"chr20sim.cold{k}.vcf")
        wall, stats, _loaded = cold_cli(contig + ["-O", out])
        with open(out, "rb") as handle:
            identical = handle.read() == want
        init = stats.get("init_profile") or {}
        runs.append({
            "process_wall_s": round(wall, 3), "wall_s": stats["wall_s"],
            "process_age_s": stats.get("process_age_s"),
            "pre_main_s": stats.get("pre_main_s"),
            "identical_to_native": identical, "stages": stats["stages"],
            "init_profile": init,
            "device_stages_ms": stats.get("device_stages_ms")})
        if (not identical or init.get("torch_preloaded") is not False
                or not init.get("torch_import_s")
                or "build_start_at_age_s" not in init):
            emit({**row, "contig_cold": runs})
            raise AssertionError(f"cold 2 Mb cuda run {k}: {runs[-1]}")
        all_hits(f"cold 2 Mb cuda run {k}", init)
    row["contig_cold"] = runs
    row["contig_warm_in_process"] = contig_default

    cache = os.path.join(tmp, "kernel_cache")
    wall, lines = fresh_process(["-m", "gatk_hc_tpu_torch.tools.warm_cache",
                                 "--cache-dir", cache])
    warm = json.loads(lines[-1])
    warm["process_wall_s"] = round(wall, 3)
    row["warm_cache"] = warm
    counters = {c for inst in warm["instances"].values()
                for c in inst["counters"]}
    if (warm["nvcc_runs"] != len(warm["libraries"])
            or any(rec["status"] != "built"
                   for rec in warm["libraries"].values())
            or not all(inst["bit_equal_plain"]
                       for inst in warm["instances"].values())
            or counters != set(KERNEL_NAMES)):
        emit(row)
        raise AssertionError(f"warm_cache into an empty cache: {warm}")
    out = os.path.join(tmp, "chrM.cold_cached.vcf")
    wall, stats, _loaded = cold_cli(chrm + ["-O", out], env={CACHE_ENV: cache})
    with open(out, "rb") as handle:
        identical = handle.read() == golden
    init = stats.get("init_profile") or {}
    row["chrM_cuda_on_warmed_cache"] = {
        "process_wall_s": round(wall, 3), "wall_s": stats["wall_s"],
        "golden_identical": identical, "init_profile": init}
    emit(row)
    if not identical:
        raise AssertionError("chrM on the warmed cache: not the golden VCF")
    if os.path.realpath(all_hits("chrM on the warmed cache", init)["dir"]) \
            != os.path.realpath(cache):
        raise AssertionError(f"chrM on the warmed cache: {init}")


def long_read_unit(row):
    """A phase_long_reads unit as a field of the kernels line."""
    keys = ("run", "r_pad", "c_pad", "source", "B", "rows_per_lane",
            "stripes", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by")
    return {k: row[k] for k in keys}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "gatk_hc_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = phase_card()
    kernels = phase_kernels()
    fronts = phase_front()
    genotypes = phase_genotyper()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        chrm_launches = phase_chrm(tmp)
        f32_launches, f32_tiles = phase_chrm_engines(tmp)
        chrm_launches.update(f32_launches)
        contig_launches, contig_tiles, contig_default = phase_contig(tmp)
        phase_multi(tmp)
        phase_tools(tmp, contig_default)
        long_reads = phase_long_reads(tmp)
        phase_cold(tmp, contig_default)
    # the genotype kernel at the tiles its main-path runs gave it: the
    # kernels line reports each instance at its run's most common shape
    main_tiles = {
        "genotype_f64": phase_genotyper_main("2 Mb --genotyper cuda",
                                             contig_tiles),
        "genotype_f32": phase_genotyper_main("chrM f32 genotyper", f32_tiles),
    }
    lines = []
    for name in [f"ppe{nr}" for nr in (1, 2, 4, 8)] + [
        f"striped{h}" for h in STRIPES
    ]:
        rows = [v for (k, _r, _c), v in kernels.items() if k == name]
        rep = kernels[(name,) + REPORT_SHAPE]
        striped = name.startswith("striped")
        lines.append({
            "name": name, "route": "cuda",
            "source": STRIPED_SOURCE if striped else PPE_SOURCE,
            "replaces": STRIPED_REPLACES if striped
            else PPE_REPLACES[int(name[3:])],
            # the main path's run of this instance: the defaults (ppe4,
            # striped32) drive the 2 Mb contig; chrM runs every instance
            "launches": contig_launches.get(name) or chrm_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None,
            "shape": {"B": rep["B"], "r_pad": rep["r_pad"],
                      "c_pad": rep["c_pad"]},
            **{k: rep[k] for k in LAUNCH_KEYS if k in rep},
        })
        if name == "ppe4":  # the default instance: phase_long_reads' units
            lines[-1]["long_read_units"] = [
                long_read_unit(u) for u in long_reads["units"]]
        elif name == "striped32":
            lines[-1]["long_read_groups"] = long_reads["striped_groups"]
    for path in FRONTS:
        name = f"ppe_front_{path}"
        rows = [v for (k, *_rest), v in fronts.items() if k == name]
        rep = fronts[(name,) + REPORT_SHAPE + ("group",)]
        lines.append({
            "name": name, "route": "cuda", "source": PPE_SOURCE,
            "replaces": FRONT_REPLACES[path],
            "launches": contig_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None,
            "shape": {"B": rep["B"], "r_pad": rep["r_pad"],
                      "c_pad": rep["c_pad"]},
            "long_read_units": [long_read_unit(u)
                                for u in long_reads["units"]
                                if u["source"] == path],
        })
    for name, main in main_tiles.items():
        rows = [v for (k, *_rest), v in genotypes.items() if k == name]
        rows += main
        rep = main[0]
        lines.append({
            "name": name, "route": "cuda", "source": GENOTYPER_SOURCE,
            "replaces": GENOTYPER_REPLACES,
            # f64: the 2 Mb --genotyper cuda run; f32: chrM's guarded run
            "launches": contig_launches.get(name) or chrm_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None,
            "shape": {"S": rep["S"], "R": rep["R"], "H": rep["H"]},
        })
    assert [line["name"] for line in lines] == list(KERNEL_NAMES)
    print(smi, flush=True)
    emit({"kernels": lines})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
