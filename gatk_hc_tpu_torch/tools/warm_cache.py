"""Fill the kernel cache and launch every kernel instance once.

    python -m gatk_hc_tpu_torch.tools.warm_cache [--quick] [--cache-dir D]

The counterpart of the reference's tools/warm_cache.py.  It builds every
kernel library (ops/_kernels.py, one nvcc per source, started together)
into the kernel cache (parallel/compile_cache.py: GATK_HC_TPU_TORCH_KERNEL_CACHE,
or ``--cache-dir``), loads each one, then launches on the card, once,
every kernel instance that the CLI's flags can reach: the ppe kernel at
--ppe-rows 1, 2, 4 and 8 through both its entries (pair-minor, and the
unique-rows entry from each shipping encoding: planes, packed, nib), the
striped kernel at --stripe-height 8, 16 and 32, and the genotype kernel's
f64 and f32 instances.  Each launch runs on a small seeded input at
``WARM_SHAPE`` and is held bit for bit against the kernel's plain PyTorch
version on the same input.  A deployment runs it once per node and
toolkit; every later process then finds each library in the cache
(``hit``) and starts no nvcc.

It prints one JSON line: per library ``hit`` or ``built`` and its build
and load seconds, and per instance the launch counters it moved, the
machine-code instance it ran (named as chip_smoke.py's compiler report
names them, by rows per lane K) and its first launch in ms (the lazy
module load included).  ``--quick`` does only the default path: ppe4
through the unique-rows entry from planes and from nib, and
genotype_f64.

The reference warmed one program per (chunk, bucket) shape, because each
shape was its own traced JAX program.  A CUDA instance serves every
shape (the shape is a launch argument), so the port warms each instance
once.  With no card or no nvcc it raises: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Tuple

import numpy as np

from ..ops import _kernels
from ..parallel.compile_cache import enable_compile_cache

# the main path's most common group shape (151 bp reads, 415 bp windows)
WARM_SHAPE = (160, 448)
PPE_ROWS = (1, 2, 4, 8)
PPE_ENTRIES = ("pair_minor", "planes", "packed", "nib")
STRIPES = (8, 16, 32)
GENOTYPE_TILE = (32, 16, 8)  # (S, R, H)


@dataclasses.dataclass(frozen=True)
class Instance:
    """One launch: ``kernel`` "ppe" (``arg`` = NR), "striped" (``arg`` =
    H) or "genotype" (``arg`` = 64 or 32 bits), through ``entry``."""

    kernel: str
    arg: int
    entry: str = ""

    @property
    def name(self) -> str:
        if self.kernel == "ppe":
            return f"ppe{self.arg}" + (
                "" if self.entry == "pair_minor" else f"_front_{self.entry}")
        if self.kernel == "striped":
            return f"striped{self.arg}"
        return f"genotype_f{self.arg}"

    @property
    def counters(self) -> Tuple[str, ...]:
        """The LAUNCHES counters one launch of it moves."""
        if self.kernel == "ppe":
            from ..ops.pairhmm_torch import select_rows

            nr = f"ppe{select_rows(self.arg, WARM_SHAPE[0])}"
            return (nr,) if self.entry == "pair_minor" else (
                nr, f"ppe_front_{self.entry}")
        return (self.name,)

    @property
    def machine_instance(self) -> str:
        """The template instance it runs, named by rows per lane K as
        chip_smoke.py names the instances in the libraries' machine code."""
        r_pad = WARM_SHAPE[0]
        if self.kernel == "ppe":
            from ..ops.pairhmm_torch import ppe_stripes, rows_per_lane, select_rows

            k = rows_per_lane(select_rows(self.arg, r_pad), r_pad)
            carry = "_carry" if ppe_stripes(k, r_pad) > 1 else ""
            return f"ppe_k{k}{carry}"
        if self.kernel == "striped":
            from ..ops.pairhmm_striped import striped_rows_per_lane, striped_stripes

            k = striped_rows_per_lane(self.arg, r_pad)
            carry = "_carry" if striped_stripes(self.arg, k, r_pad) > 1 else ""
            return f"striped{self.arg}_k{k}{carry}"
        return self.name


def instances(quick: bool = False) -> List[Instance]:
    """The launches of a warm-up: every instance the CLI's flags reach, or
    with ``quick`` the default path's."""
    if quick:
        return [Instance("ppe", 4, "planes"), Instance("ppe", 4, "nib"),
                Instance("genotype", 64)]
    return ([Instance("ppe", nr, e) for nr in PPE_ROWS for e in PPE_ENTRIES]
            + [Instance("striped", h) for h in STRIPES]
            + [Instance("genotype", 64), Instance("genotype", 32)])


def seeded_group(rng, r_pad: int, c_pad: int, jobs: int = 8, nr: int = 4,
                 nh: int = 2):
    """A small group as the runner packs it (its ``_Unique`` rows): each
    job's reads drawn from its first haplotype with ~1% substitutions,
    Phred 28-40, lengths inside the pads."""
    from ..ops.torch_runner import _Unique
    from ..utils.quality import INITIAL_CONSTANT_F32

    acgt = np.frombuffer(b"ACGT", np.uint8)
    n_reads, n_haps = jobs * nr, jobs * nh
    clen = rng.integers(c_pad - 64, c_pad + 1, n_haps).astype(np.int32)
    rlen = rng.integers(r_pad - 63, r_pad + 1, n_reads).astype(np.int32)
    hap = acgt[rng.integers(0, 4, (n_haps, c_pad))]
    read = np.zeros((n_reads, r_pad), np.uint8)
    for i in range(n_reads):
        h = (i // nr) * nh
        start = int(rng.integers(0, clen[h] - rlen[i] + 1))
        read[i, : rlen[i]] = hap[h, start : start + rlen[i]]
    sub = rng.random(read.shape) < 0.01
    read[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    qual = (rng.integers(28, 41, read.shape) + 33).astype(np.uint8)
    cols = np.arange(r_pad)[None, :]
    read[cols >= rlen[:, None]] = 0
    qual[cols >= rlen[:, None]] = 0
    hap[np.arange(c_pad)[None, :] >= clen[:, None]] = 0
    init_y = (INITIAL_CONSTANT_F32 / clen.astype(np.float32)).astype(np.float32)
    spans = [(j, j * nr * nh, nr, nh) for j in range(jobs)]
    bases = [(j * nr, j * nh) for j in range(jobs)]
    return _Unique((n_reads, n_haps, r_pad, c_pad), read.ravel(), qual.ravel(),
                   hap.ravel(), rlen, clen, init_y, spans, bases,
                   jobs * nr * nh)


def seeded_tile(rng, S: int, R: int, H: int):
    """A small genotype tile (lik f64, hap_to_allele, read_keep, hap_valid,
    allele_count): 2-8 alleles per site, every allele on a hap,
    likelihoods on a 0.25 grid (ties included)."""
    lik = np.zeros((S, R, H))
    h2a = np.zeros((S, H), np.int32)
    keep = np.zeros((S, R), bool)
    hv = np.zeros((S, H), bool)
    ac = np.zeros(S, np.int32)
    for s in range(S):
        nr = int(rng.integers(1, R + 1))
        nh = int(rng.integers(2, H + 1))
        a = min(int(rng.integers(2, 9)), nh)
        mapper = np.concatenate([rng.permutation(a), rng.integers(0, a, nh - a)])
        lik[s, :nr, :nh] = np.round(-rng.uniform(1.0, 40.0, (nr, nh)) * 4) / 4
        h2a[s, :nh] = rng.permutation(mapper)
        keep[s, :nr] = rng.random(nr) < 0.8
        hv[s, :nh] = True
        ac[s] = a
    return lik, h2a, keep, hv, ac


class _Launcher:
    """Each instance's kernel launch and its plain version on one seeded
    input per kernel, built once."""

    def __init__(self, device):
        import torch

        from ..config import DEFAULT_CONFIG
        from ..ops.pairhmm_striped import striped_tables
        from ..ops.torch_runner import TorchPairHMMRunner
        from ..utils.quality import BASE_TABLE, PH2PR_F32

        self.torch = torch
        self.device = device
        rng = np.random.default_rng(20261017)
        self.runner = TorchPairHMMRunner(DEFAULT_CONFIG, devices=[device])
        self.trans = self.runner.trans
        self.tab = self.runner._ppe_tab
        self.group = seeded_group(rng, *WARM_SHAPE)
        u = self.group
        pairs = np.empty(2 * u.total, np.int32)
        u.pairs_into(pairs)
        pr, ph = pairs[: u.total], pairs[u.total :]
        r_pad, c_pad = WARM_SHAPE
        reads = u.read_u8.reshape(-1, r_pad)[pr]
        quals = u.qual_u8.reshape(-1, r_pad)[pr] & 127
        haps = u.hap_u8.reshape(-1, c_pad)[ph]
        base, omq, q3 = striped_tables(BASE_TABLE, PH2PR_F32)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        self.striped_args = (to(base[reads]), to(omq[quals]), to(q3[quals]),
                             to(base[haps]), to(u.read_lens[pr]),
                             to(u.hap_lens[ph]), to(u.hap_init_y[ph]))
        tile = seeded_tile(rng, *GENOTYPE_TILE)
        self.tiles = {
            bits: [to(tile[0].astype(np.float64 if bits == 64 else np.float32))]
            + [to(x) for x in tile[1:]]
            for bits in (64, 32)
        }

    def segments(self, path: str):
        from ..ops.torch_runner import join_payloads, segments_of

        runner, u, t0 = self.runner, self.group, time.perf_counter()
        if path == "planes":
            payload = runner._pack_planes(u, t0)
        elif path == "packed":
            payload = runner._pack_bytes(u, t0)
        else:
            payload = runner._pack_nib(
                u, *runner._nib_encode(u.read_u8, u.qual_u8), t0)
        buf = join_payloads([payload], runner._pinned)
        return segments_of([payload], buf.ship(self.device))

    def calls(self, inst: Instance):
        """(the kernel's launch, its plain version) as two callables."""
        from ..ops import genotyper_cuda as gc
        from ..ops import pairhmm_front as pf
        from ..ops import pairhmm_striped as ps
        from ..ops import pairhmm_torch as pt

        trans, tab = self.trans, self.tab
        if inst.kernel == "ppe":
            if inst.entry == "pair_minor":
                args = pf.segment_inputs("planes", self.segments("planes")[0],
                                         tab)
                return (lambda: pt.ppe_forward(*args, trans, inst.arg),
                        lambda: pt.ppe_forward_plain(*args, trans))
            segs = self.segments(inst.entry)
            return (lambda: pf.ppe_forward_unique(inst.entry, segs, tab, trans,
                                                  inst.arg),
                    lambda: pf.ppe_forward_unique_plain(inst.entry, segs, tab,
                                                        trans))
        if inst.kernel == "striped":
            args = self.striped_args
            return (lambda: ps.striped_forward(*args, trans, inst.arg),
                    lambda: ps.striped_forward_plain(*args, trans, inst.arg))
        args = self.tiles[inst.arg]
        jac = gc.jacobian_table(args[0].dtype, self.device)
        return (lambda: gc.genotype_sites_cuda(*args),
                lambda: gc.genotype_sites_plain(*args, jac))

    def equal(self, got, want) -> bool:
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        return all(
            torch.equal(a.view(bits[a.dtype]), b.view(bits[b.dtype]))
            if a.dtype in bits and b.dtype == a.dtype else torch.equal(a, b)
            for a, b in zip(got, want))


def warm(quick: bool = False, cache_dir=None) -> Dict[str, object]:
    """Build and load every library, launch ``instances(quick)`` once each
    on the card, each bit-checked against its plain version -> the
    report.  Raises without nvcc or a card, and on a mismatch."""
    _kernels.nvcc_path()  # raises without the toolkit
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("warm_cache: no CUDA device is available (the "
                           "kernels warm only on the card)")
    if cache_dir is not None:
        enable_compile_cache(cache_dir)
    t0 = time.perf_counter()
    _kernels.build_all()  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    libraries = {}
    for name in _kernels.KERNELS:
        t1 = time.perf_counter()
        _kernels.load(name)
        libraries[name] = {"load_s": round(time.perf_counter() - t1, 4)}
    cache = _kernels.cache_report()
    for name, rec in cache["libraries"].items():
        libraries[name].update(rec)
    device = torch.device("cuda", torch.cuda.current_device())
    launcher = _Launcher(device)
    out = {}
    for inst in instances(quick):
        kernel, plain = launcher.calls(inst)
        before = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = kernel()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t1) * 1e3
        moved = tuple(k for k, n in _kernels.LAUNCHES.items()
                      if n != before[k])
        same = launcher.equal(got, plain())
        out[inst.name] = {"instance": inst.machine_instance,
                          "counters": list(moved),
                          "first_launch_ms": round(first_ms, 3),
                          "bit_equal_plain": same}
        if not same or moved != inst.counters:
            raise AssertionError(f"warm_cache {inst.name}: {out[inst.name]}")
    return {"tool": "warm_cache", "quick": quick,
            "device": torch.cuda.get_device_name(device),
            "cache_dir": cache["dir"], "nvcc_runs": cache["nvcc_runs"],
            "build_all_s": round(build_s, 3), "libraries": libraries,
            "instances": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="only the default path: ppe4 through the "
                    "unique-rows entry (planes, nib) and genotype_f64")
    ap.add_argument("--cache-dir", default=None,
                    help="the kernel cache to fill (default: "
                    "GATK_HC_TPU_TORCH_KERNEL_CACHE or the package's _build/)")
    args = ap.parse_args(argv)
    print(json.dumps(warm(args.quick, args.cache_dir)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
