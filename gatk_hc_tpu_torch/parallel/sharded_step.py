"""Sharded likelihood step over a (data, hap) grid of devices — the
``--pairhmm shardmap`` engine.

The PairHMM pair grid (reads x haplotypes) decomposes in 2D:

* the **data** axis shards READS (each slot holds a row block of the pair
  matrix);
* the **hap** axis shards HAPLOTYPES (column blocks).

Each slot computes its local (reads_block x haps_block) grid of RAW f32
forward probabilities with the same CUDA kernels the runner launches
(ops/pairhmm_torch.py::forward_batch: the ppe kernel's pair-minor entry, or
the striped kernel), or their plain versions on CPU slots.  Two reductions
follow: the per-read best raw probability (a max over the hap axis) and the
count of raw values under MIN_ACCEPTED (a sum over both axes, the pairs the
host's f64 rescue recomputes).  In one process these are exact reductions
after peer copies of each slot's partial results to the first slot's
device — an elementwise max and an integer sum — and no collective library
is involved; across processes the work splits by region instead
(parallel/multihost.py).

The counterpart of gatk_hc_tpu/parallel/sharded_step.py, whose shard_map
program places the same blocks with jax and reduces them with pmax / psum.
Normalization stays on the host: the raw grid goes through the exact f64
chain every engine uses (``finalize_log10`` with the f64 rescue, then
``normalize_and_filter`` in the caller), so a VCF written through
:class:`ShardMapPairHMMRunner` is byte-identical to the golden one.

A grid may repeat a device (``make_mesh(devices=["cpu"] * 8)``, or
``["cuda:0"] * 4``): the blocks are the same, so the tests hold an 8-slot
CPU grid against the reference's 8-virtual-device mesh, and one card runs
a 2 x 2 grid.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import HCConfig
from ..ops.torch_runner import local_devices
from ..utils.quality import (
    BASE_TABLE,
    INITIAL_CONSTANT_F32,
    MIN_ACCEPTED,
    PH2PR_F32,
)

@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """A (data, hap) array of torch devices, the counterpart of a jax Mesh
    with axis names ("data", "hap")."""

    devices: np.ndarray  # (data, hap) object array of torch.device
    axis_names: Tuple[str, str] = ("data", "hap")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(
    n_devices: Optional[int] = None, hap_parallel: int = 1, devices=None
) -> DeviceGrid:
    """(data, hap) grid over the first n devices of ``devices`` (default:
    every visible card; a device may repeat).  Raises when the count does
    not divide by ``hap_parallel``, when fewer than n devices are given and
    when no card is visible for the default."""
    devs = local_devices("cuda", devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices asked for, {len(devs)} available")
    if n % hap_parallel != 0:
        raise ValueError("device count must divide by hap_parallel")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return DeviceGrid(grid.reshape(n // hap_parallel, hap_parallel))


def _forward_local(
    rc, omq, q3, rl, hc, hl, iy, trans, r_pad, c_pad, algo="ppe",
    ppe_rows=4, stripe=32,
):
    """All-pairs forward of one block: (nr, r_pad) read planes and
    (nh, c_pad) hap planes on one device -> (nr, nh) raw f32, read-major.
    The per-pair gathers are torch index ops on the block's device; the
    forward is ``forward_batch`` (the CUDA kernels take any pair count, so
    nothing is padded to a tile)."""
    from ..ops.pairhmm_torch import forward_batch

    nr, nh = rc.shape[0], hc.shape[0]
    dev = rc.device
    pair_read = torch.arange(nr, device=dev).repeat_interleave(nh)
    pair_hap = torch.arange(nh, device=dev).repeat(nr)
    probs = forward_batch(
        rc.index_select(0, pair_read), omq.index_select(0, pair_read),
        q3.index_select(0, pair_read), rl.index_select(0, pair_read),
        hc.index_select(0, pair_hap), hl.index_select(0, pair_hap),
        iy.index_select(0, pair_hap), trans, r_pad, c_pad,
        ppe_rows=ppe_rows, stripe=min(stripe, r_pad), algo=algo,
    )
    return probs.reshape(nr, nh)


def _device_of(device: torch.device):
    """The slot's card made current (nothing on the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else nullcontext())


def make_sharded_raw_step(
    mesh: DeviceGrid, trans: Tuple, r_pad: int, c_pad: int, cfg: HCConfig,
):
    """-> step(rc, omq, q3, rl, hc, hl, iy) over ``shard_inputs`` arrays
    (reads split over "data", haps over "hap") returning, on the host:

    * the raw f32 (nr, nh) probability grid, the same values the
      single-device kernels give;
    * the per-read best raw probability (nr,) f32, the max over "hap";
    * the count of raw values under MIN_ACCEPTED, shape (1,), the sum over
      both axes.

    The kernel is ``cfg.pallas_algo`` with ``cfg.ppe_rows`` /
    ``cfg.stripe_height``.  Every block launches before anything is read
    back, so the slots of a grid of several cards compute together."""
    min_accepted = float(MIN_ACCEPTED)
    devices = mesh.devices
    data_n, hap_n = devices.shape
    first = devices[0, 0]

    def step(rc, omq, q3, rl, hc, hl, iy):
        raw = np.empty((data_n, hap_n), dtype=object)
        best = np.empty((data_n, hap_n), dtype=object)
        under = np.empty((data_n, hap_n), dtype=object)
        for i in range(data_n):
            for j in range(hap_n):
                with _device_of(devices[i, j]):
                    block = _forward_local(
                        *(a[i, j] for a in (rc, omq, q3, rl, hc, hl, iy)),
                        trans, r_pad, c_pad, algo=cfg.pallas_algo,
                        ppe_rows=cfg.ppe_rows, stripe=cfg.stripe_height,
                    )
                    raw[i, j] = block
                    best[i, j] = block.amax(dim=1)
                    under[i, j] = (block < min_accepted).sum()
        # the reductions, on the first slot's device after peer copies:
        # max over "hap" per data row, sum over both axes
        best_rows = [
            torch.stack([best[i, j].to(first) for j in range(hap_n)]).amax(0)
            for i in range(data_n)
        ]
        n_rescue = torch.stack(
            [under[i, j].to(first) for i in range(data_n)
             for j in range(hap_n)]).sum()
        grid = np.concatenate([
            np.concatenate([raw[i, j].cpu().numpy() for j in range(hap_n)],
                           axis=1)
            for i in range(data_n)
        ])
        return (grid, torch.cat(best_rows).cpu().numpy(),
                np.array([int(n_rescue)], dtype=np.int64))

    return step


# the axis that splits each array's rows: the counterparts of the
# reference's PartitionSpecs
READ_SPECS = ("data", "data", "data", "data")
HAP_SPECS = ("hap", "hap", "hap")


def shard_inputs(mesh: DeviceGrid, arrays, specs):
    """Place host arrays over the grid -> per array a (data, hap) object
    array of tensors: an array split over "data" gives slot (i, j) its
    i-th row block, one split over "hap" its j-th, each copied to the
    slot's device.  The axis must divide the rows."""
    devices = mesh.devices
    data_n, hap_n = devices.shape
    out = []
    for array, axis in zip(arrays, specs):
        t = torch.as_tensor(np.ascontiguousarray(array))
        parts = mesh.shape[axis]
        if t.shape[0] % parts:
            raise ValueError(
                f"{t.shape[0]} rows do not split over {parts} {axis} slots")
        chunks = t.chunk(parts)
        blocks = np.empty((data_n, hap_n), dtype=object)
        for i in range(data_n):
            for j in range(hap_n):
                part = chunks[i if axis == "data" else j]
                blocks[i, j] = part.contiguous().to(devices[i, j])
        out.append(blocks)
    return out


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f"value {value} exceeds largest bucket {buckets[-1]}")


def _pow2_multiple(n: int, base: int) -> int:
    """Smallest base * 2^k >= n: row counts that split evenly over the
    grid, from few distinct shapes."""
    per = max(1, -(-n // base))
    k = 1
    while k < per:
        k *= 2
    return base * k


def _read_planes(reads, n_pad: int, r_pad: int):
    """Host-side element planes for n reads padded to (n_pad, r_pad):
    (codes i32, 1-ph2pr[q] f32, ph2pr[q]/3 f32, lens i32).  The divisions
    happen on the host, as for every engine.  Padding rows are benign
    dummies (len 1, code 0), sliced off after the step."""
    rc = np.zeros((n_pad, r_pad), np.int32)
    omq = np.ones((n_pad, r_pad), np.float32)
    q3 = np.zeros((n_pad, r_pad), np.float32)
    rl = np.ones(n_pad, np.int32)
    for i, (b, q) in enumerate(reads):
        L = len(b)
        rc[i, :L] = BASE_TABLE[b]
        err = PH2PR_F32[(np.asarray(q) & 127).astype(np.int64)]
        omq[i, :L] = np.float32(1.0) - err
        q3[i, :L] = err / np.float32(3.0)
        rl[i] = L
    return rc, omq, q3, rl


def _hap_planes(haps, n_pad: int, c_pad: int):
    """(codes i32, lens i32, INITIAL_CONSTANT/len f32) padded to n_pad."""
    hc = np.zeros((n_pad, c_pad), np.int32)
    hl = np.ones(n_pad, np.int32)
    for j, h in enumerate(haps):
        hc[j, : len(h)] = BASE_TABLE[h]
        hl[j] = len(h)
    iy = (INITIAL_CONSTANT_F32 / hl.astype(np.float32)).astype(np.float32)
    return hc, hl, iy


def default_mesh(device="cuda") -> DeviceGrid:
    """The runner's grid: every visible card, with 2 hap slots when the
    count is even and above 1 (raises without a card); one CPU slot for
    ``device="cpu"``."""
    devs = local_devices(device)
    hp = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
    return make_mesh(hap_parallel=hp, devices=devs)


class ShardMapPairHMMRunner:
    """Each region's raw pair grid through the sharded step over the grid,
    finalized by the exact f64 host chain: what ``--pairhmm shardmap``
    means in call_batched (``run(jobs)`` fills each ``job.result``, as the
    other runners do), so the chrM VCF comes out byte-identical.

    ``mesh`` is the grid (default: ``default_mesh(device)``)."""

    def __init__(self, cfg: HCConfig, mesh: Optional[DeviceGrid] = None,
                 device="cuda"):
        from ..ops.pairhmm_torch import transition_constants

        self.cfg = cfg
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self._trans = transition_constants(cfg.gop_char, cfg.gcp_char)
        self._steps = {}
        # regions by padded shape (r_pad, c_pad): the bucket shapes launched
        self.bucket_counts: Dict[Tuple[int, int], int] = {}

    def _step(self, r_pad: int, c_pad: int):
        key = (r_pad, c_pad)
        if key not in self._steps:
            self._steps[key] = make_sharded_raw_step(
                self.mesh, self._trans, r_pad, c_pad, self.cfg)
        return self._steps[key]

    def run(self, jobs) -> None:
        for job in jobs:
            self._run_one(job)

    def _run_one(self, job) -> None:
        from ..ops.pairhmm_oracle import finalize_log10
        from ..ops.pairhmm_torch import _host_f64_rescue

        reads = list(job.reads)
        haps = list(job.haps)
        nr, nh = len(reads), len(haps)
        if nr * nh == 0:
            job.result = np.zeros((nr, nh))
            return
        cfg = self.cfg
        shape = self.mesh.shape
        r_pad = _bucket(max(len(b) for b, _ in reads), cfg.read_pad_buckets)
        if cfg.pallas_algo == "striped":  # a multiple of the stripe height
            h = cfg.stripe_height
            r_pad = -(-r_pad // h) * h
        c_pad = _bucket(max(len(h) for h in haps), cfg.hap_pad_buckets)
        self.bucket_counts[r_pad, c_pad] = (
            self.bucket_counts.get((r_pad, c_pad), 0) + 1)
        nr_pad = _pow2_multiple(nr, shape["data"])
        nh_pad = _pow2_multiple(nh, shape["hap"])
        args = shard_inputs(
            self.mesh,
            _read_planes(reads, nr_pad, r_pad) + _hap_planes(haps, nh_pad,
                                                             c_pad),
            READ_SPECS + HAP_SPECS,
        )
        raw_grid, _best, _n_rescue = self._step(r_pad, c_pad)(*args)
        raw = np.ascontiguousarray(raw_grid[:nr, :nh]).reshape(-1)
        pair_read = np.repeat(np.arange(nr), nh)
        pair_hap = np.tile(np.arange(nh), nr)

        def rescue(indices):
            return _host_f64_rescue(
                cfg, reads, haps, pair_read[indices], pair_hap[indices]
            )

        job.result = finalize_log10(
            raw, rescue, mode=cfg.f64_rescue
        ).reshape(nr, nh)


def shardmap_pairhmm_engine(cfg: HCConfig, mesh: Optional[DeviceGrid] = None,
                            device="cuda"):
    """Per-region engine over ShardMapPairHMMRunner (the engine interface
    of ops/engines.py: (reads, haps) -> read-major log10 f64)."""
    from ..ops.engines import _to_arrays
    from ..ops.runner import PairHMMJob

    runner = ShardMapPairHMMRunner(cfg, mesh=mesh, device=device)

    def engine(reads, haplotypes):
        read_arrays, hap_arrays = _to_arrays(reads, haplotypes)
        if len(read_arrays) == 0 or len(hap_arrays) == 0:
            return np.zeros((len(read_arrays), len(hap_arrays)))
        job = PairHMMJob(read_arrays, hap_arrays)
        runner.run([job])
        return job.result

    return engine
