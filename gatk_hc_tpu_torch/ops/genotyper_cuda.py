"""Device genotyper reductions on PyTorch: the CUDA genotype kernel's
wrapper and its plain PyTorch version, over padded (S, R, H) site tiles.

The kernel (csrc/genotyper.cu) replaces gatk_hc_tpu/ops/genotyper_jax.py::
genotype_sites: per site, the per-read max over each allele's haplotypes,
the diploid hom/het composition through the Jacobian log table, the read
sums in read order, and the best genotype (later ties win) with its GQ,
in the MAX_ALLELES = 8 triu genotype layout.  Sites are padded into tiles
whose masks carry each site's read / hap / allele counts
(models/genotyper.py::genotype_regions_device builds them).

Two instances, chosen by the caller through the likelihoods' dtype:
float64 (the default of the port: the H100 has native f64; bit-equal to
the host genotyper) and float32 (Neumaier-compensated read sums, for the
guarded f32 path).  ``genotype_sites_cuda`` launches the kernel on CUDA
tensors and counts the launch under ``genotype_f64`` / ``genotype_f32`` in
ops/_kernels.py::LAUNCHES; on CPU tensors it runs
``genotype_sites_plain``, which gives the same outputs bit for bit.
Nothing else picks between them.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.quality import (
    JACOBIAN_F64,
    JACOBIAN_LOG_TABLE_INV_STEP,
    MAX_JACOBIAN_TOLERANCE,
)

_LOG10_2 = math.log10(2.0)
_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)
MAX_ALLELES = 8
MAX_GENOTYPES = (MAX_ALLELES * (MAX_ALLELES + 1)) // 2
# reads per chunk of the kernel (csrc/genotyper.cu READ_CHUNK): the plain
# version takes its reads in the same chunks
READ_CHUNK = 128
# haps of one tile the kernel takes (csrc/genotyper.cu MAX_HAPS)
MAX_HAPS = 32768

_jac_lock = threading.Lock()
_jac_tables: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}


def genotype_pair_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(a1, a2) per genotype index, for the MAX_ALLELES-allele layout —
    the allele_index_cache analogue (genotyper.hpp:22-33)."""
    a1, a2 = np.triu_indices(MAX_ALLELES)
    return a1.astype(np.int32), a2.astype(np.int32)


def lowest(dtype: torch.dtype) -> float:
    """The masked fill: numeric_limits<double>::lowest in f64; its f32
    cast, which overflows to -inf."""
    if dtype == torch.float32:
        return -math.inf
    return -float(np.finfo(np.float64).max)


def jacobian_table(dtype: torch.dtype, device) -> torch.Tensor:
    """The Jacobian log table (80,001 entries) in ``dtype`` on ``device``,
    copied there once per process."""
    device = torch.device(device)
    key = (str(device), dtype)
    table = _jac_tables.get(key)
    if table is None:
        with _jac_lock:
            table = _jac_tables.get(key)
            if table is None:
                np_dtype = np.float64 if dtype == torch.float64 else np.float32
                table = torch.from_numpy(
                    JACOBIAN_F64.astype(np_dtype)).to(device)
                _jac_tables[key] = table
    return table


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush subnormal f32 values to a zero of their sign (-ftz=true)."""
    return torch.where(x.abs() < _MIN_NORMAL_F32, x * 0.0, x)


def genotype_sites_plain(lik, hap_to_allele, read_keep, hap_valid,
                         allele_count, jacobian, max_gq: int = 99):
    """Plain PyTorch version of the genotype kernel: the same tensors in,
    the same (genotype_lik (S, 36), best (S,) i32, gq (S,) i32) out, bit
    for bit, on the inputs' device.

    Reads are taken in READ_CHUNK chunks as the kernel takes them, and each
    chunk's reads are added to the (S, 36) sums one read at a time, in read
    order (torch.sum / cumsum do not fix an order on the card).  f32 sums
    are Neumaier-compensated, and f32 flushes as the kernel's -ftz=true
    does: subnormal likelihoods read as zero and every subnormal f32 result
    becomes a zero of its sign (f64 is never flushed).  The best / second scans are loops over the
    36 slots with the kernel's comparisons: >= for best (later ties win),
    > for second, a NaN ranking above every number (f32 only: a
    compensated sum over -inf), and a NaN GQ gives 0, as in the
    reference."""
    dtype = lik.dtype
    S, R, H = lik.shape
    dev = lik.device
    low = lowest(dtype)
    compensated = dtype == torch.float32
    fl = _ftz if compensated else (lambda x: x)
    lik = fl(lik)
    a1_np, a2_np = genotype_pair_tables()
    a1 = torch.from_numpy(a1_np).long().to(dev)
    a2 = torch.from_numpy(a2_np).long().to(dev)
    is_hom = a1 == a2
    a_iota = torch.arange(MAX_ALLELES, dtype=torch.int32, device=dev)
    assign = (hap_to_allele[:, None, :] == a_iota[None, :, None]) & (
        hap_valid.bool()[:, None, :])  # (S, A, H)
    keep = read_keep.bool()
    log10_2 = torch.tensor(_LOG10_2, dtype=dtype, device=dev)
    s_sum = torch.zeros((S, MAX_GENOTYPES), dtype=dtype, device=dev)
    comp = torch.zeros_like(s_sum)
    for base in range(0, R, READ_CHUNK):
        chunk = lik[:, base:base + READ_CHUNK, :]  # (S, n, H)
        allele_lik = torch.where(
            assign[:, None, :, :], chunk[:, :, None, :], low
        ).amax(dim=-1)  # (S, n, A)
        l1 = allele_lik[:, :, a1]  # (S, n, G)
        l2 = allele_lik[:, :, a2]
        big = torch.maximum(l1, l2)
        diff = fl(big - torch.minimum(l1, l2))
        in_range = diff < MAX_JACOBIAN_TOLERANCE
        ind = torch.floor(fl(fl(
            torch.where(in_range, diff, 0.0) * JACOBIAN_LOG_TABLE_INV_STEP)
            + 0.5)).long()
        het = torch.where(in_range, fl(big + jacobian[ind]), big)
        vals = torch.where(is_hom, fl(l1 + log10_2), het)
        vals = torch.where(keep[:, base:base + READ_CHUNK, None], vals, 0.0)
        for i in range(vals.shape[1]):
            v = vals[:, i]
            if compensated:
                t = fl(s_sum + v)
                comp = fl(comp + torch.where(
                    s_sum.abs() >= v.abs(), fl(fl(s_sum - t) + v),
                    fl(fl(v - t) + s_sum)))
                s_sum = t
            else:
                s_sum = s_sum + v
    summed = fl(s_sum + comp) if compensated else s_sum
    n_kept = keep.sum(dim=1).to(dtype)
    totals = fl(summed - fl(n_kept * log10_2)[:, None])
    ac = allele_count.long()[:, None]
    masked = torch.where((a1[None] < ac) & (a2[None] < ac), totals, low)
    best = torch.zeros(S, dtype=torch.int64, device=dev)
    best_v = masked[:, 0]
    for g in range(1, MAX_GENOTYPES):
        v = masked[:, g]
        take = (v >= best_v) | v.isnan()
        best = torch.where(take, g, best)
        best_v = torch.where(take, v, best_v)
    second = torch.full((S,), low, dtype=dtype, device=dev)
    for g in range(MAX_GENOTYPES):
        v = masked[:, g]
        take = (best != g) & ((v > second) | v.isnan())
        second = torch.where(take, v, second)
    q = torch.floor(fl(fl(-10.0 * fl(second - best_v)) + 0.5))
    capped = torch.where(q < max_gq, q, float(max_gq))
    gq = torch.where(q.isnan(), 0.0, capped).to(torch.int32)
    return masked, best.to(torch.int32), gq


def _check_inputs(lik, hap_to_allele, read_keep, hap_valid,
                  allele_count) -> None:
    if lik.dim() != 3:
        raise ValueError(f"lik must be (S, R, H), got {tuple(lik.shape)}")
    S, R, H = lik.shape
    if lik.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"lik must be float64 or float32, got {lik.dtype}")
    if R < 1 or H < 1 or H > MAX_HAPS:
        raise ValueError(f"tile (S, R, H) = {(S, R, H)}: need R, H >= 1 "
                         f"and H <= {MAX_HAPS}")
    for name, t, dtype, shape in (
        ("hap_to_allele", hap_to_allele, torch.int32, (S, H)),
        ("read_keep", read_keep, torch.bool, (S, R)),
        ("hap_valid", hap_valid, torch.bool, (S, H)),
        ("allele_count", allele_count, torch.int32, (S,)),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != lik.device:
            raise ValueError(f"{name} is on {t.device}, lik on {lik.device}")
    for name, t in (("lik", lik), ("hap_to_allele", hap_to_allele),
                    ("read_keep", read_keep), ("hap_valid", hap_valid),
                    ("allele_count", allele_count)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def genotype_sites_cuda(lik, hap_to_allele, read_keep, hap_valid,
                        allele_count, max_gq: int = 99):
    """(genotype_lik (S, 36), best (S,) i32, gq (S,) i32) of one tile.

    ``lik`` (S, R, H) float64 or float32 picks the instance;
    ``hap_to_allele`` (S, H) i32, ``read_keep`` (S, R) and ``hap_valid``
    (S, H) bool, ``allele_count`` (S,) i32, all on one device.  CUDA
    tensors launch the kernel on the current stream (no synchronise; it
    allocates the outputs) and count it under genotype_f64 / genotype_f32;
    CPU tensors run ``genotype_sites_plain``.  A failed build or launch
    raises."""
    _check_inputs(lik, hap_to_allele, read_keep, hap_valid, allele_count)
    jac = jacobian_table(lik.dtype, lik.device)
    if lik.device.type == "cpu":
        return genotype_sites_plain(lik, hap_to_allele, read_keep, hap_valid,
                                    allele_count, jac, max_gq)
    if lik.device.type != "cuda":
        raise ValueError(f"unsupported device {lik.device}")
    from . import _kernels

    lib = _kernels.load("genotyper")
    S, R, H = lik.shape
    f64 = lik.dtype == torch.float64
    gl = torch.empty((S, MAX_GENOTYPES), dtype=lik.dtype, device=lik.device)
    best = torch.empty(S, dtype=torch.int32, device=lik.device)
    gq = torch.empty(S, dtype=torch.int32, device=lik.device)
    err = lib.genotype_sites(
        int(f64), lik.data_ptr(), hap_to_allele.data_ptr(),
        read_keep.data_ptr(), hap_valid.data_ptr(), allele_count.data_ptr(),
        jac.data_ptr(), gl.data_ptr(), best.data_ptr(), gq.data_ptr(),
        S, R, H, int(max_gq), _LOG10_2,
        torch.cuda.current_stream(lik.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"genotype_sites launch failed: CUDA error {err}")
    _kernels.LAUNCHES["genotype_f64" if f64 else "genotype_f32"] += 1
    return gl, best, gq


def genotype_sites_device(likelihoods: np.ndarray, hap_to_allele: np.ndarray,
                          read_keep: np.ndarray, hap_valid: np.ndarray,
                          allele_count: np.ndarray, device, max_gq: int = 99):
    """Host arrays -> ``genotype_sites_cuda`` on ``device``: the
    counterpart of genotyper_jax.py::genotype_sites_host.  The likelihoods'
    dtype (float64 or float32) picks the instance.  On a CUDA device the
    arrays go through pinned host memory, copied on the current stream
    without a wait, and the results stay on the card (the caller reads
    them back); on a CPU device the plain version runs."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def to_dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    return genotype_sites_cuda(
        to_dev(likelihoods), to_dev(hap_to_allele, torch.int32),
        to_dev(read_keep, torch.bool), to_dev(hap_valid, torch.bool),
        to_dev(allele_count, torch.int32), max_gq=max_gq,
    )
