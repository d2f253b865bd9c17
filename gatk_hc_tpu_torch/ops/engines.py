"""Engine factories: dispatch PairHMM / assembler / SW implementations.

Engines (HCConfig.pairhmm_engine):
* "python" — the exact NumPy oracle (slow; tests and tiny runs)
* "native" — the C++ host library (CPU production path + f64 rescue)
* "cuda"   — the hand-written CUDA ppe kernel through the batched runner
  (production device path; ops/runner.py::TorchPairHMMRunner)
* "diag"   — the anti-diagonal forward in PyTorch ops, padded per region
  (ops/pairhmm_diag.py; an independent cross-check of the kernels)
* "shardmap" — each region's pair grid split over a (data, hap) grid of
  devices, the same CUDA kernels per block
  (parallel/sharded_step.py::ShardMapPairHMMRunner)

All engines produce the same read-major log10 matrix; rescue (raw f32 result
below MIN_ACCEPTED) always runs through the float64 host path.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

from ..config import HCConfig
from ..io.sam import SAMRecord
from ..models.haplotype import Haplotype


def _to_arrays(reads: Sequence[SAMRecord], haps: Sequence[Haplotype]):
    """(bases u8, quals u8) pairs + hap u8 arrays from any of the read/hap
    representations: SAMRecord-like objects, already-converted array
    tuples (PairHMMJob contents), or the columnar ReadPairs container."""
    if hasattr(reads, "flat_seq") or (len(reads) and isinstance(reads[0], tuple)):
        read_arrays = list(reads)  # ReadPairs iterates as (seq, qual) views
    else:
        read_arrays = [
            (
                np.frombuffer(r.seq.encode(), dtype=np.uint8),
                np.frombuffer(r.qual.encode(), dtype=np.uint8),
            )
            for r in reads
        ]
    if len(haps) and isinstance(haps[0], np.ndarray):
        hap_arrays = list(haps)
    else:
        hap_arrays = [
            np.frombuffer(h.bases.encode(), dtype=np.uint8) for h in haps
        ]
    return read_arrays, hap_arrays


def make_pairhmm_engine(cfg: HCConfig, device="cuda") -> Callable:
    """The per-region engine of ``cfg.pairhmm_engine``; "cuda", "diag" and
    "shardmap" run on ``device``."""
    name = cfg.pairhmm_engine
    if name == "python":

        def engine(reads, haplotypes):
            from .pairhmm_oracle import pairhmm_log10_batch

            read_arrays, hap_arrays = _to_arrays(reads, haplotypes)
            return pairhmm_log10_batch(
                read_arrays, hap_arrays, cfg.gop_char, cfg.gcp_char,
                rescue_mode=cfg.f64_rescue,
            )

        return engine
    if name == "native":
        from ..native import native_pairhmm_engine

        return native_pairhmm_engine(cfg)
    if name == "cuda":
        from .torch_runner import torch_pairhmm_engine

        return torch_pairhmm_engine(cfg, device=device)
    if name == "diag":
        from .pairhmm_diag import diag_pairhmm_engine

        return diag_pairhmm_engine(cfg, device=device)
    if name == "shardmap":
        from ..parallel.sharded_step import shardmap_pairhmm_engine

        return shardmap_pairhmm_engine(cfg, device=device)
    raise ValueError(f"unknown pairhmm engine {name!r}")


def make_assemble_fn(cfg: HCConfig) -> Callable:
    if cfg.assembler_engine == "python":
        from ..models.assembler import assemble

        return assemble
    if cfg.assembler_engine == "native":
        from ..native import native_assemble_fn

        return native_assemble_fn(cfg)
    raise ValueError(f"unknown assembler engine {cfg.assembler_engine!r}")
