"""Positional downsampling: one read per alignment-start position.

The reference picks uniformly at random with a fresh ``std::random_device``
per call (haplotypecaller.hpp:44-50), making its VCF nondeterministic.  We
pin a deterministic rule (HCConfig.downsample_mode):

* ``"first"``  — keep the first read parsed at that start (default; this is
  the rule used to produce the golden chrM VCF).
* ``"seeded"`` — index chosen by a splitmix-style hash of (seed, position),
  stable across runs and across host shardings.

A *copy* of the record is returned because the per-window pipeline mutates
reads (clipping) while buckets are shared between overlapping windows.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

from ..config import HCConfig
from ..io.sam import SAMRecord


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def select_one_read(
    bucket: Sequence[SAMRecord], position: int, cfg: HCConfig
) -> SAMRecord:
    if cfg.downsample_mode == "first":
        chosen = bucket[0]
    elif cfg.downsample_mode == "seeded":
        index = _splitmix64(cfg.downsample_seed * 0x10001 + position) % len(bucket)
        chosen = bucket[index]
    else:
        raise ValueError(f"unknown downsample_mode {cfg.downsample_mode!r}")
    # shallow copy is a true clone: every SAMRecord field is immutable
    # (str/int/tuple — Cigar is a tuple of tuples), and the clipper rebinds
    # fields rather than mutating shared structure.  deepcopy here cost
    # ~75us/read and dominated the downsample stage at contig scale.
    return copy.copy(chosen)


def downsample_window(
    buckets: Sequence[Sequence[SAMRecord]],
    begin: int,
    end: int,
    cfg: HCConfig,
) -> List[SAMRecord]:
    """One read per non-empty start position in [begin, end), clamped to the
    contig (the reference indexes out of bounds here; we clamp —
    haplotypecaller.hpp:141-142)."""
    reads: List[SAMRecord] = []
    for position in range(max(begin, 0), min(end, len(buckets))):
        bucket = buckets[position]
        if bucket:
            reads.append(select_one_read(bucket, position, cfg))
    return reads
