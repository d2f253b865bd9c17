"""Pair batching: pack (read, haplotype) pairs into fixed-shape tiles — the
anti-diagonal engine's input (ops/pairhmm_diag.py).

Reads pad to a small set of row buckets and haplotypes to column buckets
(HCConfig.read_pad_buckets / hap_pad_buckets); the batch axis pads to a
multiple of ``pair_batch``.  A ``PairBatch`` carries the index maps needed to
scatter results back to (region, read, hap) coordinates.  A copy of the
reference package's gatk_hc_tpu/ops/batching.py; ``pair_batch`` is not an
HCConfig key in this package (convert.TPU_ONLY_KEYS), so its default is
the module's PAIR_BATCH.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

# pairs per tile row block: the reference's HCConfig.pair_batch default
PAIR_BATCH = 128


@dataclasses.dataclass
class PairBatch:
    """One fixed-shape batch of pairs."""

    read_bases: np.ndarray  # (B, R_pad) uint8 ASCII, zero padded
    read_quals: np.ndarray  # (B, R_pad) uint8 ASCII
    read_lens: np.ndarray  # (B,) int32
    hap_bases: np.ndarray  # (B, C_pad) uint8 ASCII
    hap_lens: np.ndarray  # (B,) int32
    n_valid: int  # first n_valid rows are real pairs

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.read_lens), self.read_bases.shape[1], self.hap_bases.shape[1])


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    # beyond the largest bucket: round up to a multiple of the last one
    last = buckets[-1]
    return ((value + last - 1) // last) * last


def pack_pairs(
    reads: Sequence[Tuple[np.ndarray, np.ndarray]],  # (bases, quals) per read
    haps: Sequence[np.ndarray],
    pair_read: np.ndarray,
    pair_hap: np.ndarray,
    read_pad_buckets: Sequence[int] = (64, 128, 200),
    hap_pad_buckets: Sequence[int] = (128, 256, 384, 512),
    pair_batch: int = PAIR_BATCH,
) -> PairBatch:
    """Pack explicit pair lists into one padded batch.

    The batch's R_pad/C_pad come from the max lengths, bucketed; the pair
    axis pads to a multiple of ``pair_batch`` by repeating a dummy pair of
    length 1 (cheap rows, masked out by ``n_valid``).
    """
    n = len(pair_read)
    max_r = max((len(reads[i][0]) for i in pair_read), default=1)
    max_c = max((len(haps[j]) for j in pair_hap), default=1)
    r_pad = _bucket(max_r, read_pad_buckets)
    c_pad = _bucket(max_c, hap_pad_buckets)
    b_pad = max(((n + pair_batch - 1) // pair_batch) * pair_batch, pair_batch)

    read_bases = np.zeros((b_pad, r_pad), dtype=np.uint8)
    read_quals = np.full((b_pad, r_pad), ord("I"), dtype=np.uint8)
    read_lens = np.ones(b_pad, dtype=np.int32)
    hap_bases = np.zeros((b_pad, c_pad), dtype=np.uint8)
    hap_lens = np.ones(b_pad, dtype=np.int32)
    read_bases[:, 0] = ord("A")
    hap_bases[:, 0] = ord("A")

    for k in range(n):
        bases, quals = reads[int(pair_read[k])]
        hap = haps[int(pair_hap[k])]
        read_bases[k, : len(bases)] = bases
        read_quals[k, : len(quals)] = quals
        read_lens[k] = len(bases)
        hap_bases[k, : len(hap)] = hap
        hap_lens[k] = len(hap)
    return PairBatch(read_bases, read_quals, read_lens, hap_bases, hap_lens, n)


def all_pairs(n_reads: int, n_haps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Read-major cartesian pair indices (reference testcase order)."""
    pair_read = np.repeat(np.arange(n_reads, dtype=np.int32), n_haps)
    pair_hap = np.tile(np.arange(n_haps, dtype=np.int32), n_reads)
    return pair_read, pair_hap
