"""The one generator of region jobs: PairHMM requests as HaplotypeCaller's
assembly hands them over, from a configuration and a traffic mix.

It extends the port's ``tools/bench.py::make_workload`` (the reference's
headline job: haplotypes a few SNPs off one window, reads drawn from them
with a few substitutions, Phred 20-40 as raw ASCII 53-73) to whole pools
of regions whose sizes are recorded ones, vectorised with numpy so that a
pool of thousands of regions is made in seconds.

The sizes of every region come from the mix's recorded shapes,
``hcbench/traffic/<mix>/<configuration>.jsonl`` (``record_shapes.py``
writes them): one line a region, in the order the caller submitted them,
``[[haplotype length, ...], [[read length, run], ...]]`` with the read
lengths run-length coded.  So every ``--seed`` gives the same work in the
same order; ``--seed`` draws every base and quality, region by region
(``numpy.random.default_rng([seed, region])``).  (The pool's order sets
which groups the runner packs together, and so its device-memory peak.)
A region is made so:

* haplotype 0 is a window of random bases, as long as the recorded first
  haplotype (the caller's reference haplotype);
* each other haplotype carries up to ``snps_per_hap_max`` SNPs and one
  indel that makes it as long as its recorded length (``make_haps``), at a
  random place; the inserted bases are random;
* read i, of its recorded length, is drawn from haplotype i mod n_haps at
  a random start, with up to ``substitutions_per_read_max`` substitutions,
  and qualities uniform over ``qual_ascii``.

A region is (flat_seq u8, flat_qual u8, off i64, [hap u8]): the columnar
form the caller ships (``io/columnar.py::ReadPairs``), built by the
driver.  Nothing here imports the port.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
CODE = np.zeros(256, np.int64)
CODE[ACGT] = np.arange(4)
SEED_MASK = (1 << 64) - 1
HERE = os.path.dirname(os.path.abspath(__file__))

Region = Tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray]]
Shape = Tuple[List[int], List[int]]  # haplotype lengths, read lengths


def shapes_path(config: Dict, traffic: Dict) -> str:
    return os.path.join(HERE, "traffic", traffic["name"],
                        config["name"] + ".jsonl")


def decode(line: str) -> Shape:
    """One recorded line -> (haplotype lengths, read lengths)."""
    haps, runs = json.loads(line)
    return [int(h) for h in haps], [int(n) for n, k in runs
                                    for _ in range(k)]


def encode(hap_lens: Sequence[int], read_lens: Sequence[int]) -> str:
    """The inverse of ``decode``: read lengths run-length coded."""
    runs: List[List[int]] = []
    for n in read_lens:
        if runs and runs[-1][0] == n:
            runs[-1][1] += 1
        else:
            runs.append([int(n), 1])
    return json.dumps([[int(h) for h in hap_lens], runs],
                      separators=(",", ":"))


def region_shapes(config: Dict, traffic: Dict) -> List[Shape]:
    """Every region's sizes, in pool order: the mix's ``shapes`` when it
    holds them, else its recorded file for this configuration."""
    if "shapes" in traffic:
        return traffic["shapes"]
    with open(shapes_path(config, traffic)) as handle:
        return [decode(line) for line in handle if line.strip()]


def make_haps(rng, base: np.ndarray, indels: np.ndarray,
              snps_max: int) -> List[np.ndarray]:
    """Haplotype 0 is ``base``; haplotype h > 0 takes up to ``snps_max``
    SNPs (at least one where it has no indel, so that no two haplotypes
    are alike but by chance) and then the indel ``indels[h]`` (a signed
    length: random bases inserted, or window bases deleted) at a random
    place, so that it is ``base.size + indels[h]`` long."""
    width = base.size
    seq = np.tile(base, (indels.size, 1))
    n_snps = rng.integers(0, snps_max + 1, indels.size)
    if snps_max:
        n_snps = np.maximum(n_snps, indels == 0)
    n_snps[0] = 0
    hit = np.arange(snps_max) < n_snps[:, None]
    rows = np.nonzero(hit)[0]
    cols = rng.integers(0, width, hit.sum())
    seq[rows, cols] = ACGT[(CODE[seq[rows, cols]]
                            + rng.integers(1, 4, hit.sum())) % 4]
    at = (rng.random(indels.size)
          * (width - np.maximum(-indels, 0) + 1)).astype(np.int64)
    haps = []
    for row, d, a in zip(seq, indels, at):
        if d < 0:
            row = np.concatenate([row[:a], row[a - d:]])
        elif d > 0:
            row = np.concatenate([row[:a], ACGT[rng.integers(0, 4, d)],
                                  row[a:]])
        haps.append(row)
    return haps


def make_region(traffic: Dict, shape: Shape, k: int, seed: int) -> Region:
    """Region ``k`` of the pool, of ``shape``, drawn from (seed, k)."""
    rng = np.random.default_rng([seed & SEED_MASK, k])
    want_haps, read_lens = shape
    lens = np.asarray(read_lens, np.int64)
    base = ACGT[rng.integers(0, 4, want_haps[0])]
    haps = make_haps(rng, base, np.asarray(want_haps) - want_haps[0],
                     traffic["snps_per_hap_max"])
    hap_lens = np.asarray(want_haps, np.int64)
    hap_off = np.cumsum(hap_lens) - hap_lens
    n_reads = lens.size
    which = np.arange(n_reads) % hap_lens.size
    if (lens > hap_lens[which]).any():
        raise ValueError(f"region {k}: a read longer than its haplotype")
    starts = (rng.random(n_reads) * (hap_lens[which] - lens + 1)).astype(
        np.int64)
    off = np.zeros(n_reads + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    first = hap_off[which] + starts
    reads = np.concatenate(haps)[np.repeat(first - off[:-1], lens)
                                 + np.arange(total)]
    subs_max = traffic["substitutions_per_read_max"]
    n_subs = rng.integers(0, subs_max + 1, n_reads)
    where = off[:-1, None] + (rng.random((n_reads, subs_max))
                              * lens[:, None]).astype(np.int64)
    bases = ACGT[rng.integers(0, 4, (n_reads, subs_max))]
    hit = np.arange(subs_max) < n_subs[:, None]
    reads[where[hit]] = bases[hit]
    q_lo, q_hi = traffic["qual_ascii"]
    quals = rng.integers(q_lo, q_hi + 1, total, dtype=np.uint8)
    return reads, quals, off, haps


def make_pool(config: Dict, traffic: Dict, seed: int) -> List[Region]:
    """The seed's pool: every recorded region, in order."""
    return [make_region(traffic, shape, k, seed)
            for k, shape in enumerate(region_shapes(config, traffic))]
