"""The PairHMM's work and its least time on one H100, frozen here.

A copy of the port's ``tools/_timing.py::ppe_bound`` arithmetic, summed
over whole region jobs instead of one launch's pairs, so that the count
does not move when the program changes:

* true cells: read length x haplotype length per (read, haplotype) pair.
  The runner pads every group to a c_pad at least as long as the group's
  longest haplotype (``_pads_for_group``), so no pair is clipped and the
  count is the same whichever kernel or encoding runs;
* operations: 8 multiplies + 4 adds per true cell, 2 adds per column of
  the last row (its M and X summed in column order) and 1 add per pair;
* bytes: each pair's rlen rows of the three read planes, clen haplotype
  masks, rlen, clen and init_y read once, its f32 result written once.

The least time is the larger of operations over the f32 peak and bytes
over the HBM bandwidth: NVIDIA's data sheet for the H100 SXM at its full
700 W, f32 outside the tensor cores with an FMA counted as two operations.
Every number printed carries the card's name and power limit
(``card_header``), since a card set below 700 W runs slower.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Tuple

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def job_work(read_len_sum: int, hap_len_sum: int, n_reads: int,
             n_haps: int) -> Dict[str, int]:
    """True cells, operations and bytes of one region job, every read
    against every haplotype, from its reads' and haplotypes' summed
    lengths and counts."""
    pairs = n_reads * n_haps
    cells = read_len_sum * hap_len_sum
    col_sum = n_reads * hap_len_sum  # clen summed over pairs
    row_sum = n_haps * read_len_sum  # rlen summed over pairs
    return {
        "pairs": pairs,
        "cells": cells,
        "ops": 12 * cells + 2 * col_sum + pairs,
        "bytes": 4 * (3 * row_sum + col_sum + 3 * pairs) + 4 * pairs,
    }


def add_work(total: Dict[str, int], work: Dict[str, int]) -> None:
    for key, value in work.items():
        total[key] = total.get(key, 0) + value


def bound_s(work: Dict[str, int]) -> Tuple[float, str]:
    """The least seconds the card needs for ``work`` and what sets it
    ("operations" or "bytes")."""
    times = {"operations": work["ops"] / PEAK_F32_FLOPS,
             "bytes": work["bytes"] / PEAK_HBM_BYTES}
    by = max(times, key=times.get)
    return times[by], by


def card_header() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them for the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
