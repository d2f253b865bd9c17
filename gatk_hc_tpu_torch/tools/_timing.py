"""Timing, bounds and the card's header, shared by the port's measurement
tools (bench, kernel_bench, sustained_sweep, genotyper_bench,
scaling_bench) and chip_smoke.py: one definition of each.

* ``time_ms`` / ``time_ms_queued``: a function's ms on the card by CUDA
  events (one call at a time, or calls queued back to back);
* ``ppe_bound``: the least time of one PairHMM forward launch on given
  pairs, from the published peaks of one H100 SXM below;
* ``nvidia_smi``: the card's name and power limit, as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
  them, which every number a tool prints carries;
* ``card_missing``: why a tool asked to run on the card cannot (the tools
  never fall back to the CPU).

torch is imported inside the functions that need it.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Optional

# Published peaks of one H100 SXM (NVIDIA data sheet): f32 and f64 outside
# the tensor cores (an FMA counted as two operations) and HBM bandwidth,
# used for each kernel's least time.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_missing(device: str) -> Optional[str]:
    """None when ``device`` can run here, else the reason it cannot: a
    "cuda" device with no visible card (pass ``--device cpu`` to run the
    kernels' plain versions)."""
    if device != "cuda":
        return None
    import torch

    if torch.cuda.is_available():
        return None
    return ("no CUDA device is available (pass --device cpu to run the "
            "kernels' plain versions on the CPU)")


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
