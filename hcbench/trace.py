"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: the device's activity in the measured window, by name, and
the gaps in it, each labelled by what the harness's thread was doing.

The driver marks the window and its own calls with
``torch.profiler.record_function`` spans named ``hcbench.<what>``
(``hcbench.window``, ``hcbench.submit``, ``hcbench.drain``); their
host-side copies in the trace share the device events' clock.  Device
activity is every kernel, copy and memset (``cat`` "kernel",
"gpu_memcpy", "gpu_memset"), clipped to the window.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "hcbench."
TOP = 10


def load(path: str) -> List[Dict]:
    with open(path) as handle:
        data = json.load(handle)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def reduce(events: List[Dict]) -> Dict:
    """-> {"window_s", "busy_s", "device_s": {name: s}, "idle_gaps":
    [[label, s]] longest first (at most TOP), "device_ops": [[name, s]]
    (at most TOP)}; every time in seconds.  Raises when the trace has no
    window span."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    windows = [e for e in spans if e["name"] == SPAN_PREFIX + "window"]
    if not windows:
        raise ValueError("the trace holds no hcbench.window span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device: List[Tuple[str, float, float]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        lo = max(float(e["ts"]), w0)
        hi = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if hi > lo:
            device.append((str(e.get("name", "")), lo, hi))
    by_name: Dict[str, float] = {}
    for name, lo, hi in device:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) * 1e-6
    busy = _union([(lo, hi) for _, lo, hi in device])
    gaps = []
    at = w0
    for lo, hi in busy + [(w1, w1)]:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    labelled = [e for e in spans if e["name"] != SPAN_PREFIX + "window"]

    def label(lo: float, hi: float) -> str:
        mid = 0.5 * (lo + hi)
        for e in labelled:
            if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"]):
                return e["name"][len(SPAN_PREFIX):]
        return "loop"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(hi - lo for lo, hi in busy) * 1e-6,
        "device_s": by_name,
        "idle_gaps": [[label(lo, hi), (hi - lo) * 1e-6]
                      for lo, hi in gaps[:TOP]],
        "device_ops": [[name[:64], s] for name, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
    }
