"""The card's idle time in the measured window, put down to what the
runner's dispatch worker was doing, from the same ``torch.profiler`` trace
that ``trace.py`` reduces.

The port marks its steps with ``record_function`` ranges named
``hc.<what>`` (``gatk_hc_tpu_torch/utils/logging.py::span``); a profile
that records every thread holds them on the thread that ran them, on the
device events' clock.  The dispatch worker is the thread of the
``hc.runner.batch`` spans (one a submit), and its spans nest:
``hc.runner.pack`` holds ``hc.runner.pack.unique_rows`` and
``hc.runner.pack.encode``, which holds the encoding that ran.  Each idle
instant of the card is put down to the worker's innermost span open at
that instant, or to ``worker idle`` where none is.  Like ``trace.py`` this
imports nothing of the port and names the spans by string.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from hcbench import trace

PREFIX = "hc."
WORKER = "hc.runner."
BATCH = "hc.runner.batch"
PACK = "hc.runner.pack"
IDLE = "worker idle"

Interval = Tuple[float, float]


def _window(events: List[Dict]) -> Interval:
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == trace.SPAN_PREFIX + "window"):
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError("the trace holds no hcbench.window span")


def idle_gaps(events: List[Dict], w0: float, w1: float) -> List[Interval]:
    """The window's intervals in which no kernel, copy or memset ran."""
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        lo = max(float(e["ts"]), w0)
        hi = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if hi > lo:
            device.append((lo, hi))
    gaps, at = [], w0
    for lo, hi in trace._union(device) + [(w1, w1)]:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    return gaps


def worker_spans(events: List[Dict]) -> List[Tuple[float, float, str]]:
    """The dispatch worker's ``hc.runner.*`` spans as (start, end, name):
    those on the threads that hold ``hc.runner.batch`` spans."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(WORKER)]
    threads = {(e.get("pid"), e.get("tid")) for e in spans
               if e["name"] == BATCH}
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in spans if (e.get("pid"), e.get("tid")) in threads]


def innermost(spans: List[Tuple[float, float, str]]):
    """Spans that nest (one thread's) -> [(start, end, name)]: disjoint
    pieces in time order, each under the innermost span open there; a
    child that outlasts its parent by a rounding is cut to it."""
    out = []
    stack: List[Tuple[float, str]] = []  # (end, name), innermost last
    at = 0.0
    for lo, hi, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= lo:
            end, top = stack.pop()
            out.append((at, end, top))
            at = end
        if stack:
            out.append((at, lo, stack[-1][1]))
            hi = min(hi, stack[-1][0])
        stack.append((hi, name))
        at = lo
    while stack:
        end, top = stack.pop()
        out.append((at, end, top))
        at = end
    return [(lo, hi, name) for lo, hi, name in out if hi > lo]


def _overlaps(pieces, gaps: List[Interval]) -> Dict[str, float]:
    """Seconds of ``gaps`` under each piece's name (pieces and gaps each
    disjoint and in time order)."""
    starts = [lo for lo, _, _ in pieces]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(pieces) and pieces[k][0] < g1:
            lo, hi, name = pieces[k]
            cut = min(hi, g1) - max(lo, g0)
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut * 1e-6
            k += 1
    return out


def reduce(events: List[Dict]) -> Optional[Dict]:
    """-> {"idle_s", "idle_in_pack_s", "idle_by_worker_span": [[name, s]]
    longest first (at most ``trace.TOP``), "self_s": {name: s}}, the
    window's seconds (names without ``hc.``; ``worker idle`` where no span
    of the worker is open; ``self_s`` is each span's own time in the
    window, its children's left out), or None when the trace holds no
    span of the worker.  Raises when it has no window span."""
    w0, w1 = _window(events)
    spans = worker_spans(events)
    if not spans:
        return None
    pieces = innermost(spans)
    gaps = idle_gaps(events, w0, w1)
    idle_s = sum(hi - lo for lo, hi in gaps) * 1e-6
    by_span = _overlaps(pieces, gaps)
    by_span[IDLE] = max(idle_s - sum(by_span.values()), 0.0)
    in_pack = sum(s for name, s in by_span.items()
                  if name == PACK or name.startswith(PACK + "."))
    short = {(name[len(PREFIX):] if name.startswith(PREFIX) else name): s
             for name, s in by_span.items()}
    return {
        "idle_s": idle_s,
        "idle_in_pack_s": in_pack,
        "idle_by_worker_span": sorted(
            ([name, s] for name, s in short.items() if s > 0),
            key=lambda kv: -kv[1])[:trace.TOP],
        "self_s": {name[len(PREFIX):]: s for name, s in
                   _overlaps(pieces, [(w0, w1)]).items()},
    }
