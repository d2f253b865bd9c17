"""device.idle_in_pack_pct: the share of the card's idle time in the
traced window that falls inside the dispatch worker's ``hc.runner.pack``
spans, in % (``hcbench/worker_trace.py``).  Nothing without a trace or
when the trace holds no span of the worker."""


def read(record):
    w = record.get("worker_trace")
    if not w or w["idle_s"] <= 0:
        return None
    return 100.0 * w["idle_in_pack_s"] / w["idle_s"]
