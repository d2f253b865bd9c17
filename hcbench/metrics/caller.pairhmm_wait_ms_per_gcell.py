"""caller.pairhmm_wait_ms_per_gcell: the caller's ``hc.caller.pairhmm`` spans
(host clock: the caller's thread blocked in the runner's submit and
drain), summed over the window's passes, in ms per true Gcell the caller
submitted.  Nothing when the record holds no such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["spans_ms"].get("pairhmm")
    return ms / gcells if ms is not None and gcells else None
