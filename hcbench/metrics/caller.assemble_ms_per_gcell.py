"""caller.assemble_ms_per_gcell: the caller's ``hc.caller.assemble`` spans
(host clock, one a region on the host thread that assembles it: window
prep and native assembly; summed over the threads, so it can pass the
window's length), summed over the window's passes, in ms per true Gcell
the caller submitted.  Nothing when the record holds no such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["spans_ms"].get("assemble")
    return ms / gcells if ms is not None and gcells else None
