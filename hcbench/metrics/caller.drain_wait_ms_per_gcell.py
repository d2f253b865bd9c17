"""caller.drain_wait_ms_per_gcell: the harness's own spans around each
``drain`` in the window (where the caller waits for its results), summed,
in ms per true Gcell."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    return record["spans_ms"]["drain"] / gcells if gcells else None
