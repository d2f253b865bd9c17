"""runner.finalize_ms_per_gcell: the runner's ``finalize`` stage (host
clock in ``drain``: log10 and the underflow sentinel per job), summed over
the window, in ms per true Gcell."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    return record["stage_sums_ms"]["finalize"] / gcells if gcells else None
