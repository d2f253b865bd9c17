"""runner.encode_ms_per_gcell: the runner's ``encode`` stage (host clock
on its dispatch worker, the ``hc.runner.pack.encode`` span: the nib
dictionary pass and the chosen encoding's pinned buffer), summed over the
window's groups, in ms per true Gcell.  Nothing when the runner has no
such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["stage_sums_ms"].get("encode")
    return ms / gcells if ms is not None and gcells else None
