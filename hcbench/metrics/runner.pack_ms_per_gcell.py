"""runner.pack_ms_per_gcell: the runner's ``pack`` stage (host clock on its
dispatch worker: unique rows and the chosen encoding), summed over the
window's groups, in ms per true Gcell."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    return record["stage_sums_ms"]["pack"] / gcells if gcells else None
