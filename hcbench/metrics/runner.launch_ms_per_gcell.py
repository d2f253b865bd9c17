"""runner.launch_ms_per_gcell: the runner's ``launch`` stage (host clock
on its dispatch worker, the ``hc.runner.launch`` span: enqueuing each
launch unit's H2D copy and kernel launches), summed over the window, in
ms per true Gcell.  Nothing when the runner has no such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["stage_sums_ms"].get("launch")
    return ms / gcells if ms is not None and gcells else None
