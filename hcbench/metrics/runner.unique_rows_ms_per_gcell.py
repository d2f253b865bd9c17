"""runner.unique_rows_ms_per_gcell: the runner's ``unique_rows`` stage
(host clock on its dispatch worker, the ``hc.runner.pack.unique_rows``
span: each group's unique reads and haplotypes as padded byte rows),
summed over the window's groups, in ms per true Gcell.  Nothing when the
runner has no such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["stage_sums_ms"].get("unique_rows")
    return ms / gcells if ms is not None and gcells else None
