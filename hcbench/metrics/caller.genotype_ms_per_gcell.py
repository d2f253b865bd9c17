"""caller.genotype_ms_per_gcell: the caller's ``hc.caller.genotype`` spans
(host clock on the "genotype" thread: normalisation, the read filter and
the host genotyper, a drained chunk at a time), summed over the window's
passes, in ms per true Gcell the caller submitted.  Nothing when the
record holds no such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["spans_ms"].get("genotype")
    return ms / gcells if ms is not None and gcells else None
