"""caller.parse_ms_per_gcell: the caller's ``hc.caller.parse`` spans (host
clock: the FASTA and the columnar SAM parse), summed over the window's
passes, in ms per true Gcell the caller submitted.  Nothing when the
record holds no such stage."""


def read(record):
    gcells = record["work"]["cells"] / 1e9
    ms = record["spans_ms"].get("parse")
    return ms / gcells if ms is not None and gcells else None
