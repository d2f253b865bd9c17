"""gcells_per_s: the likelihood stage's throughput, every true cell of the
window's region jobs (read length x haplotype length per pair, counted the
same whichever kernel or encoding runs) over the window's whole elapsed
time, from its first submit to its last drain, on the host clock."""


def read(record):
    return record["work"]["cells"] / record["window_s"] / 1e9
