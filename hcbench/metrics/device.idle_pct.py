"""device.idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the card, in %, from the profiler's trace."""


def read(record):
    t = record["trace"]
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
