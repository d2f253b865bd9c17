"""runner.pack_offcpu_pct: the share of the runner's ``pack`` stage in
which its dispatch thread was off the CPU (waiting for the interpreter
lock, or preempted), in %: 100 x (1 - ``pack_cpu`` / ``pack``), the
thread's CPU time over the same intervals against their host-clock
time, summed over the window.  Nothing when the runner has no
``pack_cpu`` stage."""


def read(record):
    sums = record["stage_sums_ms"]
    cpu, wall = sums.get("pack_cpu"), sums.get("pack")
    if cpu is None or not wall:
        return None
    return 100.0 * (1.0 - cpu / wall)
