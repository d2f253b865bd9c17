"""pairhmm_roofline: the PairHMM kernels' share of their roofline, in %:
the least time of the window's work (``hcbench/roofline.py``, the same
count whichever kernel implements it) over the device time of the kernels
named below in the profiler's trace, clipped to the window.  Nothing when
the trace holds none of them."""

from hcbench import roofline

KERNELS = ("ppe_forward_kernel", "striped_forward_kernel")


def read(record):
    if record["trace"] is None:
        return None
    kernel_s = sum(s for name, s in record["trace"]["device_s"].items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    return 100.0 * roofline.bound_s(record["work"])[0] / kernel_s
