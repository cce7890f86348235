"""The share of their roofline that the program's CUDA kernels reach in the
profiled slice: the summed least time of every launch (`roofline.py`, the
bytes and operations of the rows each fold carries, against the card's
peaks) over their summed device time, in percent. Nothing when the trace
does not hold one launch of each kernel per fold."""

from portbench import harness


def read(run):
    got = harness.kernel_bounds(run)
    if got is None or got[1] <= 0:
        return None
    return got[0] / got[1] * 100.0
