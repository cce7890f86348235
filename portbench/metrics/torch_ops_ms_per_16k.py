"""Device milliseconds of the kernels not built from the program's `csrc/`
(the hash sweep and torch's own operations) in the profiled slice, per
16,384 records the slice folded."""

from portbench import roofline


def read(run):
    if run.slice is None or not run.slice.kernels or run.slice_rows <= 0:
        return None
    s = sum(d for name, _, d in run.slice.kernels
            if roofline.csrc_kernel(name) is None)
    return s / run.slice_rows * 16384 * 1e3
