"""Kernels the device ran in the profiled slice per 16,384 records the
slice folded."""


def read(run):
    if run.slice is None or not run.slice.kernels or run.slice_rows <= 0:
        return None
    return len(run.slice.kernels) / run.slice_rows * 16384
