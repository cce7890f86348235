"""Device milliseconds in which a kernel, copy or fill ran, per 16,384
records the profiled slice folded: the card's own cost per record, which
the profiler's slower host does not change. (The slice's busy time over
its wall time does change: the profiler makes each graph launch cost the
host milliseconds, so no idle share is read from it.)"""


def read(run):
    if run.slice is None or run.slice.busy_s <= 0 or run.slice_rows <= 0:
        return None
    return run.slice.busy_s / run.slice_rows * 16384 * 1e3
