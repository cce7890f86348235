"""Records folded a second: every record handed to `export_evicted` in the
measured window and folded (the pending buffer's unfolded tail left out),
over the whole window, which ends once the device has finished."""


def read(run):
    if run.records <= 0 or run.seconds <= 0:
        return None
    return run.records / run.seconds
