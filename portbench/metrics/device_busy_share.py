"""The share of the measured window in which the card ran the program's
work: the device time between the CUDA events around every ingest
dispatch and every roll (`device_busy_seconds_total`), over the window's
seconds. The events are read back without waiting and the profiler is
off, so its host cost is not in it. Nothing where the program has no
device timeline."""

SPANS = ("ingest_dispatch", "roll_dispatch")


def read(run):
    keys = [("device_busy_seconds_total", s) for s in SPANS]
    if run.seconds <= 0 or run.tally_delta(keys[0], "count") <= 0:
        return None
    return sum(run.tally_delta(k) for k in keys) / run.seconds
