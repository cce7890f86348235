"""Host milliseconds in the staging ring's packer per 16,384 records folded
in the measured window (the ring's `pack_seconds`)."""


def read(run):
    if run.records <= 0:
        return None
    return run.delta("pack_seconds") / run.records * 16384 * 1e3
