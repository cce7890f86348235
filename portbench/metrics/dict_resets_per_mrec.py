"""Key dictionaries of the lane ring reset (full, so every key ships again)
per million records folded in the measured window (its `dict_resets`)."""


def read(run):
    if run.records <= 0:
        return None
    return run.delta("dict_resets") / run.records * 1e6
