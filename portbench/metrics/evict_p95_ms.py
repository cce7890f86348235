"""The 95th percentile, over every eviction handed in the measured window,
of the milliseconds `export_evicted` held its caller: how long the
agent's drain of its kernel map stalls. The calls that close a window
count."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
