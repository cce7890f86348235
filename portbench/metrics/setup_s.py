"""Seconds from the process's start to the first timed eviction: imports,
the pool, the exporter with its kernels built or loaded and its graphs
captured, and one pass of the pool as warm-up."""


def read(run):
    return run.setup_s
