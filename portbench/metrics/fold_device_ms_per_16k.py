"""Device milliseconds of the ingest dispatches per 16,384 records folded
in the measured window: the time between the two CUDA events the program
records around each dispatch (the slot's copy to the card and the fold),
summed over every fold into `device_busy_seconds_total{span=
"ingest_dispatch"}` of the harness's registry in a traced run. Nothing
where the program has no device timeline."""


def read(run):
    key = ("device_busy_seconds_total", "ingest_dispatch")
    if run.records <= 0 or run.tally_delta(key, "count") <= 0:
        return None
    return run.tally_delta(key) / run.records * 16384 * 1e3
