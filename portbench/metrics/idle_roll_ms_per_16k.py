"""Milliseconds the card sat idle while the host rolled a window (the
`roll_dispatch` span, and `roll_drain` outside its folds), per 16,384
records folded in the measured window:
`device_idle_seconds_total{phase="roll"}` of the harness's registry in a
traced run, which the program's device timeline feeds from the gaps between
its timed intervals. Nothing where the program has no device timeline; 0
where it has one and no gap fell in the phase."""


def read(run):
    busy = ("device_busy_seconds_total", "ingest_dispatch")
    if run.records <= 0 or run.tally_delta(busy, "count") <= 0:
        return None
    idle = run.tally_delta(("device_idle_seconds_total", "roll"))
    return idle / run.records * 16384 * 1e3
