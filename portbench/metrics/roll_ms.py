"""Milliseconds of a window roll under the exporter's lock, the mean over
the measured window's rolls: its `roll_drain` and `roll_dispatch` spans
(the pending rows folded, the tables copied to the host, the state
rolled), which every window trace records into the `stage_seconds`
family of the harness's registry in a traced run."""


def read(run):
    n = run.tally_delta(("observe_stage", "roll_dispatch"), "count")
    if n <= 0:
        return None
    s = (run.tally_delta(("observe_stage", "roll_drain"))
         + run.tally_delta(("observe_stage", "roll_dispatch")))
    return s / n * 1e3
