"""Milliseconds a fold waited for a staging slot whose copy to the card was
still running, per 16,384 records folded in the measured window (the sum
of the `sketch_slot_wait_seconds` observations the ring made into the
harness's registry)."""


def read(run):
    if run.records <= 0:
        return None
    waited = run.tally_delta(("sketch_slot_wait_seconds",))
    return waited / run.records * 16384 * 1e3
