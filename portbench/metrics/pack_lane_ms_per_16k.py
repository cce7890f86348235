"""Host milliseconds of the lane packs per 16,384 records folded in the
measured window: each region's pack, timed on its pack thread (the
`pack_lane` span, summed into the `stage_seconds` family of the harness's
registry in a traced run). Against `pack_ms_per_16k.resident`, the packs'
wall time, it says how far the pack threads run at once. Nothing where
the program has no such span."""


def read(run):
    key = ("observe_stage", "pack_lane")
    if run.records <= 0 or run.tally_delta(key, "count") <= 0:
        return None
    return run.tally_delta(key) / run.records * 16384 * 1e3
