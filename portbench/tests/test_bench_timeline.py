"""The readers of the program's device timeline and lane packs
(`fold_device_ms_per_16k`, `device_busy_share`, the five
`idle_<phase>_ms_per_16k` and `pack_lane_ms_per_16k`) on a synthetic run:
their arithmetic, 0 for a phase no gap fell in, and nothing from a program
without the timeline."""

import pytest
import torch

from portbench import harness
from portbench.tests.helpers import ROOT

PHASES = ("pack", "dispatch", "entry", "caller", "roll")
READERS = ("fold_device_ms_per_16k", "device_busy_share",
           "pack_lane_ms_per_16k") + tuple(
               f"idle_{p}_ms_per_16k" for p in PHASES)


def _run(before: tuple, after: tuple, records=16384 * 1000, seconds=10.0):
    cell = harness.load_cell(ROOT, "resident.fullmap")
    run = harness.Run(cell, torch.device("cpu"), 8192)
    run.records, run.seconds = records, seconds
    run.before, run.after = {"tally": before}, {"tally": after}
    return run


def _tally(busy: dict, idle: dict, lane: float, n: int) -> tuple:
    counts, sums = {}, {}
    for fam, part in (("device_busy_seconds_total", busy),
                      ("device_idle_seconds_total", idle)):
        for k, v in part.items():
            counts[(fam, k)], sums[(fam, k)] = n, v
    counts[("observe_stage", "pack_lane")] = 8 * n
    sums[("observe_stage", "pack_lane")] = lane
    return counts, sums


def test_the_timeline_readers_take_the_windows_deltas():
    before = _tally({"ingest_dispatch": 1.0, "roll_dispatch": 0.1},
                    {"pack": 2.0}, 3.0, 10)
    after = _tally({"ingest_dispatch": 2.0, "roll_dispatch": 0.3},
                   {"pack": 5.0, "dispatch": 0.2, "entry": 2.5,
                    "caller": 0.1, "roll": 0.4}, 11.0, 900)
    run = _run(before, after)
    got = {name: harness.reader(name)(run) for name in READERS}
    assert got["fold_device_ms_per_16k"] == pytest.approx(1.0)
    assert got["device_busy_share"] == pytest.approx(1.2 / 10.0)
    assert got["pack_lane_ms_per_16k"] == pytest.approx(8.0)
    assert got["idle_pack_ms_per_16k"] == pytest.approx(3.0)
    assert got["idle_dispatch_ms_per_16k"] == pytest.approx(0.2)
    assert got["idle_entry_ms_per_16k"] == pytest.approx(2.5)
    assert got["idle_caller_ms_per_16k"] == pytest.approx(0.1)
    assert got["idle_roll_ms_per_16k"] == pytest.approx(0.4)
    # busy and idle account for the window
    idle_s = sum(got[f"idle_{p}_ms_per_16k"] for p in PHASES) \
        * run.records / 16384 / 1e3
    assert got["device_busy_share"] + idle_s / run.seconds == \
        pytest.approx((1.2 + 6.2) / 10)


def test_a_phase_no_gap_fell_in_reads_zero():
    after = _tally({"ingest_dispatch": 2.0}, {"pack": 1.0}, 1.0, 5)
    run = _run(({}, {}), after)
    assert harness.reader("idle_caller_ms_per_16k")(run) == 0.0
    assert harness.reader("device_busy_share")(run) == pytest.approx(0.2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_timeline(name):
    """The parent's program records no interval and no `pack_lane`
    span: every reader finds nothing, and raises nothing."""
    tally = ({("observe_stage", "resident_pack"): 9},
             {("observe_stage", "resident_pack"): 0.5})
    assert harness.reader(name)(_run(({}, {}), tally)) is None
    assert harness.reader(name)(_run(({}, {}), tally, records=0)) is None
