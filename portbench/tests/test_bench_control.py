"""The control (the reference one precision lower, in the program's
place) comes out not correct: on the CPU at a test's size, and on the
card at each cell's own size over three seeds (`card`)."""

import pytest

from portbench import harness
from portbench.reference import control
from portbench.tests.helpers import ROOT, small_mix

CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]
#: evictions one 5 s window of each cell folds on the card (PERF.md)
WINDOW_EVICTIONS = {"resident.fullmap": 220, "resident.smallmap": 2500}


def _fails(num: dict, limits: dict) -> bool:
    return any(num[k] > limits[k] for k in num)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_cpu(name):
    import torch
    cell = harness.load_cell(ROOT, name)
    num = control.readings(small_mix(cell.mix), cell.config, 2**36 + 5, 20,
                           2, torch.device("cpu"), harness._dtypes())
    assert _fails(num, cell.limits), num


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name, card):
    cell = harness.load_cell(ROOT, name)
    for seed in (2**36 + 1, 2**36 + 2, 2**36 + 3):
        num = control.readings(cell.mix, cell.config, seed,
                               WINDOW_EVICTIONS[name], 2, card,
                               harness._dtypes())
        assert _fails(num, cell.limits), (seed, num)
