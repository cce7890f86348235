"""The comparison catches a broken timed path: each run drives the whole
harness on the CPU (the look for a card skipped), with a fault planted in
the program underneath, and must come out not correct. The faults a cell
of one card can have: a fold that leaves its state unchanged; half of
each batch left out and the mass of the rest doubled (the mean over the
rest); one fold of the run lost, and one row in a hundred; an answer
altered where it is produced (a heavy-hitter key word, and a HyperLogLog
register). No cell spans cards, so none has an exchange
between them to leave out."""

import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests.helpers import CPU_ENV, ROOT, small_cell

CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")
         ["workloads"]]


def _correct(cell) -> tuple[bool, dict]:
    out = harness.run_cell(cell, 2**34 + 9, 2.5, False, time.time(),
                           env=CPU_ENV)
    num = out["numbers"]
    return all(num[k] <= cell.limits[k] for k in num), num


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    ok, num = _correct(small_cell(name))
    assert ok, num


def _unchanged(monkeypatch):
    from netobserv_tpu_torch.sketch import state as sk
    monkeypatch.setattr(sk, "ingest", lambda state, arrays, **kw: state)


def _half_batch(monkeypatch):
    import torch
    from netobserv_tpu_torch.sketch import state as sk
    ingest = sk.ingest

    def half(state, arrays, **kw):
        n = arrays["valid"].shape[0]
        keep = torch.arange(n, device=arrays["valid"].device) < n // 2
        arrays = dict(arrays, valid=arrays["valid"] & keep,
                      bytes=arrays["bytes"] * 2)
        return ingest(state, arrays, **kw)

    monkeypatch.setattr(sk, "ingest", half)


def _lost_fold(monkeypatch):
    from netobserv_tpu_torch.sketch import state as sk
    ingest, calls = sk.ingest, []

    def lose_the_third(state, arrays, **kw):
        calls.append(1)
        return state if len(calls) == 3 else ingest(state, arrays, **kw)

    monkeypatch.setattr(sk, "ingest", lose_the_third)


def _lost_rows(monkeypatch):
    import torch
    from netobserv_tpu_torch.sketch import state as sk
    ingest = sk.ingest

    def one_in_a_hundred(state, arrays, **kw):
        n = arrays["valid"].shape[0]
        keep = torch.arange(n, device=arrays["valid"].device) % 100 != 7
        return ingest(state, dict(arrays, valid=arrays["valid"] & keep),
                      **kw)

    monkeypatch.setattr(sk, "ingest", one_in_a_hundred)


def _altered_key(monkeypatch):
    from netobserv_tpu_torch.sketch import state as sk
    tables = sk.state_tables

    def altered(state):
        out = tables(state)
        top = int(np.argmax(np.where(out["heavy_valid"],
                                     out["heavy_counts"], -1)))
        out["heavy_words"][top, 0] ^= 1
        return out

    monkeypatch.setattr(sk, "state_tables", altered)


def _altered_register(monkeypatch):
    from netobserv_tpu_torch.sketch import state as sk
    tables = sk.state_tables

    def altered(state):
        out = tables(state)
        out["hll_src"][7] += 1
        return out

    monkeypatch.setattr(sk, "state_tables", altered)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _lost_fold,
                                   _lost_rows, _altered_key,
                                   _altered_register],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    ok, num = _correct(small_cell(name))
    assert not ok, num
    if fault in (_lost_fold, _lost_rows):
        assert num["count_gap"] > 0, num
