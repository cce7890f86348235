"""The port's compile watch (netobserv_tpu_torch/utils/retrace.py) and the
captured fold's binding check (sketch/capture.py) with a fake capture, and
the CPU side of the captured fold (exporter/torch_sketch.py): the CPU
exporter folds eagerly and records no capture, and every tensor a captured
fold is bound to keeps its storage through folds and every kind of roll,
so a graph stays valid across windows. The capture itself needs a card
(`chip_smoke.py`)."""

import importlib.util
import logging

import numpy as np
import pytest
import torch

from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.sketch.capture import CapturedFold, binding
from netobserv_tpu_torch.utils import retrace

GEOM = dict(cm_width=1024, hll_precision=10, perdst_buckets=64,
            persrc_buckets=64, topk=128, hist_buckets=64, ewma_buckets=256)


class FakeCapturedFold(CapturedFold):
    """A CapturedFold whose capture keeps its arguments and whose replay
    folds them eagerly: the binding check and the watch of the real one,
    with no card."""

    def _capture(self, args):
        self.bound = args

    def _replay(self):
        self._fold(*self.bound)


def _add(acc, x, k=1):
    acc.add_(x * k)


def test_warmup_capture_is_no_retrace_and_a_rebinding_is(caplog):
    total = retrace.total_retraces()
    fold = FakeCapturedFold("fold_fake", _add)
    acc, x = torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.int32)
    for _ in range(4):
        fold(acc, x)
    s = fold.stats()
    assert (s["calls"], s["compiles"], s["retraces"]) == (4, 1, 0)
    assert fold.captures == 1 and acc.tolist() == [4, 4, 4]
    assert s["last_signature"] == "int32[3] int32[3]"
    assert "last_retrace" not in s
    # a new accumulator: a replay would fold into the old one's storage,
    # so the call captures again, after warm-up: a retrace
    acc2 = torch.zeros((2, 3), dtype=torch.int32)
    with caplog.at_level(logging.ERROR, logger="netobserv_tpu_torch.retrace"):
        fold(acc2, x)
    s = fold.stats()
    assert (s["calls"], s["compiles"], s["retraces"]) == (5, 2, 1)
    assert acc2.tolist() == [[1, 1, 1]] * 2 and acc.tolist() == [4, 4, 4]
    assert s["last_retrace"] == "int32[2, 3] int32[3]"
    assert retrace.total_retraces() == total + 1
    assert "fold_fake" in caplog.text and "int32[2, 3]" in caplog.text
    fold(acc2, x, 2)  # a leaf that is not a tensor is bound too
    assert fold.stats()["retraces"] == 2 and acc2.tolist() == [[3] * 3] * 2
    fold(acc2, x, 2)
    assert fold.stats()["compiles"] == 3


def test_binding_follows_storage_shape_strides_and_leaves():
    a = torch.zeros((4, 6))
    key = binding((a, (a[0], 3)))
    a.add_(1)  # in place: the same binding
    assert binding((a, (a[0], 3))) == key
    assert binding((a.clone(), (a[0], 3))) != key
    assert binding((a, (a[0], 4))) != key
    assert binding((a.t(), (a[0], 3))) != key
    assert binding((a, (a[1], 3))) != key
    assert binding((a, (a[0].view(2, 3), 3))) != key


def test_stats_fields_and_snapshot():
    def fold(x):
        if x.sum() > 0:
            entry.note_compile(0.5, retrace.describe((x,)))
        return x + 1

    entry = retrace.watch(fold, "fold_fields", warmup_calls=2)
    entry(torch.ones(1))
    entry(torch.ones(2))  # call 2: still warm-up
    s = entry.stats()
    assert set(s) == {"fn", "calls", "compiles", "retraces", "warmup_calls",
                      "dispatch_seconds", "compile_seconds", "last_signature"}
    assert (s["calls"], s["compiles"], s["retraces"]) == (2, 2, 0)
    entry(torch.zeros(3))
    entry(torch.ones(7, dtype=torch.int64))  # call 4: a retrace
    s = entry.stats()
    assert set(s) == {"fn", "calls", "compiles", "retraces", "warmup_calls",
                      "dispatch_seconds", "compile_seconds", "last_signature",
                      "last_retrace"}
    assert (s["fn"], s["calls"], s["compiles"], s["retraces"],
            s["warmup_calls"]) == ("fold_fields", 4, 3, 1, 2)
    assert s["compile_seconds"] == 1.5 and s["dispatch_seconds"] >= 0
    assert s["last_signature"] == s["last_retrace"] == "int64[7]"
    assert s in retrace.snapshot()
    assert retrace.watch(entry, "again") is entry


def _fresh_retrace(monkeypatch, **env):
    """A new copy of the module, imported under `env`."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("retrace_copy",
                                                  retrace.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_retrace_watchdog_0_disables_the_watch(monkeypatch):
    off = _fresh_retrace(monkeypatch, RETRACE_WATCHDOG="0")

    def fn():
        return 7
    assert off.watch(fn, "fold_off") is fn
    assert off.snapshot() == [] and off.total_retraces() == 0
    on = _fresh_retrace(monkeypatch, RETRACE_WATCHDOG="1",
                        RETRACE_WARMUP_CALLS="0")
    w = on.watch(fn, "fold_on")
    assert w() == 7 and w.warmup_calls == 0
    w.note_compile(0.1, "x")  # no warm-up: the first capture is an alarm
    assert [s["fn"] for s in on.snapshot()] == ["fold_on"]
    assert on.total_retraces() == 1
    # with the watch off a captured fold still captures on a rebinding,
    # and counts its captures
    monkeypatch.setattr(retrace, "_enabled", False)
    fold = FakeCapturedFold("fold_unwatched", _add)
    acc = torch.zeros(2)
    fold(acc, torch.ones(2))
    fold(acc.clone(), torch.ones(2))
    assert fold.stats() == {"fn": "fold_unwatched", "compiles": 2}


def test_cpu_exporter_folds_eagerly_and_records_no_capture():
    names = {s["fn"] for s in retrace.snapshot()}
    cfg = ts.SketchConfig(**GEOM)
    exp = TorchSketchExporter(cfg, batch_size=256, device="cpu",
                              capture=True)
    assert exp.captures == [] and exp.ring is None
    _, pool = traffic.make_pool(np.random.default_rng(4), batch=256,
                                n_batches=1)
    exp.fold_dense(traffic.dense_pool(pool)[0])
    (events, feats), = traffic.event_pool(pool, np.random.default_rng(5))
    exp.fold_events(events, **feats)
    assert exp.ring.captured is None and exp.captures == []
    assert float(exp.state.total_records) == 512.0
    assert {s["fn"] for s in retrace.snapshot()} <= names
    exp.close()
    fold = CapturedFold("fold_cpu", _add)
    with pytest.raises(ValueError, match="CUDA"):
        fold(torch.zeros(2), torch.ones(2))


@pytest.mark.parametrize("tiers", [None, tiered.TierSpec()],
                         ids=["wide", "tiered"])
def test_folds_and_rolls_keep_every_bound_tensor_in_place(tiers):
    """What a captured fold binds (the state, both feeds' device buffers,
    the key table) keeps its storage and shape through dense and resident
    folds and rolls in reset, decay and keep mode: a graph captured once
    stays valid across windows, and never captures again."""
    cfg = ts.SketchConfig(tiered=tiers, **GEOM)
    exp = TorchSketchExporter(cfg, batch_size=256, device="cpu")
    bound = lambda: (binding((exp.state, exp._dev))  # noqa: E731
                     + binding((exp.state, exp.ring.key_tables,
                                exp.ring._dev)))
    _, pool = traffic.make_pool(np.random.default_rng(6), batch=256,
                                n_batches=2)
    dense = traffic.dense_pool(pool)
    events = traffic.event_pool(pool, np.random.default_rng(7))
    ev0, feats0 = events[0]
    exp.fold_events(ev0, **feats0)  # makes the ring
    before = bound()
    for decay, reset in ((None, True), (0.5, False), (None, False)):
        exp.decay_factor, exp.reset_sketches = decay, reset
        for d, (ev, feats) in zip(dense, events):
            exp.fold_dense(d)
            exp.fold_events(ev, **feats)
        exp.roll()
        assert bound() == before, (decay, reset)
    assert exp.rolls == 3
    exp.close()
