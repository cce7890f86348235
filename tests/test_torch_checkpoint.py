"""The port's checkpoints (netobserv_tpu_torch/sketch/checkpoint.py,
config.CheckpointSettings, and the exporter's and aggregator's checkpoint
seams) against the JAX package's, on the CPU.

- The checkpointer: a wide and a tiered state round-trip bit for bit; the
  port's restore of its save equals the JAX checkpointer's restore of the
  same state (carried across by `sketch/carry`); the FORMAT.json,
  META-<step>.json and PUBLISHED.json bytes and every format verdict equal
  the reference's; format 2 is refused before any tensor is read, the
  legacy era upgrades, and torn sidecars degrade without poisoning a
  restore. The tensor file itself is the port's own (no orbax), so the
  two packages' tensor files are not compared.
- The exporter: every Nth roll saved, restored in place at the next start
  (the same tensors, nothing captured) as the JAX exporter restores its
  own, a tiered exporter through its wide form; a rejected or
  incompatible checkpoint gives a fresh window.
- The aggregator, against the JAX aggregator
  (tests/test_federation_chaos.py:331-583): kill and restart keeps
  exactly-once delivery, `checkpoint_every` N never republishes a closed
  window, a failed restore quarantines the directory and a wedged
  checkpoint never stalls the plane; a hung checkpoint stalls only the
  window thread (the port's, with every wait bounded).

Windows close by `flush()`; aggregator windows are 3600 s, so no window
thread reaches a deadline."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from netobserv_tpu import config as jconfig
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.federation.aggregator import (
    FederationAggregator as RefAggregator,
)
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.sketch import checkpoint as jck
from netobserv_tpu.sketch import state as js
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.federation.aggregator import FederationAggregator
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import checkpoint as tck
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.utils import faultinject, retrace
from tests.test_federation import make_arrays
from tests.test_torch_federation import (
    JCFG, TCFG, _agent_tables, _frame, _jax_flat,
)
from tests.test_torch_resident import GEOM
from tests.test_torch_staging import B, _feed, _Samples
from tests.test_torch_window import _jax_exporter, _port_exporter

EPOCH0 = 1_000


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()


@pytest.fixture(scope="module")
def universe():
    return np.random.default_rng(21).integers(0, 2**32, (48, 10),
                                              dtype=np.uint32)


def _jax_state(universe, seed=3):
    """A JAX state with every structure touched: two windows folded, the
    first rolled (EWMA baselines, slot churn), integer-valued masses."""
    rng = np.random.default_rng(seed)
    s = js.init_state(JCFG)
    for w in range(2):
        for _ in range(2):
            s = js.ingest(s, make_arrays(rng, universe))
        if w == 0:
            s, _ = js.roll_window(s, JCFG)
    return s


def _flat_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _pool_state(cfg, seed=1, n=300):
    _, pool = traffic.make_pool(np.random.default_rng(seed), batch=n,
                                n_batches=2)
    state = ts.init_state(cfg, device="cpu")
    for batch in traffic.device_pool(pool, "cpu"):
        ts.ingest(state, batch)
    return state


# ------------------------------------------------------------ checkpointer


def test_wide_and_tiered_states_round_trip_bit_for_bit(tmp_path, universe):
    wide = carry.state_from_numpy(_jax_flat(_jax_state(universe)), "cpu")
    ck = tck.SketchCheckpointer(str(tmp_path / "wide"))
    ck.save(4, wide)
    target = ts.init_state(TCFG, "cpu")
    ptrs = [carry.get_leaf(target, p).data_ptr()
            for p in carry.field_paths()]
    assert ck.restore(target) is target
    assert ptrs == [carry.get_leaf(target, p).data_ptr()
                    for p in carry.field_paths()]
    _flat_equal(carry.state_to_numpy(target), carry.state_to_numpy(wide))
    ck.close()
    # tiered: the wide decode is saved and restored bit for bit; the
    # tiered state is its from-scratch encode, as the reference's restore
    cfg = ts.SketchConfig(**GEOM, tiered=tiered.TierSpec())
    state = _pool_state(cfg)
    ck = tck.SketchCheckpointer(str(tmp_path / "tiered"))
    ck.save(9, tiered.decode_state(state))
    restored = ts.init_state(cfg, "cpu")
    wide = ck.restore(cfg._replace(tiered=None), device="cpu")
    _flat_equal(carry.state_to_numpy(wide),
                carry.state_to_numpy(tiered.decode_state(state)))
    ts.copy_state_(restored, tiered.encode_state(wide, cfg.tiered))
    _flat_equal(carry.state_to_numpy(restored), carry.state_to_numpy(
        tiered.encode_state(tiered.decode_state(state), cfg.tiered)))
    assert ck.latest_step() == 9
    ck.close()


def test_restore_equals_the_reference_checkpointer(tmp_path, universe):
    """The same state saved and restored by each package's checkpointer:
    the port's restore equals the JAX checkpointer's, leaf for leaf, with
    the JAX paths and dtypes."""
    js_state = _jax_state(universe)
    jc = jck.SketchCheckpointer(str(tmp_path / "ref"))
    jc.save(2, js_state, wait=True)
    want = _jax_flat(jc.restore(js.init_state(JCFG)))
    jc.close()
    pc = tck.SketchCheckpointer(str(tmp_path / "port"))
    pc.save(2, carry.state_from_numpy(_jax_flat(js_state), "cpu"))
    pc.close()
    got = carry.state_to_numpy(pc.restore(TCFG, device="cpu"))
    _flat_equal(got, want)
    assert pc.latest_step() == 2
    with pytest.raises(TypeError, match="wide"):
        pc.stage(ts.init_state(TCFG._replace(tiered=tiered.TierSpec()),
                               "cpu"))


def test_stamp_and_sidecars_equal_the_reference(tmp_path, universe):
    meta = {"ledger": {"a": {"epoch": 7, "window_seq": 3,
                             "frame_uuid": "u-1"}},
            "agents": {"a": {"frames": 2, "window": 3, "last_ms": 1.5}}}
    dirs = {}
    for name, mod, state in (
            ("port", tck, ts.init_state(TCFG, "cpu")),
            ("ref", jck, js.init_state(JCFG))):
        c = mod.SketchCheckpointer(str(tmp_path / name))
        kw = {"wait": True} if mod is jck else {}
        c.save_metadata(3, meta)
        c.save(3, state, **kw)
        c.save_publish_marker(5, meta)
        dirs[name] = c
    for f in ("FORMAT.json", "META-3.json", "PUBLISHED.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f
    p, r = dirs["port"], dirs["ref"]
    assert p.read_stamp() == r.read_stamp()
    assert p.read_metadata() == r.read_metadata() == meta
    assert p.read_metadata(3) == r.read_metadata(3)
    assert p.read_publish_marker() == r.read_publish_marker()
    assert p.latest_step() == r.latest_step() == 3
    # a sidecar of a step beyond the retention is pruned alike
    for c, state, kw in ((p, ts.init_state(TCFG, "cpu"), {}),
                         (r, js.init_state(JCFG), {"wait": True})):
        for step in (4, 5, 6, 7):
            c.save_metadata(step, meta)
            c.save(step, state, **kw)
        c.save_metadata(8, meta)
    for sub in ("port", "ref"):
        assert sorted(n for n in os.listdir(tmp_path / sub)
                      if n.startswith("META-")) == [
            "META-5.json", "META-6.json", "META-7.json", "META-8.json"]
    p.close()
    r.close()


STAMPS = {
    "current": None,
    "future": {"format_version": 44},
    "crc_drift": {"format_version": 3, "table_spec_crc": 12345},
    "v2_era": {"format_version": 2, "table_spec_crc": 1393615489,
               "delta_format_version": 2},
    "legacy": "remove",
    "torn": "torn",
}


@pytest.mark.parametrize("case", sorted(STAMPS))
def test_format_verdicts_equal_the_reference(tmp_path, case):
    verdicts = []
    for name, mod, state, tmpl in (
            ("port", tck, ts.init_state(TCFG, "cpu"), TCFG),
            ("ref", jck, js.init_state(JCFG), js.init_state(JCFG))):
        d = str(tmp_path / name)
        c = mod.SketchCheckpointer(d)
        c.save(1, state, **({"wait": True} if mod is jck else {}))
        stamp = os.path.join(d, "FORMAT.json")
        how = STAMPS[case]
        if how == "remove":
            os.remove(stamp)
        elif how == "torn":
            with open(stamp, "r+b") as fh:
                fh.truncate(9)
        elif how is not None:
            with open(stamp, "w") as fh:
                json.dump(how, fh)
        try:
            verdict = ("ok", c.check_format())
        except RuntimeError as exc:
            verdict = ("refused", str(exc).replace(d, "<dir>"))
        if verdict[0] == "ok":
            kw = {"device": "cpu"} if mod is tck else {}
            c.restore(tmpl, **kw)
        verdicts.append(verdict)
        c.close()
    assert verdicts[0] == verdicts[1]


def test_v2_refused_before_any_tensor_is_read(tmp_path):
    c = tck.SketchCheckpointer(str(tmp_path))
    c.save(0, ts.init_state(TCFG, "cpu"))
    with open(os.path.join(str(tmp_path), "FORMAT.json"), "w") as fh:
        json.dump(STAMPS["v2_era"], fh)
    calls = []
    load = c._load
    c._load = lambda step: calls.append(step) or load(step)
    with pytest.raises(RuntimeError, match="format version 2"):
        c.restore(TCFG, device="cpu")
    assert not calls
    # a legacy directory (no stamp) restores through the identity upgrade
    os.remove(os.path.join(str(tmp_path), "FORMAT.json"))
    assert c.check_format() == 1
    c.restore(TCFG, device="cpu")
    assert calls == [0]
    c.close()


def test_torn_sidecars_degrade_and_never_poison_a_restore(tmp_path):
    d = str(tmp_path / "ck")
    s = _pool_state(TCFG)
    c = tck.SketchCheckpointer(d)
    c.save_metadata(3, {"ledger": {"a": {"epoch": 1}}})
    c.save(3, s)
    c.save_publish_marker(3, {"ledger": {}})
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    for name in ("FORMAT.json", "META-3.json", "PUBLISHED.json"):
        path = os.path.join(d, name)
        with open(path, "r+b") as fh:
            fh.truncate(max(1, os.path.getsize(path) // 2))
    c2 = tck.SketchCheckpointer(d)
    assert c2.read_stamp()["format_version"] == 1
    assert c2.check_format() == 1
    assert c2.read_metadata(3) is None
    assert c2.read_publish_marker() is None
    restored = c2.restore(TCFG, device="cpu")
    assert torch.equal(restored.cm_bytes.counts, s.cm_bytes.counts)
    c2.save_metadata(4, {"ledger": {}})
    c2.save(4, s)
    c2.save_publish_marker(4, {})
    assert c2.read_stamp()["format_version"] > 1
    assert c2.read_metadata(4) == {"ledger": {}}
    assert c2.read_publish_marker()["window"] == 4
    # a write cut before its rename leaves a temporary the next open drops
    os.makedirs(os.path.join(d, ".tmp-9"))
    c3 = tck.SketchCheckpointer(d)
    assert c3.latest_step() == 4 and ".tmp-9" not in os.listdir(d)
    for c_ in (c, c2, c3):
        c_.close()


def test_restore_defaults_to_cuda_and_checks_the_layout(tmp_path):
    c = tck.SketchCheckpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        c.restore(TCFG, device="cpu")
    c.save(0, ts.init_state(TCFG, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            c.restore(TCFG)
    for other in (TCFG._replace(topk=32), TCFG._replace(cm_depth=2)):
        target = ts.init_state(other, "cpu")
        before = carry.state_to_numpy(target)
        with pytest.raises(ValueError, match="checkpoint step 0"):
            c.restore(target)
        _flat_equal(carry.state_to_numpy(target), before)
    c.close()


def test_checkpoint_settings_equal_the_reference():
    for env in ({}, {"SKETCH_CHECKPOINT_DIR": "/ck", "SKETCH_CHECKPOINT_EVERY":
                     "3", "FEDERATION_CHECKPOINT_DIR": "/fck",
                     "FEDERATION_CHECKPOINT_EVERY": "2"},
                {"SKETCH_CHECKPOINT_EVERY": ""}):
        want = jconfig.load_config({"EXPORT": "stdout", **env})
        got = tconfig.CheckpointSettings.from_env(env)
        for name in tconfig.CheckpointSettings.__dataclass_fields__:
            assert getattr(got, name) == getattr(want, name), (env, name)


# ---------------------------------------------------------------- exporter


def test_exporter_restores_in_place_as_the_reference(tmp_path):
    """The same evictions through the JAX exporter and the port, each
    checkpointing every roll; both restart on their directory. The port's
    restored state is its saved one bit for bit, and equals the JAX one's:
    the RTT and DNS histograms to the bound of tests/test_torch_staging.py
    and the EWMA baselines (`alpha` products, not integer-valued) to
    4 ulp of f32, the rest bit for bit. Its tensors stay where they were,
    and nothing captures."""
    rng = np.random.default_rng(51)
    samples = _Samples()
    kw = dict(checkpoint_every=1)
    jexp, _ = _jax_exporter(checkpoint_dir=str(tmp_path / "ref"), **kw)
    exp, _ = _port_exporter(checkpoint_dir=str(tmp_path / "port"), **kw)
    for w in range(2):
        for n in (300, 2 * B + 50):
            ev, f = _feed(rng, n, n_distinct=900)
            samples.add(f)
            exp.export_evicted(EvictedFlows(ev, **f))
            jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
        exp.flush()
        jexp.flush()
    exp.close()
    jexp.close()
    saved = carry.state_to_numpy(exp.state)  # the close's roll, step 2
    before = retrace.total_retraces()
    jexp, _ = _jax_exporter(checkpoint_dir=str(tmp_path / "ref"), **kw)
    exp, _ = _port_exporter(checkpoint_dir=str(tmp_path / "port"), **kw)
    try:
        got = carry.state_to_numpy(exp.state)
        _flat_equal(got, saved)
        want = _jax_flat(jexp._state)
        assert int(got["window"]) == int(want["window"]) == 3
        for k, v in want.items():
            g = got[k]
            assert g.dtype == v.dtype, k
            if k.startswith("hist_"):
                assert g.sum() == v.sum()
                moved = np.abs(np.cumsum(g.astype(np.float64) - v)).sum()
                assert moved <= samples.edge_prone(k[:8], len(v)), k
                continue
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(g, v, rtol=4 * 2.0**-23,
                                           atol=0, err_msg=k)
                continue
            np.testing.assert_array_equal(g, v, err_msg=k)
        ptrs = [carry.get_leaf(exp.state, p).data_ptr()
                for p in carry.field_paths()]
        exp._maybe_restore()  # again: in place, the same values
        assert ptrs == [carry.get_leaf(exp.state, p).data_ptr()
                        for p in carry.field_paths()]
        _flat_equal(carry.state_to_numpy(exp.state), got)
        assert exp.captures == [] and retrace.total_retraces() == before
    finally:
        exp.close()
        jexp.close()


def test_tiered_exporter_restores_through_the_wide_form(tmp_path):
    cfg = ts.SketchConfig(**GEOM, tiered=tiered.TierSpec())
    _, pool = traffic.make_pool(np.random.default_rng(5), batch=B,
                                n_batches=2)
    dense = traffic.dense_pool(pool)
    d = str(tmp_path / "ck")
    exp = TorchSketchExporter(cfg, batch_size=B, device="cpu", feed="dense",
                              sink=lambda o: None, checkpoint_dir=d,
                              checkpoint_every=2)
    for flat in dense:
        exp.fold_dense(flat)
        exp.flush()
    exp.fold_dense(dense[0])
    wide = tiered.decode_state(exp.state)
    saved = carry.state_to_numpy(tiered.encode_state(wide, cfg.tiered))
    exp._ckpt.save(7, wide)
    exp2 = TorchSketchExporter(cfg, batch_size=B, device="cpu",
                               feed="dense", sink=lambda o: None,
                               checkpoint_dir=d)
    try:
        assert isinstance(exp2.state, tiered.TieredState)
        _flat_equal(carry.state_to_numpy(exp2.state), saved)
        assert sorted(exp2._ckpt.all_steps()) == [1, 7]
    finally:
        exp2.close()
        exp.close()


@pytest.mark.parametrize("how", ["rejected", "incompatible"])
def test_bad_checkpoint_gives_a_fresh_window(tmp_path, how):
    d = str(tmp_path / "ck")
    c = tck.SketchCheckpointer(d)
    cfg = ts.SketchConfig(**GEOM)
    c.save(1, _pool_state(cfg._replace(topk=64) if how == "incompatible"
                          else cfg))
    c.close()
    if how == "rejected":
        with open(os.path.join(d, "FORMAT.json"), "w") as fh:
            json.dump({"format_version": 4}, fh)
    reports = []
    exp = TorchSketchExporter(cfg, batch_size=B, device="cpu", feed="dense",
                              sink=reports.append, checkpoint_dir=d,
                              checkpoint_every=1)
    try:
        _flat_equal(carry.state_to_numpy(exp.state),
                    carry.state_to_numpy(ts.init_state(cfg, "cpu")))
        exp.flush()
    finally:
        exp.close()
    assert reports and reports[0]["Records"] == 0.0
    assert reports[0]["Window"] == 0


# -------------------------------------------------------------- aggregator


def _streams(universe, n_agents, n_windows, seed):
    """(agent, window) -> frame bytes, with explicit v2+ delivery
    headers."""
    rng = np.random.default_rng(seed)
    return {(a, w): _frame(_agent_tables(rng, universe), f"agent-{a}", w,
                           EPOCH0, uid=f"uuid-{a}-{w}", window_seq=w)
            for a in range(n_agents) for w in range(n_windows)}


def _pair(tmp_path, sub, reports, jreports, **kw):
    return (FederationAggregator(TCFG, window_s=3600.0, device="cpu",
                                 sink=reports.append,
                                 checkpoint_dir=str(tmp_path / sub / "p"),
                                 **kw),
            RefAggregator(sketch_cfg=JCFG, window_s=3600.0,
                          sink=jreports.append,
                          checkpoint_dir=str(tmp_path / sub / "r"), **kw))


def _ingest_both(pair, frame) -> tuple:
    got, want = (a.ingest_frame(frame) for a in pair)
    assert got.SerializeToString() == want.SerializeToString()
    return got.accepted, got.duplicate


def _same_state(pair) -> None:
    got = ts.state_tables(pair[0]._state)
    want = {k: np.asarray(v) for k, v in
            js.state_tables(pair[1]._state).items()}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(pair[0]._state.window) == int(pair[1]._state.window)
    assert pair[0]._window_host == pair[1]._window_host
    assert pair[0]._ledger == pair[1]._ledger


def test_kill_restart_keeps_exactly_once_as_the_reference(tmp_path,
                                                          universe):
    frames = _streams(universe, 2, 2, seed=31)
    reports, jreports = [], []
    pair = _pair(tmp_path, "k", reports, jreports)
    assert _ingest_both(pair, frames[(0, 0)]) == (1, 0)
    assert _ingest_both(pair, frames[(1, 0)]) == (1, 0)
    for a in pair:
        a.flush()
    assert _ingest_both(pair, frames[(0, 1)]) == (1, 0)
    for a in pair:
        a.kill()
    pair = _pair(tmp_path, "k", reports, jreports)
    try:
        _same_state(pair)
        assert _ingest_both(pair, frames[(0, 0)]) == (1, 1)
        assert _ingest_both(pair, frames[(0, 1)]) == (1, 0)
        assert _ingest_both(pair, frames[(1, 1)]) == (1, 0)
        assert _ingest_both(pair, frames[(0, 1)]) == (1, 1)
        _same_state(pair)
        for a in pair:
            a.flush()
        assert [r["Window"] for r in reports] == \
            [r["Window"] for r in jreports] == [0, 1]
        assert pair[0]._fold.calls == 2 and pair[0]._fold.retraces == 0
        assert pair[0]._roll.retraces == 0
    finally:
        for a in pair:
            a.close()


def test_checkpoint_every_n_never_republishes_as_the_reference(tmp_path,
                                                               universe):
    frames = _streams(universe, 1, 3, seed=35)
    reports, jreports = [], []
    pair = _pair(tmp_path, "n", reports, jreports, checkpoint_every=2)
    for w in range(3):
        assert _ingest_both(pair, frames[(0, w)]) == (1, 0)
        for a in pair:
            a.flush()
    for a in pair:
        a.kill()
    pair = _pair(tmp_path, "n", reports, jreports, checkpoint_every=2)
    try:
        # window 2 published but not tensor-checkpointed: its frame dedups
        assert _ingest_both(pair, frames[(0, 2)]) == (1, 1)
        _same_state(pair)
        assert float(pair[0]._state.heavy.counts.sum()) == 0.0
        for a in pair:
            a.flush()
        windows = [r["Window"] for r in reports]
        assert windows == [r["Window"] for r in jreports] == [0, 1, 2, 3]
    finally:
        for a in pair:
            a.close()


def test_failed_restore_quarantines_as_the_reference(tmp_path, universe):
    frames = _streams(universe, 1, 2, seed=33)
    reports, jreports = [], []
    pair = _pair(tmp_path, "q", reports, jreports)
    assert _ingest_both(pair, frames[(0, 0)]) == (1, 0)
    for a in pair:
        a.flush()
        a.close()
    for d in ("p", "r"):
        with open(tmp_path / "q" / d / "FORMAT.json", "w") as fh:
            json.dump({"format_version": 99}, fh)
    tm = Metrics()
    pair = (FederationAggregator(TCFG, window_s=3600.0, device="cpu",
                                 metrics=tm, sink=reports.append,
                                 checkpoint_dir=str(tmp_path / "q" / "p")),
            RefAggregator(sketch_cfg=JCFG, window_s=3600.0,
                          sink=jreports.append,
                          checkpoint_dir=str(tmp_path / "q" / "r")))
    try:
        names = sorted(os.listdir(tmp_path / "q"))
        assert [n.split(".corrupt-")[0] for n in names] == \
            ["p", "p", "r", "r"]
        _same_state(pair)
        assert _ingest_both(pair, frames[(0, 1)]) == (1, 0)
        for a in pair:
            a.flush()
        assert tm.registry.get_sample_value(
            "ebpf_agent_federation_checkpoints_total",
            {"result": "ok"}) == 1
    finally:
        for a in pair:
            a.close()
    pair = _pair(tmp_path, "q", reports, jreports)
    try:
        assert _ingest_both(pair, frames[(0, 1)]) == (1, 1)
    finally:
        for a in pair:
            a.close()


def test_wedged_checkpoint_never_stalls_the_plane_as_the_reference(
        tmp_path, universe):
    frames = _streams(universe, 1, 2, seed=32)
    tm, jm = Metrics(), jreg.Metrics(jreg.MetricsSettings())
    reports, jreports = [], []
    pair = (FederationAggregator(TCFG, window_s=3600.0, device="cpu",
                                 metrics=tm, sink=reports.append,
                                 checkpoint_dir=str(tmp_path / "p")),
            RefAggregator(sketch_cfg=JCFG, window_s=3600.0, metrics=jm,
                          sink=jreports.append,
                          checkpoint_dir=str(tmp_path / "r")))
    try:
        faultinject.arm("federation.checkpoint", "crash", times=1)
        jfault.arm("federation.checkpoint", "crash", times=1)
        assert _ingest_both(pair, frames[(0, 0)]) == (1, 0)
        for a in pair:
            a.flush()
        assert len(reports) == len(jreports) == 1
        assert _ingest_both(pair, frames[(0, 1)]) == (1, 0)
        for a in pair:
            a.flush()
        assert len(reports) == len(jreports) == 2
        for result in ("ok", "error"):
            name = "ebpf_agent_federation_checkpoints_total"
            assert tm.registry.get_sample_value(name, {"result": result}) \
                == jm.registry.get_sample_value(name, {"result": result}) \
                == 1, result
        assert pair[0].status()["checkpointing"] is \
            pair[1].status()["checkpointing"] is True
    finally:
        for a in pair:
            a.close()


def test_hung_checkpoint_stalls_only_the_window_thread(tmp_path, universe):
    """A checkpoint write that blocks stalls only the publish path: the
    tensors were staged under the lock, the write runs off it, so delta
    ingest flows; `close()` stays bounded; once released, the publish
    lands. Every wait here is bounded."""
    frames = _streams(universe, 1, 2, seed=34)
    reports: list = []
    agg = FederationAggregator(TCFG, window_s=3600.0, device="cpu",
                               sink=reports.append,
                               checkpoint_dir=str(tmp_path / "agg"))
    entered, release = threading.Event(), threading.Event()
    real_save = agg._ckpt.save

    def hung_save(step, state):
        entered.set()
        assert release.wait(timeout=30), "release never came"
        return real_save(step, state)

    agg._ckpt.save = hung_save
    try:
        assert agg.ingest_frame(frames[(0, 0)]).accepted == 1
        flusher = threading.Thread(target=agg.flush, daemon=True)
        flusher.start()
        assert entered.wait(timeout=15), "checkpoint write never ran"
        done, got = threading.Event(), {}

        def ingest():
            got["ack"] = agg.ingest_frame(frames[(0, 1)])
            done.set()
        threading.Thread(target=ingest, daemon=True).start()
        assert done.wait(timeout=10), "ingest waited for the hung disk"
        assert got["ack"].accepted == 1
        assert not reports, "publish outran its window's checkpoint"
        closed = threading.Event()
        closer = threading.Thread(target=lambda: (agg.close(),
                                                  closed.set()),
                                  daemon=True)
        closer.start()
        assert closed.wait(timeout=15), "close() waited for the hung disk"
        release.set()
        flusher.join(timeout=15)
        assert not flusher.is_alive()
        assert [r["Window"] for r in reports][:1] == [0]
        assert agg._ckpt.latest_step() == 0
    finally:
        release.set()
        agg.close()
