"""The mesh modes of the port's planes (TorchSketchExporter(mesh_shape=),
FederationAggregator(mesh_shape=), their checkpoints and `from_config`)
against the JAX package's, on the CPU.

The JAX exporter and aggregator build their meshes over the first of the
8 virtual CPU devices of tests/conftest.py; the port's run on `["cpu"] *
n`. Every window closes by `flush()`, never by the clock. Masses are
integer-valued (tests/test_torch_staging.py's feed, bytes 1-63 a record),
so every table and count is held bit for bit; the rendered reports are
held as tests/test_torch_query_plane.py holds them (floats to 1e-5
relative, which covers the HLL estimates' m * 2^-24, and the quantiles to
one histogram bucket, since the two libraries' f32 log can put a sample
on an edge one bucket apart, ROADMAP C5)."""

import logging

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.federation.aggregator import (
    FederationAggregator as RefAggregator,
)
from netobserv_tpu.federation.aggregator import (
    agent_owner_shard as ref_owner_shard,
)
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.agent.supervisor import Supervisor
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.federation.aggregator import (
    FederationAggregator, agent_owner_shard,
)
from netobserv_tpu_torch.parallel import MeshSpec, make_mesh
from netobserv_tpu_torch.parallel import merge as tm
from netobserv_tpu_torch.sketch import staging as tstg
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered
from tests.test_torch_federation import (
    GAMMA as FED_GAMMA, JCFG as FED_JCFG, TCFG as FED_TCFG, _schedule,
    _timeless_agents,
)
from tests.test_torch_query_plane import _assert_report
from tests.test_torch_staging import B, GEOM, _feed

GAMMA = ts.quantile.gamma_for(GEOM["hist_buckets"])
CPU4 = ["cpu"] * 4


def _port(mesh_shape, feed="resident", **kw):
    return TorchSketchExporter(
        ts.SketchConfig(**GEOM), batch_size=B, device="cpu", devices=CPU4,
        mesh_shape=mesh_shape, pack_threads=8, superbatch=(1, 2),
        feed=feed, resident_slots=1 << 12, sink=lambda r: None, **kw)


def _ref(mesh_shape, feed="resident", **kw):
    jexp = TpuSketchExporter(
        batch_size=B, window_s=3600.0, mesh_shape=mesh_shape,
        sketch_cfg=js.SketchConfig(**GEOM, use_pallas=False),
        sink=lambda obj: None, pack_threads=8, feed=feed,
        resident_slots=1 << 12, superbatch=(1, 2), **kw)
    assert jexp._distributed
    jexp.warm_superbatch_ladder(block=True)
    return jexp


def _ring_of(exp):
    """The port exporter's ring, made now if no fold has made it yet (the
    reference's constructor makes its ring)."""
    with exp._lock:
        exp._ensure_ring()
    return exp.ring


# ------------------------------------------------------------ exporter


@pytest.mark.parametrize("mesh_shape,feed", [("4x1", "resident"),
                                             ("2x2", "dense")],
                         ids=["4x1-resident", "2x2-dense"])
def test_mesh_exporter_equals_the_reference_exporter(mesh_shape, feed):
    """Two windows of evictions through the mesh exporter and the
    reference's: the rendered reports, the query snapshots (the CM planes
    on a data-axis mesh, none on a width-sharded one, whose
    /query/frequency answers 503) and the ring's shape."""
    exp, jexp = _port(mesh_shape, feed), _ref(mesh_shape, feed)
    reports, jreports = [], []
    exp.sink, jexp._sink = reports.append, jreports.append
    rng = np.random.default_rng(21)
    try:
        nd = exp.mesh.data
        assert exp.batch_size == jexp._batch_size
        _ring_of(exp)
        if feed == "resident":
            assert exp.ring.lanes == jexp._ring.lanes == 2
            assert exp.ring.n_shards == jexp._ring.n_shards == nd
        for w in range(2):
            for n in (B + 37, 3 * B, 190):
                ev, f = _feed(rng, n, v4_share=0.97)
                exp.export_evicted(EvictedFlows(ev, **f))
                jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
            exp.flush()
            jexp.flush()
            _assert_report(reports[-1], jreports[-1], GAMMA)
            snap, jsnap = exp.query.get(), jexp.query.get()
            if exp.mesh.sketch == 1:
                for k in ("cm_bytes", "cm_pkts"):
                    np.testing.assert_array_equal(snap[k], jsnap[k])
            else:
                assert snap["cm_bytes"] is None and jsnap["cm_bytes"] is None
                params = {"src": "10.0.0.1", "dst": "10.0.0.2"}
                got = exp.query_routes.handle("/query/frequency", params)
                want = jexp.query_routes.handle("/query/frequency", params)
                assert got[0] == want[0] == 503
        assert len(reports) == len(jreports) == 2
        assert exp.records == sum((B + 37, 3 * B, 190)) * 2
    finally:
        exp.close()
        jexp.close()


def test_mesh_exporter_refresh_and_state_tables():
    """A mid-window refresh rolls a staged copy of every shard through the
    merge and leaves the live window as it was; `state_tables` is the
    merged tables; `fold_dense` has no mesh form."""
    exp = _port("4x1", window_s=None)
    try:
        rng = np.random.default_rng(22)
        ev, f = _feed(rng, 2 * B + 11, v4_share=0.97)
        exp.export_evicted(EvictedFlows(ev, **f))
        with exp._lock:
            exp._drain_pending()  # what the refresh folds first
        before = tm.dist_tables(exp.state)
        exp._refresh_query_snapshot()
        snap = exp.query.get()
        assert snap["mid_window"] and snap["report"]["Records"] == len(ev)
        after = tm.dist_tables(exp.state)
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        tables = exp.state_tables()
        np.testing.assert_array_equal(tables["cm_bytes"], snap["cm_bytes"])
        assert float(tables["scalars"][0]) == len(ev)
        with pytest.raises(ValueError, match="mesh"):
            exp.fold_dense(np.zeros(20, np.uint32))
        bytes_ = exp.counter_table_bytes()
        cfg = ts.SketchConfig(**GEOM)
        assert bytes_["cm_bytes"] == 4 * cfg.cm_depth * cfg.cm_width * 4
    finally:
        exp.close()


def test_tiered_and_tenant_settings_degrade_as_the_reference_does(caplog):
    """On a mesh SKETCH_TIERED runs wide, with the reference's warning and
    its `tiered_degraded` condition and status flag, and tenants run as
    one, with the reference's warning; the compact feed falls back to
    dense with the reference's log line."""
    import netobserv_tpu.exporter.tpu_sketch as jmod
    import netobserv_tpu_torch.exporter.torch_sketch as tmod
    from netobserv_tpu.sketch import tiered as jt
    got = {}
    for name in ("port", "reference"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            if name == "port":
                tmod._TIERED_DEGRADE_WARNED = False
                exp = TorchSketchExporter(
                    ts.SketchConfig(**GEOM, tiered=tiered.TierSpec()),
                    batch_size=B, device="cpu", devices=CPU4,
                    mesh_shape="2x1", feed="compact", tenants=3,
                    sink=lambda r: None, window_s=3600.0)
                dense = isinstance(_ring_of(exp), tstg.DenseStagingRing)
            else:
                jmod._TIERED_DEGRADE_WARNED = False
                exp = TpuSketchExporter(
                    batch_size=B, window_s=3600.0, mesh_shape="2x1",
                    sketch_cfg=js.SketchConfig(**GEOM, use_pallas=False,
                                               tiered=jt.TierSpec()),
                    sink=lambda obj: None, feed="compact", tenants=3)
                dense = type(exp._ring).__name__ == "DenseStagingRing"
        sup = Supervisor()
        try:
            exp.register_supervised(sup)
            got[name] = (sorted(r.getMessage() for r in caplog.records
                                if "form" in r.getMessage()),
                         exp._tiered_degraded, dense,
                         exp.query_status().get("tiered_degraded"),
                         sup.conditions().get("tiered_degraded"))
        finally:
            exp.close()
    assert got["port"] == got["reference"]
    msgs, degraded, dense, flag, cond = got["port"]
    assert degraded and dense and flag is True and cond["active"]
    assert [m.split(" ")[0] for m in msgs] == ["SKETCH_FEED=compact",
                                               "SKETCH_TENANTS",
                                               "SKETCH_TIERED"]


# ----------------------------------------------------------- checkpoint


def test_dist_state_checkpoint_round_trip(tmp_path):
    """A mesh exporter checkpoints its `DistState` in the reference's
    leading-axis layout; a restarted exporter restores it in place into
    every shard, and the next window equals a run without the restart.
    The stamp sidecar is the one-device checkpoint's, byte for byte."""
    rng = np.random.default_rng(23)
    feeds = [_feed(rng, n, v4_share=0.97) for n in (2 * B + 5, B + 90)]
    plain = _port("4x1")
    ck = _port("4x1", checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=1)
    try:
        for exp in (plain, ck):
            ev, f = feeds[0]
            exp.export_evicted(EvictedFlows(ev, **f))
            exp.flush()
        saved = tm.dist_tables(ck.state)
    finally:
        ck.close()
    from netobserv_tpu_torch.sketch.checkpoint import SketchCheckpointer
    step = SketchCheckpointer(str(tmp_path / "ck")).latest_step()
    fields = dict(np.load(tmp_path / "ck" / str(step) / "state.npz"))
    # close() published one more, empty, window: the latest step is its
    cfg = ts.SketchConfig(**GEOM)
    assert fields["cm_bytes.counts"].shape == (4, cfg.cm_depth,
                                               cfg.cm_width)
    assert fields["heavy.h1"].shape == (4, 1, cfg.topk)
    assert fields["hll_src.regs"].shape == (4, 1 << cfg.hll_precision)
    back = _port("4x1", checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=1)
    try:
        restored = tm.dist_tables(back.state)
        for k, v in fields.items():
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
        # close() closed one more, empty, window: so does the plain run
        plain.flush()
        assert int(back.state.window) == int(plain.state.window) == 2
        for exp in (plain, back):
            ev, f = feeds[1]
            exp.export_evicted(EvictedFlows(ev, **f))
        with plain._lock, back._lock:
            plain._drain_pending()
            back._drain_pending()
        got, want = tm.dist_tables(back.state), tm.dist_tables(plain.state)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert saved["window"].tolist() == [1] * 4
    finally:
        back.close()
        plain.close()
    one = tmp_path / "one"
    SketchCheckpointer(str(one)).save(0, ts.init_state(
        ts.SketchConfig(**GEOM), "cpu"))
    assert (one / "FORMAT.json").read_bytes() == \
        (tmp_path / "ck" / "FORMAT.json").read_bytes()
    # a one-device checkpoint does not restore into a mesh
    with pytest.raises(ValueError, match="cm_bytes"):
        SketchCheckpointer(str(one)).restore(tm.init_dist_state(
            ts.SketchConfig(**GEOM), make_mesh(MeshSpec(2), CPU4)))


# ----------------------------------------------------------- aggregator


def test_agent_owner_shard_equals_the_reference():
    for agent in ("agent-0", "agent-1", "node-17", "", "ünïcode"):
        for n in (1, 2, 3, 4, 8):
            assert agent_owner_shard(agent, n) == ref_owner_shard(agent, n)


def test_mesh_aggregator_equals_the_reference_mesh_aggregator():
    """tests/test_torch_federation.py's frame schedule (4 agents x 3
    windows, duplicates, stale, v1 and v2 frames, a wrong geometry,
    garbage) into a 4x1 mesh aggregator and the reference's: every ack,
    the ledger, every closed window's snapshot (CM planes and heavy table
    bit for bit) and report, and the status."""
    universe = np.random.default_rng(11).integers(0, 2**32, (48, 10),
                                                  dtype=np.uint32)
    reports, jreports = [], []
    agg = FederationAggregator(FED_TCFG, window_s=3600.0, device="cpu",
                               devices=CPU4, mesh_shape="4x1",
                               sink=reports.append)
    ref = RefAggregator(sketch_cfg=FED_JCFG, window_s=3600.0,
                        mesh_shape="4x1", sink=jreports.append)
    try:
        for item in _schedule(universe):
            if item == "flush":
                agg.flush()
                ref.flush()
                got, want = agg.snapshot(), ref.snapshot()
                for k in ("window", "seq", "total_records", "total_bytes"):
                    assert got[k] == want[k], k
                _assert_report(got["report"], want["report"], FED_GAMMA)
                for k in ("cm_bytes", "cm_pkts"):
                    np.testing.assert_array_equal(got[k], want[k])
                for k, v in want["heavy"].items():
                    np.testing.assert_array_equal(got["heavy"][k],
                                                  np.asarray(v), err_msg=k)
                continue
            ack = agg.ingest_frame(item)
            want = ref.ingest_frame(item)
            assert ack.SerializeToString() == want.SerializeToString()
            assert agg._ledger == ref._ledger
        assert len(reports) == len(jreports) == 3
        for got, want in zip(reports, jreports):
            _assert_report(got, want, FED_GAMMA)
        st, jst = agg.status(), ref.status()
        assert st["mesh"] is jst["mesh"] is True
        for k in jst:
            if k == "agents":
                assert _timeless_agents(st[k]) == _timeless_agents(jst[k])
            else:
                assert st[k] == jst[k], k
        # each agent's frames folded into its owner shard alone
        owners = {agent_owner_shard(a, 4) for a in
                  ("agent-0", "agent-1", "agent-2", "agent-3", "old-v1",
                   "old-v2")}
        assert len(owners) > 1
    finally:
        agg.close()
        ref.close()


def test_mesh_aggregator_refuses_a_width_sharded_mesh():
    with pytest.raises(ValueError) as want:
        RefAggregator(sketch_cfg=FED_JCFG, window_s=3600.0,
                      mesh_shape="2x2")
    with pytest.raises(ValueError) as got:
        FederationAggregator(FED_TCFG, window_s=3600.0, device="cpu",
                             devices=CPU4, mesh_shape="2x2")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ from_config


def test_from_config_builds_the_mesh_exporter_on_the_cpu():
    """SKETCH_MESH_SHAPE with SKETCH_DEVICES=cpu repeats the CPU; the
    reference's refusals of SKETCH_TIERED or SKETCH_TENANTS with a mesh
    stay in `validate`."""
    env = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
           "SKETCH_CM_WIDTH": "1024", "SKETCH_TOPK": "64",
           "SKETCH_BATCH_SIZE": "510", "SKETCH_WINDOW": "1h",
           "SKETCH_MESH_SHAPE": "2x2", "SKETCH_RESIDENT_SLOTS": "4096",
           "SKETCH_FEED": "dense"}
    cfg = tcfg.load_config(env)
    cfg.validate()
    exp = TorchSketchExporter.from_config(cfg, sink=lambda r: None)
    try:
        assert exp.mesh.shape == {"data": 2, "sketch": 2}
        assert exp.batch_size == 510 and exp._with_tables is False
        assert isinstance(_ring_of(exp), tstg.DenseStagingRing)
    finally:
        exp.close()
    for extra in ({"SKETCH_TIERED": "true"}, {"SKETCH_TENANTS": "2"}):
        with pytest.raises(ValueError, match="SKETCH_MESH_SHAPE"):
            tcfg.load_config({**env, **extra}).validate()


def test_from_config_builds_the_mesh_aggregator_on_the_cpu():
    """FEDERATION_MESH_SHAPE reaches the aggregator, as the reference's
    aggregator process gives it (`federation/service.py:29-64`)."""
    env = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
           "SKETCH_CM_WIDTH": "1024", "SKETCH_TOPK": "64",
           "FEDERATION_MESH_SHAPE": "2x1", "FEDERATION_WINDOW": "1h"}
    agg = FederationAggregator.from_config(tcfg.load_config(env),
                                           sink=lambda obj: None)
    try:
        assert agg.mesh.shape == {"data": 2, "sketch": 1}
        assert agg.status()["mesh"] is True and agg._window_s == 3600.0
    finally:
        agg.close()
    one = FederationAggregator.from_config(tcfg.load_config(
        {**env, "FEDERATION_MESH_SHAPE": ""}), sink=lambda obj: None)
    try:
        assert one.mesh is None and one.status()["mesh"] is False
    finally:
        one.close()


def test_the_cli_runs_a_mesh_on_the_cpu(tmp_path):
    """`python -m netobserv_tpu_torch` with SKETCH_MESH_SHAPE=2x2 and
    SKETCH_DEVICES=cpu publishes its first window's report and exits 0 on
    SIGTERM (tests/test_torch_entry.py's child)."""
    from tests.test_torch_entry import flood_pcap, run_tenant_child
    flood_pcap(tmp_path / "flood.pcap")
    rc, reports, err = run_tenant_child(tmp_path / "flood.pcap", 0, 1,
                                        SKETCH_MESH_SHAPE="2x2")
    assert rc == 0, err.decode()[-2000:]
    assert reports and reports[0]["Window"] == 0
    assert sum(r["Records"] for r in reports) > 0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="asserts the refusal of a box without CUDA")
def test_a_mesh_that_needs_more_cards_than_are_visible_raises():
    """Without CUDA a mesh on the cards raises naming both counts, and
    never quietly shrinks or moves to the CPU."""
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                            mesh_shape="2x1", sink=lambda r: None)
    with pytest.raises(ValueError, match="needs 4 devices, have 0"):
        FederationAggregator(FED_TCFG, window_s=3600.0, mesh_shape="4")
    cfg = tcfg.load_config({"EXPORT": "tpu-sketch",
                            "SKETCH_MESH_SHAPE": "2x1"})
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSketchExporter.from_config(cfg, sink=lambda r: None)
