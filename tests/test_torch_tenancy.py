"""The port's tenant planes (netobserv_tpu_torch/sketch/tenancy.py,
`ops/hashing.tenant_of`, the exporter's tenant mode, `from_config` and the
CLI with SKETCH_TENANTS) against the JAX package's, on the CPU.

- The router: `tenant_of_np` and torch `tenant_of` against the reference's
  on seeded words for n in {3, 4, 5, 16, 64}, and its golden vectors
  (tests/test_tenancy.py:174-180).
- The stacked fold and roll on the reference's schedule
  (tests/test_tenancy.py:121-152: n = 4, folds of 7, 64, 33, 128, 1 and
  200 rows over a shared universe, integer masses), wide and tiered:
  every table and rolled state bit for bit against the reference's
  `TenantStack`, the reports within `tests/test_torch_state.py`'s bound
  (the HLL estimates and quantiles are computed by two libraries); and
  every table, report and rolled tensor bit for bit against the port's own
  single-tenant ingest fed each tenant's routed chunks, also at n = 3.
- `fold` against `fold_rows`, `route` against the reference's,
  `split_tenants` and the views' offsets.
- No capture or retrace after warm-up across the ladder (1, 4, 16), with
  the `tenants=` attribution, through a stand-in for the CUDA graph
  (`tests/test_torch_retrace.FakeCapturedFold`).
- `close` evicts the per-tenant series.
- A budgeted slot wait that trips mid-fold against the reference's: the
  state, the rows dropped, the counters and the tables after it.
- The exporter with `tenants=3` against the JAX exporter with `tenants=3`
  (shown one device while it is made) on the same evictions and records:
  each tenant's report with its `Tenant`, `query_status()["tenants"]`,
  the 400/404/200 route contract, the delta frames through a callable
  sink, the per-tenant archive stores byte for byte, the per-tenant alert
  fingerprints, a mid-window refresh; the overlap against the synchronous
  exporter, the checkpoint's and a single store's warnings, and
  `tenants=0` as before.
- `from_config` with SKETCH_TENANTS=2, with and without ARCHIVE_DIR, and a
  `python -m netobserv_tpu_torch` child with SKETCH_TENANTS=2 on a synth
  pcap: two reports a window whose Records sum to the replay's flows.

The RTT and DNS histograms of evictions made by `_feed` are held to the
edge-move bound of tests/test_torch_staging.py (ROADMAP C5).
"""

import logging
import os
import time

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu import archive as jarch
from netobserv_tpu import config as jcfg
from netobserv_tpu.alerts import engine as jengine
from netobserv_tpu.alerts import rules as jrules
from netobserv_tpu.archive import segment as jseg
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.model import record as jrecord
from netobserv_tpu.ops import hashing as jhash
from netobserv_tpu.sketch import state as js
from netobserv_tpu.sketch import tenancy as jten
from netobserv_tpu_torch import archive as tarch
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.alerts import engine as tengine
from netobserv_tpu_torch.alerts import rules as trules
from netobserv_tpu_torch.archive import segment as tseg
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.report import report_numpy
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.federation import delta as fdelta
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.model import record as trecord
from netobserv_tpu_torch.ops import hashing
from netobserv_tpu_torch.ops import quantile as tquantile
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tenancy, tiered
from netobserv_tpu_torch.sketch.staging import StagingWedged
from netobserv_tpu_torch.utils import retrace
from tests.test_tenancy import (
    B, KW, SMALL_CFG, SMALL_TIERS, _oracle_chunks, _rows,
)
from tests.test_torch_entry import flood_pcap, run_tenant_child
from tests.test_torch_overload import NeverReady
from tests.test_torch_query_plane import _assert_report, _timeless
from tests.test_torch_retrace import FakeCapturedFold
from tests.test_torch_staging import _feed, _Samples
from tests.test_torch_state import _assert_report_close

#: the reference tests' geometry (tests/test_tenancy.py SMALL_CFG)
TGEOM = dict(cm_depth=2, cm_width=1 << 10, hll_precision=6,
             perdst_buckets=32, perdst_precision=4, persrc_buckets=32,
             persrc_precision=4, topk=16, hist_buckets=64, ewma_buckets=32)
TTIERS = tiered.TierSpec(mid_group=8, top_group=32, bytes_unit=1)
#: the reference schedule's fold sizes (tests/test_tenancy.py:128)
FOLD_SIZES = (7, 64, 33, 128, 1, 200)
#: the exporters' batch
EB = 64
#: the histograms' bucket ratio at TGEOM
GAMMA = tquantile.gamma_for(TGEOM["hist_buckets"])


def _cfg(tier: bool) -> ts.SketchConfig:
    return ts.SketchConfig(**TGEOM, tiered=TTIERS if tier else None)


def _jcfg(tier: bool):
    return SMALL_CFG._replace(tiered=SMALL_TIERS) if tier else SMALL_CFG


def _schedule() -> list:
    universe = np.random.default_rng(3).integers(
        0, 2**32, (64, KW), dtype=np.uint32)
    return [_rows(m, seed=100 + i, universe=universe)
            for i, m in enumerate(FOLD_SIZES)]


def _port_stack(n, cfg, folds, **kw):
    stack = tenancy.TenantStack(n, cfg, B, device="cpu", **kw)
    state = tenancy.init_stacked_state(cfg, n, "cpu")
    for rows in folds:
        state = stack.fold_rows(state, rows)
    return stack, stack.flush(state)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _assert_same(got, want, where=""):
    """Two host trees (named tuples of arrays, or dicts) equal bit for bit,
    dtypes included."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        pairs = [(got[k], want[k], k) for k in want]
    elif isinstance(want, tuple):
        names = getattr(want, "_fields", range(len(want)))
        pairs = list(zip(got, want, names))
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        np.testing.assert_array_equal(g, w, err_msg=where)
        return
    for g, w, k in pairs:
        _assert_same(g, w, f"{where}.{k}")


def _value(metric) -> float:
    return metric._value.get()


# ------------------------------------------------------------- the router


@pytest.mark.parametrize("n", [3, 4, 5, 16, 64])
def test_tenant_of_matches_the_reference(n):
    words = np.random.default_rng(9 + n).integers(
        0, 2**32, (300, KW), dtype=np.uint32)
    want = jhash.tenant_of_np(words, n)
    np.testing.assert_array_equal(np.asarray(jhash.tenant_of(words, n)),
                                  want)
    got_np = hashing.tenant_of_np(words, n)
    assert got_np.dtype == np.int32
    np.testing.assert_array_equal(got_np, want)
    got = hashing.tenant_of(torch.from_numpy(words.astype(np.int64)), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 0 and want.max() < n
    assert hashing.TENANT_SEED == jhash.TENANT_SEED


def test_tenant_of_golden_vectors():
    w = np.arange(50, dtype=np.uint32).reshape(5, 10)
    for n, want in ((4, [1, 1, 1, 3, 3]), (16, [9, 5, 9, 11, 11])):
        assert hashing.tenant_of_np(w, n).tolist() == want
        assert hashing.tenant_of(torch.from_numpy(w.astype(np.int64)),
                                 n).tolist() == want


# ------------------------------------------------ the stacked fold and roll


@pytest.mark.parametrize("tier", [False, True], ids=["wide", "tiered"])
def test_stacked_fold_and_roll_match_the_reference(tier):
    """The reference's schedule through both stacks: the dispatch counts,
    every pre-roll table and every rolled state's tables and baselines bit
    for bit, the reports within the libraries' bound."""
    n, folds = 4, _schedule()
    jstack = jten.TenantStack(n, _jcfg(tier), B)
    jstate = jten.init_stacked_state(_jcfg(tier), n)
    for rows in folds:
        jstate = jstack.fold_rows(jstate, rows)
    jstate = jstack.flush(jstate)
    jnew, jrep, jtab = jstack.roll(jstate)
    stack, state = _port_stack(n, _cfg(tier), folds)
    assert (stack.folds, stack.routed_rows) == (jstack.folds,
                                                jstack.routed_rows)
    _, rep, tab = stack.roll(state)
    for t, (g, w) in enumerate(zip(tenancy.split_tenants(tab, n),
                                   jten.split_tenants(jtab, n))):
        _assert_same(g, {k: np.asarray(v) for k, v in w.items()},
                     f"tables t={t}")
    for g, w in zip(tenancy.split_tenants(rep, n),
                    jten.split_tenants(jrep, n)):
        _assert_report_close(g, w, m_hll=64)
    for t, w in enumerate(jten.split_tenants(jnew, n)):
        view = tenancy.tenant_view(state, t)
        _assert_same(ts.state_tables(view),
                     {k: np.asarray(v) for k, v in js.state_tables(w).items()},
                     f"rolled t={t}")
        rest, jrest = getattr(view, "rest", view), getattr(w, "rest", w)
        for name in ("ddos", "syn", "drops_ewma"):
            _assert_same(tuple(np.asarray(x) for x in getattr(rest, name)),
                         tuple(np.asarray(x) for x in getattr(jrest, name)),
                         name)


@pytest.mark.parametrize("tier,n", [(False, 4), (True, 4), (False, 3)],
                         ids=["wide", "tiered", "odd-3"])
def test_stacked_fold_and_roll_equal_the_routed_single_tenant(tier, n):
    """Tenant t of the stack against the port's single-tenant ingest fed
    the chunks the schedule shipped to t (zero padding included): tables,
    report and every rolled tensor bit for bit."""
    folds, cfg = _schedule(), _cfg(tier)
    stack, state = _port_stack(n, cfg, folds)
    _, rep, tab = stack.roll(state)
    reps, tabs = tenancy.split_tenants(rep, n), tenancy.split_tenants(tab, n)
    for t, chunks in enumerate(_oracle_chunks(folds, n)):
        one = ts.init_state(cfg, "cpu")
        for c in chunks:
            flat = torch.from_numpy(c.reshape(-1).view(np.int32).copy())
            ts.ingest(one, ts.dense_to_arrays(flat))
        _assert_same(tabs[t], ts.state_tables(one), f"tables t={t}")
        _, want = ts.roll_window(one, cfg)
        _assert_same(reps[t], report_numpy(want), f"report t={t}")
        view = tenancy.tenant_view(state, t)
        for g, w in zip(_tensors(view), _tensors(one)):
            assert g.dtype == w.dtype and torch.equal(g, w), t


def test_fold_of_events_equals_fold_rows_and_routes_as_the_reference():
    n = 3
    ev, f = _feed(np.random.default_rng(5), 150)
    a = tenancy.TenantStack(n, _cfg(False), B, device="cpu")
    sa = a.flush(a.fold(tenancy.init_stacked_state(_cfg(False), n, "cpu"),
                        ev, **f))
    rows, owners = a.route(ev, **f)
    jrows, jowners = jten.TenantStack(n, SMALL_CFG, B).route(ev, **f)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(owners, jowners)
    b = tenancy.TenantStack(n, _cfg(False), B, device="cpu")
    sb = b.flush(b.fold_rows(tenancy.init_stacked_state(_cfg(False), n,
                                                        "cpu"), rows))
    for g, w in zip(_tensors(sa), _tensors(sb)):
        assert torch.equal(g, w)
    assert a.routed_rows == b.routed_rows == 150
    assert a.folds == b.folds == a.chunks


def test_split_tenants_and_the_views():
    """One host copy a leaf, then per-tenant views: scalars 0-d, uint32
    lanes back from int64; a view is contiguous, t leaves in."""
    n = 3
    state = tenancy.init_stacked_state(_cfg(False), n, "cpu")
    state.total_records.copy_(torch.tensor([1.0, 2.0, 3.0]))
    state.heavy.h1[1, 0] = 2**32 - 1
    parts = tenancy.split_tenants(state, n)
    assert [float(p.total_records) for p in parts] == [1.0, 2.0, 3.0]
    assert parts[2].total_records.shape == ()
    assert parts[1].heavy.h1.dtype == np.uint32
    assert parts[1].heavy.h1[0] == 2**32 - 1
    assert parts[0].cm_bytes.counts.base is parts[2].cm_bytes.counts.base
    for tier in (False, True):
        st = tenancy.init_stacked_state(_cfg(tier), n, "cpu")
        for leaf, view in zip(_tensors(st),
                              _tensors(tenancy.tenant_view(st, 2))):
            assert view.is_contiguous() and view.shape == leaf.shape[1:]
            assert view.data_ptr() - leaf.data_ptr() == \
                2 * view.numel() * view.element_size()
    with pytest.raises(ValueError):
        tenancy.init_stacked_state(_cfg(False), 0, "cpu")


def test_no_capture_or_retrace_after_warmup_across_the_tenant_ladder():
    """Each tenant count is one watched "tenant_ingest" with `tenants=N`;
    varied fold sizes, flushes and rolls never capture again, and the
    stand-in graph's replays fold what the eager stack folds."""
    stacks = []
    for n in (1, 4, 16):
        stack = tenancy.TenantStack(n, _cfg(False), B, device="cpu")
        eager = tenancy.TenantStack(n, _cfg(False), B, device="cpu")
        stack.captured = FakeCapturedFold("tenant_ingest", stack._ingest,
                                          tenants=n)
        stacks.append(stack)
        state = tenancy.init_stacked_state(_cfg(False), n, "cpu")
        want = tenancy.init_stacked_state(_cfg(False), n, "cpu")
        stack.warm(state)
        for s, st in ((stack, state), (eager, want)):
            for m in (5, 90, 17, 64):
                s.fold_rows(st, _rows(m, seed=m))
            s.flush(st)
            s.roll(st)
            s.fold_rows(st, _rows(40, seed=7))
            s.flush(st)
            s.roll(st)
        for g, w in zip(_tensors(state), _tensors(want)):
            assert torch.equal(g, w), n
        s = stack.captured.stats()
        assert (s["compiles"], s["retraces"], s["tenants"]) == (1, 0, n)
        assert s["calls"] == stack.folds
        assert s["last_signature"].startswith(f"tenants={n} ")
    seen = {w["tenants"] for w in retrace.snapshot()
            if w["fn"] == "tenant_ingest"}
    assert {1, 4, 16} <= seen


def test_close_evicts_the_per_tenant_series():
    from prometheus_client import generate_latest
    m = Metrics()
    stack = tenancy.TenantStack(2, _cfg(False), B, metrics=m, device="cpu")
    assert _value(m.sketch_tenants_active) == 2
    m.sketch_tenant_window_records.labels("0").set(5.0)
    m.sketch_tenant_window_records.labels("1").set(7.0)
    assert 'sketch_tenant_window_records{tenant="0"}' in \
        generate_latest(m.registry).decode()
    stack.close()
    text = generate_latest(m.registry).decode()
    assert "sketch_tenant_window_records{" not in text
    assert "sketch_tenants_active 0.0" in text


def test_wedged_slot_wait_mid_fold_matches_the_reference():
    """A never-ready token at the slot of the 200-row fold's second
    dispatch, in both stacks under a 0.05 s budget: both raise with the
    state that holds the dispatches before the trip (the port's is the
    caller's own object), drop the same rows, count the same folds and
    stalls, and fold on to the same tables."""
    n, folds = 4, _schedule()
    jstack = jten.TenantStack(n, SMALL_CFG, B)
    stack = tenancy.TenantStack(n, _cfg(False), B, device="cpu")
    jstack.slot_wait_budget_s = stack.slot_wait_budget_s = 0.05
    jstate = jten.init_stacked_state(SMALL_CFG, n)
    state = tenancy.init_stacked_state(_cfg(False), n, "cpu")
    for rows in folds[:5]:
        jstate = jstack.fold_rows(jstate, rows)
        state = stack.fold_rows(state, rows)
    assert stack._slot == jstack._slot
    slot = (stack._slot + 1) % len(stack._bufs)
    stack._copied[slot], real = NeverReady(), stack._copied[slot]
    jstack._tokens[slot], jreal = NeverReady(), jstack._tokens[slot]
    folds_before = stack.folds
    try:
        with pytest.raises(StagingWedged) as exc:
            stack.fold_rows(state, folds[5])
        with pytest.raises(Exception) as jexc:
            jstack.fold_rows(jstate, folds[5])
    finally:
        stack._copied[slot], jstack._tokens[slot] = real, jreal
    assert type(jexc.value).__name__ == "StagingWedged"
    assert exc.value.state is state
    jstate = jexc.value.state
    assert stack.folds == jstack.folds == folds_before + 1
    assert stack.routed_rows == jstack.routed_rows
    assert stack.stalls == jstack.stalls >= 1
    assert stack._fill == jstack._fill
    # the rows of the fold after the trip are dropped; later folds fold on
    jstate = jstack.flush(jstack.fold_rows(jstate, folds[1]))
    state = stack.flush(stack.fold_rows(state, folds[1]))
    _, _, jtab = jstack.roll(jstate)
    _, _, tab = stack.roll(state)
    for g, w in zip(tenancy.split_tenants(tab, n),
                    jten.split_tenants(jtab, n)):
        _assert_same(g, {k: np.asarray(v) for k, v in w.items()})


# ------------------------------------------------------------ the exporter


def _jax_exporter(sink, metrics=None, **kw):
    """The reference exporter with tenants=3 on one device: the tests' CPU
    backend has 8, and a multi-device exporter drops its tenants, so it is
    shown the first alone while it is made."""
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        jexp = TpuSketchExporter(
            batch_size=EB, window_s=3600.0, sketch_cfg=SMALL_CFG, sink=sink,
            metrics=metrics, tenants=3, synflood_min=4.0,
            scan_fanout_threshold=4.0, **kw)
    finally:
        jax.devices = devices
    assert jexp._tenancy is not None
    return jexp


def _port_exporter(sink, metrics=None, **kw):
    return TorchSketchExporter(_cfg(False), batch_size=EB, device="cpu",
                               window_s=3600.0, sink=sink, metrics=metrics,
                               tenants=3, synflood_min=4.0,
                               scan_fanout_threshold=4.0, **kw)


def _flood(rng, n, victim):
    """n SYNs from fresh sources to one victim: a SYN-flood suspect."""
    ev, f = _feed(rng, n)
    ev["key"]["dst_ip"][:] = victim
    ev["key"]["proto"] = 6
    ev["stats"]["tcp_flags"] = 0x02
    return ev, f


def _assert_hists(g, w, samples, k):
    assert g.sum() == w.sum(), k
    moved = np.abs(np.cumsum(g.astype(np.float64) - w)).sum()
    assert moved <= samples.edge_prone(k, len(w)), k


def _store_files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_tenant_exporter_matches_the_reference(tmp_path, monkeypatch):
    """Three windows of the same evictions (a SYN flood in each),
    then a window of the same records through `export_batch`, through the
    JAX exporter and the port, each with tenants=3, a callable delta sink,
    a per-tenant archive set and an alert engine; a mid-window refresh
    before the second window closes. Publish times are pinned."""
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000_000)
    rng = np.random.default_rng(17)
    out = {"port": ([], []), "ref": ([], [])}
    env = {"ARCHIVE_DIR": "{}", "SKETCH_TENANTS": "3",
           "ARCHIVE_RAW_WINDOWS": "8"}
    parch = tarch.tenant_archives(
        tcfg.load_config({**env, "ARCHIVE_DIR": str(tmp_path / "port")}),
        _cfg(False), 3, agent_id="a1", device="cpu")
    rarch = jarch.tenant_archives(
        jcfg.load_config({**env, "ARCHIVE_DIR": str(tmp_path / "ref")}),
        SMALL_CFG, 3, agent_id="a1")
    rule = dict(raise_evals=1)
    tm, jm = Metrics(), jreg.Metrics(jreg.MetricsSettings())
    exp = _port_exporter(
        out["port"][0].append, tm, delta_sink=out["port"][1].append,
        archive=parch, agent_id="a1", alerts=tengine.AlertEngine(
            [trules.signal_rule("syn_flood", **rule)], metrics=tm))
    jexp = _jax_exporter(
        out["ref"][0].append, jm, delta_sink=out["ref"][1].append,
        archive=rarch, agent_id="a1", alerts=jengine.AlertEngine(
            [jrules.signal_rule("syn_flood", **rule)], metrics=jm))
    samples = _Samples()
    victim = np.zeros(16, np.uint8)
    victim[10:12], victim[12:] = 0xFF, (10, 0, 0, 80)
    try:
        for w in range(3):
            feed = [_feed(rng, n) for n in (100, 3 * EB + 9, 37)]
            feed.append(_flood(rng, 120, victim))
            for ev, f in feed:
                samples.add(f)
                exp.export_evicted(EvictedFlows(ev.copy(), **f))
                jexp.export_evicted(jfetch.EvictedFlows(ev.copy(), **f))
            if w == 1:
                exp._refresh_query_snapshot()
                jexp._refresh_query_snapshot()
                for t in range(3):
                    g, r = exp._tenant_query[t].get(), \
                        jexp._tenant_query[t].get()
                    assert g["mid_window"] and r["mid_window"]
                    assert g["tenant"] == r["tenant"] == t
                    _assert_report(g["report"], r["report"], GAMMA)
            exp.flush()
            jexp.flush()
        # the alert fingerprints: the flood raised in each tenant it
        # reached, the same in both
        view, jview = exp._alerts.view(), jexp._alerts.view()
        key = lambda v: sorted((a["rule"], a["tenant"], a["bucket"])  # noqa
                               for a in v["active"])
        assert key(view) == key(jview)
        assert len({a["tenant"] for a in view["active"]}) >= 2
        ev, f = _feed(rng, 2 * EB + 30)
        samples.add({"extra": np.zeros(0, f["extra"].dtype),
                     "dns": np.zeros(0, f["dns"].dtype)})
        exp.export_batch(trecord.records_from_events(ev))
        jexp.export_batch(jrecord.records_from_events(ev))
        exp.flush()
        jexp.flush()
        # the status block and the route contract
        st, jst = exp.query_status()["tenants"], jexp.query_status()["tenants"]
        assert st == jst and st["n"] == 3 and st["published"] == 3
        assert st["routed_rows"] == exp.records
        for params, code in (({}, 400), ({"tenant": "x"}, 400),
                             ({"tenant": "9"}, 404), ({"tenant": "1"}, 200)):
            got = exp.query_routes.handle("/query/topk", params)
            want = jexp.query_routes.handle("/query/topk", params)
            assert got[0] == want[0] == code, params
            if code == 200:
                _assert_report(_timeless(got[1]), _timeless(want[1]), GAMMA)
        code, body = exp.query_routes.handle("/query/range",
                                             {"from": "0", "to": "3"})
        assert code == 400 and body["tenants"] == 3
        assert exp.query_routes.handle(
            "/query/range", {"from": "0", "to": "3", "tenant": "2"})[0] == 200
    finally:
        exp.close()
        jexp.close()
    reports, jreports = out["port"][0], out["ref"][0]
    assert len(reports) == len(jreports) == 15  # close publishes a fifth
    assert [r["Tenant"] for r in reports] == [0, 1, 2] * 5
    for g, w in zip(reports, jreports):
        _assert_report(g, w, GAMMA)
    assert sum(r["Records"] for r in reports) == exp.records == \
        _value(jm.sketch_records_total)
    # the delta frames: one a tenant a window, the same tables
    frames = [fdelta.decode_frame(x) for x in out["port"][1]]
    jframes = [fdelta.decode_frame(x) for x in out["ref"][1]]
    assert len(frames) == len(jframes) == 15
    for g, w in zip(frames, jframes):
        assert (g.tenant, g.window, g.agent_id) == (w.tenant, w.window,
                                                    w.agent_id)
        assert fdelta.source_key(g) == fdelta.source_key(w) == \
            f"a1#t{g.tenant[0]}"
        assert g.tenant[1] == 3
        for k, v in w.tables.items():
            if k in samples.us:
                _assert_hists(g.tables[k], v, samples, k)
            else:
                np.testing.assert_array_equal(g.tables[k], v, err_msg=k)
    # the per-tenant stores: the same files, byte for byte
    files = _store_files(tmp_path / "port")
    jfiles = _store_files(tmp_path / "ref")
    assert files.keys() == jfiles.keys()
    assert {k.split(os.sep)[0] for k in files} == {
        "tenant-0", "tenant-1", "tenant-2"}
    for k in jfiles:
        if files[k] != jfiles[k]:  # only where a histogram edge moved
            got, want = (tseg.decode_segment(files[k]),
                         jseg.decode_segment(jfiles[k]))
            for name, v in want.tables.items():
                if name in samples.us:
                    _assert_hists(got.tables[name], v, samples, name)
                else:
                    np.testing.assert_array_equal(got.tables[name], v)
    # the metrics the fan-out sets
    assert _value(tm.sketch_window_records) == \
        _value(jm.sketch_window_records)
    assert _value(tm.sketch_tenant_folds_total) == \
        _value(jm.sketch_tenant_folds_total) == exp.ring.folds
    # the port keeps the slot table's uint32 lanes in int64 (ROADMAP C4)
    lanes = 3 * 4 * SMALL_CFG.topk * (KW + 2)
    assert _value(tm.sketch_resident_hbm_bytes) == \
        _value(jm.sketch_resident_hbm_bytes) + lanes == \
        tiered.array_bytes(exp.state)


def test_overlap_folds_what_the_synchronous_tenant_exporter_folds():
    rng = np.random.default_rng(23)
    feed = [_feed(rng, n) for n in (100, 3 * EB + 9, 37, 250)]
    outs = []
    for depth in (0, 2):
        reports = []
        exp = _port_exporter(reports.append, overlap_depth=depth)
        try:
            for ev, f in feed:
                exp.export_evicted(EvictedFlows(ev.copy(), **f))
            exp.flush()
        finally:
            exp.close()
        outs.append(reports)
    assert len(outs[0]) == len(outs[1]) == 6
    for g, w in zip(*outs):
        g, w = dict(g), dict(w)
        g.pop("TimestampMs"), w.pop("TimestampMs")
        assert g == w


def test_checkpoints_and_a_single_store_are_disabled_with_a_warning(
        tmp_path, caplog):
    single = tarch.maybe_archive(
        tcfg.load_config({"ARCHIVE_DIR": str(tmp_path / "arc")}),
        _cfg(False), device="cpu")
    with caplog.at_level(logging.WARNING,
                         logger="netobserv_tpu_torch.exporter.torch_sketch"):
        exp = _port_exporter(lambda obj: None,
                             checkpoint_dir=str(tmp_path / "ckpt"),
                             checkpoint_every=1, archive=single)
    try:
        assert exp._ckpt is None and exp._archive is None
        assert "no stacked-tenant form" in caplog.text
        assert "per-tenant archive set" in caplog.text
        exp.export_evicted(EvictedFlows(*_feed(np.random.default_rng(2),
                                               50)[:1]))
        exp.flush()
        with pytest.raises(ValueError, match="tenant mode"):
            exp.fold_dense(np.zeros(ts.DENSE_WORDS, np.uint32))
    finally:
        exp.close()
    assert not (tmp_path / "ckpt").exists()


def test_tenants_0_keeps_the_single_tenant_exporter():
    reports = []
    exp = TorchSketchExporter(_cfg(False), batch_size=EB, device="cpu",
                              sink=reports.append, tenants=0)
    try:
        assert exp.tenants == 0 and exp._tenant_query is None
        exp.export_evicted(EvictedFlows(*_feed(np.random.default_rng(3),
                                               8)[:1]))
        exp.flush()
        assert not isinstance(exp.ring, tenancy.TenantStack)
        assert len(reports) == 1 and "Tenant" not in reports[0]
        assert "tenants" not in exp.query_status()
        assert isinstance(exp.state, ts.SketchState)
        assert exp.state.total_records.shape == ()
    finally:
        exp.close()


# -------------------------------------------------- from_config and the CLI


@pytest.mark.parametrize("archive", [False, True], ids=["plain", "archive"])
def test_from_config_builds_the_tenant_planes(archive, tmp_path):
    env = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
           "SKETCH_TENANTS": "2", "SKETCH_BATCH_SIZE": "256",
           "SKETCH_CM_WIDTH": "1024", "SKETCH_TOPK": "64",
           "SKETCH_HLL_PRECISION": "10", "SKETCH_WINDOW": "1h"}
    if archive:
        env["ARCHIVE_DIR"] = str(tmp_path)
    exp = TorchSketchExporter.from_config(tcfg.load_config(env),
                                          sink=lambda obj: None)
    try:
        assert isinstance(exp.ring, tenancy.TenantStack)
        assert exp.ring.n_tenants == 2 and len(exp._tenant_query) == 2
        assert exp.state.total_records.shape == (2,)
        if archive:
            assert isinstance(exp._archive, tarch.TenantArchiveSet)
            assert exp._archive.n_tenants == 2
        else:
            assert exp._archive is None
    finally:
        exp.close()
    with pytest.raises(ValueError, match="SKETCH_TENANTS"):
        tcfg.load_config({**env, "SKETCH_MESH_SHAPE": "2x1"}).validate()


def test_cli_publishes_a_report_a_tenant_each_window(tmp_path):
    pcap = tmp_path / "flood.pcap"
    flood_pcap(pcap)
    rc, reports, err = run_tenant_child(pcap, 2, until_reports=2)
    assert rc == 0, err.decode()[-2000:]
    assert [r["Tenant"] for r in reports] == [0, 1] * (len(reports) // 2)
    assert len(reports) % 2 == 0 and len(reports) >= 2
    windows = [r["Window"] for r in reports]
    assert windows == sorted(windows) and windows[0::2] == windows[1::2]
    assert sum(r["Records"] for r in reports) == 300.0
    assert all(r["Records"] > 0 for r in reports[:2])
