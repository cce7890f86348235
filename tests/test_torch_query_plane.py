"""The exporter's query seam (netobserv_tpu_torch/exporter/torch_sketch.py:
the CM planes of every roll, the snapshot publish, `query_status`, the
mid-window refresh, `serve`; sketch/state.py `copy_state_` and
`host_cm_planes`) against the JAX `TpuSketchExporter`, on the CPU.

- The same evictions, refreshes and rolls through the JAX exporter (on one
  CPU device, as tests/test_torch_window.py builds it) and the port's, on
  the resident feed (2 lanes, ladder (1, 2)): every published snapshot's
  report field by field (floats to 1e-5 relative, as
  tests/test_torch_state.py holds rendered reports; the RTT and DNS
  quantiles to one histogram bucket, the C5 rule), its `cm_bytes` and
  `cm_pkts` bit for bit (integer-valued masses, per-cell sums below
  2^24), its `window`, `seq` and `mid_window`, and the `/query/*` answers
  to the same requests apart from publish times and ages.
- A refresh leaves the live state's `state_tables` bit-identical, wide and
  tiered, and reuses one staging state.
- A `sketch.query_snapshot` fault loses no report, and a failed refresh is
  counted and retried.
- `serve` answers `/query/*`, the probes and `/metrics` over a socket, and
  without a registry still answers `/query/*` and `/healthz`; the debug
  server's `/debug/torch` reports a CPU exporter without initialising
  CUDA.

Refreshes are driven by calling the refresh directly; no test waits on a
window timer. Every exporter is closed and every server shut down."""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from netobserv_tpu.alerts import engine as jengine
from netobserv_tpu.alerts import rules as jrules
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu_torch.alerts import engine as tengine
from netobserv_tpu_torch.alerts import rules as trules
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.ops import quantile as tq
from netobserv_tpu_torch.server import debug as tdebug
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.utils import faultinject
from tests.test_torch_staging import B, GEOM, _feed
from tests.test_torch_window import _jax_exporter, _port_exporter

#: the report's quantile fields, and /query/status's copies of them
QUANTILES = ("RttQuantilesUs", "DnsLatencyQuantilesUs", "rtt_quantiles_us",
             "dns_latency_quantiles_us")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()


def _assert_report(got: dict, want: dict, gamma: float, path="report"):
    """Field by field: floats to 1e-5 relative, the quantiles to one
    histogram bucket (a factor gamma), publish times left out. Serves the
    reports and the route answers alike."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            if k == "TimestampMs":
                continue
            if k in QUANTILES:
                for q, w in want[k].items():
                    g = got[k][q]
                    assert g == w or (g > 0 and w > 0 and abs(
                        math.log(g / w)) <= math.log(gamma) * (1 + 1e-6)), \
                        (path, k, q, g, w)
                continue
            _assert_report(got[k], want[k], gamma, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_report(g, w, gamma, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-5, abs_tol=1e-9), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def _timeless(x):
    """An answer without its publish times and ages."""
    if isinstance(x, dict):
        return {k: _timeless(v) for k, v in x.items()
                if k not in ("ts_ms", "since_ts_ms", "snapshot_age_s",
                             "TimestampMs")}
    if isinstance(x, list):
        return [_timeless(v) for v in x]
    return x


def _requests(snap) -> list[tuple[str, dict]]:
    top = snap["report"]["HeavyHitters"][0]
    key = {"src": top["SrcAddr"], "dst": top["DstAddr"],
           "src_port": str(top["SrcPort"]), "dst_port": str(top["DstPort"]),
           "proto": str(top["Proto"])}
    return [("/query/topk", {"n": "10"}), ("/query/churn", {}),
            ("/query/cardinality", {}), ("/query/victims", {}),
            ("/query/frequency", key),
            ("/query/frequency", {"src": "10.9.9.9", "dst": "10.8.8.8"}),
            ("/query/status", {}), ("/query/alerts", {}),
            ("/query/alerts", {"window": "0"}),
            ("/query/topk", {"window": "0"}),
            ("/query/cardinality", {"window": "1"}),
            ("/query/range", {}), ("/query/topk", {"n": "x"})]


def _engines():
    spec = "default,cardinality_surge:100,topk_share:0.01"
    return (tengine.AlertEngine(trules.parse_rules(spec), history=2),
            jengine.AlertEngine(jrules.parse_rules(spec), history=2))


def test_snapshots_and_answers_match_the_reference():
    rng = np.random.default_rng(1203)
    sizes = [300, 2 * B + 50, 700, 3 * B, B, 450, 2 * B + 5, 300, 4 * B, 90]
    feed = [_feed(rng, n, n_distinct=2000) for n in sizes]
    teng, jeng = _engines()
    jexp, _ = _jax_exporter(agent_id="a1", query_history=2, alerts=jeng)
    exp, tm = _port_exporter(agent_id="a1", query_history=2, alerts=teng,
                             window_s=3600.0)
    gamma = tq.gamma_for(GEOM["hist_buckets"])
    schedule = [0, 1, "refresh", 2, "refresh", "refresh", 3, "roll", 4,
                "refresh", 5, 6, "roll", "refresh", 7, "roll", 8, 9,
                "refresh", "roll"]
    published = []
    try:
        assert exp.query_routes.handle("/query/topk", {}) == \
            jexp.query_routes.handle("/query/topk", {})
        for op in schedule:
            if op == "refresh":
                exp._refresh_query_snapshot()
                jexp._refresh_query_snapshot()
            elif op == "roll":
                exp.roll()
                jexp.flush()
            else:
                ev, f = feed[op]
                exp.export_evicted(EvictedFlows(ev, **f))
                jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
                continue
            got, want = exp.query.get(), jexp.query.get()
            for k in ("window", "seq", "mid_window"):
                assert got[k] == want[k], (op, k)
            _assert_report(got["report"], want["report"], gamma)
            for k in ("cm_bytes", "cm_pkts"):
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for path, params in _requests(got):
                tc, tb = exp.query_routes.handle(path, dict(params))
                jc, jb = jexp.query_routes.handle(path, dict(params))
                assert tc == jc, (op, path, params)
                _assert_report(_timeless(tb), _timeless(jb), gamma,
                               f"{op} {path} {params}")
            published.append((got["window"], got["mid_window"]))
        assert exp.query.windows() == jexp.query.windows() == [2, 3]
    finally:
        exp.close()
        jexp.close()
    assert published.count((0, True)) == 3 and (3, False) in published
    assert teng.view()["transition_seq"] > 0
    _assert_report(_timeless(teng.view()), _timeless(jeng.view()), gamma,
                   "alerts")


def _fed_exporter(cfg_kw=None, **kw):
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM, **(cfg_kw or {})),
                              batch_size=B, device="cpu", pack_threads=2,
                              superbatch=(1, 2), resident_slots=1 << 12,
                              sink=lambda obj: None, **kw)
    return exp


@pytest.mark.parametrize("cfg_kw", [{}, {"tiered": tiered.TierSpec()}],
                         ids=["wide", "tiered"])
def test_refresh_leaves_the_live_tables_bit_identical(cfg_kw):
    rng = np.random.default_rng(1204)
    exp = _fed_exporter(cfg_kw)
    fed = 0
    try:
        for n in (700, 2 * B + 3):
            ev, f = _feed(rng, n)
            exp.export_evicted(EvictedFlows(ev, **f))
            fed += n
        exp._refresh_query_snapshot()
        staging = exp._staging
        ptrs = [t.data_ptr() for t in _tensors(staging)]
        for n in (300, B + 1, 0):
            with exp._lock:
                exp._drain_pending()  # what the refresh folds first
            before = exp.state_tables()
            planes = ts.host_cm_planes(exp.state)
            exp._refresh_query_snapshot()
            after = exp.state_tables()
            for k in before:
                np.testing.assert_array_equal(after[k], before[k],
                                              err_msg=k)
            snap = exp.query.get()
            assert snap["mid_window"] and snap["window"] == 0
            assert snap["report"]["Records"] == float(fed)
            for k in ("cm_bytes", "cm_pkts"):
                np.testing.assert_array_equal(snap[k], planes[k])
            assert exp._staging is staging
            assert [t.data_ptr() for t in _tensors(staging)] == ptrs
            if n:
                ev, f = _feed(rng, n)
                exp.export_evicted(EvictedFlows(ev, **f))
                fed += n
        report = exp.roll()
        assert report["Records"] == float(fed)
        assert exp.query.get()["mid_window"] is False
        assert exp.query.stats()["mid_window_refreshes"] == 4
    finally:
        exp.close()
    assert exp._staging is None


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def test_a_refresh_publishes_the_queued_window_first():
    """An eviction that closes a due window queues its report for the
    window thread; a refresh that runs before that thread's next publish
    publishes the queued window first, so snapshots go out in window
    order."""
    rng = np.random.default_rng(1207)
    exp = _fed_exporter()
    seen = []
    publish = exp.query.publish

    def record(snap, mid_window=False):
        seen.append((snap["window"], mid_window))
        return publish(snap, mid_window)
    exp.query.publish = record
    try:
        ev, f = _feed(rng, 500)
        exp.export_evicted(EvictedFlows(ev, **f))
        with exp._lock:
            exp._close_window_locked()  # queued, as a due eviction leaves it
        ev, f = _feed(rng, 300)
        exp.export_evicted(EvictedFlows(ev, **f))
        exp._refresh_query_snapshot()
        assert seen == [(0, False), (1, True)]
        assert exp.query.get()["report"]["Records"] == 300.0
        assert exp.query.get_window(0)["report"]["Records"] == 500.0
    finally:
        exp.close()
    assert seen[-1] == (1, False)


def test_copy_state_refuses_another_form():
    cfg = ts.SketchConfig(**GEOM)
    wide = ts.init_state(cfg, device="cpu")
    tier = ts.init_state(cfg._replace(tiered=tiered.TierSpec()), device="cpu")
    with pytest.raises(ValueError):
        ts.copy_state_(tier, wide)
    other = ts.init_state(cfg._replace(
        tiered=tiered.TierSpec(bytes_unit=128)), device="cpu")
    with pytest.raises(ValueError):
        ts.copy_state_(other, tier)


@pytest.mark.parametrize("closing", ["roll", "close"])
def test_query_snapshot_fault_loses_no_report(closing):
    """The fault point fires in the publish's own containment: the report
    reaches the sink, the failure is counted, and the next roll publishes
    (tests/test_query_plane.py holds the reference to the same)."""
    rng = np.random.default_rng(1205)
    reports = []
    exp, m = _port_exporter(sink=reports.append)
    try:
        ev, f = _feed(rng, 400)
        exp.export_evicted(EvictedFlows(ev, **f))
        faultinject.arm("sketch.query_snapshot", "crash", times=1)
        if closing == "close":
            exp.close()
            assert exp.query.get() is None
        else:
            exp.roll()
            assert exp.query.get() is None
            exp.roll()
            assert exp.query.get()["window"] == 1
    finally:
        exp.close()
    assert [r["Records"] for r in reports][:1] == [400.0]
    assert exp.reports_published == len(reports) == exp.rolls
    assert faultinject.hits["sketch.query_snapshot"] == 1
    errs = m.errors_total.labels("tpu-sketch-query", "error")._value.get()
    assert errs == 1


def test_failed_refresh_is_counted_and_retried_at_the_next_tick():
    m = Metrics()
    exp = _fed_exporter(metrics=m, query_refresh_s=30.0)
    try:
        assert exp.query_status()["refresh_s"] == 30.0
        exp._maybe_refresh_query()  # not due yet
        assert exp.query.get() is None
        faultinject.arm("sketch.query_snapshot", "crash", times=1)
        exp._next_refresh = 0.0
        exp._maybe_refresh_query()
        assert exp.query.get() is None
        assert m.errors_total.labels("tpu-sketch-query",
                                     "error")._value.get() == 1
        assert exp._next_refresh > 0.0
        exp._next_refresh = 0.0
        exp._maybe_refresh_query()
        assert exp.query.get()["mid_window"] is True
    finally:
        exp.close()
    assert exp.rolls == 1 and exp.query.get()["mid_window"] is False
    with pytest.raises(ValueError):
        _fed_exporter(query_refresh_s=-1.0)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.mark.parametrize("registry", [True, False])
def test_serve_answers_queries_probes_and_metrics(registry):
    rng = np.random.default_rng(1206)
    m = Metrics() if registry else None
    exp = _fed_exporter(metrics=m)
    srv = exp.serve(health_source=lambda: {"status": "Started",
                                           "degraded": False,
                                           "stages": {}})
    port = srv.server_address[1]
    try:
        assert _get(port, "/query/cardinality")[0] == 503
        ev, f = _feed(rng, 600)
        exp.export_evicted(EvictedFlows(ev, **f))
        exp.roll()
        code, body = _get(port, "/query/cardinality")
        assert code == 200 and json.loads(body)["records"] == 600.0
        code, body = _get(port, "/query/status")
        st = json.loads(body)
        assert code == 200 and st["seq"] == 1 and st["window"] == 0
        assert st["overloaded"] is False and "alerts" not in st
        assert _get(port, "/query/alerts")[0] == 404
        assert _get(port, "/healthz")[0] == _get(port, "/readyz")[0] == 200
        code, body = _get(port, "/metrics")
        if registry:
            text = body.decode()
            assert code == 200
            assert "ebpf_agent_query_snapshot_age_seconds" in text
            assert ('ebpf_agent_query_requests_total{result="ok",'
                    'route="cardinality"} 1.0') in text
        else:
            assert code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        exp.close()


def test_debug_torch_reports_a_cpu_exporter_without_initialising_cuda():
    exp = _fed_exporter()
    srv = tdebug.start_debug_server("127.0.0.1:0")
    try:
        code, body = _get(srv.server_address[1], "/debug/torch")
        out = json.loads(body)
        assert code == 200 and out["torch"] == torch.__version__
        assert out["cuda_available"] is torch.cuda.is_available()
        if not torch.cuda.is_available():
            assert out["cuda_available"] is False
            assert out["cuda_initialized"] is False and "devices" not in out
        assert not torch.cuda.is_initialized() or torch.cuda.is_available()
        assert isinstance(out["retrace_watchdog"], list)
        code, body = _get(srv.server_address[1], "/debug/executables")
        assert code == 200 and "executables" in json.loads(body)
    finally:
        srv.shutdown()
        srv.server_close()
        exp.close()
