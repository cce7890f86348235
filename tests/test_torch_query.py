"""The port's query plane (netobserv_tpu_torch/ops/hashing.py
`base_hashes_multi_np`, query/core.py, query/snapshot.py, query/routes.py,
metrics/server.py, server/debug.py) against the JAX package's, on the CPU.

- `base_hashes_multi_np` equals the reference's on its golden words and on
  1,000 seeded keys, bit for bit, and the port's torch sweep.
- Every `*_payload` gives the reference's dict, floats equal, on the same
  snapshot dicts: three windows of seeded traffic folded by the port's
  sketch at depth 4 and width 2^10, rendered under low thresholds so every
  signal has suspects and the churn lists fill, with the pre-roll CM
  planes.
- One publish schedule through both `SnapshotPublisher`s, and one request
  list through both `QueryRoutes`: the same sequence numbers, rings,
  `(status, body)` for every route and error path, and
  `query_requests_total` labels.
- The metrics server over a real socket on an ephemeral port answers
  `/query/*`, `/healthz`, `/readyz` and `/metrics` as the reference
  server does, and without a registry still answers `/query/*` and the
  health probes. The debug server answers every route.

Every server is shut down and closed; every wait is a socket read of at
most 5 s."""

import json
import threading
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from netobserv_tpu.alerts import engine as jengine
from netobserv_tpu.alerts import rules as jrules
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.metrics import server as jserver
from netobserv_tpu.ops import hashing as jhash
from netobserv_tpu.query import core as jcore
from netobserv_tpu.query import routes as jroutes
from netobserv_tpu.query import snapshot as jsnap
from netobserv_tpu_torch.alerts import engine as tengine
from netobserv_tpu_torch.alerts import rules as trules
from netobserv_tpu_torch.exporter.report import (
    heavy_identity_index, report_numpy, report_to_json,
)
from netobserv_tpu_torch.metrics import server as tserver
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.model.columnar import unpack_key_words
from netobserv_tpu_torch.model.flow import ip_from_16
from netobserv_tpu_torch.ops import hashing as thash
from netobserv_tpu_torch.query import core as tcore
from netobserv_tpu_torch.query import routes as troutes
from netobserv_tpu_torch.query import snapshot as tsnap
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.server import debug as tdebug
from netobserv_tpu_torch.sketch import state as ts

#: depth 4, width 2^10, as the issue of this plane names them
CFG = ts.SketchConfig(cm_depth=4, cm_width=1 << 10, hll_precision=8,
                      perdst_buckets=64, perdst_precision=4,
                      persrc_buckets=64, persrc_precision=4, topk=64,
                      hist_buckets=128, ewma_buckets=64)
#: thresholds low enough that every signal names suspects
LOW = dict(scan_fanout_threshold=2, ddos_z_threshold=0.5, synflood_min=1,
           synflood_ratio=1.0, drop_z_threshold=0.5, asym_min_bytes=1,
           asym_ratio=0.5, churn_ascent=1.01, churn_min_bytes=1)


def _pool():
    """Seeded traffic of v4 and v6 keys whose word 9 holds the protocol
    alone (no ICMP type or code), as a 5-tuple query names a key."""
    universe, pool = traffic.make_pool(np.random.default_rng(1201),
                                       batch=600, n_batches=6,
                                       n_distinct=400, v4=True,
                                       v6_share=0.3)
    universe[:, 9] &= np.uint32(0x00FF0000)
    for arrays, _ in pool:
        arrays["keys"][:, 9] &= np.uint32(0x00FF0000)
    return universe, pool


def _snapshots() -> list[dict]:
    """Three windows' snapshot dicts (window, ts_ms, seq, report and the
    pre-roll CM planes) of seeded traffic through the port's sketch."""
    _, pool = _pool()
    batches = traffic.device_pool(pool, "cpu")
    state = ts.init_state(CFG, device="cpu")
    snaps, prev = [], None
    for w in range(3):
        for b in batches[2 * w:2 * w + 2]:
            ts.ingest(state, b)
        planes = ts.host_cm_planes(state)
        _, report = ts.roll_window(state, CFG)
        report = report_numpy(report)
        obj = report_to_json(report, prev_heavy_index=prev, **LOW)
        prev = heavy_identity_index(report)
        obj["TimestampMs"] = 1_000 * (w + 1)
        snaps.append({"window": obj["Window"], "ts_ms": obj["TimestampMs"],
                      "seq": w + 1, "report": obj, **planes})
    return snaps


SNAPS = _snapshots()


def test_snapshots_exercise_every_payload():
    last = SNAPS[-1]["report"]
    for key in trules.SIGNAL_FIELDS.values():
        assert any(s["report"][key] for s in SNAPS), key
    assert last["HeavyHitters"] and last["FlowAscents"] is not None
    assert any(s["report"]["EvictedKeys"] or s["report"]["NewHeavyKeys"]
               for s in SNAPS)
    assert SNAPS[-1]["cm_bytes"].shape == (4, 1 << 10)


# ------------------------------------------------------------ hashing twin

_GOLDEN_WORDS = (np.arange(30, dtype=np.uint32).reshape(3, 10)
                 * np.uint32(0x9E3779B1) + np.uint32(12345))


def test_base_hashes_multi_np_golden_words():
    got = thash.base_hashes_multi_np(_GOLDEN_WORDS)
    want = jhash.base_hashes_multi_np(_GOLDEN_WORDS)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.uint32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the golden vectors of tests/test_hashing_multi.py
    assert tuple(int(x) for x in got["h1"]) == (0xb57d0400, 0x18c25346,
                                               0x29e8c841)
    assert tuple(int(x) for x in got["src_sym"]) == (0x3c8f4557, 0xd0c6ebda,
                                                    0x6e49046b)


def test_base_hashes_multi_np_seeded_keys_and_torch_sweep():
    words = np.random.default_rng(7).integers(0, 1 << 32, (1000, 10),
                                               dtype=np.uint64
                                               ).astype(np.uint32)
    got = thash.base_hashes_multi_np(words)
    want = jhash.base_hashes_multi_np(words)
    sweep = thash.base_hashes_multi(torch.from_numpy(words.astype(np.int64)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(
            got[k], getattr(sweep, k).numpy().astype(np.uint32), err_msg=k)
    with pytest.raises(ValueError):
        thash.base_hashes_multi_np(words[:, :9])


# ----------------------------------------------------------------- payloads


@pytest.mark.parametrize("w", range(3))
@pytest.mark.parametrize("name,kw", [
    ("topk_payload", {}), ("topk_payload", {"n": 5}),
    ("topk_payload", {"n": 0}), ("topk_payload", {"n": 5000}),
    ("churn_payload", {}), ("cardinality_payload", {}),
    ("victims_payload", {})])
def test_payloads_equal_the_reference(name, kw, w):
    snap = SNAPS[w]
    assert getattr(tcore, name)(snap, **kw) == getattr(jcore, name)(snap,
                                                                    **kw)


def test_error_bars_and_planeless_snapshots():
    snap = SNAPS[1]
    assert tcore.cm_error_bars(snap) == jcore.cm_error_bars(snap)
    bare = {k: v for k, v in snap.items() if k not in ("cm_bytes",
                                                        "cm_pkts")}
    assert tcore.cm_error_bars(bare) is None
    assert tcore.topk_payload(bare) == jcore.topk_payload(bare)
    assert "overestimate_bound_bytes" not in tcore.topk_payload(bare)
    assert tcore.frequency_payload(bare, "10.0.0.1", "10.0.0.2") is None
    assert jcore.frequency_payload(bare, "10.0.0.1", "10.0.0.2") is None


def _heavy_keys(snap) -> list[tuple]:
    """(src, dst, sport, dport, proto) of every heavy hitter: keys in the
    planes."""
    return [(h["SrcAddr"], h["DstAddr"], h["SrcPort"], h["DstPort"],
             h["Proto"]) for h in snap["report"]["HeavyHitters"]]


def _absent_keys() -> list[tuple]:
    return [("10.99.0.1", "10.99.0.2", 1, 2, 6),
            ("192.0.2.7", "198.51.100.9", 0, 0, 0),
            ("2001:db8::1", "2001:db8::2", 443, 51000, 17),
            ("fe80::1", "10.1.2.3", 53, 53, 17)]


@pytest.mark.parametrize("w", range(3))
def test_frequency_payload_equals_the_reference(w):
    snap = SNAPS[w]
    keys = _heavy_keys(snap)
    assert any(":" in k[0] for k in keys) and any("." in k[0] for k in keys)
    for key in keys[:40] + _absent_keys():
        got = tcore.frequency_payload(snap, *key)
        assert got == jcore.frequency_payload(snap, *key), key
    # a heavy key's estimate is its slot's CM estimate: at least its bytes
    top = snap["report"]["HeavyHitters"][0]
    est = tcore.frequency_payload(snap, *keys[0])["est_bytes"]
    assert est >= top["EstBytes"] * (1 - 1e-6)


def test_universe_keys_of_the_planes_match_the_reference():
    """Every key of the traffic universe, rendered as the report renders a
    key, queried against the last window's planes."""
    universe, _ = _pool()
    karr = unpack_key_words(universe)
    snap = SNAPS[-1]
    for k in karr[:200]:
        key = (ip_from_16(k["src_ip"].tobytes()),
               ip_from_16(k["dst_ip"].tobytes()), int(k["src_port"]),
               int(k["dst_port"]), int(k["proto"]))
        assert tcore.frequency_payload(snap, *key) == \
            jcore.frequency_payload(snap, *key), key


# ----------------------------------------------------- publisher and routes


def _schedule(pub):
    """One publish schedule: refreshes and rolls over five windows, a
    re-publish of a rolled window included. Returns what a reader sees
    after each step."""
    seen = []
    steps = [(0, True), (0, True), (0, False), (1, True), (1, False),
             (2, False), (2, False), (3, True), (3, True), (3, False),
             (4, False)]
    for i, (w, mid) in enumerate(steps):
        seq = pub.publish({"window": w, "ts_ms": 10 * i, "report": {}},
                          mid_window=mid)
        st = pub.stats()
        del st["snapshot_age_s"]
        seen.append((seq, pub.get(), pub.windows(),
                     [pub.get_window(x) for x in range(6)], st))
    return seen


@pytest.mark.parametrize("history", [0, 1, 3, 8])
def test_publishers_run_one_schedule_alike(history):
    got = _schedule(tsnap.SnapshotPublisher(history=history))
    want = _schedule(jsnap.SnapshotPublisher(history=history))
    assert got == want
    assert got[-1][0] == 11


def test_publisher_age_resets_at_publish():
    pub = tsnap.SnapshotPublisher()
    assert pub.get() is None and pub.stats()["published"] is False
    assert pub.age_s() >= 0.0
    pub.publish({"window": 0, "ts_ms": 0, "report": {}})
    assert pub.age_s() < 1.0


def _engine(mod, rules_mod):
    eng = mod.AlertEngine(rules_mod.default_rules(), history=2)
    for snap in SNAPS:
        eng.evaluate(snap)
    return eng


class _Plane:
    """Each package's routes over the same snapshots: a publisher with a
    ring of 2 fed the three windows, two tenant publishers, an alert
    engine, and the package's metrics."""

    def __init__(self, snap_mod, routes_mod, metrics, engine):
        self.pub = snap_mod.SnapshotPublisher(history=2)
        for s in SNAPS:
            self.pub.publish({k: v for k, v in s.items() if k != "seq"})
        self.tenants = [snap_mod.SnapshotPublisher(history=2)
                        for _ in range(2)]
        self.tenants[1].publish({k: v for k, v in SNAPS[0].items()
                                 if k != "seq"})
        self.metrics = metrics
        status = {"published": True, "agent_id": "a1"}
        kw = dict(metrics=metrics, history_fn=self.pub.get_window,
                  windows_fn=self.pub.windows)
        self.routes = routes_mod.QueryRoutes(self.pub.get, lambda: status,
                                             alerts=engine, **kw)
        self.empty = routes_mod.QueryRoutes(lambda: None, lambda: status,
                                            metrics=metrics)
        self.tenanted = routes_mod.QueryRoutes(
            self.pub.get, lambda: status, metrics=metrics,
            tenant_publishers=self.tenants)

        def boom():
            raise RuntimeError("snapshot source broke")
        self.broken = routes_mod.QueryRoutes(boom, boom, metrics=metrics)


def _planes():
    return (_Plane(tsnap, troutes, Metrics(),
                   _engine(tengine, trules)),
            _Plane(jsnap, jroutes, jreg.Metrics(jreg.MetricsSettings()),
                   _engine(jengine, jrules)))


TOP = _heavy_keys(SNAPS[-1])[0]
REQUESTS = [
    ("routes", "/query", {}), ("routes", "/query/", {}),
    ("routes", "/query/topk", {}), ("routes", "/query/topk", {"n": "3"}),
    ("routes", "/query/topk", {"n": "bogus"}),
    ("routes", "/query/churn", {}), ("routes", "/query/cardinality", {}),
    ("routes", "/query/victims", {}), ("routes", "/query/status", {}),
    ("routes", "/query/frequency", {"src": TOP[0], "dst": TOP[1],
                                    "src_port": str(TOP[2]),
                                    "dst_port": str(TOP[3]),
                                    "proto": str(TOP[4])}),
    ("routes", "/query/frequency", {"src": "10.0.0.1"}),
    ("routes", "/query/frequency", {"src": "not-an-ip", "dst": "10.0.0.1"}),
    ("routes", "/query/frequency", {"src": "10.0.0.1", "dst": "10.0.0.2",
                                    "proto": "x"}),
    ("routes", "/query/topk", {"window": "2"}),
    ("routes", "/query/cardinality", {"window": "1"}),
    ("routes", "/query/topk", {"window": "0"}),
    ("routes", "/query/victims", {"window": "zz"}),
    ("routes", "/query/alerts", {}), ("routes", "/query/alerts",
                                      {"window": "2"}),
    ("routes", "/query/alerts", {"window": "0"}),
    ("routes", "/query/range", {}), ("routes", "/query/range/topk", {}),
    ("routes", "/query/nope", {}),
    ("empty", "/query/topk", {}), ("empty", "/query/alerts", {}),
    ("empty", "/query/topk", {"window": "1"}),
    ("tenanted", "/query/topk", {}),
    ("tenanted", "/query/topk", {"tenant": "5"}),
    ("tenanted", "/query/topk", {"tenant": "x"}),
    ("tenanted", "/query/topk", {"tenant": "0"}),
    ("tenanted", "/query/cardinality", {"tenant": "1"}),
    ("tenanted", "/query/churn", {"tenant": "1", "window": "0"}),
    ("tenanted", "/query/status", {}),
    ("broken", "/query/topk", {}), ("broken", "/query/status", {}),
]


def test_routes_answer_every_request_as_the_reference():
    tp, jp = _planes()
    codes = set()
    for which, path, params in REQUESTS:
        got = getattr(tp, which).handle(path, dict(params))
        want = getattr(jp, which).handle(path, dict(params))
        assert got == want, (which, path, params)
        codes.add(got[0])
    assert codes == {200, 400, 404, 500, 503}

    def samples(m):
        return sorted((s.labels["route"], s.labels["result"], s.value)
                      for metric in m.query_requests_total.collect()
                      for s in metric.samples if s.name.endswith("_total"))
    assert samples(tp.metrics) == samples(jp.metrics)
    assert {r for r, _, _ in samples(tp.metrics)} >= {
        "topk", "frequency", "alerts", "range", "status", "query", "nope"}


# ------------------------------------------------------------ HTTP servers


def _get(srv, path):
    port = srv.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), \
                resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type", ""), err.read()


@pytest.fixture
def servers():
    made = []

    def start(fn, *args, **kw):
        srv = fn(*args, **kw)
        made.append(srv)
        return srv

    yield start
    for srv in made:
        srv.shutdown()
        srv.server_close()


def _health(status, degraded):
    return lambda: {"status": status, "degraded": degraded,
                    "stages": {"sketch-window": {"state": "running"}}}


@pytest.fixture(scope="module")
def health_servers():
    """The port's server with and without a registry and the reference's,
    each probing `health["now"]`."""
    health = {"now": _health("Unknown", False)}

    def src():
        return health["now"]()
    made = [tserver.start_metrics_server(Metrics().registry, "127.0.0.1", 0,
                                         health_source=src),
            tserver.start_metrics_server(None, "127.0.0.1", 0,
                                         health_source=src),
            jserver.start_metrics_server(
                jreg.Metrics(jreg.MetricsSettings()).registry, "127.0.0.1",
                0, health_source=src)]
    yield health, made
    for srv in made:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("status,degraded", [
    ("NotStarted", False), ("Starting", False), ("Started", False),
    ("Started", True), ("Degraded", True), ("Stopping", False),
    ("Stopped", False), ("Unknown", False), ("broken", False)])
def test_health_probes_answer_as_the_reference_server(health_servers, status,
                                                      degraded):
    health, (tsrv, bare, jsrv) = health_servers
    if status == "broken":
        def boom():
            raise RuntimeError("probe failed")
        health["now"] = boom
    else:
        health["now"] = _health(status, degraded)
    for path in ("/healthz", "/readyz"):
        want = _get(jsrv, path)
        assert want[0] in (200, 503)
        assert _get(tsrv, path) == want
        assert _get(bare, path) == want


def test_query_routes_and_metrics_over_a_socket(servers):
    tp, jp = _planes()
    tm = tp.metrics
    tsrv = servers(tserver.start_metrics_server, tm.registry, "127.0.0.1",
                   0, query_routes=tp.routes)
    jsrv = servers(jserver.start_metrics_server, jp.metrics.registry,
                   "127.0.0.1", 0, query_routes=jp.routes)
    for path in ("/query/topk?n=4", "/query/cardinality", "/query/victims",
                 "/query/churn", "/query/alerts", "/query/status",
                 "/query/topk?window=0", "/query/topk?n=x", "/query/range",
                 "/query/nope", f"/query/frequency?src={TOP[0]}&dst={TOP[1]}"
                 f"&src_port={TOP[2]}&dst_port={TOP[3]}&proto={TOP[4]}"):
        code, ctype, body = _get(tsrv, path)
        want = _get(jsrv, path)
        assert (code, ctype) == want[:2], path
        assert json.loads(body) == json.loads(want[2]), path
    for path in ("/healthz", "/readyz", "/nope", "/metricsx"):
        assert _get(tsrv, path)[0] == _get(jsrv, path)[0] == 404, path
    code, ctype, body = _get(tsrv, "/metrics")
    assert code == 200 and ctype == _get(jsrv, "/metrics")[1]
    text = body.decode()
    for result in ("ok", "bad_request", "not_found"):
        assert ('ebpf_agent_query_requests_total{result="%s",route="topk"} '
                '1.0' % result) in text
    assert "ebpf_agent_alert_eval_seconds_bucket" in text
    assert _get(tsrv, "/")[0] == 200


def test_no_registry_still_answers_queries_and_health(servers):
    tp, _ = _planes()
    srv = servers(tserver.start_metrics_server, None, "127.0.0.1", 0,
                  health_source=_health("Started", False),
                  query_routes=tp.routes)
    code, ctype, body = _get(srv, "/query/cardinality")
    assert code == 200 and ctype == "application/json"
    assert json.loads(body) == tcore.cardinality_payload(
        {**SNAPS[-1], "seq": 3})
    assert _get(srv, "/healthz")[0] == _get(srv, "/readyz")[0] == 200
    assert _get(srv, "/metrics")[0] == _get(srv, "/")[0] == 404
    bare = servers(tserver.start_metrics_server, None, "127.0.0.1", 0)
    assert _get(bare, "/query/topk")[0] == 404


@pytest.fixture
def _tracemalloc_off():
    """/debug/tracemalloc starts tracemalloc; stop it after the test."""
    was = tracemalloc.is_tracing()
    yield
    if not was:
        tracemalloc.stop()


def test_debug_server_answers_every_route(servers, _tracemalloc_off):
    srv = servers(tdebug.start_debug_server, "127.0.0.1:0")
    code, _, body = _get(srv, "/debug")
    assert code == 200
    routes = [line.split()[0] for line in body.decode().splitlines()]
    assert routes == sorted(tdebug._ROUTES) and "/debug/torch" in routes
    assert "/debug/executables" in routes
    for route in routes:
        code, ctype, body = _get(srv, route)
        assert code == 200, route
        if ctype == "application/json":
            json.loads(body)
    assert _get(srv, "/debug/traces?limit=x&trace=t")[0] == 200
    assert _get(srv, "/debug/nope")[0] == 404
    ex = json.loads(_get(srv, "/debug/executables")[2])
    assert set(ex) == {"executables", "retraces_total"}
    names = {t.name for t in threading.enumerate()}
    assert "debug-http" in names
