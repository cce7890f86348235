"""The port's alerting plane (netobserv_tpu_torch/alerts/: rules.py,
engine.py, sinks.py; config.QuerySettings) against the JAX package's
netobserv_tpu/alerts/, on the CPU.

- `parse_rules` and `default_rules`: the same rules, field for field, and
  the same errors.
- One seeded sequence of snapshots, mid-window refreshes and rolls, with
  every signal, a cardinality surge, a top-K share and per-flow churn
  crossing and recrossing their thresholds, through both `AlertEngine`s
  under `default_rules()` and under a parsed ALERT_RULES string: the same
  transitions in the same order, the same views, `route_payload` for the
  live and past windows, `summary`, `condition`, and the same metric
  values.
- `WebhookSink` posts to a local `http.server` thread: the same JSON
  bodies as the reference's, held to its rate limit on a fake clock (no
  wall-clock wait).
- The `alerts.evaluate` and `alerts.sink` fault points are contained and
  counted alike.

Every thread started is joined."""

import dataclasses
import json
import threading
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu.alerts import engine as jengine
from netobserv_tpu.alerts import rules as jrules
from netobserv_tpu.alerts import sinks as jsinks
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu_torch.alerts import engine as tengine
from netobserv_tpu_torch.alerts import rules as trules
from netobserv_tpu_torch.alerts import sinks as tsinks
from netobserv_tpu_torch.config import QuerySettings
from netobserv_tpu_torch.exporter import report as treport
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.utils import faultinject

# the JAX package's modules, and the port's, side by side
PKGS = {"port": (tengine, trules, tsinks, Metrics, faultinject),
        "jax": (jengine, jrules, jsinks,
                lambda: jreg.Metrics(jreg.MetricsSettings()), jfault)}


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()


def test_one_signal_map():
    """`SIGNAL_FIELDS` lives in the alerting plane and the report renderer
    reads that one map."""
    assert trules.SIGNAL_FIELDS == jrules.SIGNAL_FIELDS
    assert treport.SIGNAL_FIELDS is trules.SIGNAL_FIELDS


SPECS = ["default", "syn_flood,port_scan", "ddos", "drop_storm,asym_conv",
         "default,cardinality_surge:1000,topk_share:0.5",
         "flow_ascent:12,new_heavy_key", "flow_ascent", "ddos,ddos",
         "default,syn_flood"]
BAD = ["nope", "cardinality_surge", "topk_share", "", " , ", "syn_flood:500",
       "default:3", "topk_share:50%", "cardinality_surge:50k",
       "flow_ascent:0.5", "flow_ascent:big", "new_heavy_key:3"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("evals", [(2, 2), (3, 4), (1, 1)])
def test_parse_rules_equal_the_reference(spec, evals):
    got = trules.parse_rules(spec, *evals)
    want = jrules.parse_rules(spec, *evals)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]


@pytest.mark.parametrize("spec", BAD)
def test_parse_rules_refuse_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as got:
        trules.parse_rules(spec)
    with pytest.raises(ValueError) as want:
        jrules.parse_rules(spec)
    assert str(got.value) == str(want.value)


def test_default_rules_equal_the_reference():
    for evals in ((2, 2), (5, 3)):
        assert [dataclasses.astuple(r) for r in
                trules.default_rules(*evals)] == \
            [dataclasses.astuple(r) for r in jrules.default_rules(*evals)]


# ------------------------------------------------------- engine sequences


def _report(rng, step: int) -> dict:
    """A rendered report whose signals cross and recross: each signal fires
    in stretches (a seeded on/off pattern per signal), on one to three of
    four buckets, with the cardinality, the top flow's share and the churn
    lists moving across their thresholds."""
    rep = {key: [] for key in trules.SIGNAL_FIELDS.values()}
    for j, (sig, key) in enumerate(trules.SIGNAL_FIELDS.items()):
        if (step // (2 + j)) % 2 == 0 and rng.random() < 0.85:
            buckets = sorted(rng.choice(4, rng.integers(1, 4),
                                        replace=False).tolist())
            rep[key] = [{"bucket": 16 * j + b,
                         trules._VALUE_KEYS[sig]: float(rng.integers(1, 500)),
                         "probable_victims": [f"10.0.{j}.{b}"]}
                        for b in buckets]
    total = float(rng.integers(1_000, 10_000))
    share = 0.7 if step % 5 in (1, 2) else 0.1
    rep["Bytes"] = total
    rep["DistinctSrcEstimate"] = float(rng.choice([200.0, 2_000.0]))
    rep["HeavyHitters"] = [{"SrcAddr": "10.1.0.1", "DstAddr": "10.1.0.2",
                            "EstBytes": share * total}]
    keys = [f"10.2.0.{k}:80>10.3.0.{k}:443/6" for k in range(3)]
    rep["FlowAscents"] = [{"Key": k, "SrcAddr": "10.2.0.1",
                           "DstAddr": "10.3.0.1",
                           "Ratio": float(rng.choice([9.0, 20.0]))}
                          for k in keys[:int(rng.integers(0, 3))]]
    rep["NewHeavyKeys"] = ([{"Key": keys[2], "SrcAddr": "10.2.0.2",
                             "DstAddr": "10.3.0.2", "EstBytes": 5e6}]
                           if step % 4 == 3 else [])
    return rep


def _sequence(n: int = 40):
    """(snapshot, mid_window) pairs: windows of zero to two mid-window
    refreshes, then their roll."""
    rng = np.random.default_rng(1202)
    out, window, seq = [], 0, 0
    step = 0
    while len(out) < n:
        for _ in range(int(rng.integers(0, 3))):
            seq += 1
            out.append(({"window": window, "ts_ms": 1_000 * seq, "seq": seq,
                         "report": _report(rng, step)}, True))
            step += 1
        seq += 1
        out.append(({"window": window, "ts_ms": 1_000 * seq, "seq": seq,
                     "report": _report(rng, step)}, False))
        step += 1
        window += 1
    return out


class _ListSink:
    """A mixin for each package's AlertSink: keeps what it delivered."""

    name = "list"

    def deliver(self, event):
        self.events.append(event)


def _list_sink(sinks_mod):
    cls = type("ListSink", (_ListSink, sinks_mod.AlertSink), {})
    sink = cls(min_interval_s=0.0)
    sink.events = []
    return sink


def _run(pkg: str, rules_fn, max_active: int = 256, ring: int = 256):
    eng_mod, rules_mod, sinks_mod, metrics_cls, _ = PKGS[pkg]
    m = metrics_cls()
    lst = _list_sink(sinks_mod)
    eng = eng_mod.AlertEngine(
        rules_fn(rules_mod), metrics=m,
        sinks=[sinks_mod.LogSink(), sinks_mod.MetricsSink(m), lst],
        history=3, ring=ring, max_active=max_active)
    seen = []
    for snap, mid in _sequence():
        trans = eng.evaluate(snap, mid_window=mid)
        view = eng.view()
        seen.append((trans, view, eng.summary(), eng.condition(),
                     eng.route_payload(), eng.windows()))
    routes = [eng.route_payload(str(w)) for w in range(-1, 40)]
    return eng, m, lst, seen, routes


def _metric_values(m) -> dict:
    out = {}
    for fam in (m.alerts_active, m.alerts_transitions_total,
                m.alert_sink_errors_total, m.errors_total):
        for metric in fam.collect():
            for s in metric.samples:
                if not s.name.endswith("_created"):
                    out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    out["evals"] = sum(s.value for metric in m.alert_eval_seconds.collect()
                       for s in metric.samples if s.name.endswith("_count"))
    return out


RULE_SETS = {
    "default": lambda mod: mod.default_rules(),
    "parsed": lambda mod: mod.parse_rules(
        "default,cardinality_surge:1000,topk_share:0.5,flow_ascent:10",
        raise_evals=2, clear_evals=3),
    "eager": lambda mod: mod.parse_rules("default", raise_evals=1,
                                         clear_evals=1),
}


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("bounds", [(256, 256), (3, 4)])
def test_engines_run_one_sequence_alike(rules, bounds):
    max_active, ring = bounds
    teng, tm, tlist, tseen, troutes = _run("port", RULE_SETS[rules],
                                           max_active, ring)
    jeng, jm, jlist, jseen, jroutes = _run("jax", RULE_SETS[rules],
                                           max_active, ring)
    for i, (got, want) in enumerate(zip(tseen, jseen)):
        assert got == want, i
    assert troutes == jroutes
    assert tlist.events == jlist.events
    assert _metric_values(tm) == _metric_values(jm)
    actions = [t["action"] for trans, *_ in tseen for t in trans]
    assert actions.count("raise") >= 4 and actions.count("clear") >= 2
    assert {c for c, _ in troutes} == {200, 404}
    if max_active < 256:
        assert tseen[-1][1]["dropped_fingerprints"] > 0


def test_broken_rule_is_quiet_but_counted_alike():
    out = []
    for pkg in ("port", "jax"):
        eng_mod, rules_mod, _, metrics_cls, _ = PKGS[pkg]
        m = metrics_cls()
        rules = [rules_mod.AlertRule(name="bad", field="Bytes",
                                     kind="scalar", threshold=1.0),
                 rules_mod.signal_rule("syn_flood", 1, 1)]
        eng = eng_mod.AlertEngine(rules, metrics=m)
        snaps = [s for s, _ in _sequence(8)]
        for s in snaps:
            s = {**s, "report": {**s["report"], "Bytes": "not a number"}}
            eng.evaluate(s)
        out.append((eng.view(), _metric_values(m)))
    assert out[0] == out[1]
    assert out[0][0]["rule_errors"] == {"bad": 8}


# ------------------------------------------------------------------ sinks


class _Clock:
    """A fake monotonic clock for the sinks' rate limit."""

    def __init__(self):
        self.t = 1_000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def webhook():
    """A local HTTP server that records each POST body, answering 500 to
    the requests whose index is in `fail`."""
    got, fail = [], set()

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            body = self.rfile.read(int(self.headers["Content-Length"]))
            n = len(got)
            got.append(json.loads(body))
            if n in fail:
                self.send_error(500)
                return
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/hook", got, fail
    srv.shutdown()
    thr.join(timeout=5)
    srv.server_close()


def _events():
    """Transitions of two fingerprints that flap inside the interval."""
    a = {"rule": "syn_flood", "bucket": 7}
    b = {"rule": "ddos", "bucket": 3}
    return [(0.0, {**a, "action": "raise", "seq": 1}),
            (0.1, {**a, "action": "clear", "seq": 2}),   # held (flap)
            (0.2, {**a, "action": "raise", "seq": 3}),   # dedup
            (0.3, {**b, "action": "raise", "seq": 4}),
            (0.4, {**a, "action": "clear", "seq": 5}),   # held
            (0.5, None),                                 # flush: too early
            (1.6, None),                                 # flush: delivered
            (1.7, {**b, "action": "clear", "seq": 6}),
            (1.8, {**b, "action": "raise", "seq": 7}),   # held clear gone
            (3.0, None)]


@pytest.mark.parametrize("fail", [(), (1,), (0, 1, 2, 3)])
def test_webhook_sink_posts_what_the_reference_posts(webhook, monkeypatch,
                                                     fail):
    url, got, failing = webhook
    results = []
    for pkg in ("port", "jax"):
        sinks_mod = PKGS[pkg][2]
        clock = _Clock()
        monkeypatch.setattr(sinks_mod, "time",
                            types.SimpleNamespace(monotonic=clock.monotonic))
        got.clear()
        failing.clear()
        failing.update(fail)
        sink = sinks_mod.WebhookSink(url, min_interval_s=1.0, retries=1,
                                     timeout_s=5.0)
        m = PKGS[pkg][3]()
        for dt, ev in _events():
            clock.t = 1_000.0 + dt
            if ev is None:
                sink.flush(metrics=m)
            else:
                sink.emit(ev, metrics=m)
        results.append((list(got), sink.stats(), _metric_values(m)))
    assert results[0] == results[1]
    posted, stats, _ = results[0]
    assert stats["rate_limited"] >= 2
    if not fail:
        assert [e["seq"] for e in posted] == [1, 4, 5, 6, 7]


def test_sinks_build_from_settings_as_the_reference_builds_them():
    for cfg in (QuerySettings(alert_rules="default"),
                QuerySettings(alert_rules="default", alert_sinks="log"),
                QuerySettings(alert_rules="ddos",
                              alert_sinks="webhook,log,metrics",
                              alert_webhook_url="http://127.0.0.1:9/x",
                              alert_webhook_interval=2.5)):
        for metrics in (None, "with"):
            tm = Metrics() if metrics else None
            jm = jreg.Metrics(jreg.MetricsSettings()) if metrics else None
            got = [(s.name, s.min_interval_s, s.retries)
                   for s in tsinks.build_sinks(cfg, tm)]
            want = [(s.name, s.min_interval_s, s.retries)
                    for s in jsinks.build_sinks(cfg, jm)]
            assert got == want
            teng = tengine.maybe_engine(cfg, tm)
            jeng = jengine.maybe_engine(cfg, jm)
            assert teng.view() == jeng.view()
    assert tengine.maybe_engine(QuerySettings()) is None
    assert jengine.maybe_engine(QuerySettings()) is None
    for bad in ("nope", " , ", "kafka"):
        with pytest.raises(ValueError) as got:
            tsinks.build_sinks(QuerySettings(alert_sinks=bad))
        with pytest.raises(ValueError) as want:
            jsinks.build_sinks(QuerySettings(alert_sinks=bad))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,match", [
    ({"sketch_query_refresh": -1.0}, "SKETCH_QUERY_REFRESH"),
    ({"sketch_query_history": -1}, "SKETCH_QUERY_HISTORY"),
    ({"alert_raise_evals": 0}, "ALERT_RAISE_EVALS"),
    ({"alert_clear_evals": 0}, "ALERT_CLEAR_EVALS"),
    ({"alert_ring": 0}, "ALERT_RING"),
    ({"alert_webhook_interval": -1.0}, "ALERT_WEBHOOK_INTERVAL"),
    ({"alert_rules": "syn_flood:3"}, "takes no parameter"),
    ({"alert_rules": "default", "alert_sinks": "webhook"},
     "ALERT_WEBHOOK_URL")])
def test_settings_refuse_what_the_reference_config_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        QuerySettings(**kw)


def test_settings_defaults_are_the_reference_defaults():
    from netobserv_tpu.config import AgentConfig
    ref = {f.name: f.default for f in dataclasses.fields(AgentConfig)}
    for f in dataclasses.fields(QuerySettings):
        assert f.default == ref[f.name], f.name


# ------------------------------------------------------------ fault points


def _flood(window=1, seq=1, mid=False):
    rep = {key: [] for key in trules.SIGNAL_FIELDS.values()}
    rep["SynFloodSuspectBuckets"] = [{"bucket": 7, "syn": 200.0,
                                      "probable_victims": ["10.0.0.80"]}]
    return {"window": window, "ts_ms": 1000 * seq, "seq": seq,
            "report": rep}


def test_evaluate_fault_point_is_contained_and_counted_alike():
    out = []
    for pkg in ("port", "jax"):
        eng_mod, rules_mod, _, metrics_cls, fault = PKGS[pkg]
        m = metrics_cls()
        eng = eng_mod.AlertEngine([rules_mod.signal_rule("syn_flood", 1, 1)],
                                  metrics=m)
        fault.arm("alerts.evaluate", "crash", times=2)
        for seq in range(1, 5):
            eng.safe_evaluate(_flood(seq, seq))
        out.append((fault.hits["alerts.evaluate"], eng.view(),
                    _metric_values(m)))
    assert out[0] == out[1]
    hits, view, values = out[0]
    assert hits == 2 and view["evals"] == 2 and len(view["active"]) == 1
    assert values[("ebpf_agent_errors_total",
                   (("component", "alerts"), ("severity", "error")))] == 2


def test_sink_fault_point_is_contained_counted_and_reconciled_alike():
    out = []
    for pkg in ("port", "jax"):
        eng_mod, rules_mod, sinks_mod, metrics_cls, fault = PKGS[pkg]
        m = metrics_cls()
        lst = _list_sink(sinks_mod)
        eng = eng_mod.AlertEngine([rules_mod.signal_rule("syn_flood", 1, 1)],
                                  metrics=m, sinks=[lst])
        fault.arm("alerts.sink", "crash", times=2)  # both tries of one
        trans = eng.evaluate(_flood(1, 1))
        parked = eng.view()["sinks"]["list"]
        eng.evaluate(_flood(2, 2))  # flush delivers the parked raise
        out.append((trans, parked, list(lst.events), eng.view(),
                    fault.hits["alerts.sink"], _metric_values(m)))
    assert out[0] == out[1]
    trans, parked, events, view, hits, values = out[0]
    assert len(trans) == 1 and parked["pending_transitions"] == 1
    assert hits == 2 and [e["action"] for e in events] == ["raise"]
    assert values[("ebpf_agent_alert_sink_errors_total",
                   (("sink", "list"),))] == 1
