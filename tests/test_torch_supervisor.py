"""The port's stage supervisor (netobserv_tpu_torch/agent/supervisor.py)
and the health surface it feeds, against the JAX package's, on the CPU.

- The same crash, hang, failed-restart, healthy-reset and degrade schedule
  through the port's `Supervisor` and the reference's, each check driven
  by hand (`_check_once`): the same stage states, counters, snapshots,
  metric series and `on_degraded` calls after every step; the heartbeat
  and the condition registry the same.
- The monitor loop restarts a crashed stage thread and `stop` marks the
  stages STOPPED, in both packages.
- The exporter's `register_supervised` registers what the reference's
  does: the window and fold stages with the same deadlines, and the
  `overloaded` and `alerting` conditions. The `alerting` condition is a
  repair: without it a port agent's supervisor never showed ALERTING.
- `/healthz` and `/readyz` over the port's metrics server with OVERLOADED
  and DEGRADED (the reference's tests/test_overload.py semantics), with a
  health source written inline as the reference agent's
  `health_snapshot` builds it.
- The port's supervisor drives the exporter's window thread and fold
  thread and the aggregator's window thread through crashes; the six
  metric families and `config.SupervisorSettings` equal the reference's.

Every thread joined, no wait past 15 s."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu import config as jconfig
from netobserv_tpu.agent import supervisor as jsup
from netobserv_tpu.alerts import engine as jengine
from netobserv_tpu.alerts import rules as jrules
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.agent import supervisor as tsup
from netobserv_tpu_torch.alerts import engine as tengine
from netobserv_tpu_torch.alerts import rules as trules
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.metrics.server import start_metrics_server
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject
from tests.test_torch_overload import (
    SMALL, jax_exporter, pin, port_exporter, small_exporter, wait_for,
)
from tests.test_torch_staging import _feed

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

PKGS = {"port": (tsup, Metrics), "jax": (
    jsup, lambda: jreg.Metrics(jreg.MetricsSettings()))}
#: the supervision and overload families, each held against the reference
FAMILIES = ("stage_failures_total", "stage_restarts_total", "stage_degraded",
            "sketch_shed_factor", "sketch_shed_rows_total",
            "sketch_shed_batches_total")


@pytest.fixture(autouse=True)
def _clean():
    yield
    faultinject.clear()
    faultinject.hits.clear()


class FakeThread:
    def __init__(self):
        self.alive = True

    def is_alive(self):
        return self.alive


class FakeStage:
    """A stage whose thread the schedule kills; `restart` revives it, or
    raises while `broken`."""

    def __init__(self):
        self._thread = FakeThread()
        self.restarts = 0
        self.broken = False

    def start(self):
        if self.broken:
            raise RuntimeError("restart failed")
        self.restarts += 1
        self._thread = FakeThread()


def _sample(m, family, labels):
    return m.registry.get_sample_value(f"ebpf_agent_{family}", labels)


def _timeless(snap):
    return {k: {f: v for f, v in s.items() if f != "heartbeat_age_s"}
            for k, s in snap.items()}


def _build(pkg):
    mod, metrics_cls = PKGS[pkg]
    m = metrics_cls()
    degraded = []
    sup = mod.Supervisor(metrics=m, check_period_s=3600,
                         on_degraded=degraded.append)
    stages = {name: FakeStage() for name in ("a", "b", "c")}
    sup.register_stage("a", stages["a"], heartbeat_timeout_s=0.5,
                       max_restarts=2, backoff_initial_s=0.0,
                       backoff_max_s=0.0, healthy_reset_s=1000.0)
    sup.register_stage("b", stages["b"], heartbeat_timeout_s=None,
                       max_restarts=2, backoff_initial_s=0.0,
                       healthy_reset_s=1000.0)
    sup.register_stage("c", stages["c"], heartbeat_timeout_s=None,
                       max_restarts=1, backoff_initial_s=0.0,
                       healthy_reset_s=0.0)
    return sup, stages, m, degraded


def _schedule():
    """(action, stage) steps: kill a thread, age a heartbeat past its
    deadline, break or mend a restart, or run one check."""
    return [("check", None), ("kill", "a"), ("check", None), ("check", None),
            ("age", "a"), ("check", None), ("check", None),
            ("kill", "b"), ("break", "b"), ("check", None), ("check", None),
            ("mend", "b"), ("check", None),
            ("kill", "c"), ("check", None), ("check", None), ("check", None),
            ("kill", "c"), ("check", None), ("check", None),
            ("kill", "a"), ("check", None), ("check", None), ("kill", "a"),
            ("check", None), ("check", None)]


def test_supervisor_schedule_equals_the_reference():
    runs = {pkg: _build(pkg) for pkg in PKGS}
    for i, (action, name) in enumerate(_schedule()):
        for sup, stages, m, _ in runs.values():
            if action == "kill":
                stages[name]._thread.alive = False
            elif action == "age":
                sup._stages[name].last_beat -= 10.0
            elif action in ("break", "mend"):
                stages[name].broken = action == "break"
            else:
                time.sleep(0.002)  # backoff 0: the restart is due
                sup._check_once()
        (tsup_, tst, tm, tdeg), (jsup_, jst, jm, jdeg) = (runs["port"],
                                                          runs["jax"])
        assert _timeless(tsup_.snapshot()) == _timeless(jsup_.snapshot()), i
        assert tsup_.degraded == jsup_.degraded, i
        assert tdeg == jdeg, i
        assert {k: s.restarts for k, s in tst.items()} == \
            {k: s.restarts for k, s in jst.items()}, i
        for name in ("a", "b", "c"):
            for kind in ("crash", "hang"):
                assert _sample(tm, "stage_failures_total",
                               {"stage": name, "kind": kind}) == \
                    _sample(jm, "stage_failures_total",
                            {"stage": name, "kind": kind}), (i, name, kind)
            for fam in ("stage_restarts_total", "stage_degraded"):
                assert _sample(tm, fam, {"stage": name}) == \
                    _sample(jm, fam, {"stage": name}), (i, name, fam)
    sup = runs["port"][0]
    snap = sup.snapshot()
    assert snap["a"]["state"] == "Degraded" and runs["port"][3] == ["a"]
    assert snap["c"]["consecutive_failures"] == 0  # earned its budget back
    assert _sample(runs["port"][2], "stage_degraded", {"stage": "a"}) == 1
    assert snap["b"] == {**snap["b"], "state": "Running", "restarts": 1,
                         "consecutive_failures": 2}
    for pkg in PKGS:
        runs[pkg][0].stop()
        assert runs[pkg][0].snapshot()["a"]["state"] == "Degraded"
        assert runs[pkg][0].snapshot()["b"]["state"] == "Stopped"


@pytest.mark.parametrize("pkg", list(PKGS))
def test_heartbeat_and_superseded_thread(pkg):
    """A beat refreshes the stage's heartbeat; a beat from a thread the
    stage no longer owns exits that thread (SystemExit)."""
    mod, _ = PKGS[pkg]
    sup = mod.Supervisor(check_period_s=3600)
    owner = {"t": threading.current_thread()}
    beat = sup.register("s", restart=lambda: None,
                        thread_getter=lambda: owner["t"],
                        heartbeat_timeout_s=1.0)
    sup._stages["s"].last_beat -= 5.0
    beat()
    assert sup.snapshot()["s"]["heartbeat_age_s"] < 1.0
    owner["t"] = threading.Thread(target=lambda: None)
    with pytest.raises(SystemExit):
        beat()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_condition_registry(pkg):
    mod, _ = PKGS[pkg]
    sup = mod.Supervisor(check_period_s=3600)
    assert sup.conditions() == {}
    assert sup.condition_active("overloaded") is False
    state = {"active": True, "shed_factor": 4}
    sup.register_condition("overloaded", lambda: dict(state))
    assert sup.condition_active("overloaded") is True
    assert sup.conditions()["overloaded"]["shed_factor"] == 4
    sup.register_condition("broken", lambda: 1 / 0)
    out = sup.conditions()["broken"]
    assert out["active"] is False and "error" in out
    assert sup.condition_active("broken") is False
    sup.register_condition("overloaded", lambda: {"active": False})
    assert sup.condition_active("overloaded") is False  # the latest wins


class LoopStage:
    """A real stage thread that runs until `die` is set."""

    def __init__(self):
        self.die = threading.Event()
        self.stop = threading.Event()
        self._thread = None
        self.heartbeat = lambda: None

    def start(self):
        self.die.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self.stop.is_set() and not self.die.is_set():
            self.heartbeat()
            time.sleep(0.01)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_monitor_loop_restarts_a_crashed_thread(pkg):
    mod, metrics_cls = PKGS[pkg]
    m = metrics_cls()
    sup = mod.Supervisor(metrics=m, check_period_s=0.02)
    stage = LoopStage()
    stage.start()
    sup.register_stage("loop", stage, heartbeat_timeout_s=2.0,
                       backoff_initial_s=0.02)
    sup.start()
    try:
        first = stage._thread
        stage.die.set()
        wait_for(lambda: sup.snapshot()["loop"]["restarts"] == 1,
                 msg="the loop stage's restart")
        assert stage._thread is not first and stage._thread.is_alive()
        assert _sample(m, "stage_failures_total",
                       {"stage": "loop", "kind": "crash"}) == 1
        assert _sample(m, "stage_restarts_total", {"stage": "loop"}) == 1
    finally:
        sup.stop()
        stage.stop.set()
        stage._thread.join(timeout=5)
    assert sup.snapshot()["loop"]["state"] == "Stopped"
    assert not sup._thread.is_alive()


# ------------------------------------------------- the exporter's stages


def test_register_supervised_equals_the_reference():
    """With a controller, an alert engine and the overlap, both exporters
    register the window and fold stages with the same deadlines and the
    `overloaded` and `alerting` conditions."""
    kw = dict(shed_watermark=2.0, overlap_depth=2)
    eng = tengine.AlertEngine(trules.default_rules())
    jeng = jengine.AlertEngine(jrules.default_rules())
    exp, _ = port_exporter(alerts=eng, window_s=3600.0, **kw)
    jexp, _ = jax_exporter(alerts=jeng, **kw)
    sup = tsup.Supervisor(check_period_s=3600)
    jsup_ = jsup.Supervisor(check_period_s=3600)
    try:
        exp.register_supervised(sup, heartbeat_timeout_s=30.0)
        jexp.register_supervised(jsup_, heartbeat_timeout_s=30.0)
        got, want = _timeless(sup.snapshot()), _timeless(jsup_.snapshot())
        assert got == want
        assert set(got) == {"sketch-window", "sketch-fold"}
        assert got["sketch-fold"]["heartbeat_timeout_s"] == 30.2
        assert set(sup.conditions()) == set(jsup_.conditions()) == {
            "overloaded", "alerting"}
        assert sup.conditions()["overloaded"] == {
            "active": False, **exp.overload_snapshot()}
        assert sup.conditions()["alerting"].keys() == \
            jsup_.conditions()["alerting"].keys()
        assert exp.fold_heartbeat is not None
    finally:
        exp.close()
        jexp.close()


def test_unarmed_exporter_registers_no_condition():
    exp = small_exporter(window_s=3600.0)
    sup = tsup.Supervisor(check_period_s=3600)
    try:
        exp.register_supervised(sup)
        assert sup.conditions() == {}
        assert set(sup.snapshot()) == {"sketch-window"}
    finally:
        exp.close()


def test_alerting_condition_follows_the_engine():
    """The repair: the exporter registers its alert engine's `alerting`
    condition, which turns active once a rule raises on a published
    window (the reference's `register_supervised`,
    `tpu_sketch.py:979-981`)."""
    eng = tengine.AlertEngine([trules.cardinality_rule(0.0, raise_evals=1)])
    exp = small_exporter(window_s=3600.0, alerts=eng)
    sup = tsup.Supervisor(check_period_s=3600)
    try:
        exp.register_supervised(sup)
        assert "alerting" in sup.conditions()
        assert sup.condition_active("alerting") is False
        ev, f = _feed(np.random.default_rng(400), 600, n_distinct=500)
        exp.export_evicted(EvictedFlows(ev, **f))
        exp.flush()
        assert sup.condition_active("alerting") is True
        cond = sup.conditions()["alerting"]
        assert cond == eng.condition() and cond["active_alerts"] >= 1
        assert "ALERTING" in exp._telemetry_block(0)["conditions"]
    finally:
        exp.close()


def _health(sup):
    """The reference agent's `health_snapshot` (`agent/agent.py:239-255`),
    written inline over a supervisor that no agent owns."""
    conditions = sup.conditions()
    return {"status": "Started", "degraded": sup.degraded,
            "overloaded": bool(conditions.get("overloaded", {})
                               .get("active")),
            "conditions": conditions, "stages": sup.snapshot()}


def _get(port, path):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=5)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_readyz_static_overloaded_and_degraded():
    """OVERLOADED shows in both bodies and fails neither probe; DEGRADED
    fails readiness only (tests/test_overload.py)."""
    health = {"status": "Started", "degraded": False, "overloaded": True,
              "conditions": {"overloaded": {"active": True,
                                            "shed_factor": 8}},
              "stages": {}}
    srv = start_metrics_server(None, address="127.0.0.1", port=0,
                               health_source=lambda: dict(health))
    try:
        port = srv.server_address[1]
        code, body = _get(port, "/healthz")
        assert code == 200 and body["overloaded"] is True
        assert body["conditions"]["overloaded"]["shed_factor"] == 8
        assert _get(port, "/readyz")[0] == 200
        health["degraded"] = True
        assert _get(port, "/readyz")[0] == 503
        assert _get(port, "/healthz")[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()


def test_health_surface_of_an_overloaded_then_degraded_exporter():
    """A shedding exporter under the port's supervisor: `/healthz` hoists
    OVERLOADED, `/readyz` stays 200; a stage past its budget then makes
    the agent DEGRADED: `/readyz` 503, `/healthz` still 200."""
    exp = small_exporter(window_s=3600.0, shed_watermark=2.0)
    sup = tsup.Supervisor(check_period_s=3600)
    srv = exp.serve(health_source=lambda: _health(sup))
    try:
        exp.register_supervised(sup)
        port = srv.server_address[1]
        code, body = _get(port, "/healthz")
        assert code == 200 and body["overloaded"] is False
        pin(exp, 8)
        code, body = _get(port, "/healthz")
        assert code == 200 and body["overloaded"] is True
        assert body["degraded"] is False
        assert body["conditions"]["overloaded"]["shed_factor"] == 8
        assert _get(port, "/readyz")[0] == 200
        dead = FakeStage()
        dead._thread.alive = False
        sup.register_stage("dead", dead, max_restarts=0)
        sup._check_once()
        code, body = _get(port, "/readyz")
        assert code == 503 and body["degraded"] is True
        assert body["stages"]["dead"]["state"] == "Degraded"
        assert _get(port, "/healthz")[0] == 200
    finally:
        srv.shutdown()
        srv.server_close()
        exp.close()


def test_window_thread_crash_publishes_once_under_the_port_supervisor():
    """A crash between the roll and the sink restarts the window thread
    through the port's supervisor; the queued report publishes exactly
    once (tests/test_roll_nonblocking.py)."""
    reports: list = []
    metrics = Metrics()
    exp = small_exporter(batch_size=32, window_s=0.4, metrics=metrics,
                         sink=reports.append)
    sup = tsup.Supervisor(metrics=metrics, check_period_s=0.05)
    exp.register_supervised(sup, heartbeat_timeout_s=2.0, max_restarts=3,
                            backoff_initial_s=0.05, backoff_max_s=0.2)
    sup.start()
    try:
        ev, f = _feed(np.random.default_rng(410), 8)
        exp.export_evicted(EvictedFlows(ev, **f))
        faultinject.arm("sketch.window_publish", "crash", times=1)
        wait_for(lambda: faultinject.hits.get("sketch.window_publish", 0)
                 >= 1, msg="the publish crash")
        wait_for(lambda: sup.snapshot()["sketch-window"]["restarts"] >= 1,
                 msg="the window thread's restart")
        wait_for(lambda: len(reports) >= 2, msg="reports after the restart")
        assert _sample(metrics, "stage_restarts_total",
                       {"stage": "sketch-window"}) >= 1
    finally:
        faultinject.clear()
        sup.stop()
        exp.close()
    windows = [r["Window"] for r in reports]
    assert windows == sorted(set(windows)), windows
    assert sum(r["Records"] for r in reports) == 8.0


def test_timer_fault_restarts_the_window_thread():
    """`sketch.window_timer` crash and hang restart the window thread."""
    metrics = Metrics()
    exp = small_exporter(batch_size=32, window_s=0.5, metrics=metrics)
    exp._deadline = time.monotonic() + 1e9
    sup = tsup.Supervisor(metrics=metrics, check_period_s=0.05)
    exp.register_supervised(sup, heartbeat_timeout_s=1.0,
                            backoff_initial_s=0.05, backoff_max_s=0.2)
    sup.start()
    try:
        faultinject.arm("sketch.window_timer", "crash", times=1)
        wait_for(lambda: sup.snapshot()["sketch-window"]["restarts"] >= 1,
                 msg="restart after the crash")
        faultinject.arm("sketch.window_timer", "hang", times=1)
        wait_for(lambda: sup.snapshot()["sketch-window"]["restarts"] >= 2,
                 msg="restart after the hang")
        assert _sample(metrics, "stage_failures_total",
                       {"stage": "sketch-window", "kind": "hang"}) >= 1
        assert exp._timer.is_alive()
    finally:
        faultinject.clear()
        sup.stop()
        exp.close()


def test_aggregator_window_thread_under_the_port_supervisor():
    from netobserv_tpu_torch.federation.aggregator import FederationAggregator
    metrics = Metrics()
    agg = FederationAggregator(ts.SketchConfig(**SMALL), window_s=0.5,
                               device="cpu", metrics=metrics,
                               sink=lambda obj: None)
    sup = tsup.Supervisor(metrics=metrics, check_period_s=0.05)
    agg.register_supervised(sup, heartbeat_timeout_s=2.0,
                            backoff_initial_s=0.05)
    sup.start()
    try:
        faultinject.arm("federation.window_timer", "crash", times=1)
        wait_for(lambda: sup.snapshot()["federation-window"]["restarts"]
                 >= 1, msg="the aggregator window thread's restart")
        assert _sample(metrics, "stage_restarts_total",
                       {"stage": "federation-window"}) >= 1
    finally:
        faultinject.clear()
        sup.stop()
        agg.close()


# --------------------------------------------- metric families, config


@pytest.mark.parametrize("name", FAMILIES)
def test_metric_family_equals_the_reference(name):
    got = getattr(Metrics(), name)
    want = getattr(jreg.Metrics(jreg.MetricsSettings()), name)
    assert type(got).__name__ == type(want).__name__
    for attr in ("_name", "_documentation", "_labelnames", "_type",
                 "_unit"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("env", [
    {},
    {"SUPERVISOR_ENABLE": "false", "SUPERVISOR_CHECK_PERIOD": "1s",
     "SUPERVISOR_MAX_RESTARTS": "2", "SUPERVISOR_BACKOFF_INITIAL": "50ms",
     "SUPERVISOR_BACKOFF_MAX": "1m", "SUPERVISOR_HEALTHY_RESET": "90",
     "SUPERVISOR_HEARTBEAT_TIMEOUT": "1h30m"},
    {"SUPERVISOR_ENABLE": "on", "SUPERVISOR_MAX_RESTARTS": ""},
    {"SUPERVISOR_ENABLE": "0"},
])
def test_supervisor_settings_equal_the_reference(env):
    got = tconfig.SupervisorSettings.from_env(env)
    ref = jconfig.load_config(environ=env)
    for name in tconfig.SupervisorSettings.__dataclass_fields__:
        assert getattr(got, name) == getattr(ref, name), name


def test_supervisor_settings_refuse_a_malformed_duration():
    for env in ({"SUPERVISOR_CHECK_PERIOD": "5 parsecs"},
                {"SUPERVISOR_MAX_RESTARTS": "x"}):
        with pytest.raises(ValueError):
            jconfig.load_config(environ=env)
        with pytest.raises(ValueError):
            tconfig.SupervisorSettings.from_env(env)
