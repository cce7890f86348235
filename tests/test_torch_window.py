"""The port's exporter seam and window plane (netobserv_tpu_torch/
exporter/torch_sketch.py: fold containment, the window thread, the report
queue and sinks; metrics/registry.py; utils/tracing.py and
utils/faultinject.py) against the JAX package's, on the CPU.

- Fault C8: a fold whose dispatch raises after its chunk packed is
  dropped, counted and, on the resident feed, rolls every dictionary's
  epoch, as the reference's `TpuSketchExporter` does; the tables, the
  counters and every lane's key table then agree bit for bit with the JAX
  exporter's through the same failure (integer-valued masses, per-cell
  sums below 2^24; the RTT and DNS histograms to the bound of
  tests/test_torch_staging.py, ROADMAP C5).
- Fault C9: `close()` publishes the last, partial window, as the
  reference's `close()` does.
- The window thread's behaviour under a blocking, wedged or failing sink
  and under its fault points, driven through the JAX package's
  `Supervisor` where the reference's tests drive it
  (tests/test_roll_nonblocking.py, tests/test_supervision.py).
- The metric families, trace spans and fault registries of the two
  packages.

Every test joins the threads it starts, and waits at most 15 s on any
condition. Sizes: B = 512 at the small sketch geometry (B = 64 and a
smaller one for the window-thread tests)."""

import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu.agent.supervisor import Supervisor
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.sketch import state as js
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu.utils import tracing as jtracing
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter import torch_sketch
from netobserv_tpu_torch.exporter.report import make_report_sink
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.ops.kernels import countmin_kernel
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import staging as tstg
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject, tracing
from tests.test_torch_staging import (
    B, COUNTERS, GEOM, _assert_tables, _feed, _Samples,
)

# injected crashes are unhandled thread exceptions: the scenario under test
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

SMALL = dict(cm_depth=2, cm_width=1 << 10, hll_precision=6,
             perdst_buckets=32, perdst_precision=4, persrc_buckets=32,
             persrc_precision=4, topk=16, hist_buckets=64, ewma_buckets=32)
#: the port's metric families, each held against the reference's
FAMILIES = (
    "errors_total", "sketch_batches_total", "sketch_records_total",
    "sketch_window_reports_total", "sketch_ingest_seconds",
    "sketch_staging_stalls_total", "sketch_resident_continuations_total",
    "sketch_resident_dict_epochs_total", "sketch_dense_fallback_total",
    "sketch_resident_spill_rows_total", "sketch_direct_fold_rows_total",
    "sketch_superbatch_folds_total", "sketch_slot_wait_seconds",
    "sketch_heavy_evictions_total", "sketch_tier_promotions_total",
    "sketch_tiered_interior_folds_total", "sketch_reports_shed_total",
    "sketch_window_records", "sketch_window_drop_bytes",
    "sketch_window_suspects", "sketch_ingest_errors_total", "stage_seconds",
    "sketch_retraces_total", "executable_dispatch_seconds_total",
    "trace_context_propagated_total", "query_requests_total",
    "query_snapshot_age_seconds", "alerts_active", "alerts_transitions_total",
    "alert_sink_errors_total", "alert_eval_seconds",
    "federation_deltas_total", "federation_delta_bytes_total",
    "federation_deltas_sent_total", "federation_merge_seconds",
    "federation_agent_staleness_seconds", "federation_active_agents",
    "federation_fleet_requests_total", "federation_agent_evictions_total")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()
    for mod in (tracing, jtracing):
        mod.configure(sample=0.0)
        mod.set_metrics(None)


def wait_for(pred, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _value(metric) -> float:
    return metric._value.get()


class FailOnce:
    """A test seam: the `at`-th fold call of a ring (1-based) raises at
    its first dispatch, after its chunk packed; `rows` is that call's row
    count."""

    def __init__(self, at: int):
        self.at = at
        self.calls = 0
        self.armed = False
        self.fired = 0
        self.rows = 0

    def fold(self, fold):
        def wrapped(state, events, *args, **kw):
            self.calls += 1
            self.armed = self.calls == self.at
            if self.armed:
                self.rows = len(events)
            return fold(state, events, *args, **kw)
        return wrapped

    def dispatch(self, fn):
        def wrapped(*args, **kw):
            if self.armed:
                self.armed = False
                self.fired += 1
                raise RuntimeError("injected dispatch failure")
            return fn(*args, **kw)
        return wrapped


def _evictions(rng, sizes, n_distinct=300):
    """One (events, lanes) a size, integer-valued bytes (1-63)."""
    return [_feed(rng, n, n_distinct=n_distinct) for n in sizes]


def _jax_exporter(feed="resident", slots=1 << 12, sink=None, **kw):
    """The reference exporter on one device: the tests' CPU backend has 8
    (tests/conftest.py), and an exporter that sees more than one builds a
    mesh, so it is shown the first alone while it is made."""
    jm = jreg.Metrics(jreg.MetricsSettings())
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        jexp = TpuSketchExporter(
            batch_size=B, window_s=3600.0,
            sketch_cfg=js.SketchConfig(**GEOM, use_pallas=False),
            sink=sink or (lambda obj: None), metrics=jm, pack_threads=2,
            feed=feed, resident_slots=slots, superbatch=(1, 2), **kw)
    finally:
        jax.devices = devices
    assert not jexp._distributed
    jexp.warm_superbatch_ladder(block=True)
    return jexp, jm


def _port_exporter(feed="resident", slots=1 << 12, sink=None, **kw):
    tm = Metrics()
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", pack_threads=2, superbatch=(1, 2),
                              feed=feed, resident_slots=slots, metrics=tm,
                              sink=sink or (lambda obj: None), **kw)
    return exp, tm


def _drain_jax(jexp):
    """The JAX exporter's pending tail, folded without closing the
    window."""
    with jexp._lock:
        jexp._drain_pending_locked()
    jexp._ring.drain()


# ---------------------------------------------------------------- fault C8


def test_failed_dispatch_is_contained_as_the_reference_contains_it():
    """Fault C8: the same evictions through the JAX exporter and the port
    on the resident feed (2 lanes, ladder (1, 2)); the 4th fold's first
    dispatch raises after its chunk packed in both. The exception never
    reaches `export_evicted`; both drop that fold's rows, count one ingest
    error and roll every dictionary's epoch; folding on, the tables, the
    ring counters and every lane's key table agree bit for bit."""
    rng = np.random.default_rng(110)
    sizes = [300, 2 * B + 50, 300, 3 * B, 700, B, 2 * B + 5, 300, 4 * B,
             450]
    feed = _evictions(rng, sizes, n_distinct=2000)
    jexp, jm = _jax_exporter()
    exp, tm = _port_exporter()
    try:
        exp._ensure_ring()
        tring, jring = exp.ring, jexp._ring
        assert tring.lanes == jring.lanes == 2
        tfail, jfail = FailOnce(4), FailOnce(4)
        tring.fold = tfail.fold(tring.fold)
        tring._dispatch = tfail.dispatch(tring._dispatch)
        jring.fold = jfail.fold(jring.fold)
        jring._ingests = {k: jfail.dispatch(f)
                          for k, f in jring._ingests.items()}
        samples = _Samples()
        for ev, f in feed:
            samples.add(f)
            assert exp.export_evicted(EvictedFlows(ev, **f)) is None
            jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
        exp._drain_pending()
        _drain_jax(jexp)
        assert tfail.fired == jfail.fired == 1
        assert tfail.rows == jfail.rows > 0
        assert exp.ingest_errors == _value(jm.sketch_ingest_errors_total) == 1
        assert _value(tm.sketch_ingest_errors_total) == 1
        assert tring.dict_resets == jring.dict_resets >= len(tring.kdicts)
        assert (_value(tm.sketch_resident_dict_epochs_total)
                == _value(jm.sketch_resident_dict_epochs_total))
        for c in COUNTERS:
            assert getattr(tring, c) == getattr(jring, c), c
        assert exp.records == _value(jm.sketch_records_total) == (
            sum(sizes) - tfail.rows)
        assert _value(tm.sketch_records_total) == exp.records
        _assert_tables(exp.state, jexp._state, samples=samples)
        np.testing.assert_array_equal(
            carry.key_table_to_numpy(tring.key_tables),
            np.asarray(jring.key_tables))
    finally:
        exp.close()
        jexp.close()


@pytest.mark.parametrize("feed", ["dense", "compact", "fold_dense"])
def test_failed_fold_on_the_dictionary_free_feeds(feed):
    """Fault C8 on the dense and compact rings and the dense entry: a fold
    made to raise at the `sketch.ingest` fault point is dropped and
    counted, with no dictionary to reset; the tables equal an exporter's
    that never saw the dropped batch."""
    rng = np.random.default_rng(120)
    _, pool = traffic.make_pool(rng, batch=B, n_batches=4)
    dense = traffic.dense_pool(pool)
    events = traffic.event_pool(pool, rng)

    def run(exp, skip=None):
        for i in range(4):
            if i == skip:
                continue
            if feed == "fold_dense":
                exp.fold_dense(dense[i])
            else:
                exp.fold_events(events[i][0], **events[i][1])

    ring_feed = "dense" if feed == "fold_dense" else feed
    exp, tm = _port_exporter(feed=ring_feed)
    want, _ = _port_exporter(feed=ring_feed)
    try:
        for e in (exp, want):  # a first window: the rings exist
            run(e)
            e.roll()
        faultinject.arm("sketch.ingest", "crash", times=1)
        run(exp)
        run(want, skip=0)
        assert faultinject.hits["sketch.ingest"] == 1
        assert exp.ingest_errors == 1
        assert _value(tm.sketch_ingest_errors_total) == 1
        assert _value(tm.sketch_resident_dict_epochs_total) == 0
        assert not hasattr(exp.ring, "kdicts")
        assert exp.records == 7 * B
        got, ref = exp.state_tables(), want.state_tables()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    finally:
        exp.close()
        want.close()


@pytest.mark.parametrize("feed", ["resident", "fold_dense"])
def test_shape_gate_raises_before_any_table_changes(monkeypatch, feed):
    """An eager ingest updates its tables op by op, so every shape gate of
    the path runs first (`check_fold_shapes`): a fold refused by kernel
    1's gate leaves the state tables and the key tables as they were, is
    contained and counted; the resident feed's dictionaries roll their
    epoch."""
    rng = np.random.default_rng(130)
    _, pool = traffic.make_pool(rng, batch=B, n_batches=2)
    dense = traffic.dense_pool(pool)
    events = traffic.event_pool(pool, rng)
    exp, _ = _port_exporter(feed="resident")
    try:
        def fold(i):
            if feed == "fold_dense":
                exp.fold_dense(dense[i])
            else:
                exp.fold_events(events[i][0], **events[i][1])

        fold(0)
        before = exp.state_tables()
        keys = (carry.key_table_to_numpy(exp.ring.key_tables)
                if exp.ring is not None else None)
        resets = exp.ring.dict_resets if exp.ring is not None else 0
        monkeypatch.setattr(countmin_kernel, "fold_fits",
                            lambda d, w, n: False)
        with pytest.raises(ValueError, match="kernel 1"):
            ts.check_fold_shapes(exp.state, B)
        fold(1)
        assert exp.ingest_errors == 1 and exp.records == B
        after = exp.state_tables()
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
        if keys is not None:
            np.testing.assert_array_equal(
                carry.key_table_to_numpy(exp.ring.key_tables), keys)
            assert exp.ring.dict_resets == resets + len(exp.ring.kdicts)
        monkeypatch.undo()
        fold(1)
        assert exp.records == 2 * B
    finally:
        exp.close()


def test_ring_creation_failure_still_raises(monkeypatch):
    """Containment covers folds, not construction: a ladder warm-up that
    fails raises out of `export_evicted`."""
    def boom(self, state, k):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(tstg.ShardedResidentStagingRing, "warm", boom)
    exp, _ = _port_exporter()
    try:
        ev, f = _feed(np.random.default_rng(140), 10)
        with pytest.raises(RuntimeError, match="capture failed"):
            exp.export_evicted(EvictedFlows(ev, **f))
        assert exp.ingest_errors == 0
    finally:
        monkeypatch.undo()
        exp.close()


# ---------------------------------------------------------------- fault C9


def test_close_publishes_the_last_window_as_the_reference_does():
    """Fault C9: rows still pending and a window still open at `close()`
    reach the sink once, as the JAX exporter's `close()` publishes them:
    the same Records, Bytes and heavy hitters; a second close is a
    no-op."""
    rng = np.random.default_rng(150)
    feed = _evictions(rng, [B + 100, 300, 2 * B + 7, 40])
    got, want = [], []
    jexp, _ = _jax_exporter(sink=want.append)
    exp, _ = _port_exporter(sink=got.append, window_s=3600.0)
    try:
        for ev, f in feed:
            exp.export_evicted(EvictedFlows(ev, **f))
            jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
        assert len(exp.pending) == len(jexp._pending_buf) > 0
    finally:
        exp.close()
        jexp.close()
    exp.close()
    assert len(got) == len(want) == 1
    for key in ("Window", "Records", "Bytes", "HeavyHitters"):
        assert got[0][key] == want[0][key], key
    assert got[0]["Records"] == float(sum(len(ev) for ev, _ in feed))


def test_idle_exporter_publishes_on_its_window_thread():
    """With `window_s` set, the window thread closes windows on an exporter
    that folds nothing; `close` publishes the open window once more."""
    got = []
    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=64,
                              device="cpu", window_s=0.2, sink=got.append)
    try:
        assert exp._window_poll_s == pytest.approx(0.02)
        wait_for(lambda: len(got) >= 2, msg="idle windows")
        assert exp._timer.is_alive()
    finally:
        exp.close()
    assert not exp._timer.is_alive()
    n = len(got)
    exp.close()
    windows = [r["Window"] for r in got]
    assert windows == list(range(n)) and n == exp.rolls
    assert exp.reports_published == n


# ------------------------------------------------------------ window thread


def test_blocking_sink_does_not_block_folds():
    """Folds keep landing at steady latency while a sink that blocks
    0.5 s delivers a report (tests/test_roll_nonblocking.py:57): the render
    and the sink run on the window thread, outside the exporter lock."""
    sink_spans: list[tuple[float, float]] = []

    def slow_sink(obj):
        t0 = time.monotonic()
        time.sleep(0.5)
        sink_spans.append((t0, time.monotonic()))

    rng = np.random.default_rng(160)
    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=64,
                              device="cpu", window_s=0.6, sink=slow_sink,
                              pack_threads=1, superbatch=(1,))
    samples: list[tuple[float, float]] = []
    try:
        ev, f = _feed(rng, 32)
        exp.export_evicted(EvictedFlows(ev, **f))
        exp.flush()
        t_end = time.monotonic() + 2.5
        while time.monotonic() < t_end:
            ev, f = _feed(rng, 32)
            t0 = time.monotonic()
            exp.export_evicted(EvictedFlows(ev, **f))
            samples.append((t0, time.monotonic() - t0))
            time.sleep(0.01)
    finally:
        exp.close()
    assert len(sink_spans) >= 2, "window reports did not flow"
    during = [dt for t, dt in samples
              if any(s0 <= t <= s1 for s0, s1 in sink_spans)]
    assert during, "no folds observed during a sink delivery"
    assert max(during) < 0.35, (
        f"a fold waited {max(during):.3f}s behind the blocking sink")


def _supervised(exp, metrics):
    sup = Supervisor(metrics=metrics, check_period_s=0.05)
    exp.register_supervised(sup, heartbeat_timeout_s=2.0, max_restarts=3,
                            backoff_initial_s=0.05, backoff_max_s=0.2,
                            healthy_reset_s=30.0)
    sup.start()
    return sup


def test_timer_crash_mid_publish_restarts_without_double_emit():
    """A crash between the roll and the sink is the window thread's fault:
    the supervisor restarts it and the queued report publishes exactly
    once (tests/test_roll_nonblocking.py:99)."""
    reports: list[dict] = []
    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=32,
                              device="cpu", window_s=0.4, metrics=Metrics(),
                              sink=reports.append, pack_threads=1,
                              superbatch=(1,))
    sup = _supervised(exp, jreg.Metrics(jreg.MetricsSettings()))
    try:
        ev, f = _feed(np.random.default_rng(170), 8)
        exp.export_evicted(EvictedFlows(ev, **f))
        faultinject.arm("sketch.window_publish", "crash", times=1)
        wait_for(lambda: faultinject.hits.get("sketch.window_publish",
                                              0) >= 1,
                 msg="publish crash to fire")
        wait_for(lambda: sup.snapshot()["sketch-window"]["restarts"] >= 1,
                 msg="window thread restart")
        wait_for(lambda: len(reports) >= 2, msg="reports after restart")
        assert exp._timer.is_alive()
    finally:
        faultinject.clear()
        sup.stop()
        exp.close()
    windows = [r["Window"] for r in reports]
    assert len(windows) == len(set(windows)), f"double emit: {windows}"
    assert windows == sorted(windows), f"out-of-order emit: {windows}"
    assert sum(r["Records"] for r in reports) == 8.0


def test_report_queue_bounded_under_wedged_sink():
    """Rolls behind a wedged sink queue at most 8 reports; each one shed
    past the bound is counted (tests/test_roll_nonblocking.py:135)."""
    import threading

    metrics = Metrics()
    release = threading.Event()
    got = []

    def wedged(obj):
        release.wait(10)
        got.append(obj)

    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=32,
                              device="cpu", metrics=metrics, sink=wedged)
    try:
        with exp._lock:
            for _ in range(torch_sketch.MAX_QUEUED_REPORTS + 5):
                exp._roll_locked()
        assert len(exp._reports) == torch_sketch.MAX_QUEUED_REPORTS
        assert exp.reports_shed == 5
        assert _value(metrics.sketch_reports_shed_total) == 5
    finally:
        release.set()
        exp.close()
    # close's own roll queued window 13 behind the 8 and shed window 5
    assert [r["Window"] for r in got] == list(range(6, 14))
    assert exp.reports_shed == 6


def test_publish_failure_is_swallowed_and_counted():
    """A sink outage loses that window's report, counted, never the window
    thread or later windows (tests/test_roll_nonblocking.py:164)."""
    calls = []

    def flaky_sink(obj):
        calls.append(obj)
        if len(calls) == 1:
            raise RuntimeError("sink outage")

    metrics = Metrics()
    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=32,
                              device="cpu", window_s=0.3, metrics=metrics,
                              sink=flaky_sink, pack_threads=1,
                              superbatch=(1,))
    try:
        ev, f = _feed(np.random.default_rng(180), 4)
        exp.export_evicted(EvictedFlows(ev, **f))
        wait_for(lambda: len(calls) >= 2, msg="later windows still publish")
        assert exp._timer.is_alive()
        assert _value(metrics.errors_total.labels("tpu-sketch", "error")) >= 1
        assert exp.reports_published == len(calls) - 1
    finally:
        exp.close()


def test_window_roll_errors_swallowed_and_timer_faults_restart():
    """`sketch.window_roll` errors are swallowed and counted with the
    thread alive; a `sketch.window_timer` crash and hang restart it
    (tests/test_supervision.py:310)."""
    metrics = Metrics()
    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=32,
                              device="cpu", window_s=0.5, metrics=metrics,
                              sink=lambda obj: None)
    exp._deadline = time.monotonic() + 1e9  # never actually roll
    sup = _supervised(exp, jreg.Metrics(jreg.MetricsSettings()))
    errors = metrics.errors_total.labels("tpu-sketch", "error")
    try:
        faultinject.arm("sketch.window_roll", "crash", times=2)
        wait_for(lambda: _value(errors) >= 2, msg="roll errors counted")
        assert exp._timer.is_alive()
        assert sup.snapshot()["sketch-window"]["restarts"] == 0
        faultinject.arm("sketch.window_timer", "crash", times=1)
        wait_for(lambda: sup.snapshot()["sketch-window"]["restarts"] >= 1,
                 msg="window thread restart")
        assert exp._timer.is_alive()
        after_crash = sup.snapshot()["sketch-window"]["restarts"]
        faultinject.arm("sketch.window_timer", "hang", times=1)
        wait_for(lambda: sup.snapshot()["sketch-window"]["restarts"]
                 > after_crash, msg="window thread hang restart")
    finally:
        faultinject.clear()
        sup.stop()
        exp.close()
    assert exp.rolls == 1  # close's own


def test_staging_wait_fault_seam():
    """A staging ring's slot wait is a fault point: a hang there stalls the
    fold as a wedged copy would (tests/test_supervision.py:399)."""
    ring = tstg.DenseStagingRing(64, device="cpu")
    faultinject.arm("sketch.staging_wait", "crash", times=1)
    with pytest.raises(faultinject.FaultInjected):
        ring._wait_slot()
    assert ring._wait_slot() == 0  # disarmed again: transparent
    ring.close()


def test_ingest_error_rolls_every_dictionary_epoch():
    """`_count_ingest_error` resets a one-dictionary ring's `kdict` and a
    lane ring's every `kdicts` entry, counts them in `dict_resets` and
    `sketch_resident_dict_epochs_total`, and leaves a ring without
    dictionaries alone (tests/test_supervision.py:364)."""
    class FakeKD:
        resets = 0

        def reset(self):
            self.resets += 1

    class OneDict:
        def __init__(self):
            self.kdict = FakeKD()
            self.dict_resets = 0

    class Lanes:
        def __init__(self):
            self.kdicts = [FakeKD() for _ in range(3)]
            self.dict_resets = 2

    class DenseRing:
        pass

    metrics = Metrics()
    exp = TorchSketchExporter(ts.SketchConfig(**SMALL), batch_size=32,
                              device="cpu", metrics=metrics,
                              sink=lambda obj: None)
    try:
        exp.ring = OneDict()
        exp._count_ingest_error(8, RuntimeError("device lost"))
        assert exp.ring.kdict.resets == 1 and exp.ring.dict_resets == 1
        exp.ring = Lanes()
        exp._count_ingest_error(8, RuntimeError("device lost"))
        assert [kd.resets for kd in exp.ring.kdicts] == [1, 1, 1]
        assert exp.ring.dict_resets == 5
        exp.ring = DenseRing()
        exp._count_ingest_error(8, RuntimeError("device lost"))
        assert exp.ingest_errors == 3
        assert _value(metrics.sketch_ingest_errors_total) == 3
        assert _value(metrics.sketch_resident_dict_epochs_total) == 4
    finally:
        exp.ring = None
        exp.close()


def test_report_sinks():
    """SKETCH_REPORT_SINK: "" and "stdout" give the JSON-lines sink,
    "kafka" a `KafkaReportSink` over the KAFKA_* settings, connected to
    its broker when made (tests/test_torch_kafka.py sends through it),
    anything else raises."""
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.exporter.report import KafkaReportSink
    from tests.test_kafka_broker import FakeBroker

    class Cfg:
        def __init__(self, sink):
            self.sketch_report_sink = sink

    assert make_report_sink(Cfg("")) is make_report_sink(Cfg("stdout"))
    broker = FakeBroker()
    broker.start()
    try:
        sink = make_report_sink(load_config({
            "SKETCH_REPORT_SINK": "kafka",
            "KAFKA_BROKERS": f"127.0.0.1:{broker.port}"}))
        assert isinstance(sink, KafkaReportSink)
        sink.close()
    finally:
        broker.stop()
    with pytest.raises(ValueError):
        make_report_sink(Cfg("grpc"))


# ------------------------------------------ metrics, traces, fault points


@pytest.mark.parametrize("name", FAMILIES)
def test_metric_family_equals_the_reference(name):
    """Each family of the port's Metrics has the reference family's name,
    type, help text, labels (and buckets)."""
    got = getattr(Metrics(), name)
    want = getattr(jreg.Metrics(jreg.MetricsSettings()), name)
    assert type(got).__name__ == type(want).__name__
    for attr in ("_name", "_documentation", "_labelnames", "_type",
                 "_unit"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert getattr(got, "_upper_bounds", None) == getattr(
        want, "_upper_bounds", None)


def test_trace_spans_equal_the_reference():
    """With sampling at 1.0 the port's fold and window traces carry the
    JAX exporter's span names on the same feed, the query plane's
    `query_snapshot` included; a fold that waits on a busy slot adds
    `staging_wait` in either."""
    rng = np.random.default_rng(190)
    feed = _evictions(rng, [300, 2 * B + 9, B])
    for mod in (tracing, jtracing):
        mod.configure(sample=1.0, capacity=256)
    jexp, _ = _jax_exporter()
    exp, tm = _port_exporter()
    try:
        for ev, f in feed:
            exp.export_evicted(EvictedFlows(ev, **f))
            jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
        exp.flush()
        jexp.flush()
    finally:
        exp.close()
        jexp.close()

    def spans(snapshot):
        out: dict[str, set] = {}
        for t in snapshot:
            out.setdefault(t["kind"], set()).update(
                s["stage"] for s in t["stages"])
        for names in out.values():
            names.discard("staging_wait")
        return out

    got, want = spans(tracing.snapshot()), spans(jtracing.snapshot())
    assert got == want
    assert got["fold"] == {"fold", "resident_pack", "ingest_dispatch"}
    assert got["window"] == {"roll_drain", "roll_dispatch", "report_render",
                             "query_snapshot", "report_sink"}
    stages = {s.labels(st)._sum.get() > 0
              for st in ("resident_pack", "report_sink")
              for s in (tm.stage_seconds,)}
    assert stages == {True}


@pytest.mark.parametrize("armed", ["port", "jax"])
def test_fault_registries_are_separate(armed):
    """Arming a point in one package leaves the other's unarmed."""
    one, other = (faultinject, jfault) if armed == "port" else (
        jfault, faultinject)
    one.arm("sketch.ingest", "crash", times=1)
    assert one.armed("sketch.ingest")
    assert not other.armed("sketch.ingest")
    assert other.fire("sketch.ingest", b"x") == b"x"
    with pytest.raises(one.FaultInjected):
        one.fire("sketch.ingest")
    assert other.hits.get("sketch.ingest", 0) == 0
