"""The port's agent stages (netobserv_tpu_torch/flow/map_tracer.py,
flow/limiter.py, exporter/base.py, agent/agent.py, datapath/fetcher.py,
datapath/replay.py, scenarios/synth.py, model/record.py) against the JAX
package's, on the CPU.

- `MapTracer` over the same `FakeFetcher` schedule in both packages: the
  queued evictions' columns are equal on the columnar path, the records
  equal as dicts on the record path (one clock pinned for both); the
  map-pressure cadence, its latch and the occupancy sink behave as
  tests/test_overload.py:524-630 requires of the reference, with the same
  metrics; a sampled batch trace born at `evict` is finished by the
  exporter's next fold, with the reference's spans.
- `CapacityLimiter` drop counting and `QueueExporter` export and error
  counting equal the reference's.
- `health_snapshot` of both agents over a fake exporter, before, while
  and after they run; `shutdown` delivers every injected row, also
  through the sketch exporter's last window.
- Each fault point of the stages (`map_tracer.evict`,
  `map_tracer.pressure_evict`, `limiter.forward`, `exporter.loop`) gets a
  supervisor restart, and `exporter.export` is swallowed and counted, as
  tests/test_supervision.py requires of the reference.
- `SyntheticFetcher` evictions of one seed, and `PcapReplayFetcher`
  evictions of the synth pcaps, are equal in both packages; every builder
  of `scenarios/synth.py` gives byte-identical frames and pcaps.

Every test joins the threads it starts and waits at most 10 s on any
condition."""

import dataclasses
import queue
import threading
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu import config as jcfg
from netobserv_tpu.agent import FlowsAgent as JAgent
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.datapath import replay as jreplay
from netobserv_tpu.exporter import base as jbase
from netobserv_tpu.flow import CapacityLimiter as JLimiter
from netobserv_tpu.flow import MapTracer as JMapTracer
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.model import binfmt as jbin
from netobserv_tpu.scenarios import synth as jsynth
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu.utils import tracing as jtracing
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.agent import FlowsAgent, Status
from netobserv_tpu_torch.datapath import fetcher as tfetch
from netobserv_tpu_torch.datapath import replay as treplay
from netobserv_tpu_torch.exporter import base as tbase
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.flow import CapacityLimiter, MapTracer
from netobserv_tpu_torch.metrics import registry as treg
from netobserv_tpu_torch.model import binfmt as tbin
from netobserv_tpu_torch.scenarios import synth as tsynth
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject, tracing

# injected crashes are unhandled thread exceptions: the scenario under test
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

#: fast supervision for the chaos cases (tests/test_supervision.py's)
FAST_SUP = {"SUPERVISOR_CHECK_PERIOD": "50ms",
            "SUPERVISOR_BACKOFF_INITIAL": "50ms",
            "SUPERVISOR_BACKOFF_MAX": "200ms",
            "SUPERVISOR_HEARTBEAT_TIMEOUT": "2s",
            "SUPERVISOR_HEALTHY_RESET": "30s"}
#: a small sketch geometry for the exporter cases
SMALL = ts.SketchConfig(cm_depth=2, cm_width=1 << 10, hll_precision=6,
                        perdst_buckets=32, perdst_precision=4,
                        persrc_buckets=32, persrc_precision=4, topk=64,
                        hist_buckets=64, ewma_buckets=64)


def _reset_globals():
    """Leave both packages' fault registries cleared and both flight
    recorders empty and disabled: a sampled trace left in the JAX
    package's recorder fails that package's own tracing tests when they
    share this process (fault C11)."""
    for fi in (faultinject, jfault):
        fi.clear()
        fi.hits.clear()
    for trc in (tracing, jtracing):
        trc.configure(sample=0.0)
        trc.recorder.clear()


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    _reset_globals()
    time.sleep(0.05)


def wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def test_record_dtypes_are_the_references():
    for name in ("FLOW_EVENT_DTYPE", "DNS_REC_DTYPE", "DROPS_REC_DTYPE",
                 "EXTRA_REC_DTYPE", "XLAT_REC_DTYPE", "QUIC_REC_DTYPE"):
        assert getattr(tbin, name) == getattr(jbin, name), name


def make_eviction(rng: np.random.Generator, n: int, features: bool = True
                  ) -> dict:
    """One eviction's arrays from `rng`: flow events with random keys,
    counters, flags and observed interfaces, and (with `features`) every
    feature lane, the network events included."""
    ev = np.zeros(n, tbin.FLOW_EVENT_DTYPE)
    raw = ev.view(np.uint8).reshape(n, tbin.FLOW_EVENT_DTYPE.itemsize)
    raw[:] = rng.integers(0, 256, raw.shape, dtype=np.uint8)
    k, st = ev["key"], ev["stats"]
    k["src_ip"][:, :12] = np.frombuffer(b"\x00" * 10 + b"\xff\xff", np.uint8)
    k["dst_ip"][:, :12] = np.frombuffer(b"\x00" * 10 + b"\xff\xff", np.uint8)
    k["proto"] = rng.choice([1, 6, 17, 58], n)
    st["bytes"] = rng.integers(64, 9000, n)
    st["first_seen_ns"] = rng.integers(1, 10**15, n)
    st["last_seen_ns"] = st["first_seen_ns"] + rng.integers(0, 10**9, n)
    st["n_observed_intf"] = rng.integers(0, 8, n)
    out = {"events": ev}
    if not features:
        return out
    for name, dt in (("dns", tbin.DNS_REC_DTYPE),
                     ("drops", tbin.DROPS_REC_DTYPE),
                     ("extra", tbin.EXTRA_REC_DTYPE),
                     ("xlat", tbin.XLAT_REC_DTYPE),
                     ("quic", tbin.QUIC_REC_DTYPE),
                     ("nevents", jbin.NEVENTS_REC_DTYPE)):
        arr = np.zeros(n, dt)
        b = arr.view(np.uint8).reshape(n, dt.itemsize)
        b[:] = rng.integers(0, 256, b.shape, dtype=np.uint8)
        out[name] = arr
    name = np.zeros((n, 32), np.uint8)
    name[:, 0], name[:, 1:4] = 3, ord("a")
    name[:, 4], name[:, 5:8] = 2, ord("b")
    out["dns"]["name"] = [bytes(r) for r in name]
    out["extra"]["ipsec_encrypted"] = rng.integers(0, 2, n)
    for f in ("seen_long_hdr", "seen_short_hdr"):
        out["quic"][f] = rng.integers(0, 2, n)
    return out


def schedule(seed: int = 0) -> list:
    """A FakeFetcher schedule: evictions of several sizes, one empty."""
    rng = np.random.default_rng(seed)
    return [make_eviction(rng, n, features=(i % 2 == 0))
            for i, n in enumerate((37, 0, 5, 64, 1))]


class _PinnedClock:
    """`MonotonicClock` at one (mono, wall) pair, for both packages."""

    def now_pair(self):
        return 5_000_000_000_000, 1_700_000_000_000_000_000


def _tracers(columnar: bool, **kw):
    """(port tracer, its queue, reference tracer, its queue), fed the same
    schedule by two FakeFetchers."""
    out = []
    for fetch, tracer_cls in ((tfetch, MapTracer), (jfetch, JMapTracer)):
        fake = fetch.FakeFetcher()
        for ev in schedule():
            fake.inject_events(ev["events"], **{
                k: v for k, v in ev.items() if k != "events"})
        q = queue.Queue(maxsize=100)
        tracer = tracer_cls(fake, q, active_timeout_s=60, agent_ip="10.1.2.3",
                            columnar=columnar, namer=lambda i, mac: f"if{i}",
                            **kw)
        tracer._clock = _PinnedClock()
        out += [tracer, q]
    return out


def _drain(q) -> list:
    items = []
    while not q.empty():
        items.append(q.get_nowait())
    return items


def test_map_tracer_columnar_path_forwards_the_same_evictions():
    t, tq, r, rq = _tracers(columnar=True)
    for _ in range(len(schedule()) + 1):  # the last drain finds nothing
        t._evict_once()
        r._evict_once()
    ours, ref = _drain(tq), _drain(rq)
    assert len(ours) == len(ref) == 4  # the empty drains forward nothing
    for a, b in zip(ours, ref):
        assert isinstance(a, tfetch.EvictedFlows)
        for lane in ("events", "dns", "drops", "extra", "xlat", "quic",
                     "nevents"):
            x, y = getattr(a, lane), getattr(b, lane)
            assert (x is None) == (y is None), lane
            if x is not None:
                assert x.tobytes() == y.tobytes(), lane


def test_map_tracer_record_path_gives_equal_records(monkeypatch):
    t, tq, r, rq = _tracers(columnar=False)
    for _ in range(len(schedule())):
        t._evict_once()
        r._evict_once()
    ours, ref = _drain(tq), _drain(rq)
    assert [len(b) for b in ours] == [len(b) for b in ref] == [37, 5, 64, 1]
    for a, b in zip(ours, ref):
        assert [dataclasses.asdict(x) for x in a] == \
            [dataclasses.asdict(y) for y in b]
    rec = ours[0][0]
    assert rec.agent_ip == "10.1.2.3" and rec.interface.startswith("if")
    assert rec.features.dns_name == "aaa.bb"
    assert any(x.features.network_events for x in ours[0])


class SizedFetcher:
    """A fetcher of `rows` rows a drain of the given package (the
    reference test's stub), counting its drains."""

    def __init__(self, fetch, rows: int):
        self.fetch, self.rows, self.calls = fetch, rows, 0

    def lookup_and_delete(self):
        self.calls += 1
        ev = np.zeros(self.rows, tbin.FLOW_EVENT_DTYPE)
        ev["stats"]["bytes"] = 100
        return self.fetch.EvictedFlows(ev)

    def read_global_counters(self):
        return {}


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_map_pressure_latch_metrics_occupancy_sink_and_fault_point(pkg):
    """tests/test_overload.py's latch, hysteresis and metrics cases, on
    both packages with the same occupancies and the same counts."""
    tracer_cls, fetch, reg, fi = (
        (MapTracer, tfetch, treg, faultinject) if pkg == "port"
        else (JMapTracer, jfetch, jreg, jfault))
    metrics = reg.Metrics(reg.MetricsSettings())
    seen = []
    q = queue.Queue(maxsize=100)
    tracer = tracer_cls(SizedFetcher(fetch, 90), q, active_timeout_s=60,
                        metrics=metrics, columnar=True, map_capacity=100,
                        pressure_watermark=0.8, occupancy_sink=seen.append)
    fi.arm("map_tracer.pressure_evict", "delay", 0.0)
    latches = []
    for rows in (90, 45, 30, 85):
        tracer._fetcher = SizedFetcher(fetch, rows)
        tracer._evict_once()
        latches.append(tracer._pressure_relief)
    assert latches == [True, True, False, True]
    assert seen == [0.9, 0.45, 0.3, 0.85]
    assert metrics.map_pressure_evictions_total._value.get() == 3
    assert fi.hits.get("map_tracer.pressure_evict") == 3
    assert metrics.map_occupancy_ratio._sum.get() == pytest.approx(2.5)
    assert metrics.evicted_flows_total.labels("map")._value.get() == 250
    assert metrics.evictions_total.labels("map")._value.get() == 4
    # a disabled watermark never latches, and a failing sink is ignored
    quiet = tracer_cls(SizedFetcher(fetch, 100), q, active_timeout_s=60,
                       columnar=True, occupancy_sink=lambda r: 1 / 0)
    quiet._evict_once()
    assert quiet._pressure_relief is False


def _count_collects(monkeypatch, tracer_cls, fetch, columnar: bool,
                    evictions: int, timeout_s: float,
                    pause_s: float = 0.0) -> int:
    """gc.collect calls over `evictions` evictions of a three-flow map,
    `pause_s` apart, by a tracer with FORCE_GARBAGE_COLLECTION."""
    import gc
    calls = []
    monkeypatch.setattr(gc, "collect", lambda *a: calls.append(1) or 0)
    fetcher = fetch.FakeFetcher()
    tracer = tracer_cls(fetcher, queue.Queue(), active_timeout_s=timeout_s,
                        columnar=columnar, force_gc=True)
    events = np.zeros(3, tbin.FLOW_EVENT_DTYPE)
    events["key"]["src_port"] = [1, 2, 3]
    for i in range(evictions):
        if i:
            time.sleep(pause_s)
        fetcher.inject_events(events.copy())
        tracer._evict_once()
    return len(calls)


@pytest.mark.parametrize("columnar", [False, True],
                         ids=["records", "columnar"])
def test_one_eviction_collects_as_the_reference(monkeypatch, columnar):
    """FORCE_GARBAGE_COLLECTION collects after the record path's eviction
    and never on the columnar path, in both packages
    (tests/test_evict_columnar.py::TestColumnarGcSkip)."""
    got = [_count_collects(monkeypatch, cls, fetch, columnar, 1, 60.0)
           for cls, fetch in ((MapTracer, tfetch), (JMapTracer, jfetch))]
    assert got == [0, 0] if columnar else got == [1, 1]


def test_early_evictions_collect_once_an_active_timeout(monkeypatch):
    """A storm of early evictions (one a ring-buffer single) collects once
    an active timeout, where the reference collects after each."""
    assert _count_collects(monkeypatch, MapTracer, tfetch, False,
                           50, 60.0) == 1
    assert _count_collects(monkeypatch, JMapTracer, jfetch, False,
                           50, 60.0) == 50
    assert _count_collects(monkeypatch, MapTracer, tfetch, False,
                           3, 0.05, pause_s=0.1) == 3


def test_map_pressure_halves_the_wait_and_relaxes_back():
    """Under pressure the next wakeup comes at half the period, and the
    period comes back when occupancy falls (tests/test_overload.py)."""
    q = queue.Queue(maxsize=100)
    fetcher = SizedFetcher(tfetch, 90)
    tracer = MapTracer(fetcher, q, active_timeout_s=0.2, columnar=True,
                       map_capacity=100, pressure_watermark=0.8)
    waits = []
    real_wait = tracer._flush.wait

    def recording_wait(timeout=None):
        waits.append(timeout)
        return real_wait(timeout=min(timeout, 0.02))

    tracer._flush.wait = recording_wait
    tracer.start()
    try:
        wait_for(lambda: fetcher.calls >= 3, msg="pressured drains")
        assert waits[0] == pytest.approx(0.2)
        assert any(w == pytest.approx(0.1) for w in waits[1:])
        tracer._fetcher = SizedFetcher(tfetch, 10)
        n = len(waits)
        wait_for(lambda: len(waits) > n + 2, msg="relaxed waits")
        assert waits[-1] == pytest.approx(0.2)
    finally:
        tracer.stop(final_evict=False)
    assert not tracer._thread.is_alive()


def _spans(traces, kind):
    return [sorted({s["stage"] for s in t["stages"]}) for t in traces
            if t["kind"] == kind]


def test_the_batch_trace_is_finished_by_the_next_fold():
    """A sampled eviction's "batch" trace (span `evict`) rides the
    eviction to the exporter, whose next fold finishes it (span `fold`);
    a sub-batch eviction's trace waits in the exporter until a fold takes
    its rows. The reference's spans are the same, less the port's
    `pack_lane` (each lane region's pack), which the reference does not
    time."""
    from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
    from netobserv_tpu.sketch import state as js
    got = {}
    for name, tracer_cls, fetch, trc, make in (
            ("port", MapTracer, tfetch, tracing,
             lambda: TorchSketchExporter(SMALL, batch_size=64, device="cpu",
                                         sink=lambda r: None)),
            ("reference", JMapTracer, jfetch, jtracing,
             lambda: TpuSketchExporter(
                 batch_size=64, sketch_cfg=js.SketchConfig(
                     **{k: v for k, v in SMALL._asdict().items()
                        if k != "tiered"}),
                 sink=lambda r: None, window_s=3600.0))):
        exp = make()
        fake = fetch.FakeFetcher()
        rng = np.random.default_rng(3)
        for n in (40, 100):
            fake.inject_events(make_eviction(rng, n, False)["events"])
        q = queue.Queue()
        trc.configure(sample=1.0, capacity=64)
        try:
            tracer = tracer_cls(fake, q, active_timeout_s=60, columnar=True)
            tracer._evict_once()
            first = q.get_nowait()
            assert first.trace is not None and first.trace.sampled
            exp.export_evicted(first)  # 40 rows: no fold yet
            parked = _spans(trc.snapshot(), "batch")
            tracer._evict_once()
            exp.export_evicted(q.get_nowait())  # 140 rows: a fold of 64
            got[name] = (parked, _spans(trc.snapshot(), "batch"))
        finally:
            trc.configure(sample=0.0)
            exp.close()
    parked, done = got["port"]
    assert "pack_lane" in done[0]
    done[0].remove("pack_lane")
    assert got["port"] == got["reference"]
    assert parked == [] and len(done) == 2 and done[1] == ["evict"]
    assert {"evict", "fold"} <= set(done[0])


def test_the_batch_trace_case_leaves_both_recorders_empty():
    """Fault C11: the batch-trace case samples into both packages' flight
    recorders. Run its schedule, then this module's clean-up, and the JAX
    package's recorder must be empty and disabled, as its own tracing
    tests expect to find it."""
    test_the_batch_trace_is_finished_by_the_next_fold()
    assert len(jtracing.recorder) > 0  # the case did sample
    _reset_globals()
    assert len(jtracing.recorder) == 0 and not jtracing.enabled()
    assert len(tracing.recorder) == 0 and not tracing.enabled()


class _Collect:
    """An exporter collecting what it is given, failing while `fail`."""

    name = "collect"

    def __init__(self):
        self.batches, self.fail, self.closed = [], False, False

    def export_batch(self, records):
        if self.fail:
            raise RuntimeError("sink down")
        self.batches.append(records)

    def export_evicted(self, evicted):
        self.export_batch(evicted)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_limiter_drops_and_terminal_errors_are_counted(pkg):
    lim_cls, term_cls, reg, fetch = (
        (CapacityLimiter, tbase.QueueExporter, treg, tfetch)
        if pkg == "port" else
        (JLimiter, jbase.QueueExporter, jreg, jfetch))
    metrics = reg.Metrics(reg.MetricsSettings())
    inp, out = queue.Queue(), queue.Queue(maxsize=2)
    lim = lim_cls(inp, out, metrics=metrics)
    for n in (3, 4, 5, 6):
        inp.put([object()] * n)
    lim.start()
    wait_for(lambda: inp.empty(), msg="limiter drained")
    lim.stop()
    assert metrics.dropped_flows_total.labels("limiter")._value.get() == 11
    exp = _Collect()
    term = term_cls(exp, out, metrics=metrics)
    term._drain()
    exp.fail = True
    ev = fetch.EvictedFlows(np.zeros(7, tbin.FLOW_EVENT_DTYPE))
    out.put(ev)
    term._drain()
    exp.fail = False
    faultinject_mod = faultinject if pkg == "port" else jfault
    faultinject_mod.arm("exporter.export", "crash", times=1)
    out.put([object()] * 2)
    term._drain()
    term.stop()
    assert [len(b) for b in exp.batches] == [3, 4] and exp.closed
    assert metrics.exported_flows_total.labels("collect")._value.get() == 7
    assert metrics.exported_batches_total.labels("collect")._value.get() == 2
    assert metrics.export_errors_total.labels(
        "collect", "RuntimeError")._value.get() == 1
    assert metrics.export_errors_total.labels(
        "collect", "FaultInjected")._value.get() == 1


def _agents(env=None, exporters=None):
    """Both packages' agents over a FakeFetcher and a collecting
    exporter each (the port's `Exporter` base and the reference's)."""
    env = {"EXPORT": "tpu-sketch", "CACHE_ACTIVE_TIMEOUT": "100ms",
           "BUFFERS_LENGTH": "10", "AGENT_IP": "10.9.9.9", **FAST_SUP,
           **(env or {})}
    t_exp, j_exp = exporters or (_Collect(), _Collect())
    ours = FlowsAgent(tcfg.load_config(env), tfetch.FakeFetcher(), t_exp)
    ref = JAgent(jcfg.load_config(env), jfetch.FakeFetcher(), j_exp)
    return ours, ref


def _start(agent):
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    wait_for(lambda: agent.status.value == "Started", msg="agent start")
    return stop, t


def _health(agent) -> dict:
    snap = agent.health_snapshot()
    return {**snap, "stages": {k: {f: v for f, v in s.items()
                                   if f in ("state", "restarts",
                                            "last_failure")}
                               for k, s in snap["stages"].items()}}


def test_health_snapshots_are_the_references():
    # the default hang deadline: no stage of either agent restarts under
    # a loaded test run, so the two snapshots stay comparable
    ours, ref = _agents({"SUPERVISOR_HEARTBEAT_TIMEOUT": "5m"})
    assert _health(ours) == _health(ref)
    assert ours.health_snapshot()["status"] == "NotStarted"
    runs = [_start(a) for a in (ours, ref)]
    try:
        assert _health(ours) == _health(ref)
        assert set(ours.health_snapshot()["stages"]) == {
            "map-tracer", "capacity-limiter", "exporter"}
    finally:
        for stop, t in runs:
            stop.set()
            t.join(timeout=10)
    assert _health(ours) == _health(ref)
    assert ours.status == Status.STOPPED


def _feed_then_stop(agent, stop, t, sizes, seed):
    """Inject one eviction (a FakeFetcher drain returns one) per size,
    each but the last drained at once by a flush; the last is what the map
    holds at shutdown, and only the final eviction takes it."""
    rng = np.random.default_rng(seed)
    for i, n in enumerate(sizes):
        agent.fetcher.inject_events(make_eviction(rng, n, False)["events"])
        if i < len(sizes) - 1:
            agent.map_tracer.flush()
            wait_for(agent.fetcher._evictions.empty, msg="a drain")
    stop.set()
    t.join(timeout=20)
    assert not t.is_alive()


def test_shutdown_delivers_every_injected_row():
    """Rows still in the map, the limiter's and the terminal's queues at
    shutdown come out of the final eviction and the drains."""
    ours, _ = _agents({"CACHE_ACTIVE_TIMEOUT": "60s"})
    stop, t = _start(ours)
    sizes = (17, 1, 250)
    _feed_then_stop(ours, stop, t, sizes, seed=5)
    assert sum(len(b) for b in ours.exporter.batches) == sum(sizes)
    assert ours.exporter.closed and ours.fetcher.closed


def test_shutdown_publishes_every_row_through_the_sketch_exporter():
    """The same through the sketch exporter (columnar): the rows land in
    its last window, which `close` publishes."""
    reports = []
    exp = TorchSketchExporter(SMALL, batch_size=64, device="cpu",
                              window_s=3600.0, sink=reports.append)
    cfg = tcfg.load_config({"CACHE_ACTIVE_TIMEOUT": "60s", **FAST_SUP})
    agent = FlowsAgent(cfg, tfetch.FakeFetcher(), exp)
    stop, t = _start(agent)
    _feed_then_stop(agent, stop, t, (70, 3, 129), seed=6)
    assert [r["Records"] for r in reports] == [202.0]
    assert exp.records == 202


@pytest.mark.parametrize("stage,point", [
    ("map-tracer", "map_tracer.evict"),
    ("map-tracer", "map_tracer.pressure_evict"),
    ("capacity-limiter", "limiter.forward"),
    ("exporter", "exporter.loop")])
def test_stage_fault_points_restart_through_the_supervisor(stage, point):
    """An injected crash at each stage's fault point restarts the stage
    (tests/test_supervision.py); the agent stays Started."""
    env = {"MAP_PRESSURE_WATERMARK": "0.5", "CACHE_MAX_FLOWS": "10"}
    ours, _ = _agents(env)
    stop, t = _start(ours)
    try:
        if point == "map_tracer.pressure_evict":
            ours.fetcher.inject_events(
                make_eviction(np.random.default_rng(7), 9, False)["events"])
        faultinject.arm(point, "crash", times=1)
        wait_for(lambda: faultinject.hits.get(point, 0) >= 1,
                 msg=f"{point} to fire")
        wait_for(lambda: ours.supervisor.snapshot()[stage]["restarts"] >= 1
                 and ours.supervisor.snapshot()[stage]["state"] == "Running",
                 msg=f"{stage} restart")
        assert ours.supervisor.snapshot()[stage]["last_failure"] == "crash"
        assert ours.status == Status.STARTED
        assert ours.metrics.stage_restarts_total.labels(
            stage)._value.get() >= 1
    finally:
        faultinject.clear()
        stop.set()
        t.join(timeout=10)
    assert ours.status == Status.STOPPED


def test_exporter_export_faults_are_swallowed_not_restarted():
    ours, _ = _agents()
    stop, t = _start(ours)
    try:
        faultinject.arm("exporter.export", "crash", times=1)
        ours.fetcher.inject_events(
            make_eviction(np.random.default_rng(8), 4, False)["events"])
        wait_for(lambda: faultinject.hits.get("exporter.export", 0) >= 1,
                 msg="exporter.export to fire")
        wait_for(lambda: ours.metrics.export_errors_total.labels(
            "collect", "FaultInjected")._value.get() == 1, msg="counted")
        assert ours.supervisor.snapshot()["exporter"]["restarts"] == 0
    finally:
        stop.set()
        t.join(timeout=10)


def _pin_clocks(monkeypatch):
    ns = iter(range(10**12, 10**13, 10**6))
    monkeypatch.setattr(time, "clock_gettime_ns", lambda clk: next(ns))


def _same_evictions(a, b):
    assert (a.events.tobytes() == b.events.tobytes()
            and len(a) == len(b))
    for lane in ("dns", "drops", "extra", "xlat", "quic"):
        x, y = getattr(a, lane), getattr(b, lane)
        assert (x is None) == (y is None), lane
        if x is not None:
            assert x.tobytes() == y.tobytes(), lane


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_fetcher_evictions_are_equal(seed, monkeypatch):
    fetchers = []
    for mod in (treplay, jreplay):
        _pin_clocks(monkeypatch)
        fetchers.append(mod.SyntheticFetcher(flows_per_eviction=300,
                                             n_distinct=500, seed=seed))
    _pin_clocks(monkeypatch)
    ours = [fetchers[0].lookup_and_delete() for _ in range(3)]
    _pin_clocks(monkeypatch)
    ref = [fetchers[1].lookup_and_delete() for _ in range(3)]
    for a, b in zip(ours, ref):
        _same_evictions(a, b)
        assert len(a) > 10


def _scenario_pcap(synth, path) -> "synth.PcapBuilder":
    """A SYN flood, a port scan, an elephant (jumbo-claimed), DNS pairs,
    QUIC long headers, ICMP and an IPv6 conversation in one pcap."""
    b = synth.PcapBuilder()
    for i in range(300):  # SYN flood: 300 spoofed sources, one victim
        b.add(i * 1000, f"172.16.{i % 250}.{i // 250 + 1}", "10.0.0.80", 6,
              synth.tcp(1024 + i, 80, 0x02), sport=1024 + i, dport=80)
    for p in range(600):  # port scan: one source, 600 ports
        b.add(300_000 + p * 500, "192.0.2.7", "10.0.0.9", 6,
              synth.tcp(40000, 1 + p, 0x02), sport=40000, dport=1 + p)
    for i in range(50):  # elephant
        b.add(600_000 + i * 20_000, "10.0.0.1", "10.0.0.2", 6,
              synth.tcp(5001, 443, 0x18), claim_len=60_000, sport=5001,
              dport=443)
    for i in range(20):  # DNS query/response pairs and QUIC
        b.add(700_000 + i * 50_000, "10.0.0.5", "10.0.0.53", 17,
              synth.udp(30000 + i, 53, synth.dns_query(i)),
              sport=30000 + i, dport=53)
        b.add(710_000 + i * 50_000, "10.0.0.53", "10.0.0.5", 17,
              synth.udp(53, 30000 + i, synth.dns_response(i, rcode=i % 3)),
              sport=53, dport=30000 + i)
        b.add(720_000 + i * 50_000, "10.0.0.6", "10.0.0.7", 17,
              synth.udp(50000, 443, synth.quic_long_header()), sport=50000,
              dport=443)
    b.add(2_000_000, "10.0.0.5", "10.0.0.9", 1, b"\x08\x00" + b"\x00" * 6)
    b.add(2_100_000, "2001:db8::1", "2001:db8::2", 6,
          synth.tcp(1234, 80, 0x12), claim_len=1500, sport=1234, dport=80)
    b.write(str(path))
    return b


def test_synth_builders_give_identical_bytes(tmp_path):
    for args in (("10.0.0.1", "10.0.0.2", 6, 20), ("1.2.3.4", "5.6.7.8", 17,
                                                    8, 9000)):
        assert tsynth.ipv4(*args) == jsynth.ipv4(*args)
    v6 = ("2001:db8::1", "2001:db8:0:0::2", 6, 20)
    assert tsynth.ipv6(*v6) == jsynth.ipv6(*v6)
    assert tsynth.ipv6(*v6, 1500) == jsynth.ipv6(*v6, 1500)
    assert tsynth.eth() == jsynth.eth() and \
        tsynth.eth(0x86DD) == jsynth.eth(0x86DD)
    for addr in ("2001:DB8:0::1", "10.0.0.1"):
        assert tsynth.canonical_ip(addr) == jsynth.canonical_ip(addr)
    assert tsynth.tcp(1, 2, 0x12) == jsynth.tcp(1, 2, 0x12)
    assert tsynth.udp(1, 2, b"xy") == jsynth.udp(1, 2, b"xy")
    assert tsynth.dns_query(7) == jsynth.dns_query(7)
    assert tsynth.dns_response(7, 3) == jsynth.dns_response(7, 3)
    assert tsynth.quic_long_header(2) == jsynth.quic_long_header(2)
    assert tsynth.heavy_entry("a", "b", 1, 2, 6) == \
        jsynth.heavy_entry("a", "b", 1, 2, 6)
    ours = _scenario_pcap(tsynth, tmp_path / "t.pcap")
    ref = _scenario_pcap(jsynth, tmp_path / "j.pcap")
    assert (tmp_path / "t.pcap").read_bytes() == \
        (tmp_path / "j.pcap").read_bytes()
    assert ours.flow_bytes == ref.flow_bytes and len(ours) == len(ref)
    assert ours.flow_packets == ref.flow_packets


@pytest.mark.parametrize("window_s", [0.1, 5.0])
def test_pcap_replay_evictions_are_equal(window_s, tmp_path, monkeypatch):
    _scenario_pcap(tsynth, tmp_path / "s.pcap")
    fetchers = []
    for mod in (treplay, jreplay):
        _pin_clocks(monkeypatch)
        fetchers.append(mod.PcapReplayFetcher(str(tmp_path / "s.pcap"),
                                              window_s=window_s))
    assert fetchers[0].n_windows == fetchers[1].n_windows >= 1
    total = 0
    while not fetchers[1].exhausted():
        a, b = (f.lookup_and_delete() for f in fetchers)
        _same_evictions(a, b)
        total += len(a)
    assert fetchers[0].exhausted() and total > 900
    assert len(fetchers[0].lookup_and_delete()) == 0
