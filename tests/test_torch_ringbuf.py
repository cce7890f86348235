"""The port's ring-buffer fallback (netobserv_tpu_torch/flow/
ringbuf_tracer.py, flow/accounter.py, the agent's ENABLE_FLOWS_RINGBUF_
FALLBACK branch and the `ringbuf_events_total` family) against the JAX
package's, on the CPU.

- The same single-packet events through each package's `RingBufTracer`
  and `Accounter` (one clock pinned for both) give the same evictions of
  the same records, whether the accounter evicts on `max_entries` or on
  `stop`; every flow's bytes and packets are the injected sums.
- An event of the wrong size is logged and skipped, never fatal (the
  reference's `tests/test_supervision.py:509`), and each stage's fault
  point (`ringbuf_tracer.read`, `accounter.loop`) gets a supervisor
  restart.
- The agent with the fallback re-aggregates singles into a collecting
  exporter as the reference's `tests/test_pipeline.py:79` requires, and
  its health snapshot is the reference agent's.
- The accounters' records through the port's `TorchSketchExporter` on the
  CPU and the JAX `TpuSketchExporter` give equal `state_tables`, bit for
  bit (integer masses: 40-79 bytes a packet).

Every test joins the threads it starts and waits at most 10 s on any
condition."""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.flow import Accounter as JAccounter
from netobserv_tpu.flow import RingBufTracer as JRingBufTracer
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.sketch import state as js
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu_torch.agent import Status
from netobserv_tpu_torch.datapath import fetcher as tfetch
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.flow import Accounter, RingBufTracer
from netobserv_tpu_torch.metrics import registry as treg
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject
from tests.test_torch_agent import (
    _agents, _Collect, _health, _reset_globals, _start, wait_for,
)
from tests.test_torch_staging import GEOM

# injected crashes are unhandled thread exceptions: the scenario under test
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

FALLBACK = {"ENABLE_FLOWS_RINGBUF_FALLBACK": "true"}


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    _reset_globals()
    time.sleep(0.05)


class _PinnedClock:
    """`MonotonicClock` at one (mono, wall) pair, for both packages."""

    def now_pair(self):
        return 5_000_000_000_000, 1_700_000_000_000_000_000


def singles(rng: np.random.Generator, n: int, n_flows: int,
            s: float = 1.1) -> np.ndarray:
    """`n` single-packet flow events over `n_flows` zipf-skewed (`s`) v4
    flows: 40-79 bytes, one packet, a TCP flag or none, rising monotonic
    times, an interface of three and set MACs, as the datapath sends them
    over the ring buffer when its map is full."""
    keys = np.zeros(n_flows, binfmt.FLOW_KEY_DTYPE)
    for side in ("src_ip", "dst_ip"):
        keys[side][:, 10:12] = 0xFF
        keys[side][:, 12:] = rng.integers(0, 256, (n_flows, 4))
    keys["src_port"] = rng.integers(1024, 65536, n_flows)
    keys["dst_port"] = rng.choice([53, 80, 443, 8080], n_flows)
    keys["proto"] = rng.choice([6, 17], n_flows)
    weights = 1.0 / np.arange(1, n_flows + 1) ** s
    ranks = rng.choice(n_flows, n, p=weights / weights.sum())
    ev = np.zeros(n, binfmt.FLOW_EVENT_DTYPE)
    ev["key"] = keys[ranks]
    st = ev["stats"]
    st["bytes"] = rng.integers(40, 80, n)
    st["packets"] = 1
    st["tcp_flags"] = rng.choice([0, 0x02, 0x10, 0x12, 0x18], n)
    st["first_seen_ns"] = 10**12 + np.cumsum(rng.integers(1, 1000, n))
    st["last_seen_ns"] = st["first_seen_ns"]
    st["eth_protocol"] = 0x0800
    st["if_index_first"] = rng.integers(1, 4, n)
    st["direction_first"] = rng.integers(0, 2, n)
    st["src_mac"] = rng.integers(1, 256, (n, 6))
    st["dst_mac"] = rng.integers(1, 256, (n, 6))
    return ev


def flow_sums(events: np.ndarray) -> dict:
    """key bytes -> (bytes, packets) summed over `events`."""
    out: dict = {}
    for e in events:
        k = e["key"].tobytes()
        b, p = out.get(k, (0, 0))
        out[k] = (b + int(e["stats"]["bytes"]), p + int(e["stats"]["packets"]))
    return out


def record_sums(batches) -> dict:
    """The same sums over evicted records (their keys as event keys)."""
    out: dict = {}
    for recs in batches:
        for r in recs:
            k = _key_bytes(r.key)
            b, p = out.get(k, (0, 0))
            out[k] = (b + r.bytes_, p + r.packets)
    return out


def _key_bytes(key) -> bytes:
    k = np.zeros(1, binfmt.FLOW_KEY_DTYPE)
    k["src_ip"] = np.frombuffer(key.src_ip, np.uint8)
    k["dst_ip"] = np.frombuffer(key.dst_ip, np.uint8)
    k["src_port"], k["dst_port"] = key.src_port, key.dst_port
    k["proto"] = key.proto
    k["icmp_type"], k["icmp_code"] = key.icmp_type, key.icmp_code
    return k[0].tobytes()


def _drain(q) -> list:
    items = []
    while not q.empty():
        items.append(q.get_nowait())
    return items


def _fallback_run(pkg: str, events: np.ndarray, max_entries: int) -> tuple:
    """`events` through one package's tracer and accounter (evicting on
    `max_entries`, the timeout a minute away), stopped once the tracer
    took them all: (the evictions, the metrics, the flusher's calls)."""
    if pkg == "port":
        fetch, tracer_cls, acc_cls = tfetch, RingBufTracer, Accounter
        metrics = treg.Metrics()
    else:
        fetch, tracer_cls, acc_cls = jfetch, JRingBufTracer, JAccounter
        metrics = jreg.Metrics(jreg.MetricsSettings())
    fake = fetch.FakeFetcher()
    for e in events:
        fake.inject_ringbuf(e.tobytes())
    rb_q, out = queue.Queue(maxsize=len(events) + 1), queue.Queue()
    flushes = []
    tracer = tracer_cls(fake, rb_q, flusher=lambda: flushes.append(1),
                        metrics=metrics, poll_timeout_s=0.05)
    acc = acc_cls(rb_q, out, max_entries=max_entries, evict_timeout_s=60.0,
                  agent_ip="10.1.2.3", metrics=metrics)
    acc._clock = _PinnedClock()
    acc.start()
    tracer.start()
    try:
        wait_for(lambda: metrics.ringbuf_events_total._value.get()
                 == len(events) and rb_q.empty(), msg="the tracer")
    finally:
        tracer.stop()
        acc.stop()
    assert not tracer._thread.is_alive() and not acc._thread.is_alive()
    return _drain(out), metrics, len(flushes)


def test_ringbuf_events_family_equals_the_reference():
    got = treg.Metrics().ringbuf_events_total
    want = jreg.Metrics(jreg.MetricsSettings()).ringbuf_events_total
    assert type(got).__name__ == type(want).__name__
    for attr in ("_name", "_documentation", "_labelnames", "_type",
                 "_unit"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("max_entries", [64, 5000])
def test_tracer_and_accounter_give_the_reference_records(max_entries):
    """2,000 singles over 300 flows: evictions of at most `max_entries`
    flows (64: on `max_entries`, many; 5,000: one, at `stop`), record for
    record the reference's, their sums the injected ones."""
    events = singles(np.random.default_rng(max_entries), 2000, 300)
    ours, tm, t_flushes = _fallback_run("port", events, max_entries)
    ref, jm, j_flushes = _fallback_run("reference", events, max_entries)
    assert [len(b) for b in ours] == [len(b) for b in ref]
    assert (len(ours) > 10) == (max_entries == 64) and len(ours) >= 1
    assert max(len(b) for b in ours) <= max_entries
    for a, b in zip(ours, ref):
        assert [dataclasses.asdict(x) for x in a] == \
            [dataclasses.asdict(y) for y in b]
    assert record_sums(ours) == flow_sums(events)
    assert t_flushes == j_flushes == len(events)
    assert tm.evictions_total.labels("accounter")._value.get() == len(ours)
    assert tm.evicted_flows_total.labels("accounter")._value.get() == \
        jm.evicted_flows_total.labels("accounter")._value.get() == \
        sum(len(b) for b in ours)
    rec = ours[0][0]
    assert rec.agent_ip == "10.1.2.3" and rec.packets >= 1


def test_a_full_queue_drops_and_counts_as_the_reference():
    """A tracer whose queue is full logs and drops the event; an accounter
    whose evicted queue is full counts the eviction's records dropped
    under "accounter", in both packages."""
    events = singles(np.random.default_rng(3), 6, 6)
    for fetch, tracer_cls, acc_cls, metrics in (
            (tfetch, RingBufTracer, Accounter, treg.Metrics()),
            (jfetch, JRingBufTracer, JAccounter,
             jreg.Metrics(jreg.MetricsSettings()))):
        fake = fetch.FakeFetcher()
        for e in events:
            fake.inject_ringbuf(e.tobytes())
        rb_q = queue.Queue(maxsize=2)
        tracer = tracer_cls(fake, rb_q, metrics=metrics, poll_timeout_s=0.05)
        tracer.start()
        try:
            wait_for(lambda: metrics.ringbuf_events_total._value.get() == 6,
                     msg="the tracer")
        finally:
            tracer.stop()
        assert rb_q.qsize() == 2
        out = queue.Queue(maxsize=1)
        out.put([])
        acc = acc_cls(rb_q, out, metrics=metrics)
        for _ in range(2):
            acc._account(rb_q.get_nowait())
        acc._evict()
        assert metrics.dropped_flows_total.labels(
            "accounter")._value.get() == 2
        assert metrics.evicted_flows_total.labels(
            "accounter")._value.get() == 2


def test_a_wrong_size_event_is_skipped_not_fatal(caplog):
    """A short event (and the `corrupt` fault's mangled one) is logged and
    skipped: no count, no flush, no queue entry; the next good event
    goes through."""
    fake = tfetch.FakeFetcher()
    metrics = treg.Metrics()
    rb_q, flushes = queue.Queue(), []
    tracer = RingBufTracer(fake, rb_q, flusher=lambda: flushes.append(1),
                           metrics=metrics, poll_timeout_s=0.05)
    event = singles(np.random.default_rng(4), 1, 1)[0].tobytes()
    with caplog.at_level(logging.WARNING):
        fake.inject_ringbuf(event[:100])
        tracer.start()
        try:
            wait_for(fake._ringbuf.empty, msg="the short event")
            time.sleep(0.1)
            assert metrics.ringbuf_events_total._value.get() == 0
            faultinject.arm("ringbuf_tracer.read", "corrupt", times=1)
            fake.inject_ringbuf(event)
            wait_for(lambda: faultinject.hits.get("ringbuf_tracer.read", 0)
                     >= 1, msg="the corrupt fault")
            fake.inject_ringbuf(event)
            wait_for(lambda: metrics.ringbuf_events_total._value.get() == 1,
                     msg="the good event")
        finally:
            tracer.stop()
    assert not tracer._thread.is_alive()
    assert rb_q.qsize() == 1 and len(flushes) == 1
    assert rb_q.get_nowait().tobytes() == event
    assert any("bad ringbuf event size 100" in r.getMessage()
               for r in caplog.records)


def test_a_corrupt_ringbuf_event_is_not_fatal_in_the_agent():
    """The reference's tests/test_supervision.py:509 on the port's agent:
    the mangled event takes the bad-size path and the tracer stage keeps
    running, unrestarted."""
    ours, _ = _agents(FALLBACK)
    stop, t = _start(ours)
    try:
        faultinject.arm("ringbuf_tracer.read", "corrupt", times=1)
        ours.fetcher.inject_ringbuf(singles(np.random.default_rng(5), 1, 1))
        wait_for(lambda: faultinject.hits.get("ringbuf_tracer.read", 0) >= 1,
                 msg="corrupt fault to fire")
        time.sleep(0.3)
        snap = ours.supervisor.snapshot()["ringbuf-tracer"]
        assert snap["state"] == "Running" and snap["restarts"] == 0
        assert ours.metrics.ringbuf_events_total._value.get() == 0
    finally:
        faultinject.clear()
        stop.set()
        t.join(timeout=10)
    assert ours.status == Status.STOPPED


@pytest.mark.parametrize("stage,point", [
    ("accounter", "accounter.loop"),
    ("ringbuf-tracer", "ringbuf_tracer.read")])
def test_fallback_fault_points_restart_through_the_supervisor(stage, point):
    """An injected crash at each fallback stage's fault point restarts the
    stage (tests/test_supervision.py's STAGES); the agent stays
    Started."""
    ours, _ = _agents(FALLBACK)
    stop, t = _start(ours)
    try:
        faultinject.arm(point, "crash", times=1)
        wait_for(lambda: faultinject.hits.get(point, 0) >= 1,
                 msg=f"{point} to fire")
        wait_for(lambda: ours.supervisor.snapshot()[stage]["restarts"] >= 1
                 and ours.supervisor.snapshot()[stage]["state"] == "Running",
                 msg=f"{stage} restart")
        assert ours.supervisor.snapshot()[stage]["last_failure"] == "crash"
        assert ours.status == Status.STARTED
    finally:
        faultinject.clear()
        jfault.clear()
        stop.set()
        t.join(timeout=10)
    assert ours.status == Status.STOPPED


def test_the_agent_reaggregates_ringbuf_singles():
    """tests/test_pipeline.py:79 on the port: two singles of one flow,
    queued before the agent starts, leave the accounter as one record of
    their summed bytes and packets; both agents register the two stages
    and their health snapshots are equal."""
    ours, ref = _agents({**FALLBACK, "CACHE_ACTIVE_TIMEOUT": "2s",
                         "SUPERVISOR_HEARTBEAT_TIMEOUT": "5m"})
    assert _health(ours) == _health(ref)
    assert {"accounter", "ringbuf-tracer"} <= set(
        ours.health_snapshot()["stages"])
    assert ours.accounter._max == ours.cfg.cache_max_flows == 5000
    assert ours.accounter._timeout == 2.0
    assert ours.rb_tracer._flusher == ours.map_tracer.flush
    assert ours._rb_q.maxsize == 10 * ours.cfg.buffers_length
    ev = np.zeros(1, binfmt.FLOW_EVENT_DTYPE)
    ev["key"]["src_ip"][0, 10:] = [0xFF, 0xFF, 10, 0, 0, 1]
    ev["key"]["dst_ip"][0, 10:] = [0xFF, 0xFF, 10, 0, 0, 2]
    ev["key"]["src_port"], ev["key"]["dst_port"] = 1000, 443
    ev["key"]["proto"] = 6
    ev["stats"]["bytes"], ev["stats"]["packets"] = 40, 2
    ev["stats"]["first_seen_ns"] = time.clock_gettime_ns(
        time.CLOCK_MONOTONIC) - 10**9
    ev["stats"]["last_seen_ns"] = ev["stats"]["first_seen_ns"] + 10**6
    ours.fetcher.inject_ringbuf(ev)
    ours.fetcher.inject_ringbuf(ev)
    stop, t = _start(ours)
    try:
        wait_for(lambda: any(r.packets for b in ours.exporter.batches
                             for r in b), msg="the accounter's eviction")
        merged = [r for b in ours.exporter.batches for r in b if r.packets]
        assert len(merged) == 1
        assert merged[0].bytes_ == 80 and merged[0].packets == 4
        assert merged[0].key.src_port == 1000
        assert ours.metrics.ringbuf_events_total._value.get() == 2
    finally:
        stop.set()
        t.join(timeout=10)
    assert ours.status == Status.STOPPED


def test_fallback_records_fold_to_the_reference_tables():
    """The records each package's accounter evicted (1,500 singles over
    400 flows, evictions of at most 128) through the port's exporter on
    the CPU and the JAX one (the JAX package's plain folds, shown one
    device) by `export_batch`, batch 512: the pre-roll `state_tables` are
    equal bit for bit, as are the closed windows' records and bytes."""
    events = singles(np.random.default_rng(9), 1500, 400)
    ours, _, _ = _fallback_run("port", events, 128)
    ref, _, _ = _fallback_run("reference", events, 128)
    reports, jreports = [], []
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=512,
                              device="cpu", pack_threads=1, superbatch=(1,),
                              window_s=3600.0, sink=reports.append)
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        jexp = TpuSketchExporter(
            batch_size=512, window_s=3600.0,
            sketch_cfg=js.SketchConfig(**GEOM, use_pallas=False),
            sink=jreports.append, pack_threads=1)
    finally:
        jax.devices = devices
    try:
        for a, b in zip(ours, ref):
            exp.export_batch(a)
            jexp.export_batch(b)
        with exp._lock:
            exp._drain_pending()
            got = ts.state_tables(exp.state)
        with jexp._lock:
            jexp._drain_pending_locked()
            want = {k: np.asarray(v)
                    for k, v in js.state_tables(jexp._state).items()}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        exp.flush()
        jexp.flush()
    finally:
        exp.close()
        jexp.close()
    assert [(r["Records"], r["Bytes"]) for r in reports[:1]] == \
        [(r["Records"], r["Bytes"]) for r in jreports[:1]] == \
        [(float(sum(len(b) for b in ours)),
          float(events["stats"]["bytes"].sum()))]


@pytest.fixture(scope="module")
def contended_records():
    """The fallback's contended records (2,400 singles over 600 flows,
    evictions of at most 128), as each package's accounter evicts them."""
    events = singles(np.random.default_rng(14), 2400, 600)
    ours, _, _ = _fallback_run("port", events, 128)
    ref, _, _ = _fallback_run("reference", events, 128)
    return ours, ref, events


def _routed_pair(mode: str) -> tuple:
    """The port's exporter on the CPU and the JAX one in `mode`: three
    tenants (the JAX exporter shown one device while it is made), or a
    2x1 or 1x2 mesh (the port's on the CPU repeated, the JAX one's on
    two of the 8 virtual CPU devices)."""
    kw = dict(batch_size=512, window_s=3600.0, sink=lambda r: None)
    jcfg = js.SketchConfig(**GEOM, use_pallas=False)
    if mode == "tenants":
        exp = TorchSketchExporter(ts.SketchConfig(**GEOM), device="cpu",
                                  pack_threads=1, tenants=3, **kw)
        devices = jax.devices
        jax.devices = lambda *a, **k: devices(*a, **k)[:1]
        try:
            jexp = TpuSketchExporter(sketch_cfg=jcfg, pack_threads=1,
                                     tenants=3, **kw)
        finally:
            jax.devices = devices
        assert jexp._tenancy is not None
        return exp, jexp
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), device="cpu",
                              devices=["cpu"] * 2, mesh_shape=mode,
                              pack_threads=2, **kw)
    jexp = TpuSketchExporter(sketch_cfg=jcfg, mesh_shape=mode,
                             pack_threads=2, feed="dense", **kw)
    assert jexp._distributed and exp.mesh is not None
    return exp, jexp


@pytest.mark.parametrize("mode", ["tenants", "2x1", "1x2"])
def test_records_fold_to_the_reference_tables_in_tenant_and_mesh_modes(
        contended_records, mode):
    """Fault C14: the same contended records through both exporters'
    `export_batch` with tenants=3 and on a 2x1 and a 1x2 mesh, one window
    rolled between two halves of them: the second window's pre-roll
    tables are the reference's bit for bit (each tenant's `state_tables`;
    on a mesh every shard's leaves, the rolled EWMA baselines within
    `tests/test_torch_mesh`'s bound), and the first window's records and
    bytes are too."""
    from netobserv_tpu.sketch import tenancy as jten
    from tests.test_torch_mesh import _assert_dist
    ours, ref, _ = contended_records
    exp, jexp = _routed_pair(mode)
    reports, jreports = [], []
    exp.sink, jexp._sink = reports.append, jreports.append
    half = len(ours) // 2
    try:
        for part in (slice(0, half), slice(half, None)):
            if part.start:
                exp.flush()
                jexp.flush()
            for a, b in zip(ours[part], ref[part]):
                exp.export_batch(a)
                jexp.export_batch(b)
        with exp._lock:
            exp._drain_pending()
        with jexp._lock:
            jexp._drain_pending_locked()
        if mode == "tenants":
            for t, (g, w) in enumerate(zip(exp.state_tables(),
                                           jten.split_tenants(jexp._state,
                                                              3))):
                w = js.state_tables(w)
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                                  err_msg=f"t={t} {k}")
        else:
            _assert_dist(exp.state, jexp._state, mode)
            assert exp.ring is None  # records never reach the ring
        assert exp.records == sum(len(b) for b in ours)
    finally:
        exp.close()
        jexp.close()
    n = 3 if mode == "tenants" else 1  # the first window's reports
    per = [(r["Records"], r["Bytes"]) for r in reports[:n]]
    assert per == [(r["Records"], r["Bytes"]) for r in jreports[:n]]
    assert sum(r for r, _ in per) == float(sum(len(b) for b in ours[:half]))
