"""The device timeline of `netobserv_tpu_torch/utils/tracing.py`
(`Timeline`, `PhaseLock`, `stage`, `timed`), its sites in the staging
rings and the exporter, and the profiler mirror of live spans, on the CPU.

A fake event class stands for CUDA's timing events: it takes the fake
device clock's time when recorded and is done when the test says so. The
partition is checked exactly: the test's clocks step in binary fractions,
so busy time plus the five phases add up to the timeline bit for bit."""

import threading
import time

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.sketch import staging as tstg
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import tracing
from tests.test_torch_resident import GEOM, _events

B = 512


class Clock:
    """A settable clock (the host's, or the fake device's)."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakeEvent:
    """A timing event on the fake device clock `DEVICE`: `done` unless the
    test holds it back; waiting on it fails the test."""

    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.t = None
        self.done = False

    def record(self, stream) -> None:
        self.t = DEVICE.t
        self.done = not HOLD[0]

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other) -> float:
        assert self.done and other.done
        return (other.t - self.t) * 1e3

    def synchronize(self):
        raise AssertionError("the timeline waited on an event")


DEVICE = Clock()
HOLD = [False]


@pytest.fixture
def tl():
    """A timeline of fake events on a fake host clock, tracing on."""
    DEVICE.t, HOLD[0], FakeEvent.made = 0.0, False, 0
    tracing.configure(1.0)
    host = Clock()
    t = tracing.Timeline(FakeEvent, clock=host)
    t.host = host
    yield t
    tracing.configure(0.0)


def _fold(tl, lock, host: list, device: tuple, pack=True) -> None:
    """One fold under `lock`, through the helpers the rings use: the lock
    taken at host[0], a pack from host[1] to host[2], the dispatch's
    events recorded at host[2] (device time device[0]) and host[3]
    (device[1]), the lock freed at host[4]."""
    tl.host.t = host[0]
    with lock:
        if pack:
            tl.host.t = host[1]
            with tracing.stage(tracing.NULL_TRACE, "resident_pack", tl):
                tl.host.t = host[2]
        with tracing.stage(tracing.NULL_TRACE, "ingest_dispatch", tl):
            DEVICE.t = device[0]
            with tracing.timed(tl, "ingest_dispatch"):
                tl.host.t = host[3]
                DEVICE.t = device[1]
        tl.host.t = host[4]


def _total(tl) -> float:
    return sum(tl.busy.values()) + sum(tl.idle.values())


def test_busy_and_the_five_phases_partition_the_timeline(tl):
    """Folds, a roll with a fold in its drain, and time with the lock
    free: busy plus pack, dispatch, roll, entry and caller equal the span
    from the first interval's start to the last one's end, exactly, and
    each phase holds what the host was doing over each idle gap."""
    lock = tracing.PhaseLock(tl)
    _fold(tl, lock, [1.0, 1.5, 2.0, 2.0, 2.5], (2.0, 3.0))
    # the card idles from 3.0 to 6.0; the host: caller to 4.0, entry to
    # 4.5, pack to 6.0
    _fold(tl, lock, [4.0, 4.5, 6.0, 6.0, 6.5], (6.0, 6.5))
    # a roll: its drain folds (pack 7.0-7.5), then its dispatch
    tl.host.t = 6.75
    with lock:
        tl.host.t = 7.0
        tl.push("roll")
        tl.push("pack")
        tl.host.t = 7.5
        tl.pop()
        with tracing.stage(tracing.NULL_TRACE, "ingest_dispatch", tl):
            DEVICE.t = 7.5
            with tracing.timed(tl, "ingest_dispatch"):
                DEVICE.t = 8.0
        tl.host.t = 8.25
        DEVICE.t = 8.25
        with tracing.timed(tl, "roll_dispatch"):
            DEVICE.t = 9.0
        tl.poll()
        tl.pop()
        tl.host.t = 9.5
    tl.host.t = 10.0
    tl.poll()
    assert tl.busy == {"ingest_dispatch": 2.0, "roll_dispatch": 0.75}
    assert tl.idle == {"caller": 1.25, "entry": 0.75, "pack": 2.0,
                       "roll": 0.25}
    assert _total(tl) == 9.0 - 2.0


def test_a_gap_is_placed_by_the_host_stamp_of_the_event_that_closes_it(tl):
    """A gap of 1.0 s of device time ends at the host stamp of the
    closing "before" event (10.0) and starts 1.0 s earlier, whatever the
    host did before 9.0: pack 9.0-9.5, entry 9.5-10.0."""
    lock = tracing.PhaseLock(tl)
    _fold(tl, lock, [1.0, 1.0, 1.0, 1.0, 1.0], (1.0, 2.0), pack=False)
    tl.host.t = 5.0
    with lock:
        tl.host.t = 6.0
        tl.push("pack")
        tl.host.t = 9.5
        tl.pop()
        tl.host.t = 10.0
        DEVICE.t = 3.0
        tl.begin("ingest_dispatch")
        DEVICE.t = 4.0
        tl.end()
    tl.poll()
    assert tl.idle == {"pack": 0.5, "entry": 0.5}
    assert _total(tl) == 4.0 - 1.0


def test_the_innermost_phase_wins_and_a_free_lock_is_the_caller(tl):
    """Inside a roll, a pack span's time is pack's; after it closes, the
    roll's; the lock freed, the caller's."""
    lock = tracing.PhaseLock(tl)
    _fold(tl, lock, [0.0, 0.0, 0.0, 0.0, 0.0], (0.0, 1.0), pack=False)
    with lock:
        tl.host.t = 1.0
        tl.push("roll")
        tl.host.t = 2.0
        tl.push("pack")
        tl.host.t = 4.0
        tl.pop()
        tl.host.t = 5.0
        tl.pop()
        tl.host.t = 6.0
    tl.host.t = 8.0
    with lock:
        DEVICE.t = 9.0
        tl.begin("ingest_dispatch")
        DEVICE.t = 10.0
        tl.end()
    tl.poll()
    # the gap 1.0-9.0 of device time ends at host 8.0: 0.0-1.0 entry
    # (the lock held since the first fold), 1-2 and 4-5 roll, 2-4 pack,
    # 5-6 entry, 6-8 caller
    assert tl.idle == {"entry": 1.0 + 1.0, "roll": 2.0, "pack": 2.0,
                       "caller": 2.0}
    assert _total(tl) == 10.0 - 0.0


def test_read_back_never_blocks(tl):
    """An interval whose closing event is not done stays for a later read
    (nothing waits on it), and the read then takes its gap too."""
    lock = tracing.PhaseLock(tl)
    _fold(tl, lock, [0.0, 0.0, 0.0, 0.0, 0.0], (0.0, 1.0), pack=False)
    HOLD[0] = True
    _fold(tl, lock, [2.0, 2.0, 2.0, 2.0, 2.0], (2.0, 3.0), pack=False)
    tl.poll()
    assert tl.busy == {"ingest_dispatch": 1.0}
    assert tl.idle == {}
    for iv in tl._open:
        iv[1].done = iv[3].done = True
    tl.poll()
    assert tl.busy == {"ingest_dispatch": 2.0}
    assert tl.idle == {"caller": 1.0}
    assert not tl._open


def test_the_event_pool_is_reused_and_does_not_grow(tl):
    """A thousand folds make three events; a device that falls behind
    until the pool is spent leaves the next intervals untimed, the pool at
    its bound, and the partition whole over what was timed."""
    lock = tracing.PhaseLock(tl)
    for i in range(1000):
        _fold(tl, lock, [2.0 * i] * 5, (2.0 * i, 2.0 * i + 1), pack=False)
    tl.poll()
    assert FakeEvent.made == tl.made == 3
    assert tl.busy == {"ingest_dispatch": 1000.0}
    assert _total(tl) == 2.0 * 999 + 1
    HOLD[0] = True
    for i in range(1000, 1100):
        _fold(tl, lock, [2.0 * i] * 5, (2.0 * i, 2.0 * i + 1), pack=False)
    assert tl.made == tl.POOL
    for iv in tl._open:
        if iv is not None:
            iv[1].done = iv[3].done = True
    HOLD[0] = False
    tl.poll()
    timed = (tl.POOL - 2) // 2
    assert tl.busy == {"ingest_dispatch": 1000.0 + timed}
    # the gaps around the untimed intervals are dropped
    assert _total(tl) == 2.0 * 999 + 1 + 1 + 2.0 * (timed - 1) + 1
    _fold(tl, lock, [2.0 * 1100] * 5, (2.0 * 1100, 2.0 * 1100 + 1),
          pack=False)
    tl.poll()
    assert tl.made == tl.POOL


def test_no_event_is_recorded_inside_a_capture():
    tracing.configure(1.0)
    try:
        t = tracing.Timeline(FakeEvent, capturing=lambda: True)
        FakeEvent.made = 0
        with tracing.timed(t, "roll_dispatch"):
            pass
        t.poll()
        assert FakeEvent.made == 0 and t.busy == {}
    finally:
        tracing.configure(0.0)


def test_a_captured_fold_times_its_graphs_replay(tl):
    """A captured fold with a timeline opens its interval just before the
    graph's replay and closes it just after, so the check of its binding
    ahead of the launch is the host's, not the device's; tracing off, it
    records nothing."""
    from netobserv_tpu_torch.sketch.capture import CapturedFold

    class Graph:
        def replay(self):
            DEVICE.t += 0.5

    fold = CapturedFold("fold_test", lambda *a: None)
    fold.graph, fold._device, fold.timeline = Graph(), -1, tl
    lock = tracing.PhaseLock(tl)
    for i in range(3):
        tl.host.t = DEVICE.t = float(i)
        with lock, tracing.stage(tracing.NULL_TRACE, "ingest_dispatch", tl):
            fold._replay()
    tl.poll()
    assert tl.busy == {"ingest_dispatch": 1.5}
    assert tl.idle == {"caller": 1.0}
    assert _total(tl) == 2.5
    tracing.configure(0.0)
    made = tl.made
    fold._replay()
    assert tl.made == made and not tl._open


def _ring(threads=2):
    return tstg.ShardedResidentStagingRing(
        B, slot_cap=1 << 12, device="cpu", lanes=2, ladder=(1, 2),
        pack_threads=threads)


def test_with_tracing_off_a_ring_fold_makes_no_event(monkeypatch):
    """TRACE_SAMPLE unset: a lane ring's fold on the CPU with a timeline
    bound records nothing (torch.cuda.Event raises if made); with tracing
    on, the same fold makes its events."""
    def no_event(*a, **kw):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    rng = np.random.default_rng(291)
    ring = _ring()
    ring.timeline = tracing.Timeline(
        lambda: torch.cuda.Event(enable_timing=True))
    state = ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
    ev, f = _events(rng, 3 * B)
    tracing.configure(0.0)
    ring.fold(state, ev, **f)
    assert ring.timeline.made == 0 and ring.chunks == 2
    tracing.configure(1.0)
    try:
        with pytest.raises(AssertionError, match="CUDA event"):
            ring.fold(state, ev, **f)
    finally:
        tracing.configure(0.0)
        ring.close()


def _annotations(prof) -> set:
    return {e.name for e in prof.events() if e.name.startswith("netobserv.")}


def test_the_profiler_shows_a_traced_folds_spans():
    """Under torch.profiler on the calling thread, a traced fold's spans
    open `netobserv.<stage>` ranges (not `pack_lane`, the native pack's
    time recorded after its call, which the profiler does not see); an
    unsampled fold opens none."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(292)
    ring = _ring()
    state = ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
    ev, f = _events(rng, B)
    tracing.configure(0.5)  # every second fold trace is sampled
    try:
        seen = []
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                ring.fold(state, ev, **f)
            seen.append(_annotations(prof))
    finally:
        tracing.configure(0.0)
        ring.close()
    assert seen[0] == set()
    assert seen[1] == {"netobserv.resident_pack", "netobserv.ingest_dispatch"}


def test_pack_lane_spans_time_each_regions_pack():
    """A traced lane fold records one `pack_lane` span a packed region of
    each chunk into `stage_seconds`: with two pack threads and the native
    packer, each region's pack time on its native thread, recorded by the
    folding thread after the segment's one call, inside the segment's
    `resident_pack` span."""
    rng = np.random.default_rng(293)
    ring = _ring()
    state = ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
    ev, f = _events(rng, 3 * B)  # chunks of k = 2 and k = 1
    tracing.configure(1.0)
    try:
        trace = tracing.start_trace("fold")
        ring.fold(state, ev, trace=trace, **f)
        trace.finish()
    finally:
        tracing.configure(0.0)
        ring.close()
    lanes = [s for s in trace.spans if s.stage == "pack_lane"]
    assert len(lanes) == sum(k * 2 * n for k, n in
                             ring.superbatch_folds.items())
    assert set(ring.superbatch_folds) == {1, 2}
    assert ring.native_segments == ring.chunks == 2
    assert {s.thread for s in lanes} == {threading.current_thread().name}
    packs = [s for s in trace.spans if s.stage == "resident_pack"]
    assert all(any(p.t0 <= s.t0 <= s.t1 <= p.t1 for p in packs)
               for s in lanes)


class HostEvent:
    """A timing event whose device time is the host clock when recorded
    (a device that runs each command at once); `stamps` keeps every
    record's time."""

    stamps: list = []

    def __init__(self):
        self.t = None

    def record(self, stream) -> None:
        self.t = time.perf_counter()
        HostEvent.stamps.append(self.t)

    def query(self) -> bool:
        return True

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def test_the_exporter_times_its_folds_and_rolls(monkeypatch):
    """An exporter whose timeline has host-clock events (the CPU stands
    in for the card): its folds and rolls feed both families of its
    metrics as the timeline sums them, the idle time falls in the pack,
    entry, roll and caller phases, and busy plus idle spans the timeline
    from the first fold's start to the last roll's end."""
    made = []

    def timeline(device):
        t = tracing.Timeline(HostEvent)
        made.append(t)
        return t

    monkeypatch.setattr(tracing, "device_timeline", timeline)
    HostEvent.stamps = []
    tm = Metrics()
    tracing.configure(1.0)
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", pack_threads=2, superbatch=(1, 2),
                              resident_slots=1 << 12, metrics=tm,
                              sink=lambda obj: None)
    try:
        rng = np.random.default_rng(294)
        for n in (300, 2 * B + 9, B, 700):
            ev, f = _events(rng, n)
            exp.export_evicted(EvictedFlows(ev, **f))
        exp.flush()
        ev, f = _events(rng, B)
        exp.export_evicted(EvictedFlows(ev, **f))
        exp.flush()
    finally:
        tracing.configure(0.0)
        exp.close()
    (tl,) = made
    assert isinstance(exp._lock, tracing.PhaseLock)
    assert exp.ring.timeline is tl
    assert set(tl.busy) == {"ingest_dispatch", "roll_dispatch"}
    assert {"pack", "entry", "roll"} <= set(tl.idle) <= set(
        tracing.PHASES.values()) | {"entry", "caller"}
    for fam, got in ((tm.device_busy_seconds_total, tl.busy),
                     (tm.device_idle_seconds_total, tl.idle)):
        for k, v in got.items():
            assert fam.labels(k)._value.get() == pytest.approx(v, rel=1e-9)
    # every interval was read at the last roll, its own included
    assert not tl._open
    stamps = HostEvent.stamps
    assert _total(tl) == pytest.approx(stamps[-1] - stamps[0], rel=1e-9)
    # the last read's end, a dispatch's copy and fold, the roll's
    assert tl.made <= 1 + 4 + 2


def test_the_timeline_families():
    """Both families are counters labelled by span and by phase."""
    m = Metrics()
    for name, label in (("device_busy_seconds_total", "span"),
                        ("device_idle_seconds_total", "phase")):
        fam = getattr(m, name)
        assert type(fam).__name__ == "Counter"
        assert fam._name == "ebpf_agent_" + name[:-len("_total")]
        assert fam._labelnames == (label,)
