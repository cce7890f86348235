"""The port's overload control (netobserv_tpu_torch/sketch/overload.py, the
slot-wait budget and `StagingWedged` of sketch/staging.py, the exporter's
admission seam, config.OverloadSettings) against the JAX package's, on the
CPU.

- The controller: one seeded sequence of `update`/`window_roll` calls
  gives the reference's factors, snapshots and gauge; `admit` keeps the
  same rows for one seed, lanes included, a short lane thinned over its
  prefix.
- The exporter seam against the JAX `TpuSketchExporter` on the resident
  feed (2 lanes): no controller, and a controller armed but idle, give
  the same tables bit for bit; so does a shed pinned at 4 with
  `shed_seed=1`; and so does a wedge on the first and on a later chunk of
  a multi-chunk fold, made with a never-ready stand-in for the slot's copy
  event in the port (`ring._copied`) and for the slot's token in the
  reference (`ring._tokens`), both at the ladder (1,) so a 4-batch arrival
  folds as four chunks in either. Masses are integer-valued with per-cell
  sums below 2^24; the RTT and DNS histograms are held to the bound of
  tests/test_torch_staging.py (ROADMAP C5).
- The port alone: a wedge returns within its budget, is counted without
  a dictionary epoch roll, leaves the stand-in in place and the feed
  folding on; the dense and compact rings raise it before they pack; a
  healthy feed of large arrivals does not shed; an overdriven one sheds,
  reports OVERLOADED in `query_status` and the frames' telemetry, and
  recovers within a clean window; the port's aggregator counts an
  overloaded agent's frame.

Every thread joined, no wait past 15 s. Sizes: B = 512 at the staging
tests' geometry; B = 256 at a smaller one for the port-only tests."""

import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu import config as jconfig
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.model import binfmt as jbinfmt
from netobserv_tpu.sketch import overload as joverload
from netobserv_tpu.sketch import state as js
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.sketch import overload, staging
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject
from tests.test_torch_staging import B, GEOM, _assert_tables, _feed, _Samples

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

SMALL = dict(cm_depth=2, cm_width=1 << 10, hll_precision=6,
             perdst_buckets=32, perdst_precision=4, persrc_buckets=32,
             persrc_precision=4, topk=16, hist_buckets=64, ewma_buckets=32)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()


def wait_for(pred, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _value(metric) -> float:
    return metric._value.get()


class NeverReady:
    """A slot token that never completes: the port's copy event
    (`query`) and the reference's ingest token (`is_ready`)."""

    def query(self):
        return False

    def is_ready(self):
        return False

    def synchronize(self):
        raise AssertionError("a budgeted wait never synchronizes")


def jax_exporter(sink=None, warm=True, **kw):
    """The reference exporter on one device at the staging tests' geometry
    (tests/test_torch_window.py `_jax_exporter`); `warm` warms its
    ladder."""
    jm = jreg.Metrics(jreg.MetricsSettings())
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    kw = {"superbatch": (1, 2), **kw}
    try:
        jexp = TpuSketchExporter(
            batch_size=B, window_s=3600.0,
            sketch_cfg=js.SketchConfig(**GEOM, use_pallas=False),
            sink=sink or (lambda obj: None), metrics=jm, pack_threads=2,
            resident_slots=1 << 12, **kw)
    finally:
        jax.devices = devices
    assert not jexp._distributed
    if warm:
        jexp.warm_superbatch_ladder(block=True)
    return jexp, jm


def port_exporter(sink=None, **kw):
    tm = Metrics()
    kw = {"superbatch": (1, 2), **kw}
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", pack_threads=2,
                              resident_slots=1 << 12, metrics=tm,
                              sink=sink or (lambda obj: None), **kw)
    return exp, tm


def small_exporter(**kw):
    """A port exporter at the small geometry, B = 256, one lane."""
    kw = {"batch_size": 256, "pack_threads": 1, "superbatch": (1,),
          "sink": lambda obj: None, **kw}
    return TorchSketchExporter(ts.SketchConfig(**SMALL), device="cpu", **kw)


def drain_jax(jexp):
    with jexp._lock:
        jexp._drain_pending_locked()
    jexp._ring.drain()


def pin(exp_or_ctl, factor: int, pressured: bool = False):
    """Pin a controller's factor for a whole run (the reference test's
    pin: a live controller adapts to timing); `pressured` has each update
    count as pressure, so a roll keeps the factor."""
    ctl = getattr(exp_or_ctl, "_overload", exp_or_ctl)
    ctl.shed = factor

    def update(*a, **k):
        ctl._pressured_since_roll = ctl._pressured_since_roll or pressured
        return factor

    ctl.update = update


def feed_both(exp, jexp, feed):
    samples = _Samples()
    for ev, f in feed:
        samples.add(f)
        exp.export_evicted(EvictedFlows(ev.copy(), **f))
        jexp.export_evicted(jfetch.EvictedFlows(ev.copy(), **f))
    exp._drain_pending()
    drain_jax(jexp)
    return samples


# ----------------------------------------------------------- controller


def test_controller_schedule_equals_the_reference():
    """One seeded sequence of pressure observations and window rolls: the
    port's factor, snapshot and gauge after every call equal the
    reference's."""
    tm, jm = Metrics(), jreg.Metrics(jreg.MetricsSettings())
    ctl = overload.OverloadController(256, 2.0, shed_max=16, metrics=tm)
    ref = joverload.OverloadController(256, 2.0, shed_max=16, metrics=jm)
    rng = np.random.default_rng(11)
    for step in range(300):
        if rng.random() < 0.1:
            ctl.window_roll()
            ref.window_roll()
            got = want = None
        else:
            pending = int(rng.integers(0, 8 * 256))
            wait = float(rng.choice([0.0, 0.0, 0.01, 0.3, 0.7]))
            busy = float(rng.choice([0.0, 0.3, 1.0, 1.4, -0.2]))
            got = ctl.update(pending, wait, busy=busy)
            want = ref.update(pending, wait, busy=busy)
        assert got == want, step
        assert ctl.snapshot() == ref.snapshot(), step
        assert ctl.overloaded == ref.overloaded
        assert _value(tm.sketch_shed_factor) == _value(jm.sketch_shed_factor)
    assert ctl.shed_max == ref.shed_max == 16
    assert overload.SLOT_WAIT_REF_S == joverload.SLOT_WAIT_REF_S
    assert overload._LANES == joverload._LANES


def test_disabled_gate_returns_none():
    for wm in (0, 0.0, -1.0):
        assert overload.maybe_controller(256, wm, 64) is None
        assert joverload.maybe_controller(256, wm, 64) is None
    assert overload.maybe_controller(256, 2.0, 64) is not None
    with pytest.raises(ValueError):
        overload.OverloadController(256, 0.0)


def _admit_input(n, rng):
    ev = np.zeros(n, binfmt.FLOW_EVENT_DTYPE)
    ev["key"]["src_port"] = np.arange(n)
    ev["stats"]["bytes"] = rng.integers(1, 1000, n)
    samp = ev["stats"]["sampling"]
    samp[: n // 3] = 0
    samp[n // 3: 2 * n // 3] = 3
    samp[2 * n // 3:] = 1
    extra = np.zeros(n, binfmt.EXTRA_REC_DTYPE)
    extra["rtt_ns"] = np.arange(n)
    dns = np.zeros(n // 2, binfmt.DNS_REC_DTYPE)  # a short lane
    dns["dns_id"] = np.arange(n // 2)
    quic = np.zeros(n, binfmt.QUIC_REC_DTYPE)
    nevents = np.arange(n, dtype=np.uint32)
    return ev, dict(extra=extra, dns=dns, quic=quic, nevents=nevents)


@pytest.mark.parametrize("factor,seed", [(2, 1), (4, 11), (64, 2026)])
def test_admit_keeps_the_reference_rows(factor, seed):
    """For one seed the port keeps exactly the reference's rows: the
    events with the factor multiplied into `sampling` (0 counting as 1),
    every lane thinned with them (the short one over its prefix), the
    counters, the decode stats and the trace carried over; the source
    eviction untouched."""
    rng = np.random.default_rng(seed)
    tm, jm = Metrics(), jreg.Metrics(jreg.MetricsSettings())
    ctl = overload.OverloadController(256, 1.0, shed_max=64, seed=seed,
                                      metrics=tm)
    ref = joverload.OverloadController(256, 1.0, shed_max=64, seed=seed,
                                       metrics=jm)
    for c in (ctl, ref):
        pin(c, factor)
    trace = object()
    for n in (513, 1, 0, 2048):
        ev, lanes = _admit_input(n, rng)
        src = ev.copy()
        tev = EvictedFlows(ev.copy(), **lanes)
        jev = jfetch.EvictedFlows(ev.copy(), **lanes)
        for e in (tev, jev):
            e.decode_stats = {"decode_s": 0.5}
            e.trace = trace
        got, want = ctl.admit(tev), ref.admit(jev)
        if n == 0:
            assert got is tev and want is jev
            continue
        assert isinstance(got, EvictedFlows)
        np.testing.assert_array_equal(got.events.view(np.uint8),
                                      want.events.view(np.uint8))
        for name in overload._LANES:
            g, w = getattr(got, name, None), getattr(want, name, None)
            assert (g is None) == (w is None), name
            if w is not None:
                np.testing.assert_array_equal(g, w, err_msg=name)
        assert got.decode_stats == {"decode_s": 0.5}
        assert got.trace is trace
        np.testing.assert_array_equal(tev.events.view(np.uint8),
                                      src.view(np.uint8))
    assert ctl.snapshot() == ref.snapshot()
    assert ctl.shed_rows > 0
    for fam in ("sketch_shed_rows_total", "sketch_shed_batches_total"):
        assert _value(getattr(tm, fam)) == _value(getattr(jm, fam)), fam


def test_admit_identity_at_factor_one_and_fault_point_per_batch():
    ctl = overload.OverloadController(256, watermark=2.0)
    ev = EvictedFlows(np.zeros(16, binfmt.FLOW_EVENT_DTYPE))
    assert ctl.admit(ev) is ev  # no copy below the watermark
    pin(ctl, 2)
    faultinject.arm("sketch.overload_shed", "delay", 0.0)
    ctl.admit(ev)
    ctl.admit(ev)
    assert faultinject.hits.get("sketch.overload_shed") == 2
    assert jfault.hits.get("sketch.overload_shed", 0) == 0


# ------------------------------------------------------- exporter seam


@pytest.mark.parametrize("kw", [{}, {"shed_watermark": 1e9}],
                         ids=["disabled", "idle"])
def test_unshedded_exporter_equals_the_reference(kw):
    """No controller (no RNG, no budget on the ring), and a controller
    armed but never crossing its watermark, fold the same tables as the
    reference exporter does, bit for bit."""
    rng = np.random.default_rng(200)
    feed = [_feed(rng, n, n_distinct=600)
            for n in (300, 3 * B + 40, B, 2 * B, 700, 4 * B + 1, 90)]
    exp, tm = port_exporter(**kw)
    jexp, jm = jax_exporter(**kw)
    try:
        samples = feed_both(exp, jexp, feed)
        if kw:
            assert exp.ring.slot_wait_budget_s == 30.0
            assert exp.overload_snapshot()["shed_rows"] == 0
            assert exp._overload.snapshot()["shed_factor"] == 1
        else:
            assert exp._overload is None and exp.overload_snapshot() is None
            assert exp.ring.slot_wait_budget_s is None
        assert exp.overloaded is False
        _assert_tables(exp.state, jexp._state, samples=samples)
        assert exp.records == _value(jm.sketch_records_total)
    finally:
        exp.close()
        jexp.close()


def test_disabled_and_idle_exporters_fold_identical_tables():
    rng = np.random.default_rng(201)
    feed = [_feed(rng, n) for n in (200, 600, 256, 1000, 30)]
    tables = []
    for kw in ({}, {"shed_watermark": 1e9}):
        exp = small_exporter(**kw)
        try:
            for ev, f in feed:
                exp.export_evicted(EvictedFlows(ev.copy(), **f))
            exp._drain_pending()
            tables.append(exp.state_tables())
        finally:
            exp.close()
    for k in tables[0]:
        np.testing.assert_array_equal(tables[0][k], tables[1][k], err_msg=k)


def test_pinned_shed_equals_the_reference():
    """A factor pinned at 4 with `shed_seed=1`: both exporters thin the
    same rows, fold the same tables bit for bit and count the same shed
    rows and batches."""
    rng = np.random.default_rng(210)
    feed = [_feed(rng, n, n_distinct=500)
            for n in (1024, 300, 2 * B + 7, 3 * B, 4 * B, 800, 100)]
    exp, tm = port_exporter(shed_watermark=0.5, shed_max=4, shed_seed=1)
    jexp, jm = jax_exporter(shed_watermark=0.5, shed_max=4, shed_seed=1)
    try:
        pin(exp, 4)
        pin(jexp, 4)
        samples = feed_both(exp, jexp, feed)
        assert exp.overloaded and jexp.overloaded
        assert exp.overload_snapshot() == jexp.overload_snapshot()
        assert exp._overload.shed_rows > 2000
        for fam in ("sketch_shed_rows_total", "sketch_shed_batches_total"):
            assert _value(getattr(tm, fam)) == _value(getattr(jm, fam)), fam
        _assert_tables(exp.state, jexp._state, samples=samples)
    finally:
        exp.close()
        jexp.close()


@pytest.mark.parametrize("chunk", [0, 2], ids=["first", "later"])
def test_wedged_fold_equals_the_reference(chunk):
    """The ladder (1, 4) with its k = 4 entry left unselectable in both
    exporters (the reference's test of the same seam): a 4-batch arrival
    folds as four k = 1 chunks in one fold call. A never-ready token at
    the slot of chunk `chunk` trips the slot-wait budget there. Both drop
    the rest of that fold, count one ingest error, roll no dictionary
    epoch, and fold on to the same tables bit for bit; the port's state
    object is the one it had (in place), holding exactly the chunks that
    dispatched."""
    rng = np.random.default_rng(220 + chunk)
    warm = _feed(rng, B)
    big = _feed(rng, 4 * B, n_distinct=900)
    after = [_feed(rng, n) for n in (B, 300)]
    kw = dict(superbatch=(1, 4), shed_watermark=1e9,
              shed_slot_budget_s=0.05)
    exp, tm = port_exporter(**kw)
    jexp, jm = jax_exporter(warm=False, **kw)
    try:
        exp._ensure_ring()
        exp.ring._available = {1}  # k = 4 unwarmed, as in the reference
        samples = feed_both(exp, jexp, [warm])
        ring, jring = exp.ring, jexp._ring
        assert ring.superbatch_folds == jring.superbatch_folds == {1: 1}
        assert ring._slot == jring._slot
        slot = (ring._slot + chunk) % len(ring._bufs)
        resets = ring.dict_resets, jring.dict_resets
        pre = exp.state
        ring._copied[slot], real = NeverReady(), ring._copied[slot]
        jring._tokens[slot], jreal = NeverReady(), jring._tokens[slot]
        try:
            samples.add(big[1])
            exp.export_evicted(EvictedFlows(big[0].copy(), **big[1]))
            jexp.export_evicted(jfetch.EvictedFlows(big[0].copy(), **big[1]))
        finally:
            ring._copied[slot], jring._tokens[slot] = real, jreal
        assert exp.state is pre
        assert ring.chunks == 1 + chunk
        assert exp.ingest_errors == 1
        for m in (tm, jm):
            assert _value(m.sketch_ingest_errors_total) == 1
            assert _value(m.errors_total.labels("tpu-sketch-ingest",
                                                "error")) == 1
        assert (ring.dict_resets, jring.dict_resets) == resets
        _assert_tables(exp.state, jexp._state, samples=samples)
        total = int(ts.state_tables(exp.state)["scalars"][0])
        assert total == B + chunk * B
        for ev, f in after:
            samples.add(f)
            exp.export_evicted(EvictedFlows(ev.copy(), **f))
            jexp.export_evicted(jfetch.EvictedFlows(ev.copy(), **f))
        exp._drain_pending()
        drain_jax(jexp)
        _assert_tables(exp.state, jexp._state, samples=samples)
        assert exp.records == _value(jm.sketch_records_total)
    finally:
        exp.close()
        jexp.close()


def test_wedged_fold_returns_within_budget_and_the_feed_folds_on():
    """The budget bounds the fold: it returns within the budget (plus
    slack), counted once, with no epoch roll; the stand-in stays in place,
    so the next fold waits on it again and trips again; once the slot's
    event completes the feed folds on."""
    tm = Metrics()
    exp = small_exporter(metrics=tm, shed_watermark=2.0,
                         shed_slot_budget_s=0.1)
    rng = np.random.default_rng(230)
    try:
        ev, f = _feed(rng, 256)
        exp.export_evicted(EvictedFlows(ev, **f))
        ring = exp.ring
        assert ring.slot_wait_budget_s == 0.1
        resets = ring.dict_resets
        slot = ring._slot
        stand_in = NeverReady()
        ring._copied[slot] = stand_in
        for trip in (1, 2):
            ev, f = _feed(rng, 256)
            t0 = time.monotonic()
            exp.export_evicted(EvictedFlows(ev, **f))
            waited = time.monotonic() - t0
            assert 0.1 <= waited < 0.1 + 0.5, waited
            assert ring._copied[slot] is stand_in
            assert _value(tm.sketch_ingest_errors_total) == trip
            assert exp.ingest_errors == trip
        assert ring.dict_resets == resets
        assert ring.slot_wait_p95() >= 0.1
        ring._copied[slot] = None  # the device caught up
        ev, f = _feed(rng, 256)
        exp.export_evicted(EvictedFlows(ev, **f))
        assert exp.records == 2 * 256 and exp.ingest_errors == 2
    finally:
        exp.close()


@pytest.mark.parametrize("feed", ["dense", "compact"])
def test_dense_rings_raise_the_wedge_before_they_pack(feed):
    """The dense and compact rings raise `StagingWedged` at their slot
    wait, before they pack, with the state they were given: the exporter
    drops that batch and its tables equal an exporter's that never saw
    it."""
    rng = np.random.default_rng(240)
    batches = [_feed(rng, 256) for _ in range(3)]
    exp = small_exporter(feed=feed, shed_watermark=1e9,
                         shed_slot_budget_s=0.02)
    want = small_exporter(feed=feed)
    try:
        for e in (exp, want):
            e.export_evicted(EvictedFlows(*batches[0][:1], **batches[0][1]))
        ring = exp.ring
        ring._copied[ring._slot] = NeverReady()
        exp.export_evicted(EvictedFlows(batches[1][0], **batches[1][1]))
        ring._copied[ring._slot] = None
        with pytest.raises(staging.StagingWedged) as info:
            ring._copied[ring._slot] = NeverReady()
            try:
                ring.fold(exp.state, batches[2][0], **batches[2][1])
            finally:
                ring._copied[ring._slot] = None
        assert info.value.state is exp.state
        for e in (exp, want):
            e.export_evicted(EvictedFlows(batches[2][0], **batches[2][1]))
        assert exp.ingest_errors == 1 and exp.records == 2 * 256
        got, ref = exp.state_tables(), want.state_tables()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    finally:
        exp.close()
        want.close()


def test_one_lane_resident_ring_hands_over_its_state():
    """`ResidentStagingRing` raises the wedge at a later chunk with the
    state it folded the earlier chunks into."""
    rng = np.random.default_rng(250)
    ring = staging.ResidentStagingRing(256, device="cpu", packer="python")
    state = ts.init_state(ts.SketchConfig(**SMALL), "cpu")
    ring.slot_wait_budget_s = 0.02
    ev, f = _feed(rng, 256)
    ring.fold(state, ev, **f)
    ring._copied[(ring._slot + 1) % 4] = NeverReady()
    big, bf = _feed(rng, 4000, n_distinct=3000)
    with pytest.raises(staging.StagingWedged) as info:
        ring.fold(state, big, **bf)
    assert info.value.state is state
    assert ring.chunks == 2


def test_healthy_feed_with_large_arrivals_does_not_shed():
    """Arrival size alone is not pressure: with idle gaps the seam's busy
    share stays low and many-batch evictions never shed."""
    exp = small_exporter(shed_watermark=2.0)
    rng = np.random.default_rng(260)
    try:
        exp.export_evicted(EvictedFlows(*_feed(rng, 256)[:1]))
        for _ in range(4):
            time.sleep(0.25)
            ev, f = _feed(rng, 1024)
            exp.export_evicted(EvictedFlows(ev, **f))
        assert not exp.overloaded
        snap = exp.overload_snapshot()
        assert snap["shed_rows"] == 0 and snap["busy"] < 0.5
    finally:
        exp.close()


def test_overdriven_feed_sheds_reports_and_recovers():
    """Evictions of four batches against folds slowed by 10 ms each: the
    seam's wall clock is all fold time, the factor climbs past 1, the
    status and the frames' telemetry say OVERLOADED, the pending buffer
    stays within its capacity, and one clean window after the pressure
    stops the factor is 1 again."""
    tm = Metrics()
    reports = []
    exp = small_exporter(metrics=tm, window_s=0.4, shed_watermark=2.0,
                         shed_max=8, sink=reports.append)
    rng = np.random.default_rng(270)
    try:
        exp.export_evicted(EvictedFlows(*_feed(rng, 256)[:1]))
        faultinject.arm("sketch.ingest", "delay", 0.01)
        most = 0
        for _ in range(6):
            ev, f = _feed(rng, 1024)
            exp.export_evicted(EvictedFlows(ev, **f))
            most = max(most, exp.pending.n)
        faultinject.clear("sketch.ingest")
        assert exp.overloaded and most <= exp.pending.capacity
        snap = exp.overload_snapshot()
        assert snap["shed_factor"] > 1 and snap["shed_rows"] > 0
        assert _value(tm.sketch_shed_factor) == snap["shed_factor"]
        assert _value(tm.sketch_shed_rows_total) == snap["shed_rows"]
        assert _value(tm.sketch_shed_batches_total) == snap["shed_batches"]
        assert exp.query_status()["overloaded"] is True
        tel = exp._telemetry_block(0)
        assert tel["shed_factor"] == float(snap["shed_factor"])
        assert tel["conditions"] == ["OVERLOADED"]
        wait_for(lambda: not exp.overloaded,
                 msg="recovery after the pressure stopped")
        assert _value(tm.sketch_shed_factor) == 1
        assert exp.query_status()["overloaded"] is False
        assert exp._telemetry_block(0)["conditions"] == []
    finally:
        exp.close()
    assert reports


def test_telemetry_block_keys_and_map_occupancy_equal_the_reference():
    """The frames' telemetry block: the reference's keys, the controller's
    factor, the occupancy last noted."""
    exp = small_exporter(shed_watermark=2.0)
    jexp = TpuSketchExporter(batch_size=256, window_s=3600.0,
                             sketch_cfg=js.SketchConfig(**SMALL,
                                                        use_pallas=False),
                             sink=lambda obj: None, shed_watermark=2.0)
    try:
        for e in (exp, jexp):
            pin(e, 8)
            e.note_map_occupancy(0.4375)
        got, want = exp._telemetry_block(0), jexp._telemetry_block(0)
        assert got.keys() == want.keys()
        for k in ("shed_factor", "conditions", "map_occupancy"):
            assert got[k] == want[k], k
        assert got["map_occupancy"] == 0.4375 and got["shed_factor"] == 8.0
    finally:
        exp.close()
        jexp.close()


def test_overloaded_agent_is_counted_by_the_aggregator():
    """An agent whose controller sheds stamps OVERLOADED and its factor
    into its delta frame; the port's aggregator counts it overloaded."""
    from netobserv_tpu_torch.federation.aggregator import FederationAggregator
    cfg = ts.SketchConfig(**SMALL)
    agg = FederationAggregator(cfg, window_s=3600.0, device="cpu",
                               sink=lambda obj: None)
    exps = [small_exporter(agent_id=f"agent-{i}", delta_sink=agg.ingest_frame,
                           shed_watermark=2.0) for i in range(2)]
    rng = np.random.default_rng(280)
    try:
        pin(exps[0], 4, pressured=True)
        for e in exps:
            ev, f = _feed(rng, 600)
            e.export_evicted(EvictedFlows(ev, **f))
            e.flush()
        agg.flush()
        counts = agg.fleet()["counts"]
        assert counts["agents"] == 2 and counts["overloaded"] == 1
        tel = agg.fleet()["agents"]["agent-0"]["telemetry"]
        assert tel["shed_factor"] == 4.0 and "OVERLOADED" in tel["conditions"]
    finally:
        for e in exps:
            e.close()
        agg.close()


# -------------------------------------------------------------- config


@pytest.mark.parametrize("env", [
    {},
    {"SKETCH_SHED_WATERMARK": "2.5", "SKETCH_SHED_MAX": "16",
     "SKETCH_SHED_SLOT_BUDGET": "250ms", "SKETCH_OVERLAP": "3"},
    {"SKETCH_SHED_WATERMARK": "", "SKETCH_SHED_SLOT_BUDGET": "1m30s"},
    {"SKETCH_SHED_SLOT_BUDGET": "2"},
])
def test_overload_settings_equal_the_reference(env):
    got = tconfig.OverloadSettings.from_env(env)
    ref = jconfig.load_config(environ=env)
    for name in ("sketch_shed_watermark", "sketch_shed_max",
                 "sketch_shed_slot_budget", "sketch_overlap"):
        assert getattr(got, name) == getattr(ref, name), name


@pytest.mark.parametrize("env", [
    {"SKETCH_SHED_WATERMARK": "-1"}, {"SKETCH_SHED_MAX": "1"},
    {"SKETCH_OVERLAP": "-2"}, {"SKETCH_SHED_SLOT_BUDGET": "5parsecs"},
])
def test_overload_settings_refuse_what_the_reference_refuses(env):
    with pytest.raises(ValueError):
        jconfig.load_config(environ={"EXPORT": "stdout", **env}).validate()
    with pytest.raises(ValueError):
        tconfig.OverloadSettings.from_env(env)


def test_binfmt_sampling_field_equals_the_reference():
    """The field the thin scales has the reference's type and offset."""
    want = jbinfmt.FLOW_EVENT_DTYPE["stats"].fields["sampling"]
    got = binfmt.FLOW_EVENT_DTYPE["stats"].fields["sampling"]
    assert got == want
