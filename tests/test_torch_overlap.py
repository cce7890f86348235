"""The port's overlapped fold thread (netobserv_tpu_torch/exporter/
torch_sketch.py: `overlap_depth`, the handoff, the "sketch-fold" thread)
against the JAX package's contract (tests/test_overlap.py and the overlap
half of tests/test_overload.py), on the CPU.

- Depth 0 has no handoff and no thread.
- The same evictions through the overlap fold the same tables as the
  synchronous port exporter and the synchronous JAX exporter, bit for
  bit; `flush` observes every eviction handed off before it.
- `export_evicted` returns before the fold while the handoff has room and
  blocks while it is full; `close` folds what a dead thread left; the
  thread is a restartable stage of the port's supervisor.
- The controller's depth counts the handoff's rows once, and an idle
  exporter scores the same through both seams; a shed through the direct
  route stays unbiased.

Every thread joined, no wait past 15 s. Sizes: B = 256 at the small
geometry; B = 512 at the staging tests' geometry for the JAX
comparison."""

import threading
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu_torch.agent.supervisor import Supervisor
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.utils import faultinject
from tests.test_torch_overload import (
    jax_exporter, pin, port_exporter, small_exporter, wait_for,
)
from tests.test_torch_staging import B, _assert_tables, _feed, _Samples

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


@pytest.fixture(autouse=True)
def _clean():
    yield
    faultinject.clear()
    faultinject.hits.clear()


def _events(n, sport0=1000, nbytes=100):
    """n flow events of one host pair, distinct source ports, `nbytes`
    bytes each (tests/test_pipeline.py `make_events`)."""
    rng = np.random.default_rng(sport0)
    ev, _ = _feed(rng, n)
    ev["key"]["src_port"] = sport0 + np.arange(n)
    ev["stats"]["bytes"] = nbytes
    ev["stats"]["sampling"] = 0
    return ev


def test_disabled_default_has_no_worker():
    exp = small_exporter()
    try:
        assert exp._handoff is None
        assert exp._fold_thread is None
        assert exp._queued_overlap_rows() == 0
        assert not [t for t in threading.enumerate()
                    if t.name == "sketch-fold"]
    finally:
        exp.close()


def test_overlap_makes_its_ring_before_its_thread():
    """The ring (and on CUDA its captures) exists when the constructor
    returns, so the fold thread never captures."""
    exp = small_exporter(overlap_depth=2)
    try:
        assert exp.ring is not None and exp.pending is not None
        assert exp._fold_thread.is_alive()
        assert exp._fold_thread.name == "sketch-fold"
    finally:
        exp.close()
    assert not exp._fold_thread.is_alive()


def test_overlap_tables_equal_synchronous_and_the_reference():
    """Depth 2 against depth 0 in the port and the synchronous JAX
    exporter: the same tables bit for bit once the handoff and the
    pending rows are folded; `flush` drains the handoff first."""
    rng = np.random.default_rng(300)
    feed = [_feed(rng, n, n_distinct=700)
            for n in (300, 2 * B + 11, B, 4 * B, 700, 90, 3 * B)]
    samples = _Samples()
    for _, f in feed:
        samples.add(f)
    jexp, _ = jax_exporter()
    try:
        for ev, f in feed:
            jexp.export_evicted(jfetch.EvictedFlows(ev.copy(), **f))
        with jexp._lock:
            jexp._drain_pending_locked()
        jexp._ring.drain()
        tables, reports = [], []
        for depth in (0, 2):
            got = []
            exp, _ = port_exporter(overlap_depth=depth, sink=got.append)
            try:
                for ev, f in feed:
                    exp.export_evicted(EvictedFlows(ev.copy(), **f))
                exp._drain_handoff()
                assert exp._queued_overlap_rows() == 0
                with exp._lock:
                    exp._drain_pending()
                _assert_tables(exp.state, jexp._state, samples=samples)
                tables.append(exp.state_tables())
                exp.flush()
                reports.append(got[-1])
            finally:
                exp.close()
    finally:
        jexp.close()
    for k in tables[0]:
        np.testing.assert_array_equal(tables[0][k], tables[1][k], err_msg=k)
    assert reports[0]["Records"] == reports[1]["Records"] == sum(
        len(ev) for ev, _ in feed)


def test_flush_observes_every_handed_off_eviction():
    got = []
    exp = small_exporter(overlap_depth=3, sink=got.append)
    try:
        for i in range(6):
            exp.export_evicted(EvictedFlows(_events(200, sport0=500 * i)))
        exp.flush()
        assert got[-1]["Records"] == 6 * 200
        assert exp._handoff.unfinished_tasks == 0
    finally:
        exp.close()


def test_export_returns_before_fold_and_blocks_when_full():
    exp = small_exporter(overlap_depth=1)
    try:
        exp.export_evicted(EvictedFlows(_events(256)))
        wait_for(lambda: exp._handoff.unfinished_tasks == 0, msg="warm fold")
        faultinject.arm("sketch.ingest", "delay", 0.6)
        exp.export_evicted(EvictedFlows(_events(256, sport0=3000)))
        wait_for(lambda: exp._queued_overlap_rows() == 0,
                 msg="the thread took the first handoff")
        t0 = time.perf_counter()
        exp.export_evicted(EvictedFlows(_events(256, sport0=5000)))
        free = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp.export_evicted(EvictedFlows(_events(256, sport0=7000)))
        blocked = time.perf_counter() - t0
        assert free < 0.4, f"a free handoff waited on the fold ({free:.2f}s)"
        assert blocked > max(2 * free, 0.05), (
            f"a full handoff did not hold the feed back (free={free:.3f}s "
            f"full={blocked:.3f}s)")
    finally:
        faultinject.clear("sketch.ingest")
        exp.close()


def test_close_folds_what_a_dead_thread_left():
    got = []
    exp = small_exporter(overlap_depth=4, sink=got.append)
    try:
        exp._closed.set()
        exp._fold_thread.join(timeout=5)
        assert not exp._fold_thread.is_alive()
        exp._closed.clear()
        for i in range(3):
            exp.export_evicted(EvictedFlows(_events(256, sport0=2000 + i)))
        assert exp._queued_overlap_rows() == 3 * 256
    finally:
        exp.close()
    assert exp._queued_overlap_rows() == 0
    assert exp._handoff.unfinished_tasks == 0
    assert got[-1]["Records"] == 3 * 256


def test_close_contains_a_leftover_that_fails():
    """A leftover whose fold path raises is dropped and counted; the rest
    still fold and the close finishes."""
    tm = Metrics()
    got = []
    exp = small_exporter(overlap_depth=4, metrics=tm, sink=got.append)
    exp._closed.set()
    exp._fold_thread.join(timeout=5)
    exp._closed.clear()
    exp.export_evicted(EvictedFlows(_events(100)))
    exp.export_evicted(EvictedFlows(np.zeros(3, [("x", "u4")])))  # no events
    exp.export_evicted(EvictedFlows(_events(100, sport0=9000)))
    exp.close()
    assert tm.errors_total.labels("tpu-sketch", "error")._value.get() == 1
    assert got[-1]["Records"] == 200


def test_fold_thread_is_a_restartable_stage():
    """The supervisor sees the dead fold thread, restarts it through the
    registered callable, and the handoff drains; the restart counts."""
    metrics = Metrics()
    sup = Supervisor(metrics=metrics, check_period_s=0.05)
    exp = small_exporter(overlap_depth=2, metrics=metrics)
    try:
        exp.register_supervised(sup, heartbeat_timeout_s=5.0,
                                backoff_initial_s=0.05)
        assert "sketch-fold" in sup.snapshot()
        sup.start()
        exp._closed.set()
        exp._fold_thread.join(timeout=5)
        exp._closed.clear()
        exp.export_evicted(EvictedFlows(_events(256)))
        wait_for(lambda: exp._queued_overlap_rows() == 0
                 and exp._handoff.unfinished_tasks == 0,
                 msg="the restarted thread drained the handoff")
        wait_for(lambda: sup.snapshot()["sketch-fold"]["restarts"] >= 1,
                 msg="the fold stage's restart")
        assert metrics.stage_restarts_total.labels(
            "sketch-fold")._value.get() >= 1
        assert exp.records == 256
    finally:
        sup.stop()
        exp.close()


def test_pressure_depth_counts_the_handoff_once():
    """Three evictions queued before any is admitted: admission i sees its
    own rows plus those still queued behind it, never the one in hand
    twice (tests/test_overload.py `TestOverlapCoupling`)."""
    exp = small_exporter(overlap_depth=3, shed_watermark=1e9)
    seen: list[int] = []
    gate = threading.Event()
    try:
        ctl = exp._overload
        orig_update = ctl.update

        def spying_update(pending_rows, wait_p95, busy=1.0):
            seen.append(pending_rows)
            return orig_update(pending_rows, wait_p95, busy=busy)

        ctl.update = spying_update
        orig_now = exp._export_evicted_now

        def gated_now(evicted):
            assert gate.wait(10)
            orig_now(evicted)

        exp._export_evicted_now = gated_now
        for i in range(3):
            exp.export_evicted(EvictedFlows(_events(256, sport0=3000 + i)))
        wait_for(lambda: exp._queued_overlap_rows() == 512,
                 msg="the thread holding #1, two queued behind")
        gate.set()
        wait_for(lambda: len(seen) == 3, msg="3 admissions")
        wait_for(lambda: exp._queued_overlap_rows() == 0, msg="drained")
        assert seen == [768, 512, 256], seen
    finally:
        gate.set()
        exp.close()


def test_idle_scores_equal_through_both_seams():
    scores = []
    for depth in (0, 2):
        exp = small_exporter(overlap_depth=depth, shed_watermark=1e9)
        try:
            exp.export_evicted(EvictedFlows(_events(256)))
            if depth:
                wait_for(lambda: exp._handoff.unfinished_tasks == 0,
                         msg="handoff drained")
            scores.append(exp._overload.last_score)
        finally:
            exp.close()
    assert scores == [0.0, 0.0]


def test_shed_through_the_direct_route_is_unbiased():
    """Batch-aligned evictions ride the direct route unshed; thinned at a
    pinned factor 2 the de-biased byte total agrees within sampling noise
    (a thin that forgot `sampling` reads about -50 %)."""
    evs = [_events(512, sport0=1000 + 32 * i, nbytes=200) for i in range(12)]
    exact = 12 * 512 * 200.0
    totals = []
    for factor in (None, 2):
        exp = small_exporter(**({} if factor is None else
                                {"shed_watermark": 0.5, "shed_max": 4}))
        try:
            if factor is not None:
                pin(exp, factor)
            for rows in evs:
                exp.export_evicted(EvictedFlows(rows.copy()))
            with exp._lock:
                exp._drain_pending()
            if factor is None:
                assert exp.pending.direct_rows == 12 * 512
            else:
                assert exp._overload.shed_rows > 1000
            totals.append(float(exp.state_tables()["scalars"][1]))
        finally:
            exp.close()
    unshed, shed = totals
    assert abs(unshed - exact) / exact < 0.01
    assert abs((shed - unshed) / unshed) < 0.20


def test_concurrent_producers_lose_no_row():
    """More producer threads than cores hand off at once under a short
    switch interval: the handoff's row count never goes negative and ends
    at 0, and every row is folded once."""
    import os
    import sys

    producers = min(16, 2 * (os.cpu_count() or 1))
    per, rows = 6, 64
    got = []
    exp = small_exporter(overlap_depth=2, shed_watermark=1e9,
                         sink=got.append)
    low = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def produce(i):
            for j in range(per):
                exp.export_evicted(EvictedFlows(
                    _events(rows, sport0=1000 + 500 * i + rows * j)))
                low.append(exp._queued_overlap_rows())

        threads = [threading.Thread(target=produce, args=(i,))
                   for i in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in threads)
        exp.flush()
    finally:
        sys.setswitchinterval(interval)
        exp.close()
    assert min(low) >= 0
    assert exp._queued_overlap_rows() == 0
    assert sum(r["Records"] for r in got) == producers * per * rows
