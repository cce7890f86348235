"""The export stage's shutdown (netobserv_tpu_torch/exporter/base.py
`QueueExporter`, exporter/direct_flp.py `DirectFLPExporter._emit`) on the
CPU: fault C16 of ROADMAP.

- An exporter whose `export_batch` blocks on an event for longer than
  `stop()`'s 2 s join, with `stop()` called meanwhile: no two calls into
  the exporter (`export_batch`, `export_evicted`, `close`) overlap, counted
  under a lock, and every batch is exported exactly once, the batch in
  flight first, then the queue's rest, then `close`. The reference's
  `QueueExporter` (`netobserv_tpu/exporter/base.py:56-61`) fails the same
  schedule: its drain runs beside the batch in flight.
- An exporter that never returns: `stop()` gives up after `stop_wait_s`
  and neither drains nor closes it.
- Two threads emitting through one `DirectFLPExporter`: each batch's
  lines reach the stream whole and together.
- An EXPORT=direct-flp child whose standard output is read only after it
  has written for a while, all of it with `communicate()`: every line
  parses. (`tests/test_torch_entry.py::test_cli_exits_2_for_an_unported_
  exporter` reads one line with `readline()` first, which buffers past
  that line, and `communicate()` then reads the pipe itself, so a late
  reader there loses the buffered rest and can start mid-line whatever
  the child writes.)
"""

import queue
import threading
import time

import numpy as np
import pytest

from netobserv_tpu.exporter import base as jbase
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter import base as tbase
from netobserv_tpu_torch.exporter.direct_flp import DirectFLPExporter
from netobserv_tpu_torch.model import binfmt

#: how long the first call blocks: past stop()'s 2 s join
BLOCK_S = 2.6


class _Overlaps:
    """An exporter that counts the calls inside it under a lock; the
    first `export_batch` waits on `release`."""

    name = "overlaps"
    supports_columnar = True

    def __init__(self):
        self._lock = threading.Lock()
        self.inside = 0
        self.most_inside = 0
        self.calls: list = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def _call(self, what, block: bool) -> None:
        with self._lock:
            self.inside += 1
            self.most_inside = max(self.most_inside, self.inside)
            self.calls.append(what)
        self.entered.set()
        if block:
            self.release.wait(timeout=30)
        with self._lock:
            self.inside -= 1

    def export_batch(self, records) -> None:
        self._call(("batch", records[0]), block=len(self.calls) == 0)

    def export_evicted(self, evicted) -> None:
        self._call(("evicted", len(evicted)), block=False)

    def close(self) -> None:
        self._call(("close",), block=False)


def _evicted(n: int) -> EvictedFlows:
    return EvictedFlows(np.zeros(n, dtype=binfmt.FLOW_EVENT_DTYPE))


def _stop_during_a_blocked_batch(module) -> _Overlaps:
    exp = _Overlaps()
    q: queue.Queue = queue.Queue()
    stage = module.QueueExporter(exp, q)
    stage.start()
    q.put(["b0"])
    assert exp.entered.wait(timeout=10)
    for item in (["b1"], _evicted(3), ["b2"]):
        q.put(item)
    threading.Timer(BLOCK_S, exp.release.set).start()
    stage.stop()
    exp.release.set()
    return exp


def test_stop_waits_for_the_batch_in_flight():
    """C16: the drain and the close wait for the blocked batch; each batch
    once, in order, then one close."""
    t0 = time.monotonic()
    exp = _stop_during_a_blocked_batch(tbase)
    assert time.monotonic() - t0 >= BLOCK_S - 0.1
    assert exp.most_inside == 1, exp.calls
    assert exp.calls == [("batch", "b0"), ("batch", "b1"), ("evicted", 3),
                         ("batch", "b2"), ("close",)]


def test_the_reference_stage_overlaps_the_drain():
    """The reference's stop() drains beside the blocked batch: the fault
    the port's lock removes, shown on the same schedule."""
    exp = _stop_during_a_blocked_batch(jbase)
    assert exp.most_inside == 2
    assert sorted(map(str, exp.calls)) == sorted(map(str, [
        ("batch", "b0"), ("batch", "b1"), ("evicted", 3), ("batch", "b2"),
        ("close",)]))


def test_stop_gives_up_on_a_wedged_exporter(monkeypatch, caplog):
    """A call that never returns: stop() returns after its join and
    `stop_wait_s`, with no drain and no close."""
    monkeypatch.setattr(tbase.QueueExporter, "stop_wait_s", 0.3)
    exp = _Overlaps()
    q: queue.Queue = queue.Queue()
    stage = tbase.QueueExporter(exp, q)
    stage.start()
    q.put(["b0"])
    assert exp.entered.wait(timeout=10)
    q.put(["b1"])
    t0 = time.monotonic()
    try:
        stage.stop()
        took = time.monotonic() - t0
    finally:
        exp.release.set()
    assert 2.2 <= took < 4.0, took
    assert exp.calls == [("batch", "b0")]
    assert q.qsize() == 1
    assert any("not drained" in r.getMessage() for r in caplog.records)


class _SlowStream:
    """A stream whose every write yields to other threads mid-call."""

    def __init__(self):
        self.writes: list[str] = []
        self._lock = threading.Lock()

    def write(self, text: str) -> None:
        for line in text.splitlines(keepends=True):
            time.sleep(0.001)
            with self._lock:
                self.writes.append(line)

    def flush(self) -> None:
        pass


@pytest.mark.parametrize("threads", [2, 4])
def test_direct_flp_emits_each_batch_whole(threads):
    """Concurrent `_emit` calls: each batch's lines are contiguous in the
    stream and each is a whole JSON line."""
    stream = _SlowStream()
    exp = DirectFLPExporter(stream=stream)
    batches = [[{"T": t, "N": i, "Pad": "x" * (50 + i)} for i in range(20)]
               for t in range(threads)]
    go = threading.Barrier(threads)

    def emit(batch):
        go.wait()
        exp._emit(batch)

    ts = [threading.Thread(target=emit, args=(b,)) for b in batches]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    import json
    lines = [json.loads(x) for x in stream.writes]
    assert len(lines) == 20 * threads
    order = [e["T"] for e in lines]
    runs = [order[i] for i in range(len(order))
            if i == 0 or order[i] != order[i - 1]]
    assert sorted(runs) == list(range(threads)), runs
    for t in range(threads):
        assert [e["N"] for e in lines if e["T"] == t] == list(range(20))


def test_direct_flp_child_lines_are_whole_when_read_late():
    import json
    import select
    import signal
    import subprocess
    import sys

    from tests.test_torch_entry import FLP_CHILD_CFG, ROOT, _child_env
    child = subprocess.Popen(
        [sys.executable, "-m", "netobserv_tpu_torch"], cwd=str(ROOT),
        env=_child_env(EXPORT="direct-flp", DATAPATH="synthetic",
                       FLP_CONFIG=FLP_CHILD_CFG,
                       CACHE_ACTIVE_TIMEOUT="200ms"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        ready, _, _ = select.select([child.stdout], [], [], 60)
        assert ready, "the child wrote nothing in 60 s"
        time.sleep(0.3)                      # a reader that comes late
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err.decode()[-2000:]
    entries = [json.loads(x) for x in out.splitlines()]
    assert len(entries) >= 100
    assert all(e["SrcSubnet"].endswith("/16") for e in entries)
