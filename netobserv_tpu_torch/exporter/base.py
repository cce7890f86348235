"""Exporter base: a terminal thread consuming record batches from a queue.

A copy of `netobserv_tpu/exporter/base.py` (`Exporter`, `QueueExporter`,
lines 1-98). `QueueExporter` hands each batch to its exporter: a list of
records to `export_batch`, an eviction (`datapath/fetcher.EvictedFlows`,
the columnar path) to `export_evicted`. Fault points: `exporter.loop`
(the stage itself: a crash there is the supervisor's) and
`exporter.export` (inside the export's containment: swallowed and
counted like an exporter error). `stop` drains the queue, then closes the
exporter, which publishes its last window.

No two calls into one exporter (`export_batch`, `export_evicted`,
`close`) ever run at once: each runs under the `QueueExporter`'s call
lock, so `stop`'s drain and close wait for a batch the loop thread still
has in flight. The reference (`netobserv_tpu/exporter/base.py:59-64`)
drains and closes on the stopping thread once its 2 s join returns,
whether or not the loop thread is still exporting, and a direct-FLP
batch then ran beside the drain's, tearing its output lines and its
conntrack state (ROADMAP C16).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from netobserv_tpu_torch.model.record import Record
from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.exporter")


class Exporter:
    """Subclasses implement export_batch(); name is the metrics label.

    Exporters that can consume raw evictions columnar-first (without Record
    materialization — the per-record decode loop is the reference's hottest
    path) set `supports_columnar` and implement export_evicted().
    """

    name = "exporter"
    supports_columnar = False

    def export_batch(self, records: list[Record]) -> None:
        raise NotImplementedError

    def export_evicted(self, evicted) -> None:  # EvictedFlows
        raise NotImplementedError

    def close(self) -> None:
        pass


class QueueExporter:
    """Runs an Exporter as the pipeline's terminal node.

    `stop()` waits up to 2 s for the loop thread to end, then up to
    `stop_wait_s` (30 s) more for the call it has in flight. Only a
    wedged exporter reaches that bound: every exporter bounds its own
    calls (the gRPC deadline and Kafka's socket timeout are 10 s, the
    sketch exporter's slot budget and close wait are bounded too). Past
    it, `stop` logs an error and returns without the drain and the close,
    leaving the queued batches undelivered, since running them beside the
    call in flight would interleave the two. So a wedged exporter delays
    shutdown by at most 32 s, and a healthy one by the remainder of one
    batch."""

    #: seconds `stop` waits for the call in flight after its join
    stop_wait_s = 30.0

    def __init__(self, exporter: Exporter,
                 inp: "queue.Queue[list[Record]]", metrics=None):
        self._exporter = exporter
        self._in = inp
        self._metrics = metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: held across every call into the exporter (module docstring)
        self._calls = threading.Lock()
        #: supervision hook: beats once per poll (agent/supervisor.py)
        self.heartbeat = lambda: None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"export-{self._exporter.name}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        if not self._calls.acquire(timeout=self.stop_wait_s):
            log.error("%s export still running %.0f s after stop; its "
                      "queued batches are not drained and it is not "
                      "closed", self._exporter.name, self.stop_wait_s)
            return
        try:
            self._drain()
            self._exporter.close()
        finally:
            self._calls.release()

    def _drain(self) -> None:
        """The queue's rest, exported by the caller, who holds `_calls`."""
        while True:
            try:
                self._export_locked(self._in.get_nowait())
            except queue.Empty:
                return

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.heartbeat()
            # the fault point sits OUTSIDE _export's try: it simulates a bug
            # in the terminal stage itself (supervisor territory), while
            # errors raised BY the exporter stay swallowed+counted below
            faultinject.fire("exporter.loop")
            try:
                batch = self._in.get(timeout=0.2)
            except queue.Empty:
                continue
            self._export(batch)

    def _export(self, batch) -> None:
        with self._calls:
            self._export_locked(batch)

    def _export_locked(self, batch) -> None:
        try:
            # inside the try: an armed "exporter.export" behaves exactly
            # like a throwing exporter — swallowed and counted, never fatal
            faultinject.fire("exporter.export")
            if isinstance(batch, list):
                self._exporter.export_batch(batch)
            else:  # EvictedFlows on the columnar fast path
                self._exporter.export_evicted(batch)
            if self._metrics is not None:
                self._metrics.count_exported(self._exporter.name, len(batch))
        except Exception as exc:  # exporter errors must not kill the pipeline
            if self._metrics is not None:
                self._metrics.count_export_error(
                    self._exporter.name, type(exc).__name__)
            log.error("%s export failed: %s", self._exporter.name, exc)
