"""CapacityLimiter: the pipeline's single designated lossy point.

A copy of `netobserv_tpu/flow/limiter.py` (lines 1-89): forwards batches
downstream, drops when the exporter can't keep up (counted), and logs drop
warnings with exponential backoff so a saturated exporter doesn't also
saturate the log. Fault point: `limiter.forward`.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

from netobserv_tpu_torch.model.record import Record
from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.flow.limiter")

_INITIAL_LOG_PERIOD_S = 1.0
_MAX_LOG_PERIOD_S = 300.0


class CapacityLimiter:
    def __init__(self, inp: "queue.Queue[list[Record]]",
                 out: "queue.Queue[list[Record]]", metrics=None):
        self._in = inp
        self._out = out
        self._metrics = metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dropped_since_log = 0
        self._log_period = _INITIAL_LOG_PERIOD_S
        self._next_log = 0.0
        #: supervision hook: beats once per poll (agent/supervisor.py)
        self.heartbeat = lambda: None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="capacity-limiter", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        # drain whatever arrived during/after the last get() so a final
        # eviction produced at shutdown is not lost
        while True:
            try:
                batch = self._in.get_nowait()
            except queue.Empty:
                break
            try:
                self._out.put_nowait(batch)
            except queue.Full:
                if self._metrics is not None:
                    self._metrics.count_dropped(len(batch), "limiter")
                break

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.heartbeat()
            faultinject.fire("limiter.forward")
            try:
                batch = self._in.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._out.put_nowait(batch)
                if self._metrics is not None:
                    self._metrics.buffer_size.labels("export").set(
                        self._out.qsize())
                self._log_period = _INITIAL_LOG_PERIOD_S  # recovered
            except queue.Full:
                self._dropped_since_log += len(batch)
                if self._metrics is not None:
                    self._metrics.count_dropped(len(batch), "limiter")
                now = time.monotonic()
                if now >= self._next_log:
                    log.warning(
                        "exporter is not keeping up: dropped %d flows "
                        "(next warning in %.0fs)",
                        self._dropped_since_log, self._log_period)
                    self._dropped_since_log = 0
                    self._next_log = now + self._log_period
                    self._log_period = min(
                        self._log_period * 2, _MAX_LOG_PERIOD_S)
