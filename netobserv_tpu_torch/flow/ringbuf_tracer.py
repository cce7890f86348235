"""RingBufTracer: drains the map-full fallback ring buffer.

A copy of `netobserv_tpu/flow/ringbuf_tracer.py` (lines 1-80). When a flow
misses the kernel's aggregation map (the map is full), the datapath sends
the packet as a single flow event over a ring buffer; the tracer reads
them one at a time, hands each to the accounter's queue
(`flow/accounter.py`) and asks the map tracer for an early eviction
(`flusher`), which relieves the map. An event of the wrong size is
counted in the rate-limited log and skipped, never fatal; a full queue
drops the event the same way. Off by default
(ENABLE_FLOWS_RINGBUF_FALLBACK). Its fault point is
`ringbuf_tracer.read`, and `heartbeat` beats once a poll for the stage
supervisor (`agent/supervisor.py`).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from netobserv_tpu_torch.datapath.fetcher import FlowFetcher
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.flow.ringbuf_tracer")

_LOG_EVERY_S = 5.0


class RingBufTracer:
    def __init__(self, fetcher: FlowFetcher, out: "queue.Queue[np.void]",
                 flusher: Optional[Callable[[], None]] = None,
                 metrics=None, poll_timeout_s: float = 0.2):
        self._fetcher = fetcher
        self._out = out
        self._flusher = flusher
        self._metrics = metrics
        self._poll = poll_timeout_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_log = 0.0
        #: supervision hook: beats once per poll (agent/supervisor.py)
        self.heartbeat = lambda: None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="ringbuf-tracer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._poll * 4)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.heartbeat()
            raw = faultinject.fire("ringbuf_tracer.read",
                                   self._fetcher.read_ringbuf(self._poll))
            if raw is None:
                continue
            if len(raw) != binfmt.FLOW_EVENT_DTYPE.itemsize:
                self._rate_limited_log(
                    "bad ringbuf event size %d (want %d)", len(raw),
                    binfmt.FLOW_EVENT_DTYPE.itemsize)
                continue
            event = np.frombuffer(raw, dtype=binfmt.FLOW_EVENT_DTYPE)[0]
            if self._metrics is not None:
                self._metrics.count_ringbuf_event()
            if self._flusher is not None:
                self._flusher()  # relieve map pressure with an early eviction
            try:
                self._out.put_nowait(event)
            except queue.Full:
                self._rate_limited_log("ringbuf event dropped: buffer full")

    def _rate_limited_log(self, msg: str, *args) -> None:
        now = time.monotonic()
        if now - self._last_log > _LOG_EVERY_S:
            log.warning(msg, *args)
            self._last_log = now
