"""Accounter: re-aggregates the ring buffer's single-packet events.

A copy of `netobserv_tpu/flow/accounter.py` (lines 1-104). A bounded map
keyed by flow identity merges the singles the ring-buffer tracer hands
over (`flow/ringbuf_tracer.py`) with the kernel merge's rules
(`model/accumulate.accumulate_base`), and evicts the whole map as one
`list[Record]` into the agent's evicted queue when its timeout passes or
it holds `max_entries` flows, and once more on `stop`. Each eviction is
observed as source "accounter"; one the queue cannot take is counted as
dropped under that source. Its fault point is `accounter.loop`, and
`heartbeat` beats once a poll for the stage supervisor. `ssl_correlator`
credits each evicted record with its SSL plaintext counts when given:
the agent passes its correlator under ENABLE_OPENSSL_TRACKING.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

import numpy as np

from netobserv_tpu_torch.model import accumulate, binfmt
from netobserv_tpu_torch.model.record import (
    MonotonicClock, Record, interface_namer, records_from_events,
)
from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.flow.accounter")


class Accounter:
    def __init__(self, inp: "queue.Queue[np.void]",
                 out: "queue.Queue[list[Record]]",
                 max_entries: int = 5000, evict_timeout_s: float = 5.0,
                 agent_ip: str = "", metrics=None, ssl_correlator=None):
        self._ssl_correlator = ssl_correlator
        self._in = inp
        self._out = out
        self._max = max_entries
        self._timeout = evict_timeout_s
        self._agent_ip = agent_ip
        self._metrics = metrics
        self._clock = MonotonicClock()
        self._entries: dict[bytes, np.void] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: supervision hook: beats once per poll (agent/supervisor.py)
        self.heartbeat = lambda: None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="accounter", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._timeout + 1)
        self._evict()  # drain remaining entries on shutdown

    def _loop(self) -> None:
        deadline = time.monotonic() + self._timeout
        while not self._stop.is_set():
            self.heartbeat()
            faultinject.fire("accounter.loop")
            timeout = max(deadline - time.monotonic(), 0.01)
            try:
                event = self._in.get(timeout=min(timeout, 0.2))
            except queue.Empty:
                event = None
            if event is not None:
                self._account(event)
            if time.monotonic() >= deadline or len(self._entries) >= self._max:
                self._evict()
                deadline = time.monotonic() + self._timeout

    def _account(self, event: np.void) -> None:
        key = bytes(event["key"].tobytes())
        existing = self._entries.get(key)
        if existing is None:
            self._entries[key] = event.copy()
        else:
            accumulate.accumulate_base(existing["stats"], event["stats"])

    def _evict(self) -> None:
        if not self._entries:
            return
        events = np.zeros(len(self._entries), dtype=binfmt.FLOW_EVENT_DTYPE)
        for i, ev in enumerate(self._entries.values()):
            events[i] = ev
        self._entries.clear()
        records = records_from_events(
            events, clock=self._clock, agent_ip=self._agent_ip,
            namer=interface_namer())
        if self._ssl_correlator is not None:
            # ringbuf-fallback flows must not lose their plaintext credits
            for rec in records:
                n_ev, n_bytes = self._ssl_correlator.take(rec.key)
                rec.features.ssl_plaintext_events = n_ev
                rec.features.ssl_plaintext_bytes = n_bytes
        if self._metrics is not None:
            self._metrics.observe_eviction("accounter", len(records), 0.0)
        try:
            self._out.put_nowait(records)
        except queue.Full:
            if self._metrics is not None:
                self._metrics.count_dropped(len(records), "accounter")
            log.warning("accounter eviction dropped: buffer full")
