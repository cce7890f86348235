"""PCA packet pipeline stages.

A copy of `netobserv_tpu/flow/perf_buffer.py` (lines 1-113; the
tracer decodes an event with `model/packet_record.packets_from_events`,
which the reference's repeats inline), whose reference analogs are `pkg/flow/tracer_perf.go` (PerfTracer: blocking packet
ringbuf reads -> PacketRecord) and `pkg/flow/perfbuffer.go` (PerfBuffer:
batch by size/timeout before export).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

import numpy as np

from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.packet_record import (
    PacketRecord, packets_from_events,
)
from netobserv_tpu_torch.model.record import MonotonicClock

log = logging.getLogger("netobserv_tpu_torch.flow.perf")


class PerfTracer:
    """Reads raw packet events from the datapath's packet ring buffer."""

    def __init__(self, fetcher, out: "queue.Queue[PacketRecord]",
                 poll_timeout_s: float = 0.2):
        self._fetcher = fetcher
        self._out = out
        self._poll = poll_timeout_s
        self._clock = MonotonicClock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="perf-tracer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._poll * 4)

    def _loop(self) -> None:
        while not self._stop.is_set():
            raw = self._fetcher.read_packet(self._poll)
            if raw is None:
                continue
            if len(raw) != binfmt.PACKET_EVENT_DTYPE.itemsize:
                log.debug("bad packet event size %d", len(raw))
                continue
            cur_mono, cur_wall = self._clock.now_pair()
            rec = packets_from_events(
                np.frombuffer(raw, dtype=binfmt.PACKET_EVENT_DTYPE),
                cur_wall - cur_mono)[0]
            try:
                # brief blocking put: the ring buffer already absorbed the
                # burst, so give the batcher a moment before shedding
                self._out.put(rec, timeout=0.5)
            except queue.Full:
                log.debug("packet dropped: buffer full")


class PerfBuffer:
    """Batches packets by max size or timeout before the exporter."""

    def __init__(self, inp: "queue.Queue[PacketRecord]",
                 out: "queue.Queue[list[PacketRecord]]",
                 max_batch: int = 100, timeout_s: float = 0.5):
        self._in = inp
        self._out = out
        self._max = max_batch
        self._timeout = timeout_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="perf-buffer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._timeout + 1)

    def _flush(self, batch: list[PacketRecord]) -> None:
        if not batch:
            return
        try:
            self._out.put_nowait(batch)
        except queue.Full:
            log.warning("packet batch dropped: exporter not keeping up")

    def _loop(self) -> None:
        batch: list[PacketRecord] = []
        deadline = time.monotonic() + self._timeout
        while not self._stop.is_set():
            try:
                batch.append(self._in.get(timeout=0.1))
            except queue.Empty:
                pass
            if len(batch) >= self._max or time.monotonic() >= deadline:
                self._flush(batch)
                batch = []
                deadline = time.monotonic() + self._timeout
        self._flush(batch)
