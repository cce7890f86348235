"""SSL event tracer: drains the OpenSSL-uprobe plaintext ring buffer.

Reference analog: the SSL ringbuf variant of `pkg/flow/tracer_ringbuf.go`
(NewSSLRingBufTracer, `:403,473-527`): events carry (timestamp, pid_tgid,
direction, plaintext) from the SSL_write uprobe; a handler receives decoded
events (the reference forwards them to a correlation cache that flags flows
whose ciphertext/plaintext accounting mismatches).

A copy of `netobserv_tpu/flow/ssl_tracer.py` (lines 1-87): `SSLEvent`,
`decode_ssl_event` and `SSLTracer`, with its fault point
`ssl_tracer.read` and `heartbeat` for the stage supervisor.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.flow.ssl_tracer")


@dataclass
class SSLEvent:
    timestamp_ns: int
    pid: int
    tid: int
    direction: int  # 1 = write
    data: bytes


SSLHandler = Callable[[SSLEvent], None]


def decode_ssl_event(raw: bytes) -> Optional[SSLEvent]:
    if len(raw) != binfmt.SSL_EVENT_DTYPE.itemsize:
        return None
    ev = np.frombuffer(raw, dtype=binfmt.SSL_EVENT_DTYPE)[0]
    n = max(0, min(int(ev["data_len"]), binfmt.MAX_SSL_DATA))
    pid_tgid = int(ev["pid_tgid"])
    return SSLEvent(
        timestamp_ns=int(ev["timestamp_ns"]),
        pid=pid_tgid >> 32, tid=pid_tgid & 0xFFFFFFFF,
        direction=int(ev["ssl_type"]),
        data=ev["data"][:n].tobytes())


class SSLTracer:
    """Blocking reader over the datapath's ssl_events ring buffer."""

    def __init__(self, fetcher, handler: SSLHandler,
                 poll_timeout_s: float = 0.2):
        self._fetcher = fetcher
        self._handler = handler
        self._poll = poll_timeout_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: supervision hook: beats once per poll (agent/supervisor.py)
        self.heartbeat = lambda: None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="ssl-tracer",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self._poll * 4)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.heartbeat()
            raw = faultinject.fire("ssl_tracer.read",
                                   self._fetcher.read_ssl(self._poll))
            if raw is None:
                continue
            event = decode_ssl_event(raw)
            if event is None:
                log.debug("bad ssl event size %d", len(raw))
                continue
            try:
                self._handler(event)
            except Exception as exc:
                log.error("ssl handler failed: %s", exc)
