"""The fetcher seam: one map eviction, the fetcher protocol, a fake.

Counterpart of `netobserv_tpu/datapath/fetcher.py`. `EvictedFlows`
(`:22`) has the reference's fields: the flow events, the five feature
lanes the sketch plane reads, the per-CPU event counters (`nevents`,
which the overload controller thins with the rows), the drain's
`decode_stats`, the fused drain's pre-packed resident regions (`packed`,
a `datapath/loader.PackedEviction`) and a batch trace (`trace`), which
the map tracer (`flow/map_tracer.py`) hangs on a sampled eviction and the
exporter finishes at its next fold. `FlowFetcher` and `FakeFetcher` are copies of
the reference's (`:62-170`). The replay fetchers are in `replay.py`; the
kernel fetchers in `loader.py`.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional, Protocol

import numpy as np

from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.flow import GlobalCounter


class EvictedFlows:
    """One map eviction: `events` is a FLOW_EVENT_DTYPE array
    (`model/binfmt`), and each feature lane (`extra`, `dns`, `drops`,
    `xlat`, `quic`, of their `binfmt` record dtypes) is row for row with
    it, or None when the feature is off. A lane shorter than the events
    stands for zero rows past its end. `decode_stats` (the producing
    drain's stage seconds), `packed` (a fused drain's resident regions;
    the rows above are always the whole eviction, which a consumer that
    cannot ship the regions folds instead) and `trace` (a sampled batch
    trace) are None unless set."""

    __slots__ = ("events", "extra", "dns", "drops", "xlat", "quic",
                 "nevents", "decode_stats", "packed", "trace")

    def __init__(self, events: np.ndarray,
                 dns: Optional[np.ndarray] = None,
                 drops: Optional[np.ndarray] = None,
                 extra: Optional[np.ndarray] = None,
                 xlat: Optional[np.ndarray] = None,
                 nevents: Optional[np.ndarray] = None,
                 quic: Optional[np.ndarray] = None):
        self.events = events
        self.dns = dns
        self.drops = drops
        self.extra = extra
        self.xlat = xlat
        self.nevents = nevents
        self.quic = quic
        self.decode_stats: Optional[dict] = None
        self.packed = None
        self.trace = None

    def __len__(self) -> int:
        return len(self.events)


class FlowFetcher(Protocol):
    """What the pipeline needs from the datapath."""

    def lookup_and_delete(self) -> EvictedFlows:
        """Drain the kernel aggregation map (one eviction)."""
        ...

    def read_ringbuf(self, timeout_s: float) -> Optional[bytes]:
        """Block up to timeout_s for one raw flow event (map-full fallback).
        Returns None on timeout."""
        ...

    def read_ssl(self, timeout_s: float) -> Optional[bytes]:
        """Block up to timeout_s for one raw SSL plaintext event (OpenSSL
        uprobe ring buffer). Returns None on timeout."""
        ...

    def read_global_counters(self) -> dict[GlobalCounter, int]:
        """Scrape-and-reset the datapath's global counters."""
        ...

    def purge_stale(self, older_than_s: float) -> int:
        """Drop auxiliary-map entries (e.g. unanswered DNS correlations) older
        than the deadline; returns how many were purged. (Reference analog:
        DeleteMapsStaleEntries, `pkg/tracer/tracer.go:1188-1216`.)"""
        ...

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None: ...

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None: ...

    def close(self) -> None: ...


class FakeFetcher:
    """Injectable fetcher for tests and pcap/synthetic replay.

    Push map dumps with `inject_eviction`, ringbuf events with
    `inject_ringbuf` (`netobserv_tpu/datapath/fetcher.py:105-170`)."""

    def __init__(self):
        self._evictions: queue.Queue[EvictedFlows] = queue.Queue()
        self._ringbuf: queue.Queue[bytes] = queue.Queue()
        self._ssl: queue.Queue[bytes] = queue.Queue()
        self._counters: dict[GlobalCounter, int] = {}
        self._lock = threading.Lock()
        self.attached: dict[int, str] = {}
        self.closed = False

    # --- injection side ---
    def inject_eviction(self, evicted: EvictedFlows) -> None:
        self._evictions.put(evicted)

    def inject_events(self, events: np.ndarray, **features) -> None:
        self.inject_eviction(EvictedFlows(events, **features))

    def inject_ringbuf(self, event: np.ndarray | bytes) -> None:
        if isinstance(event, np.ndarray):
            event = np.ascontiguousarray(
                event, dtype=binfmt.FLOW_EVENT_DTYPE).tobytes()
        self._ringbuf.put(event)

    def inject_ssl(self, event: bytes) -> None:
        self._ssl.put(event)

    def bump_counter(self, key: GlobalCounter, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    # --- FlowFetcher side ---
    def lookup_and_delete(self) -> EvictedFlows:
        try:
            return self._evictions.get_nowait()
        except queue.Empty:
            return EvictedFlows(np.zeros(0, dtype=binfmt.FLOW_EVENT_DTYPE))

    def read_ringbuf(self, timeout_s: float) -> Optional[bytes]:
        try:
            return self._ringbuf.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def read_ssl(self, timeout_s: float) -> Optional[bytes]:
        try:
            return self._ssl.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def read_global_counters(self) -> dict[GlobalCounter, int]:
        with self._lock:
            out, self._counters = self._counters, {}
        return out

    def purge_stale(self, older_than_s: float) -> int:
        self.purged_calls = getattr(self, "purged_calls", 0) + 1
        return 0

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None:
        # keyed like the real fetchers: ifindex values repeat across netns
        self.attached[(netns, if_index) if netns else if_index] = if_name

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None:
        self.attached.pop((netns, if_index) if netns else if_index, None)

    def close(self) -> None:
        self.closed = True
