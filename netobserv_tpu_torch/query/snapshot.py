"""The exporter's query snapshot publisher.

A copy of `netobserv_tpu/query/snapshot.py` (`SnapshotPublisher`,
`:1-106`). The exporter publishes one snapshot per window roll and,
with `query_refresh_s`, mid-window refreshes, from its window thread;
the `/query/*` routes read it from any HTTP thread. A publish stamps a
fresh dict with the next ``seq`` under the lock and swaps the whole
reference, so a reader holding a snapshot sees one window's consistent
view, and pollers order answers by ``(window, seq)``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


class SnapshotPublisher:
    """Thread-safe single-slot snapshot store with a publish sequence.

    `history > 0` additionally keeps a ring of the last N CLOSED-window
    snapshots (ROLL publishes only — mid-window refreshes are the live
    view, not history; a refresh and its eventual roll share a window id,
    and the roll's final snapshot is what the ring keeps). The ring powers
    the `/query/*?window=<id>` back-scroll: point-in-time reads of past
    windows, still snapshot-only — published dicts are immutable by the
    publish contract, so a ring entry is as torn-read-proof as the live
    slot. Evicted (or never-published) ids read as None → the routes
    answer 404."""

    def __init__(self, history: int = 0):
        self._lock = threading.Lock()
        self._snap: Optional[dict] = None
        self._seq = 0
        self._published = 0
        self._refreshes = 0
        self._history_cap = max(0, int(history))
        #: window id -> closed-window snapshot, oldest first
        self._history: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        # age is measured from construction until the first publish so the
        # gauge reads "how stale is the queryable view" even before any
        # window closed
        self._last_pub_mono = time.monotonic()

    def publish(self, snap: dict, mid_window: bool = False) -> int:
        """Stamp `snap` with the next seq and swap it in. `snap` must be a
        fresh dict the caller never mutates afterwards."""
        with self._lock:
            self._seq += 1
            snap["seq"] = self._seq
            snap["mid_window"] = bool(mid_window)
            self._snap = snap
            self._published += 1
            if mid_window:
                self._refreshes += 1
            elif self._history_cap:
                wid = int(snap["window"])
                self._history.pop(wid, None)  # re-publish: move to newest
                self._history[wid] = snap
                while len(self._history) > self._history_cap:
                    self._history.popitem(last=False)
            self._last_pub_mono = time.monotonic()
            return self._seq

    def get(self) -> Optional[dict]:
        """The last published snapshot (None before the first publish)."""
        with self._lock:
            return self._snap

    def get_window(self, window: int) -> Optional[dict]:
        """Point-in-time read: the CLOSED-window snapshot for `window`, or
        None when it was evicted from the ring (or never rolled)."""
        with self._lock:
            return self._history.get(int(window))

    def windows(self) -> list[int]:
        """Window ids currently held by the back-scroll ring (oldest
        first) — the /query/status discovery surface."""
        with self._lock:
            return list(self._history.keys())

    def age_s(self) -> float:
        """Seconds since the last publish (since construction when none) —
        the `query_snapshot_age_seconds` gauge source."""
        with self._lock:
            return max(0.0, time.monotonic() - self._last_pub_mono)

    def stats(self) -> dict:
        with self._lock:
            return {
                "published": self._snap is not None,
                "seq": self._seq,
                "window": None if self._snap is None
                else self._snap["window"],
                "mid_window": bool(self._snap and self._snap["mid_window"]),
                "snapshots_published": self._published,
                "mid_window_refreshes": self._refreshes,
                "history_cap": self._history_cap,
                "history_windows": list(self._history.keys()),
                "snapshot_age_s": round(
                    max(0.0, time.monotonic() - self._last_pub_mono), 3),
            }
