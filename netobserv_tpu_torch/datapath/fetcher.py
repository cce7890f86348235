"""One map eviction as the sketch exporter takes it.

Counterpart of `netobserv_tpu/datapath/fetcher.py` `EvictedFlows` (`:22`),
its fields only: the flow events, the five feature lanes the sketch
plane reads, the per-CPU event counters (`nevents`, which the overload
controller thins with the rows), the drain's `decode_stats` and a batch
trace (`trace`) where one rides the eviction. The fetchers are not
here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class EvictedFlows:
    """One map eviction: `events` is a FLOW_EVENT_DTYPE array
    (`model/binfmt`), and each feature lane (`extra`, `dns`, `drops`,
    `xlat`, `quic`, of their `binfmt` record dtypes) is row for row with
    it, or None when the feature is off. A lane shorter than the events
    stands for zero rows past its end. `decode_stats` (the producing
    drain's stage seconds) and `trace` (a sampled batch trace) are None
    unless set."""

    __slots__ = ("events", "extra", "dns", "drops", "xlat", "quic",
                 "nevents", "decode_stats", "trace")

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
        self.trace = None

    def __len__(self) -> int:
        return len(self.events)
