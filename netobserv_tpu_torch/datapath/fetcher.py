"""One map eviction as the sketch exporter takes it.

Counterpart of `netobserv_tpu/datapath/fetcher.py` `EvictedFlows` (`:22`),
its fields only: the flow events and the five feature lanes the sketch
plane reads. The per-CPU event counters (`nevents`), the decode timings
and the fetchers are not here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class EvictedFlows:
    """One map eviction: `events` is a FLOW_EVENT_DTYPE array
    (`model/binfmt`), and each feature lane (`extra`, `dns`, `drops`,
    `xlat`, `quic`, of their `binfmt` record dtypes) is row for row with
    it, or None when the feature is off. A lane shorter than the events
    stands for zero rows past its end."""

    __slots__ = ("events", "extra", "dns", "drops", "xlat", "quic")

    def __init__(self, events: np.ndarray,
                 dns: Optional[np.ndarray] = None,
                 drops: Optional[np.ndarray] = None,
                 extra: Optional[np.ndarray] = None,
                 xlat: Optional[np.ndarray] = None,
                 quic: Optional[np.ndarray] = None):
        self.events = events
        self.dns = dns
        self.drops = drops
        self.extra = extra
        self.xlat = xlat
        self.quic = quic
