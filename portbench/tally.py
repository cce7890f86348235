"""An in-memory metrics registry that the benchmark hands the agent.

The exporter takes a metrics facade and calls its families (`inc`,
`observe`, `set`, `labels`, `set_function`) and a few helpers
(`count_error`, `observe_stage`, `observe_dispatch`, `count_retrace`).
`Tally` answers every such call without prometheus_client and keeps, per
family and label values, the count of calls and the sum of the values
given, which the per-layer readers take deltas of.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class _Family:
    __slots__ = ("_tally", "_key")

    def __init__(self, tally: "Tally", key: tuple):
        self._tally, self._key = tally, key

    def labels(self, *values, **kw) -> "_Family":
        return _Family(self._tally, self._key + tuple(values)
                       + tuple(sorted(kw.items())))

    def _add(self, value: float) -> None:
        self._tally.add(self._key, value)

    def inc(self, value: float = 1.0) -> None:
        self._add(value)

    def observe(self, value: float) -> None:
        self._add(value)

    def set(self, value: float) -> None:
        self._tally.put(self._key, value)

    def set_function(self, fn) -> None:
        pass

    def __call__(self, *args) -> None:
        # a helper such as count_error("x") or observe_stage("pack", s)
        value = args[-1] if args and isinstance(args[-1], float) else 1.0
        labels = args[:-1] if args and isinstance(args[-1], float) else args
        self._tally.add(self._key + tuple(labels), value)


class Tally:
    """Counts and sums of every metric call (module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count: dict[tuple, int] = defaultdict(int)
        self.total: dict[tuple, float] = defaultdict(float)

    def __getattr__(self, name: str) -> _Family:
        if name.startswith("__"):
            raise AttributeError(name)
        return _Family(self, (name,))

    def add(self, key: tuple, value: float) -> None:
        with self._lock:
            self.count[key] += 1
            self.total[key] += float(value)

    def put(self, key: tuple, value: float) -> None:
        with self._lock:
            self.total[key] = float(value)

    def snapshot(self) -> tuple[dict, dict]:
        """(counts, sums) at this moment, copied."""
        with self._lock:
            return dict(self.count), dict(self.total)
