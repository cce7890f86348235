"""The compile watch: each captured fold's captures counted, and a capture
after warm-up raised as an alarm.

Counterpart of `netobserv_tpu/utils/retrace.py` (`Watched`, `watch`,
`snapshot`, `total_retraces`). JAX compiles a jitted fold once per
abstract signature, and compiles again when a call's signature changes.
The port captures its fold as a CUDA graph (`sketch/capture.py`) bound to
the storage of its arguments, and captures again when a call's binding
changes: a tensor rebound to new storage, a new shape, another state.
That second capture is what the watch is for:

- each captured fold is a watched entry (`watch`), with its calls, their
  host seconds (`dispatch_seconds`), its compiles (graph captures, noted
  by the fold with `Watched.note_compile`) and their seconds;
- a compile within an entry's first `warmup_calls` calls (default 1,
  `RETRACE_WARMUP_CALLS`) is warm-up. A compile on a later call is a
  retrace: it adds to the entry's `retraces` and to `total_retraces()`,
  and logs the signature of the arguments it was captured for.

`RETRACE_WATCHDOG=0` disables the watch: `watch` returns the function
untouched and nothing is counted. The wrapper costs one clock pair per
call, once a fold, never per record.

`set_metrics` binds a metrics facade (`metrics/registry.Metrics`, as the
reference's `set_metrics`, `utils/retrace.py:261-265`): each call's host
seconds go to `executable_dispatch_seconds_total{fn}` and each retrace to
`sketch_retraces_total{fn}`.

`snapshot` and `total_retraces` also serve `/debug/executables` and
`/debug/torch` (`server/debug.py`). Not here: the kernel-library builds
(they happen once per process, outside any graph).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Any, Callable, Optional

log = logging.getLogger("netobserv_tpu_torch.retrace")

_enabled = os.environ.get("RETRACE_WATCHDOG", "1").strip().lower() not in (
    "0", "false", "no", "off")
_default_warmup = int(os.environ.get("RETRACE_WARMUP_CALLS", "1") or 1)
_lock = threading.Lock()
#: every live entry, weakly: a closed exporter's entries drop out
_registry: list["weakref.ref[Watched]"] = []
#: process-lifetime alarm count; survives the entries
_retraces_total = 0
#: the bound metrics facade (`set_metrics`), or None
_metrics = None


def describe(args: Any, limit: int = 600) -> str:
    """dtype[shape] of every tensor in `args` (nested tuples, named or
    not), in order."""
    parts = []

    def walk(x):
        if hasattr(x, "dtype") and hasattr(x, "shape"):
            parts.append(f"{str(x.dtype).replace('torch.', '')}"
                         f"{list(x.shape)}")
        elif isinstance(x, tuple):
            for v in x:
                walk(v)

    walk(args)
    desc = " ".join(parts)
    return desc if len(desc) <= limit else desc[:limit] + "...(truncated)"


class Watched:
    """A callable entry point with its compile accounting."""

    __slots__ = ("_fn", "name", "warmup_calls", "calls", "compiles",
                 "retraces", "last_retrace", "dispatch_seconds",
                 "compile_seconds", "last_signature", "__weakref__")

    def __init__(self, fn: Callable, name: str, warmup_calls: int):
        self._fn = fn
        self.name = name
        self.warmup_calls = warmup_calls
        self.calls = 0
        self.compiles = 0
        self.retraces = 0
        self.last_retrace = ""
        self.dispatch_seconds = 0.0
        self.compile_seconds = 0.0
        self.last_signature = ""

    def __call__(self, *args, **kwargs):
        self.calls += 1
        t0 = time.perf_counter()
        try:
            return self._fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            self.dispatch_seconds += dt
            m = _metrics
            if m is not None:
                m.observe_dispatch(self.name, dt)

    def note_compile(self, seconds: float, signature: str) -> None:
        """Count a compile made by the current call, for arguments of
        `signature`."""
        global _retraces_total
        self.compiles += 1
        self.compile_seconds += seconds
        self.last_signature = signature
        if self.calls <= self.warmup_calls:
            return  # warm-up
        self.retraces += 1
        with _lock:
            _retraces_total += 1
        self.last_retrace = signature
        log.error("capture after warm-up in watched entry %r (call %d, "
                  "compile %d): a bound tensor or a fold shape changed; "
                  "signature: %s",
                  self.name, self.calls, self.compiles, signature)
        m = _metrics
        if m is not None:
            m.count_retrace(self.name)

    def stats(self) -> dict:
        return {"fn": self.name, "calls": self.calls,
                "compiles": self.compiles, "retraces": self.retraces,
                "warmup_calls": self.warmup_calls,
                "dispatch_seconds": round(self.dispatch_seconds, 6),
                "compile_seconds": round(self.compile_seconds, 6),
                **({"last_signature": self.last_signature}
                   if self.last_signature else {}),
                **({"last_retrace": self.last_retrace}
                   if self.last_retrace else {})}


def watch(fn: Callable, name: str,
          warmup_calls: Optional[int] = None) -> Callable:
    """Wrap `fn` as a watched entry named `name`. Returns `fn` unchanged
    when the watch is disabled; never wraps twice."""
    if not _enabled or isinstance(fn, Watched):
        return fn
    w = Watched(fn, name, _default_warmup if warmup_calls is None
                else warmup_calls)
    with _lock:
        _registry.append(weakref.ref(w))
        if len(_registry) % 64 == 0:  # sweep dead entries now and then
            _registry[:] = [r for r in _registry if r() is not None]
    return w


def set_metrics(metrics) -> None:
    """Bind the metrics facade whose `count_retrace` receives post-warm-up
    captures (`sketch_retraces_total{fn=...}`) and whose
    `observe_dispatch` receives each call's host seconds; None unbinds."""
    global _metrics
    _metrics = metrics


def snapshot() -> list[dict]:
    """The stats of every live watched entry."""
    with _lock:
        live = [w for w in (r() for r in _registry) if w is not None]
    return [w.stats() for w in live]


def total_retraces() -> int:
    """Retraces over the process's life (entries since dropped
    included)."""
    return _retraces_total
