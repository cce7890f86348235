"""Flight recorder: sampled end-to-end batch tracing with stage spans.

A copy of `netobserv_tpu/utils/tracing.py` (lines 1-443), the
per-thread active trace (`set_active`, `clear_active`, `active_trace`,
`:402-423`) among it, which the kernel fetchers' drains read. The map
tracer (`flow/map_tracer.py`) births a "batch" trace at each eviction
(span `evict`) and hangs a sampled one on the eviction; the exporter's
next fold finishes it (span `fold` and the ring's spans). `context_of` serves the delta frame's sender; `continue_trace`
(its receiver) and trace groups (`group`, `TraceGroup`) serve the
federation aggregator, which continues a sampled agent's trace and parks
it until the window it fed closes.

A *trace* follows one unit of work through the pipeline — a "fold" trace
wraps one fold of the exporter (its staging ring's `staging_wait`, `pack`
or `resident_pack` and `ingest_dispatch` spans ride it); a "window" trace
is born at window roll (`roll_drain`, `roll_dispatch`) and rides the queued
report through render, the query snapshot's publish and sink delivery
(`report_render`, `query_snapshot`, `report_sink`) on the window thread. Each pipeline stage wraps its work in a *span*
(``with trace.stage("resident_pack"): ...``); completed traces land in a
fixed-size ring buffer (the flight recorder, :func:`snapshot`) and every
span duration feeds the ``stage_seconds{stage=...}`` histogram family when
a Metrics facade is bound (:func:`set_metrics`, done by the exporter when
it is given a registry). The gap between a window trace's
``roll_dispatch`` and its ``report_render`` is the report's queue wait.

Sampling and the zero-cost contract:

- ``TRACE_SAMPLE`` (env, float in [0, 1], default 0/unset = disabled) is the
  per-trace sampling rate, applied deterministically PER TRACE KIND (every
  round(1/rate)-th :func:`start_trace` call of that kind samples, so
  ``TRACE_SAMPLE=1`` traces everything and tests are reproducible).
- Disabled (the default), :func:`start_trace` is one module-bool check
  returning the shared :data:`NULL_TRACE`, whose ``stage()`` returns the
  shared :data:`NULL_SPAN` context manager — no locks, no timestamps, no
  allocations anywhere on the fold path.
- Unsampled calls while enabled cost one int increment + one modulo.

``TRACE_RING`` (env, default 64) bounds how many completed traces the
recorder keeps; snapshots are newest-first.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

__all__ = [
    "NULL_SPAN", "NULL_TRACE", "Trace", "FlightRecorder", "TraceContext",
    "start_trace", "configure", "set_metrics", "snapshot", "enabled",
    "context_of", "continue_trace", "group", "TraceGroup",
    "set_active", "clear_active", "active_trace",
]


class _NullSpan:
    """Shared no-op context manager handed out whenever tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _NullTrace:
    """Shared do-nothing trace: every un-sampled batch carries this."""

    __slots__ = ()
    sampled = False

    def stage(self, name: str):
        return NULL_SPAN

    def finish(self) -> None:
        pass


NULL_TRACE = _NullTrace()


class TraceContext(NamedTuple):
    """Serializable identity of a sampled trace, for crossing a process
    boundary (the delta frame's optional ``trace_ctx`` field). ``trace_id``
    is the fleet-unique hex id (process salt + local counter), ``origin``
    names the span/process that exported it, ``sampled`` is the origin's
    sampling verdict — carried explicitly so an unsampled context decoded
    off a hand-built frame still resolves to NULL_TRACE."""

    trace_id: str
    origin: str = ""
    sampled: bool = True


class _Span:
    __slots__ = ("stage", "t0", "t1", "thread")

    def __init__(self, stage: str, t0: float, t1: float, thread: str):
        self.stage = stage
        self.t0 = t0
        self.t1 = t1
        self.thread = thread


class _SpanCtx:
    """Context manager recording one stage span onto its trace (records on
    exit even when the stage raised — a failed stage's duration is evidence,
    not noise)."""

    __slots__ = ("_trace", "_stage", "_t0")

    def __init__(self, trace: "Trace", stage: str):
        self._trace = trace
        self._stage = stage
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._trace._add(self._stage, self._t0, time.perf_counter())
        return False


class Trace:
    """One sampled unit of work. Spans may be appended from several threads
    (evict on the map-tracer thread, fold on the exporter thread, publish on
    the window timer), so appends take a per-trace lock — sampled traces are
    rare by construction, the lock never sits on the un-sampled path."""

    __slots__ = ("kind", "id", "trace_id", "origin", "unix_t0", "t0",
                 "spans", "_lock", "_done")
    sampled = True

    def __init__(self, kind: str, local_id: int,
                 trace_id: Optional[str] = None, origin: str = ""):
        self.kind = kind
        self.id = local_id
        # fleet-unique hex id: process salt + local counter for traces born
        # here; a continued trace ADOPTS the origin's id verbatim so the
        # recorder entries on both sides correlate by one string
        self.trace_id = (trace_id if trace_id is not None
                         else f"{_salt}{local_id:08x}")
        self.origin = origin
        self.unix_t0 = time.time()
        self.t0 = time.perf_counter()
        self.spans: list[_Span] = []
        self._lock = threading.Lock()
        self._done = False

    def stage(self, name: str) -> _SpanCtx:
        return _SpanCtx(self, name)

    def _add(self, stage: str, t0: float, t1: float) -> None:
        with self._lock:
            if not self._done:
                self.spans.append(_Span(
                    stage, t0, t1, threading.current_thread().name))

    def finish(self) -> None:
        """Seal the trace and hand it to the flight recorder (idempotent —
        a batch trace that merged into an already-traced fold is finished
        by whoever holds it last)."""
        with self._lock:
            if self._done:
                return
            self._done = True
            spans = list(self.spans)
        m = _metrics
        if m is not None:
            for s in spans:
                m.observe_stage(s.stage, s.t1 - s.t0)
        if spans:
            _recorder.add(self)

    def render(self) -> dict:
        """JSON-ready view: spans sorted by start, durations and the
        queue-wait gap to the previous stage in milliseconds."""
        with self._lock:
            spans = sorted(self.spans, key=lambda s: s.t0)
        stages = []
        prev_t1: Optional[float] = None
        for s in spans:
            stages.append({
                "stage": s.stage,
                "thread": s.thread,
                "offset_ms": round((s.t0 - self.t0) * 1e3, 3),
                "dur_ms": round((s.t1 - s.t0) * 1e3, 3),
                # inter-stage gap = queue wait (negative means the spans
                # overlapped across threads; reported raw, not clipped)
                "gap_ms": (round((s.t0 - prev_t1) * 1e3, 3)
                           if prev_t1 is not None else 0.0),
            })
            prev_t1 = s.t1
        total = (spans[-1].t1 - spans[0].t0) if spans else 0.0
        out = {
            "id": self.id,
            "trace_id": self.trace_id,
            "kind": self.kind,
            "start_unix_ms": int(self.unix_t0 * 1e3),
            "total_ms": round(total * 1e3, 3),
            "stages": stages,
        }
        if self.origin:
            out["origin"] = self.origin
        return out


class _GroupSpan:
    """Context manager fanning one stage span out to several traces."""

    __slots__ = ("_ctxs",)

    def __init__(self, ctxs: list):
        self._ctxs = ctxs

    def __enter__(self):
        for c in self._ctxs:
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in self._ctxs:
            c.__exit__(*exc)
        return False


class TraceGroup:
    """Several sampled traces sharing the same spans — the aggregator's
    window close, where one roll/publish serves every agent trace continued
    into that window plus the aggregator's own window trace. stage() fans
    out to each member; finish() seals them all (Trace.finish is
    idempotent, so a member finished elsewhere is harmless)."""

    __slots__ = ("traces",)
    sampled = True

    def __init__(self, traces: list):
        self.traces = traces

    def stage(self, name: str) -> _GroupSpan:
        return _GroupSpan([t.stage(name) for t in self.traces])

    def finish(self) -> None:
        for t in self.traces:
            t.finish()


def group(*traces):
    """Combine traces for shared spans: drops unsampled members, collapses
    to the single member or the shared NULL_TRACE when possible (so the
    common nothing-sampled case allocates nothing)."""
    live = [t for t in traces if t.sampled]
    if not live:
        return NULL_TRACE
    if len(live) == 1:
        return live[0]
    return TraceGroup(live)


class FlightRecorder:
    """Fixed-size ring of completed traces."""

    def __init__(self, capacity: int = 64):
        self._dq: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._dq.append(trace)

    def snapshot(self, limit: Optional[int] = None,
                 trace_id: Optional[str] = None) -> list[dict]:
        """Newest-first JSON-ready dump (the /debug/traces body).
        ``trace_id`` keeps only traces with that exact hex id (the
        cross-process correlation lookup); ``limit`` caps the result
        AFTER filtering."""
        with self._lock:
            traces = list(self._dq)
        out = [t.render() for t in reversed(traces)]
        if trace_id is not None:
            out = [t for t in out if t.get("trace_id") == trace_id]
        if limit is not None and limit >= 0:
            out = out[:limit]
        return out

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


# --- module state ----------------------------------------------------------

_enabled = False
# sample every _period-th start_trace() call PER KIND: a single shared
# counter would alias with the pipeline's periodic call pattern (each
# eviction issues one "batch" and one "fold" call, so at rate 0.5 one kind
# would land on the sampled residue every time and the other never; the
# once-per-window "window" call would pin to one residue at low rates).
# Kept >= 1 at ALL times so a concurrent configure(0) can never expose a
# modulo-by-zero to a hot-path thread that already saw _enabled=True.
_period = 1
# itertools.count: atomic under the GIL — start_trace is called from the
# map-tracer, exporter, and timer threads concurrently, and a plain `+= 1`
# would lose increments (skewing the deterministic period) and hand out
# duplicate trace ids
_counters: dict = {}
_counters_lock = threading.Lock()
_next_id = itertools.count(1)
# process-scoped salt prefixing every locally-born trace id: two agents (or
# an agent and the aggregator) must never mint the same hex id, or the
# cross-process correlation at /debug/traces?trace= aliases unrelated work
_salt = (f"{os.getpid() & 0xffffffff:08x}"
         f"{int.from_bytes(os.urandom(4), 'big'):08x}")
_metrics = None  # Metrics facade (set_metrics); observe_stage sink
_recorder = FlightRecorder(int(os.environ.get("TRACE_RING", "64") or 64))

recorder = _recorder  # public alias (server/debug.py, tests)


def configure(sample: Optional[float] = None,
              capacity: Optional[int] = None) -> None:
    """(Re)configure sampling; ``None`` re-reads the TRACE_SAMPLE env var.
    Rates in (0, 1] sample every round(1/rate)-th trace; 0 disables."""
    global _enabled, _period, _counters, _recorder, recorder
    if sample is None:
        sample = float(os.environ.get("TRACE_SAMPLE", "0") or 0)
    if not 0.0 <= sample <= 1.0:
        raise ValueError(f"TRACE_SAMPLE={sample!r} must be in [0, 1]")
    if capacity is not None:
        _recorder = recorder = FlightRecorder(capacity)
    _counters = {}
    if sample <= 0.0:
        _enabled = False  # _period stays >= 1 (hot-path race safety above)
    else:
        _period = max(1, round(1.0 / sample))
        _enabled = True


def enabled() -> bool:
    return _enabled


def start_trace(kind: str = "batch"):
    """The hot-path entry: returns a live :class:`Trace` for sampled calls,
    the shared :data:`NULL_TRACE` otherwise. Disabled = one bool check.
    Sampling is deterministic PER KIND (see _period above)."""
    if not _enabled:
        return NULL_TRACE
    c = _counters.get(kind)
    if c is None:
        with _counters_lock:
            c = _counters.setdefault(kind, itertools.count(1))
    if next(c) % _period:
        return NULL_TRACE
    return Trace(kind, next(_next_id))


def context_of(trace, origin: str = "") -> Optional[TraceContext]:
    """Serializable context of a sampled trace, or ``None``. The zero-cost
    gate for the wire: NULL_TRACE (tracing off or this window unsampled)
    answers None in one attribute check, and the caller stamps nothing —
    the frame stays byte-identical to the context-less encoding."""
    if not trace.sampled:
        return None
    return TraceContext(trace.trace_id, origin or trace.kind, True)


def continue_trace(ctx, kind: str = "batch"):
    """Continue a propagated trace in THIS process: a live :class:`Trace`
    adopting the context's trace id, or the shared NULL_TRACE when tracing
    is disabled here or the context is absent/unsampled. The origin's
    sampling verdict is honored as-is — the local period applies only to
    locally-born traces."""
    if not _enabled or ctx is None or not ctx.sampled or not ctx.trace_id:
        return NULL_TRACE
    return Trace(kind, next(_next_id), trace_id=ctx.trace_id,
                 origin=ctx.origin)


def set_metrics(metrics) -> None:
    """Bind the Metrics facade whose ``observe_stage`` receives every span
    of every finished trace (stage_seconds{stage=...})."""
    global _metrics
    _metrics = metrics


def snapshot(limit: Optional[int] = None,
             trace_id: Optional[str] = None) -> list[dict]:
    """Newest-first completed traces (the /debug/traces payload); see
    :meth:`FlightRecorder.snapshot` for the filter params."""
    return _recorder.snapshot(limit=limit, trace_id=trace_id)


# Per-thread active trace: lets a deep callee (the kernel drain inside
# BpfmanFetcher.lookup_and_delete) attach child spans to the trace born in
# map_tracer WITHOUT widening the FlowFetcher protocol. Only SAMPLED traces
# are ever bound (map_tracer gates on trace.sampled), so the disabled path
# pays nothing for the binding; the callee's active_trace() lookup is one
# thread-local getattr PER DRAIN, never per record.
_active = threading.local()


def set_active(trace) -> None:
    """Bind `trace` as the calling thread's active trace (sampled only).

    Reference: `netobserv_tpu/utils/tracing.py:411`."""
    _active.trace = trace


def clear_active() -> None:
    """Reference: `netobserv_tpu/utils/tracing.py:416`."""
    _active.trace = None


def active_trace():
    """The calling thread's bound trace, or the shared NULL_TRACE.

    Reference: `netobserv_tpu/utils/tracing.py:420`."""
    t = getattr(_active, "trace", None)
    return NULL_TRACE if t is None else t


# arm from the environment at import; unset -> disabled, start_trace stays
# on the one-branch path
if os.environ.get("TRACE_SAMPLE"):
    configure()
