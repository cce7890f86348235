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

The profiler mirror: while a ``torch.profiler`` session records the thread
that opens a span of a live trace, the span also opens
``record_function("netobserv.<stage>")``, so a profiler trace shows the
program's stages on the kernels' clock. The profiler records only the
thread that started it: a span opened on another thread (``pack_lane`` on
the Python packer's pool) feeds ``stage_seconds`` alone, as does a span of
a duration measured elsewhere (``Trace.record``: ``pack_lane`` of the
native segment pack, each region's pack time on its native thread).

The device timeline (:class:`Timeline`, one an exporter on one CUDA
device): at any ``TRACE_SAMPLE`` above 0 it times EVERY fold and roll,
sampled or not, since an idle gap needs both of its neighbours. An ingest
dispatch's slot copy and its fold, and a roll's device work, each lie
between two timing CUDA events from a bounded pool (:func:`timed`); their
elapsed time feeds ``device_busy_seconds_total{span}``. The device time
between one interval's end and the next one's start is idle: it ends at
the host stamp taken when the opening event of the next was recorded
(the card, idle, reached it within the launch latency) and is split over
the exporter's phase log
(:class:`PhaseLock` and :func:`stage` mark it) into
``device_idle_seconds_total{phase}``: ``pack``, ``dispatch``, ``roll``,
``entry`` (the rest under the exporter's lock) and ``caller`` (the lock
free). Busy time and the five phases partition the timeline. Events are
read back with ``query()`` only, never waited on. Disabled, a fold pays
the bool check of :func:`stage` and :class:`PhaseLock`: no event, no
stamp, no allocation, no profiler query.
"""

from __future__ import annotations

import functools
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
    "PHASES", "Timeline", "PhaseLock", "device_timeline", "stage", "timed",
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

    def record(self, name: str, seconds: float) -> None:
        pass

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


_torch = None  # torch, imported at the first live span


def _profiler_range(stage: str):
    """An open ``record_function("netobserv.<stage>")`` when a
    torch.profiler session records the calling thread, else None."""
    global _torch
    if _torch is None:
        import torch
        import torch.autograd.profiler  # noqa: F401 (the flag below)
        _torch = torch
    if not (_torch.autograd.profiler._is_profiler_enabled
            and _torch.autograd._profiler_enabled()):
        return None
    rf = _torch.profiler.record_function("netobserv." + stage)
    rf.__enter__()
    return rf


class _SpanCtx:
    """Context manager recording one stage span onto its trace (records on
    exit even when the stage raised — a failed stage's duration is evidence,
    not noise), mirrored to the profiler (module docstring)."""

    __slots__ = ("_trace", "_stage", "_t0", "_rf")

    def __init__(self, trace: "Trace", stage: str):
        self._trace = trace
        self._stage = stage
        self._t0 = 0.0
        self._rf = None

    def __enter__(self):
        self._rf = _profiler_range(self._stage)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._trace._add(self._stage, self._t0, time.perf_counter())
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
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

    def record(self, name: str, seconds: float) -> None:
        """A span of a duration measured elsewhere (native code's clock),
        ending now; the profiler does not see it."""
        t1 = time.perf_counter()
        self._add(name, t1 - seconds, t1)

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

    def record(self, name: str, seconds: float) -> None:
        for t in self.traces:
            t.record(name, seconds)

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


# --- device timeline (module docstring) ------------------------------------

#: the exporter phase each span marks while it is open (innermost wins);
#: under the exporter's lock and in none of them: "entry"; the lock free:
#: "caller"
PHASES = {"pack": "pack", "resident_pack": "pack",
          "ingest_dispatch": "dispatch",
          "roll_drain": "roll", "roll_dispatch": "roll"}


class Timeline:
    """The device timeline of one exporter (module docstring). Every call
    comes from the thread holding the exporter's lock, so it keeps no lock
    of its own.

    `event()` makes a timing event (`record(stream)`, `query()`,
    `elapsed_time(other)` in ms), `stream()` gives the stream to record
    on, `capturing()` says whether that stream is being captured (no
    event is recorded inside a capture) and `clock()` is the host clock
    of the phase log. `busy` (by span) and `idle` (by phase) sum what has
    been read, in seconds; `made` counts the events the pool made, at
    most `POOL`. An interval that finds the pool empty is not timed: the
    gap across it is dropped, so the partition holds over what is timed."""

    #: events the pool makes at most (two an interval; the host runs at
    #: most a few dispatches ahead of the device)
    POOL = 64
    #: phase-log entries kept at most while nothing is read
    LOG = 4096

    def __init__(self, event, stream=lambda: None, capturing=lambda: False,
                 clock=time.perf_counter):
        self._event = event
        self._stream = stream
        self._capturing = capturing
        self._clock = clock
        self._free: list = []
        self.made = 0
        # [span, before, its host stamp, after, its host stamp], oldest
        # first, not yet read; None where an interval went untimed
        self._open: deque = deque()
        self._cur: Optional[list] = None
        # (after event, host stamp) of the last interval read
        self._prev: Optional[tuple] = None
        # (host time, phase) at each change of phase, oldest first
        self._log: deque = deque([(clock(), "caller")], maxlen=self.LOG)
        self._stack: list = []
        self.busy: dict = {}
        self.idle: dict = {}
        self._busy_family = self._idle_family = None

    def bind(self, metrics) -> None:
        """Feed `device_busy_seconds_total{span}` and
        `device_idle_seconds_total{phase}` of `metrics` (None: none)."""
        self._busy_family = getattr(metrics, "device_busy_seconds_total",
                                    None)
        self._idle_family = getattr(metrics, "device_idle_seconds_total",
                                    None)

    # -- the phase log

    def _mark(self, phase: str) -> None:
        if self._log[-1][1] != phase:
            self._log.append((self._clock(), phase))

    def taken(self) -> None:
        """The exporter's lock was taken: phase "entry"."""
        self._stack.clear()
        self._stack.append("entry")
        self._mark("entry")

    def freed(self) -> None:
        """The exporter's lock is about to be freed: phase "caller"."""
        self._stack.clear()
        self._mark("caller")

    def push(self, phase: str) -> None:
        self._stack.append(phase)
        self._mark(phase)

    def pop(self) -> None:
        if self._stack:
            self._stack.pop()
        self._mark(self._stack[-1] if self._stack else "caller")

    # -- the intervals

    def _take(self):
        if self._free:
            return self._free.pop()
        if self.made < self.POOL:
            self.made += 1
            return self._event()
        return None

    def begin(self, span: str) -> None:
        """Record the event that opens an interval of `span`'s device
        work, and its host stamp."""
        if self._capturing():
            return
        before = self._take()
        after = self._take() if before is not None else None
        if after is None:
            if before is not None:
                self._free.append(before)
            if not self._open or self._open[-1] is not None:
                self._open.append(None)
            return
        before.record(self._stream())
        self._cur = [span, before, self._clock(), after, 0.0]

    def end(self) -> None:
        """Record the event that closes the open interval, if any."""
        cur = self._cur
        if cur is None:
            return
        self._cur = None
        cur[3].record(self._stream())
        cur[4] = self._clock()
        self._open.append(cur)

    def poll(self) -> None:
        """Read every interval whose closing event is done, oldest first,
        stopping at the first that is not (never waits): its busy time,
        and the idle gap before it split over the phase log."""
        busy: dict = {}
        idle: dict = {}
        opened = self._open
        while opened:
            iv = opened[0]
            if iv is None:  # an untimed interval: no gap across it
                opened.popleft()
                if self._prev is not None:
                    self._free.append(self._prev[0])
                    self._prev = None
                continue
            span, before, t_before, after, t_after = iv
            if not after.query():
                break
            opened.popleft()
            busy[span] = busy.get(span, 0.0) + \
                before.elapsed_time(after) / 1e3
            if self._prev is not None:
                gap = max(0.0, self._prev[0].elapsed_time(before) / 1e3)
                self._split(t_before - gap, t_before, idle)
                self._free.append(self._prev[0])
            self._free.append(before)
            self._prev = (after, t_after)
        if not busy:
            return
        # the next gap starts after the last read interval's end (none
        # across an untimed interval)
        log = self._log
        cut = self._prev[1] if self._prev is not None else float("inf")
        while len(log) > 1 and log[1][0] <= cut:
            log.popleft()
        self._add(self.busy, busy, self._busy_family)
        self._add(self.idle, idle, self._idle_family)

    def _split(self, a: float, b: float, out: dict) -> None:
        """Add [a, b] of the host clock to `out` by the phase in effect
        over each part; before the log's first entry, that entry's."""
        log = self._log
        last = len(log) - 1
        for i, (t, phase) in enumerate(log):
            lo = a if i == 0 else max(a, t)
            hi = b if i == last else min(b, log[i + 1][0])
            if hi > lo:
                out[phase] = out.get(phase, 0.0) + (hi - lo)
            if hi >= b:
                return

    @staticmethod
    def _add(total: dict, part: dict, family) -> None:
        for k, v in part.items():
            total[k] = total.get(k, 0.0) + v
            if family is not None:
                family.labels(k).inc(v)


def device_timeline(device) -> Optional[Timeline]:
    """A :class:`Timeline` of CUDA timing events on `device`'s current
    stream, or None off CUDA. It makes no event until tracing is on and a
    fold begins."""
    if getattr(device, "type", None) != "cuda":
        return None
    import torch
    return Timeline(functools.partial(torch.cuda.Event, enable_timing=True),
                    stream=lambda: torch.cuda.current_stream(device),
                    capturing=torch.cuda.is_current_stream_capturing)


class PhaseLock:
    """The exporter's lock, marking the timeline's phase: "entry" from the
    moment it is taken, "caller" from the moment it is freed."""

    __slots__ = ("_lock", "_timeline")

    def __init__(self, timeline: Timeline):
        self._lock = threading.Lock()
        self._timeline = timeline

    def __enter__(self):
        self._lock.acquire()
        if _enabled:
            self._timeline.taken()
        return True

    def __exit__(self, *exc):
        if _enabled:
            self._timeline.freed()
        self._lock.release()
        return False


class _PhaseSpan:
    """A stage span that also marks its phase (`PHASES`) on the timeline;
    an ingest dispatch first reads back what is done, and a roll's
    dispatch reads back everything when it ends, after the roll's host
    copy."""

    __slots__ = ("_span", "_timeline", "_stage")

    def __init__(self, span, timeline: Timeline, stage: str):
        self._span = span
        self._timeline = timeline
        self._stage = stage

    def __enter__(self):
        tl = self._timeline
        tl.push(PHASES[self._stage])
        if self._stage == "ingest_dispatch":
            tl.poll()
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        tl = self._timeline
        if self._stage == "roll_dispatch":
            tl.poll()
        tl.pop()
        return False


class _Interval:
    """The device work of a `with` block, timed on the timeline."""

    __slots__ = ("_timeline", "_span")

    def __init__(self, timeline: Timeline, span: str):
        self._timeline = timeline
        self._span = span

    def __enter__(self):
        self._timeline.begin(self._span)
        return self

    def __exit__(self, *exc):
        self._timeline.end()
        return False


def stage(trace, name: str, timeline: Optional[Timeline] = None):
    """``trace.stage(name)`` for a stage of `PHASES`; with tracing on and a
    timeline, also its phase (and the read-backs of `_PhaseSpan`)."""
    if not _enabled or timeline is None:
        return trace.stage(name)
    return _PhaseSpan(trace.stage(name), timeline, name)


def timed(timeline: Optional[Timeline], span: str):
    """Time the device work a `with` block enqueues as an interval of
    `span`, or with tracing off or no timeline do nothing. A dispatch
    times its slot's copy and its fold as two intervals, so the host's
    time between them (the launch), which the card waits out idle, is
    the `dispatch` phase's."""
    if not _enabled or timeline is None:
        return NULL_SPAN
    return _Interval(timeline, span)


# arm from the environment at import; unset -> disabled, start_trace stays
# on the one-branch path
if os.environ.get("TRACE_SAMPLE"):
    configure()
