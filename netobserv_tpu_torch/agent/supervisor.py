"""Pipeline supervision: stage registry, heartbeats, bounded restarts.

A copy of `netobserv_tpu/agent/supervisor.py` (lines 1-272): `StageState`,
`_Stage` and `Supervisor`, host code only. In the port the sketch
exporter's window thread ("sketch-window") and overlapped fold thread
("sketch-fold"), and the federation aggregator's window thread, register
with it (`register_supervised`); the exporter also registers its
`overloaded` and `alerting` conditions. The agent (`agent/agent.py`) owns
one and registers its stages with it: the map tracer, the limiter and the
terminal ("map-tracer", "capacity-limiter", "exporter").

Every pipeline thread registers with the supervisor: a *thread getter*
(so crashes — dead threads — are detected), a *restart callable* (the
stage's own ``start()``), and a *heartbeat deadline* (so hangs — a live
thread that stopped beating — are detected too).

The monitor loop restarts failed stages with bounded exponential backoff and
counts restarts/failures in the metrics registry. A stage that keeps dying
past its restart budget is declared DEGRADED: the supervisor stops burning
restarts on it, trips the degraded gauge, and notifies the agent (which
transitions its own status machine to Degraded) — a stalled stage is an
explicit, machine-readable condition (/healthz), never a silent stall.

The budget is *consecutive*: a stage that stays healthy for
``healthy_reset_s`` after a restart earns its budget back (crash storms
degrade; a once-a-day hiccup never does).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("netobserv_tpu_torch.agent.supervisor")


class StageState(enum.Enum):
    RUNNING = "Running"
    RESTARTING = "Restarting"
    DEGRADED = "Degraded"
    STOPPED = "Stopped"


@dataclass
class _Stage:
    name: str
    restart: Callable[[], None]
    thread_getter: Callable[[], Optional[threading.Thread]]
    heartbeat_timeout_s: Optional[float]
    max_restarts: int
    backoff_initial_s: float
    backoff_max_s: float
    healthy_reset_s: float
    state: StageState = StageState.RUNNING
    last_beat: float = field(default_factory=time.monotonic)
    restarts: int = 0            # lifetime, for /healthz + metrics
    consecutive_failures: int = 0
    last_failure: str = ""       # "crash" | "hang" | ""
    next_restart_at: float = 0.0
    last_restart_at: float = 0.0


class Supervisor:
    """Monitors registered stages; restarts crashed/hung ones within budget.

    `on_degraded(stage_name)` fires (once per stage) when a restart budget
    is exhausted; the agent uses it to enter its Degraded status.
    """

    def __init__(self, metrics=None, check_period_s: float = 0.25,
                 on_degraded: Optional[Callable[[str], None]] = None):
        self._metrics = metrics
        self._period = check_period_s
        self._on_degraded = on_degraded
        self._stages: dict[str, _Stage] = {}
        #: named health CONDITIONS, probed at snapshot time — states a
        #: stage reports about itself that are not crash/hang/degraded
        #: (e.g. the exporter's OVERLOADED while the overload controller
        #: sheds load). A probe returns a dict with at least
        #: {"active": bool}; /healthz + /readyz surface them distinct
        #: from DEGRADED.
        self._conditions: dict[str, Callable[[], dict]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- registry ---
    def register(self, name: str, restart: Callable[[], None],
                 thread_getter: Callable[[], Optional[threading.Thread]],
                 heartbeat_timeout_s: Optional[float] = None,
                 max_restarts: int = 5, backoff_initial_s: float = 0.2,
                 backoff_max_s: float = 30.0,
                 healthy_reset_s: float = 30.0) -> Callable[[], None]:
        """Register a stage; returns its heartbeat callable (cheap, lock-free
        on the beat path — stages call it once per loop iteration)."""
        stage = _Stage(name=name, restart=restart,
                       thread_getter=thread_getter,
                       heartbeat_timeout_s=heartbeat_timeout_s,
                       max_restarts=max_restarts,
                       backoff_initial_s=backoff_initial_s,
                       backoff_max_s=backoff_max_s,
                       healthy_reset_s=healthy_reset_s)
        with self._lock:
            self._stages[name] = stage

        def beat(_s=stage) -> None:
            # a hang restart replaces the stage thread while the hung one is
            # still alive; if that zombie ever unblocks, it must NOT resume
            # draining shared queues next to its replacement. Its first beat
            # notices it was superseded and exits silently (threading
            # swallows SystemExit) — overlap is bounded to the one iteration
            # that was already in flight when it unblocked.
            current = _s.thread_getter()
            if current is not None and current is not threading.current_thread():
                raise SystemExit(f"superseded {_s.name} thread exiting")
            _s.last_beat = time.monotonic()

        return beat

    def register_stage(self, name: str, stage_obj,
                       **kwargs) -> Callable[[], None]:
        """Convenience for the repo's stage shape: ``start()`` (re)creates
        ``_thread``. Installs the heartbeat on ``stage_obj.heartbeat`` when
        the stage exposes that attribute."""
        beat = self.register(
            name, restart=stage_obj.start,
            thread_getter=lambda: getattr(stage_obj, "_thread", None),
            **kwargs)
        if hasattr(stage_obj, "heartbeat"):
            stage_obj.heartbeat = beat
        return beat

    # --- lifecycle ---
    def start(self) -> None:
        now = time.monotonic()
        with self._lock:
            for st in self._stages.values():
                st.last_beat = now
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._period * 8 + 1)
        with self._lock:
            for st in self._stages.values():
                if st.state != StageState.DEGRADED:
                    st.state = StageState.STOPPED

    def register_condition(self, name: str,
                           probe: Callable[[], dict]) -> None:
        """Register a named health condition (see `_conditions`). The
        latest registration under a name wins (a restarted stage
        re-registers its condition)."""
        with self._lock:
            self._conditions[name] = probe

    def conditions(self) -> dict:
        """Evaluate every registered condition probe. A raising probe
        reports {"active": False, "error": ...} — the health surface must
        answer even when a stage's introspection is broken."""
        with self._lock:
            probes = dict(self._conditions)
        out = {}
        for name, probe in probes.items():
            try:
                out[name] = probe()
            except Exception as exc:
                out[name] = {"active": False, "error": str(exc)}
        return out

    def condition_active(self, name: str) -> bool:
        with self._lock:
            probe = self._conditions.get(name)
        if probe is None:
            return False
        try:
            return bool(probe().get("active"))
        except Exception:
            return False

    # --- introspection (health surface) ---
    @property
    def degraded(self) -> bool:
        with self._lock:
            return any(s.state == StageState.DEGRADED
                       for s in self._stages.values())

    def snapshot(self) -> dict:
        """Machine-readable per-stage state for /healthz."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for name, s in self._stages.items():
                out[name] = {
                    "state": s.state.value,
                    "restarts": s.restarts,
                    "consecutive_failures": s.consecutive_failures,
                    "last_failure": s.last_failure,
                    "heartbeat_age_s": round(now - s.last_beat, 3),
                    "heartbeat_timeout_s": s.heartbeat_timeout_s,
                }
        return out

    # --- monitor loop ---
    def _loop(self) -> None:
        while not self._stop.wait(timeout=self._period):
            self._check_once()

    def _check_once(self) -> None:
        now = time.monotonic()
        with self._lock:
            stages = list(self._stages.values())
        for st in stages:
            if self._stop.is_set():
                return
            if st.state == StageState.DEGRADED:
                continue
            if st.state == StageState.RESTARTING:
                if now >= st.next_restart_at:
                    self._restart(st)
                continue
            thread = st.thread_getter()
            if thread is None or not thread.is_alive():
                self._fail(st, "crash")
            elif (st.heartbeat_timeout_s is not None
                    and now - st.last_beat > st.heartbeat_timeout_s):
                self._fail(st, "hang")
            elif (st.consecutive_failures
                    and now - st.last_restart_at >= st.healthy_reset_s):
                st.consecutive_failures = 0  # earned the budget back

    def _fail(self, st: _Stage, kind: str) -> None:
        st.last_failure = kind
        st.consecutive_failures += 1
        if self._metrics is not None:
            self._metrics.count_stage_failure(st.name, kind)
        if st.consecutive_failures > st.max_restarts:
            st.state = StageState.DEGRADED
            log.error("stage %s exhausted its restart budget (%d); "
                      "marking DEGRADED", st.name, st.max_restarts)
            if self._metrics is not None:
                self._metrics.set_stage_degraded(st.name, True)
            if self._on_degraded is not None:
                try:
                    self._on_degraded(st.name)
                except Exception:
                    log.exception("on_degraded callback failed")
            return
        backoff = min(
            st.backoff_initial_s * (2 ** (st.consecutive_failures - 1)),
            st.backoff_max_s)
        st.state = StageState.RESTARTING
        st.next_restart_at = time.monotonic() + backoff
        log.warning("stage %s %s detected (failure %d/%d); restarting in "
                    "%.2fs", st.name, kind, st.consecutive_failures,
                    st.max_restarts, backoff)

    def _restart(self, st: _Stage) -> None:
        try:
            st.restart()
        except Exception as exc:
            # a restart that itself blows up consumes budget like a crash
            log.error("stage %s restart failed: %s", st.name, exc)
            self._fail(st, "crash")
            return
        st.restarts += 1
        st.last_restart_at = st.last_beat = time.monotonic()
        st.state = StageState.RUNNING
        if self._metrics is not None:
            self._metrics.count_stage_restart(st.name)
        log.info("stage %s restarted (lifetime restarts: %d)",
                 st.name, st.restarts)
