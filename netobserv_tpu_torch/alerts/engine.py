"""The alert engine: hysteresis over every snapshot publish.

A copy of `netobserv_tpu/alerts/engine.py` (`AlertEngine`, `maybe_engine`,
`:1-388`). The exporter calls `safe_evaluate` after each snapshot publish
(window rolls and, with `query_refresh_s`, mid-window refreshes) on its
window thread. The engine is host-only and reads the published dict only.

Per fingerprint (rule, bucket, tenant):

- an instance firing in ``raise_evals`` consecutive evaluations raises,
  once, however long it keeps firing (refreshes count, so detection is
  sub-window);
- an active alert quiet for ``clear_evals`` consecutive closed-window
  evaluations clears, once; a mid-window quiet evaluation holds state,
  since the signal plane resets at each roll and a sustained anomaly looks
  quiet in a fresh window's first refreshes. Quiet inactive state is
  forgotten, so the tracked set stays bounded by the live anomalies
  (``max_active`` caps it; fingerprints past the cap are counted);
- transitions land in a bounded ring (newest last) and go out to the
  sinks (`alerts/sinks.py`) outside the engine lock.

Readers (`/query/alerts`, the `/query/status` summary, `condition`) get a
whole-dict swap of a fresh view at each evaluation; roll evaluations also
enter a ring of closed-window views for ``?window=`` back-scroll.
Fault point: ``alerts.evaluate``, at the top of `evaluate`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Optional

from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.alerts")


class _FpState:
    __slots__ = ("streak", "quiet", "active", "since_window", "since_ts_ms",
                 "raise_seq", "detail")

    def __init__(self):
        self.streak = 0
        self.quiet = 0
        self.active = False
        self.since_window = 0
        self.since_ts_ms = 0
        self.raise_seq = 0
        self.detail: dict = {}


class AlertEngine:
    """One alerting plane instance (per agent, or per aggregator tier)."""

    def __init__(self, rules, metrics=None, sinks=(), source: str = "agent",
                 history: int = 8, ring: int = 256, max_active: int = 256):
        if not rules:
            raise ValueError("AlertEngine needs at least one rule "
                             "(ALERT_RULES unset means NO engine, "
                             "not an empty one)")
        self._rules = list(rules)
        self._metrics = metrics
        self._sinks = list(sinks)
        self._source = source
        # _lock guards state + the published view (held briefly; readers
        # never wait behind sink I/O). _eval_lock serializes WHOLE
        # evaluations: after a supervisor hang-restart a superseded zombie
        # timer thread can re-enter evaluate() next to its replacement —
        # without this, the two would interleave sink deliveries (a CLEAR
        # webhook POSTed before its RAISE) and racing view re-swaps.
        self._lock = threading.Lock()
        self._eval_lock = threading.Lock()
        #: fingerprint -> _FpState (bounded by max_active)
        self._states: dict[tuple, _FpState] = {}
        self._max_active = max(1, int(max_active))
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(ring)))
        self._transition_seq = 0
        self._evals = 0
        self._dropped_fingerprints = 0
        #: rule name -> firing() exception count (a broken rule must be
        #: VISIBLE, not silently quiet — logged on first failure, counted
        #: in the view and errors_total)
        self._rule_errors: dict[str, int] = {}
        self._history_cap = max(0, int(history))
        #: window id -> closed-window view (roll evaluations only)
        self._history: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        # an engine is queryable from construction: /query/alerts answers
        # an empty active set before the first publish (the route's 503
        # belongs to the SNAPSHOT routes; alert state simply starts empty)
        self._view: dict = self._build_view_locked(
            window=None, ts_ms=0, seq=0, mid_window=False)

    # --- evaluation (timer thread; callers swallow+count) ---------------
    def evaluate(self, snap: dict, mid_window: bool = False) -> list[dict]:
        """Evaluate every rule against one published snapshot. Returns the
        transitions this evaluation produced (tests read them; production
        callers ignore the return). May raise only via the
        ``alerts.evaluate`` fault point or a bug — callers wrap it in
        their own try (the snapshot is already published; a failing
        evaluation must never lose it)."""
        faultinject.fire("alerts.evaluate")
        with self._eval_lock:
            return self._evaluate_serialized(snap, mid_window)

    def _evaluate_serialized(self, snap: dict, mid_window: bool) -> list:
        t0 = time.perf_counter()
        report = snap.get("report") or {}
        window = snap.get("window")
        ts_ms = snap.get("ts_ms") or 0
        with self._lock:
            self._evals += 1
            transitions: list[dict] = []
            firing_now: set[tuple] = set()
            erroring_rules: set[str] = set()
            for rule in self._rules:
                try:
                    instances = rule.firing(report)
                except Exception as exc:
                    # one malformed rule/field must not silence the rest —
                    # but a permanently-quiet broken rule must be VISIBLE
                    # (swallow+COUNT, the plane's own discipline): logged
                    # on its first failure, counted per rule in the view
                    # and in errors_total{component="alerts"}
                    instances = []
                    erroring_rules.add(rule.name)
                    n = self._rule_errors.get(rule.name, 0) + 1
                    self._rule_errors[rule.name] = n
                    if n == 1:
                        log.error(
                            "alert rule %s failed to evaluate (rule "
                            "stays quiet until fixed; counted in the "
                            "view's rule_errors): %s", rule.name, exc)
                    if self._metrics is not None:
                        self._metrics.count_error("alerts")
                for inst in instances:
                    # tenant-mode snapshots stamp their plane id: the
                    # fingerprint carries it so tenant A's flood and
                    # tenant B's flood on the same victim bucket raise,
                    # streak and clear INDEPENDENTLY (None otherwise —
                    # single-tenant fingerprints are unchanged)
                    fp = (rule.name, inst["bucket"], snap.get("tenant"))
                    firing_now.add(fp)
                    st = self._states.get(fp)
                    if st is None:
                        if len(self._states) >= self._max_active:
                            self._dropped_fingerprints += 1
                            continue
                        st = self._states[fp] = _FpState()
                    st.streak += 1
                    st.quiet = 0
                    st.detail = {"value": inst["value"],
                                 "victims": inst["victims"]}
                    if not st.active and st.streak >= rule.raise_evals:
                        st.active = True
                        st.since_window = window
                        st.since_ts_ms = ts_ms
                        transitions.append(self._transition_locked(
                            "raise", rule, fp, st, snap))
                        st.raise_seq = self._transition_seq
            for fp, st in list(self._states.items()):
                if fp in firing_now:
                    continue
                if fp[0] in erroring_rules:
                    # an erroring rule's verdict is INDETERMINATE, not
                    # quiet: hold its existing state (streaks and active
                    # alerts freeze) — a broken rule must never tell the
                    # sinks an ongoing anomaly "cleared"
                    continue
                st.streak = 0  # "consecutive" means consecutive
                if mid_window:
                    # quiet HYSTERESIS counts CLOSED WINDOWS only: the
                    # signal plane resets at each roll, so a sustained
                    # multi-window anomaly looks quiet in the first
                    # refreshes of every fresh window while it
                    # re-accumulates — counting those evals would flap
                    # clear/re-raise once per window mid-attack. Raises
                    # keep counting EVERY evaluation (sub-window
                    # detection); clears settle at window granularity.
                    continue
                st.quiet += 1
                rule = self._rule(fp[0])
                if st.quiet >= rule.clear_evals:
                    if st.active:
                        st.active = False
                        transitions.append(self._transition_locked(
                            "clear", rule, fp, st, snap))
                    del self._states[fp]  # quiet state stays bounded
            for ev in transitions:
                self._ring.append(ev)
            view = self._build_view_locked(window, ts_ms,
                                           snap.get("seq", 0), mid_window)
            self._view = view
            if not mid_window and self._history_cap and window is not None:
                wid = int(window)
                self._history.pop(wid, None)
                self._history[wid] = view
                while len(self._history) > self._history_cap:
                    self._history.popitem(last=False)
        # the eval latency metric covers the RULE WALK only (sink I/O is
        # excluded — the docs row's triage guidance depends on that), and
        # the active gauge reads the view built under the lock (never a
        # bare walk of self._states: a superseded zombie timer thread
        # evaluating concurrently must not race the dict iteration)
        if self._metrics is not None:
            self._metrics.alerts_active.set(len(view["active"]))
            self._metrics.alert_eval_seconds.observe(
                time.perf_counter() - t0)
        # sink fan-out OFF the engine lock: a slow webhook must not block
        # a concurrent /query/alerts read (still on the timer thread — the
        # hot path never waits on it either way). flush() first: held
        # flap-suppressed clears whose interval expired reconcile before
        # this evaluation's new transitions land.
        flushed = 0
        for sink in self._sinks:
            flushed += sink.flush(metrics=self._metrics)
        for ev in transitions:
            for sink in self._sinks:
                sink.emit(ev, metrics=self._metrics)
        if self._sinks and (transitions or flushed):
            # refresh the published view's sink stats post-delivery (a
            # fresh dict swap: the immutability contract holds; readers
            # holding the pre-delivery view just see slightly older
            # delivery counters). Identity-guarded: only THIS
            # evaluation's view is re-swapped — a stale thread must
            # never clobber a newer published view.
            with self._lock:
                if self._view is view:
                    self._view = {**view, "sinks": {
                        s.name: s.stats() for s in self._sinks}}
        return transitions

    def safe_evaluate(self, snap: dict, mid_window: bool = False) -> None:
        """The swallow+count wrapper BOTH tiers mount (the exporter's
        publish seam and the aggregator's merged-window publish): a
        failing evaluation is logged and counted, never propagated — the
        snapshot it rides is already published and must not be lost.
        Lives here so the error-handling discipline cannot drift between
        the two mounts."""
        try:
            self.evaluate(snap, mid_window=mid_window)
        except Exception as exc:
            log.error("alert evaluation failed (snapshot already "
                      "published; next publish retries): %s", exc)
            if self._metrics is not None:
                self._metrics.count_error("alerts")

    def _rule(self, name: str):
        for r in self._rules:
            if r.name == name:
                return r
        raise KeyError(name)

    def _transition_locked(self, action: str, rule, fp: tuple,
                           st: _FpState, snap: dict) -> dict:
        self._transition_seq += 1
        return {
            "seq": self._transition_seq,
            "action": action,
            "rule": rule.name,
            "severity": rule.severity,
            "source": self._source,
            "bucket": fp[1],
            "victims": list(st.detail.get("victims", ())),
            "value": st.detail.get("value", 0.0),
            "window": snap.get("window"),
            "snapshot_seq": snap.get("seq", 0),
            "ts_ms": snap.get("ts_ms") or 0,
            "since_window": st.since_window,
            **({"tenant": fp[2]} if fp[2] is not None else {}),
        }

    def _build_view_locked(self, window, ts_ms: int, seq: int,
                           mid_window: bool) -> dict:
        active = []
        for (rule_name, bucket, tenant), st in self._states.items():
            if not st.active:
                continue
            rule = self._rule(rule_name)
            active.append({
                "rule": rule_name, "severity": rule.severity,
                "bucket": bucket,
                **({"tenant": tenant} if tenant is not None else {}),
                "victims": list(st.detail.get("victims", ())),
                "value": st.detail.get("value", 0.0),
                "since_window": st.since_window,
                "since_ts_ms": st.since_ts_ms,
                "raise_seq": st.raise_seq,
                "streak": st.streak,
            })
        active.sort(key=lambda a: a["raise_seq"])
        return {
            "source": self._source,
            "window": window,
            "ts_ms": ts_ms,
            "seq": seq,
            "mid_window": bool(mid_window),
            "evals": self._evals,
            "transition_seq": self._transition_seq,
            "active": active,
            "recent": list(self._ring),
            "rules": [r.name for r in self._rules],
            "rule_errors": dict(self._rule_errors),
            "dropped_fingerprints": self._dropped_fingerprints,
            "sinks": {s.name: s.stats() for s in self._sinks},
        }

    # --- read surface (HTTP threads; snapshot-only) ---------------------
    def view(self) -> dict:
        """The live alert view (whole-dict swap: torn reads impossible)."""
        with self._lock:
            return self._view

    def window_view(self, window: int) -> Optional[dict]:
        with self._lock:
            return self._history.get(int(window))

    def windows(self) -> list[int]:
        with self._lock:
            return list(self._history.keys())

    def route_payload(self, window_param=None) -> tuple[int, dict]:
        """The ONE /query/alerts + /federation/alerts body builder (the
        thin-adapter rule: both tiers' handlers call this). ``?window=``
        follows the back-scroll contract: closed-window views only,
        evicted/unknown ids answer 404 with the available list."""
        if window_param is not None:
            wid = int(window_param)  # malformed -> ValueError -> 400
            view = self.window_view(wid)
            if view is None:
                return 404, {
                    "error": f"window {wid} not in the alert ring",
                    "windows": self.windows()}
            return 200, view
        return 200, self.view()

    def summary(self) -> dict:
        """Compact block for /query/status — derived from ONE view read
        (the read-once rule: no racy second lock acquisition)."""
        view = self.view()
        return {"active": len(view["active"]),
                "last_transition_seq": view["transition_seq"],
                "evals": view["evals"]}

    def condition(self) -> dict:
        """The ``alerting`` supervisor condition probe. Like OVERLOADED:
        a raising alert is the agent doing its job, not a failing stage —
        /readyz stays 200 (conditions never gate readiness)."""
        view = self.view()
        return {"active": bool(view["active"]),
                "active_alerts": len(view["active"]),
                "last_transition_seq": view["transition_seq"],
                "rules": view["rules"]}


def maybe_engine(cfg, metrics=None, source: str = "agent"):
    """ALERT_RULES-gated construction (the zero-cost bar: unset returns
    None and the mount point is one is-None check — no engine object, no
    sinks, nothing on any path)."""
    if not cfg.alert_rules:
        return None
    from netobserv_tpu_torch.alerts import rules as arules, sinks as asinks
    return AlertEngine(
        arules.parse_rules(cfg.alert_rules,
                           raise_evals=cfg.alert_raise_evals,
                           clear_evals=cfg.alert_clear_evals),
        metrics=metrics, sinks=asinks.build_sinks(cfg, metrics),
        source=source, history=cfg.sketch_query_history,
        ring=cfg.alert_ring)
