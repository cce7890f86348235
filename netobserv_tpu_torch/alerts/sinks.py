"""Alert fan-out sinks: structured log, stdlib webhook, metrics.

A copy of `netobserv_tpu/alerts/sinks.py` (`AlertSink`, `LogSink`,
`WebhookSink`, `MetricsSink`, `build_sinks`, `:1-282`). A sink takes one
raise or clear transition at a time, on the exporter's window thread. Per
sink and per (rule, bucket):

- an event whose action the receiver already shows is skipped (counted in
  ``rate_limited``);
- a clear within ``min_interval_s`` of the last delivery is held, and
  `flush` (once per evaluation) delivers it when the interval has passed;
  a raise meanwhile cancels the hold;
- a delivery is tried ``retries`` + 1 times; one that fails every try is
  parked for `flush`, counted in ``alert_sink_errors_total{sink}`` and
  logged, and never reaches the engine, the other sinks or the publish;
  three such failures in a row open a breaker for
  ``max(min_interval_s, 5 s)``, during which deliveries are parked.

Fault point: ``alerts.sink``, at every delivery attempt.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.request

from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.alerts")


class AlertSink:
    """Base sink: subclasses implement :meth:`deliver`. Counters are
    plain ints read by the engine's view publisher (single-writer:
    deliveries are serialized by the engine's evaluation lock)."""

    name = "base"

    #: fingerprint-map bound (transitions only come from the engine's
    #: bounded active set, so this is a belt-and-braces cap)
    MAX_TRACKED_FINGERPRINTS = 1024
    #: consecutive exhausted failures that open the circuit breaker
    BREAKER_TRIP = 3
    #: minimum breaker-open window for low/zero min_interval_s sinks
    BREAKER_MIN_OPEN_S = 5.0

    def __init__(self, min_interval_s: float = 0.0, retries: int = 1):
        self.min_interval_s = float(min_interval_s)
        self.retries = max(0, int(retries))
        self.delivered = 0
        self.rate_limited = 0
        self.errors = 0
        self.breaker_skips = 0
        #: (rule, bucket) -> (last delivered action, delivery monotonic
        #: time) — the receiver-state ledger the dedup and flap
        #: suppression reason over
        self._state_by_fp: dict[tuple, tuple[str, float]] = {}
        #: fingerprints with an UNDELIVERED latest state: flap-held
        #: clears AND transitions whose delivery failed or hit an open
        #: breaker — flush() reconciles them (symmetric: a parked raise
        #: must reach the receiver once the endpoint recovers, a parked
        #: clear must never leave it stuck-active)
        self._pending: dict[tuple, dict] = {}
        self._consec_errors = 0
        self._open_until = 0.0

    def deliver(self, event: dict) -> None:
        raise NotImplementedError

    def emit(self, event: dict, metrics=None) -> None:
        """State-dedup + flap-suppression + bounded-retry wrapper around
        :meth:`deliver` (the engine calls only this; see the module
        docstring for the delivery discipline)."""
        now = time.monotonic()
        fp = (event.get("rule"), event.get("bucket"))
        action = event.get("action")
        last = self._state_by_fp.get(fp)
        if last is not None and last[0] == action:
            # the receiver already shows this state (e.g. a re-raise
            # whose clear was suppressed mid-flap): nothing to send —
            # and ANY pending transition is now stale (a deduped
            # re-raise means the alert is live again; flushing the old
            # clear later would leave the receiver stuck-cleared)
            self._pending.pop(fp, None)
            self.rate_limited += 1
            return
        if action == "raise":
            # a raise supersedes any held clear: the flap is active
            # again and the receiver (still showing raised) is right
            self._pending.pop(fp, None)
        elif action == "clear":
            stale = self._pending.pop(fp, None)
            if stale is not None and stale.get("action") == "raise":
                # the raise never reached the receiver and the lifecycle
                # already ended: the pair annihilates — the receiver's
                # view (nothing active) is already the end state
                self.rate_limited += 1
                return
            if (self.min_interval_s and last is not None
                    and now - last[1] < self.min_interval_s):
                # flap suppression: HOLD the clear — the receiver keeps
                # the alert visible through the flap; flush() reconciles
                # once the interval expires, so a real clear is never
                # lost
                self._pending[fp] = event
                self.rate_limited += 1
                return
        self._attempt(fp, event, now, metrics)

    def flush(self, metrics=None) -> int:
        """Deliver pending transitions that are past their suppression
        interval (the engine calls this once per evaluation — state
        reconciliation for flap-held clears and failure/breaker-parked
        transitions). Returns delivered-attempt count."""
        if not self._pending:
            return 0
        now = time.monotonic()
        n = 0
        for fp, ev in list(self._pending.items()):
            last = self._state_by_fp.get(fp)
            if last is None or now - last[1] >= self.min_interval_s:
                del self._pending[fp]
                self._attempt(fp, ev, now, metrics)
                n += 1
        return n

    def _park(self, fp: tuple, event: dict) -> None:
        """Remember an undeliverable transition as the fingerprint's
        latest target state; flush() keeps retrying it. Bounded by
        evicting the OLDEST parked entry (never clear-all: a wholesale
        wipe would drop terminal clears for receivers that saw the raise
        — the stuck-active hazard the parking exists to prevent; under
        churn the oldest entry is the most likely stale one)."""
        while len(self._pending) >= self.MAX_TRACKED_FINGERPRINTS:
            self._pending.pop(next(iter(self._pending)))
        self._pending[fp] = event

    def _attempt(self, fp: tuple, event: dict, now: float,
                 metrics=None) -> None:
        if now < self._open_until:
            # circuit open: a dead endpoint must not stall the timer
            # thread (retries+1)*timeout per transition — skip, counted,
            # and PARK the transition so flush() reconciles the receiver
            # once the breaker closes (a dropped raise hides an active
            # detection; a dropped terminal clear sticks it active)
            self.breaker_skips += 1
            self._park(fp, event)
            return
        last_exc: Exception | None = None
        for _attempt in range(self.retries + 1):
            try:
                faultinject.fire("alerts.sink")
                self.deliver(event)
                self.delivered += 1
                self._consec_errors = 0
                if len(self._state_by_fp) >= self.MAX_TRACKED_FINGERPRINTS:
                    self._state_by_fp.clear()  # bounded; worst case one
                    #                            duplicate send later
                self._state_by_fp[fp] = (event.get("action"), now)
                return
            except Exception as exc:
                last_exc = exc
        self.errors += 1
        self._consec_errors += 1
        if self._consec_errors >= self.BREAKER_TRIP:
            self._open_until = now + max(self.min_interval_s,
                                         self.BREAKER_MIN_OPEN_S)
        # park for flush-retry (raise AND clear: a missed raise hides an
        # active detection for its whole lifetime, a missed clear leaves
        # the receiver stuck-active)
        self._park(fp, event)
        log.error("alert sink %s failed after %d attempt(s) "
                  "(transition parked for flush retry): %s",
                  self.name, self.retries + 1, last_exc)
        if metrics is not None:
            metrics.alert_sink_errors_total.labels(self.name).inc()

    def stats(self) -> dict:
        return {"delivered": self.delivered,
                "rate_limited": self.rate_limited,
                "errors": self.errors,
                "breaker_skips": self.breaker_skips,
                "pending_transitions": len(self._pending)}


class LogSink(AlertSink):
    """Structured log line per transition (the always-works sink): one
    JSON object on the agent log, greppable by ``alert_transition``."""

    name = "log"

    def deliver(self, event: dict) -> None:
        log.warning("alert_transition %s",
                    json.dumps(event, separators=(",", ":")))


class WebhookSink(AlertSink):
    """Stdlib-only JSON POST (no requests dependency): one transition per
    call, ``Content-Type: application/json``, bounded socket timeout so a
    dead endpoint costs at most ``(retries+1) * timeout_s`` of the timer
    thread per transition — and the rate limiter bounds how often."""

    name = "webhook"

    def __init__(self, url: str, min_interval_s: float = 1.0,
                 retries: int = 1, timeout_s: float = 2.0):
        super().__init__(min_interval_s=min_interval_s, retries=retries)
        if not url:
            raise ValueError("webhook sink needs a URL "
                             "(ALERT_WEBHOOK_URL)")
        self.url = url
        self.timeout_s = float(timeout_s)

    def deliver(self, event: dict) -> None:
        req = urllib.request.Request(
            self.url, data=json.dumps(event).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()


class MetricsSink(AlertSink):
    """Transitions into the Prometheus registry:
    ``alerts_transitions_total{rule, action}``. The active-count gauge and
    eval-latency histogram are the engine's (they are per-eval, not
    per-transition)."""

    name = "metrics"

    def __init__(self, metrics):
        super().__init__()
        self._metrics = metrics

    def deliver(self, event: dict) -> None:
        self._metrics.alerts_transitions_total.labels(
            event["rule"], event["action"]).inc()


def build_sinks(cfg, metrics=None) -> list:
    """ALERT_SINKS wiring (``log,metrics`` default). ``webhook`` requires
    ALERT_WEBHOOK_URL; ``metrics`` is silently skipped when no registry is
    wired (a bare embedder)."""
    tokens = [t.strip() for t in cfg.alert_sinks.split(",") if t.strip()]
    if not tokens:
        # fail-fast symmetry with parse_rules: a whitespace/comma-only
        # ALERT_SINKS would silently route every transition to NOTHING
        raise ValueError("ALERT_SINKS is set but names no sinks "
                         "(want a comma list of log, metrics, webhook)")
    out = []
    for tok in tokens:
        if tok == "log":
            out.append(LogSink())
        elif tok == "metrics":
            if metrics is not None:
                out.append(MetricsSink(metrics))
        elif tok == "webhook":
            out.append(WebhookSink(cfg.alert_webhook_url,
                                   min_interval_s=cfg.alert_webhook_interval))
        else:
            raise ValueError(f"ALERT_SINKS: unknown sink {tok!r} "
                             "(one of log, metrics, webhook)")
    return out
