"""Federation delta sink: streams sketch-delta frames to the aggregator.

A copy of `netobserv_tpu/exporter/federation.py` (lines 1-133) on the
port's `grpc/federation.FederationClient` and its own transport
(`grpc/h2.py`); the acks are pbwire's `DeltaAck`.

Exporter-seam semantics, the rules of every other exporter: errors are
swallowed and counted, never fatal: a dead aggregator must not
stall the window timer or lose the local JSON report. Each frame gets a
small bounded retry ladder with exponential backoff and a reconnect between
attempts (the aggregator tier restarts/rebalances like any collector); a
frame that exhausts its ladder is dropped and counted, because the NEXT
window's frame supersedes it anyway (deltas are per-window snapshots, not a
log — re-sending stale windows after an outage would only delay fresh
ones).

Failure classification (`grpc.federation.classify_rpc_error`):

- **retry-safe** (UNAVAILABLE, DEADLINE_EXCEEDED, ...): walk the ladder.
  DEADLINE_EXCEEDED is the ambiguous one — the aggregator may have applied
  the push before the deadline fired — and retrying it is safe ONLY
  because v2 frames carry an idempotency key the aggregator's ledger
  dedups on (a redelivered frame acks `accepted+duplicate`, counted here
  as `duplicate`, never double-merged). A stale-window discard acks the
  same way on the wire but its data was NOT merged — the ack reason
  (`delta.ACK_REASON_STALE`) splits it into the `stale` count so
  agent-side monitoring sees the loss.
- **terminal** (INVALID_ARGUMENT, UNIMPLEMENTED, ...): resending the same
  bytes cannot succeed; fail fast without burning the ladder.

The ladder state is PER WINDOW: every `__call__` (one frame = one closed
window) starts back at `backoff_initial_s` — a bad window must not tax the
next one's first attempt (as the reference's tests pin it).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from netobserv_tpu_torch.federation.delta import ACK_REASON_STALE
from netobserv_tpu_torch.grpc.federation import (
    FederationClient, classify_rpc_error,
)

log = logging.getLogger("netobserv_tpu_torch.exporter.federation")


class FederationDeltaSink:
    """Callable `(frame_bytes) -> bool` that the sketch exporter calls at
    window publish time, off its lock (`federation.py:43-133`)."""

    name = "federation"

    def __init__(self, host: str, port: int, tls_ca: str = "",
                 tls_cert: str = "", tls_key: str = "",
                 retries: int = 3, backoff_initial_s: float = 0.2,
                 backoff_max_s: float = 2.0, timeout_s: float = 10.0,
                 metrics=None,
                 client: Optional[FederationClient] = None,
                 sleep=time.sleep):
        self._client = client or FederationClient(host, port, tls_ca,
                                                  tls_cert, tls_key)
        self._retries = max(1, retries)
        self._backoff_initial = backoff_initial_s
        self._backoff_max = backoff_max_s
        self._timeout = timeout_s
        self._metrics = metrics
        self._sleep = sleep
        #: the delays slept by the MOST RECENT __call__ — introspection for
        #: the per-window ladder-reset pin (tests), not control flow
        self.last_ladder: list[float] = []

    def __call__(self, frame: bytes) -> bool:
        """Push one frame; True when the aggregator accepted it (applied
        OR safely deduplicated). Never raises — failures are logged +
        counted and the frame is dropped."""
        err: Exception | None = None
        # ladder state is local to this window's frame: a previous
        # window's exhausted ladder never escalates this one's first try
        self.last_ladder = []
        for attempt in range(self._retries):
            try:
                ack = self._client.send(frame, timeout_s=self._timeout)
                if ack.accepted:
                    if getattr(ack, "duplicate", 0):
                        if getattr(ack, "reason", "") == ACK_REASON_STALE:
                            # acked only so we stop resending: the window
                            # was DISCARDED as stale/out-of-order, not
                            # merged — that is per-window data loss (epoch
                            # step-back, reordering) and must not hide
                            # under the benign `duplicate` count
                            log.warning("aggregator discarded delta frame "
                                        "as stale (window data lost)")
                            self._count("stale", len(frame))
                        else:
                            # an earlier (timed-out but delivered) attempt
                            # already applied this window — the ledger did
                            # its job; a success, distinctly counted
                            self._count("duplicate", len(frame))
                    else:
                        self._count("ok", len(frame))
                    return True
                # the aggregator SAW the frame and said no (version/shape
                # mismatch): retrying the same bytes cannot succeed
                log.error("aggregator rejected delta frame: %s", ack.reason)
                self._count("rejected", len(frame))
                return False
            except Exception as exc:
                err = exc
                if classify_rpc_error(exc) == "terminal":
                    log.error("delta push failed terminally (%s) — not "
                              "retrying: %s", type(exc).__name__, exc)
                    self._count("terminal", len(frame))
                    return False
                if attempt + 1 < self._retries:
                    delay = min(self._backoff_initial * (2 ** attempt),
                                self._backoff_max)
                    self.last_ladder.append(delay)
                    self._sleep(delay)
                    try:
                        self._client.connect()
                    except Exception:
                        pass  # next send() attempt surfaces the real error
        log.error("delta frame dropped after %d attempts: %s",
                  self._retries, err)
        self._count("error", len(frame))
        return False

    def _count(self, result: str, n_bytes: int) -> None:
        m = self._metrics
        if m is not None:
            m.federation_deltas_sent_total.labels(result).inc()
            if result in ("error", "terminal"):
                m.count_export_error(self.name, "delta_push")

    def close(self) -> None:
        self._client.close()
