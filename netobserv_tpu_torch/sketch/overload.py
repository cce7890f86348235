"""Closed-loop overload control at the exporter seam (the sketch
exporter's admission controller).

A copy of `netobserv_tpu/sketch/overload.py` (lines 1-201):
`SLOT_WAIT_REF_S`, `_LANES`, `OverloadController` and `maybe_controller`.
For one seed it keeps exactly the rows the reference keeps; a thinned
eviction is the port's `datapath/fetcher.EvictedFlows`, with
`decode_stats` and `trace` carried over. The de-bias the thin relies on
is the port's ingest (`sketch/state.py`: `factor = max(sampling, 1)`).

When the device folds slower than eviction feeds it, staging-ring slot
waits backpressure the export thread, queues fill, and — with nothing
shedding — the kernel map overflows into the ringbuf fallback where
accuracy silently degrades. SALSA's observation (PAPERS.md) is that
update/merge THROUGHPUT, not sketch math, bounds streaming measurement;
the principled response to overload is therefore *sampling*, which
sketches absorb without bias: the device ingest already de-biases a
per-row ``sampling`` lane (``sketch/state.py``: ``factor =
max(sampling, 1)`` scales CM bytes/packets, drop mass and the signal
planes), so a host-side 1-in-N thin that multiplies N into each
surviving row's ``sampling`` field keeps the estimates unbiased AND
composes with kernel-configured sampling (the factors multiply).

The controller is AIMD on the shed factor: pressure doubles it
(multiplicative decrease of the admitted fraction — drains a backlog in
O(log) steps), calm subtracts one (additive recovery — probes capacity
gently), and a window roll with no pressure since the last roll snaps it
back to 1 (recovery within one window of the pressure clearing, even on
an idle feed). Pressure is a dimensionless score in "batches":

    score = (pending_rows / batch_size) * busy
            + slot_wait_p95 / SLOT_WAIT_REF_S

``pending_rows`` is the fold backlog at admission time (rows already
buffered plus the incoming eviction); ``busy`` in [0, 1] is the seam's
recent fold-duty fraction (seconds spent folding per second of wall
clock between arrivals, EWMA — measured by the exporter). The weighting
is load-bearing: folds run synchronously on the export thread, so
arrival SIZE alone is not backlog — a healthy device folding a
many-batch eviction instantly must not shed (busy ~0 zeroes the depth
term), while a seam spending its whole wall clock folding (busy ~1)
counts the full depth. ``slot_wait_p95`` comes from the staging ring's
recent-wait window. ``SLOT_WAIT_REF_S`` converts device backpressure
into batch-equivalents: a quarter second of slot wait per fold is
severe (a healthy fold's slot wait is far below it), so p95 == the
reference counts like one full batch of backlog.

Disabled (``SKETCH_SHED_WATERMARK`` unset) the exporter never constructs
a controller — no RNG, no extra copies, no per-batch branches beyond one
``is None`` check: the same zero-cost bar as tracing and fault points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.utils import faultinject

#: slot-wait p95 that counts as ONE batch of pending-fold depth in the
#: pressure score (see module docstring)
SLOT_WAIT_REF_S = 0.25

#: feature lanes thinned alongside events (the EvictedFlows parallel
#: arrays; a lane shorter than events — allowed by the pending buffer's
#: zero-pad contract — is thinned over its own prefix)
_LANES = ("extra", "dns", "drops", "xlat", "nevents", "quic")


class OverloadController:
    """AIMD admission control for ``TorchSketchExporter.export_evicted``.

    ``update`` runs once per incoming eviction batch (a stage boundary,
    never per record) and moves the shed factor; ``admit`` applies it.
    Not thread-safe on its own — the exporter calls both under its lock.
    """

    def __init__(self, batch_size: int, watermark: float,
                 shed_max: int = 64, seed: int = 2026, metrics=None):
        if watermark <= 0:
            raise ValueError("watermark must be > 0 (unset disables "
                             "shedding at the exporter instead)")
        self.batch_size = batch_size
        self.high = float(watermark)
        #: hysteresis: recovery starts only below half the high watermark,
        #: so the factor doesn't oscillate across one boundary
        self.low = self.high / 2.0
        self.shed_max = max(2, int(shed_max))
        self.shed = 1
        # fixed schedule under a seeded generator: the unbiasedness suite
        # replays the exact keep/drop decisions (tests/test_torch_overload.py)
        self._rng = np.random.default_rng(seed)
        self._metrics = metrics
        self.shed_rows = 0
        self.shed_batches = 0
        self.last_score = 0.0
        self.last_busy = 0.0
        self._pressured_since_roll = False
        if metrics is not None:
            metrics.sketch_shed_factor.set(1)

    @property
    def overloaded(self) -> bool:
        """True while load is being shed — the /healthz OVERLOADED
        condition (distinct from DEGRADED: the agent is healthy and
        serving, deliberately trading resolution for stability)."""
        return self.shed > 1

    def snapshot(self) -> dict:
        """Machine-readable controller state for the health surface."""
        return {
            "shed_factor": self.shed,
            "shed_max": self.shed_max,
            "watermark": self.high,
            "pressure_score": round(self.last_score, 3),
            "busy": round(self.last_busy, 3),
            "shed_rows": self.shed_rows,
            "shed_batches": self.shed_batches,
        }

    def update(self, pending_rows: int, slot_wait_p95: float,
               busy: float = 1.0) -> int:
        """Move the AIMD factor from the current pressure observation and
        return it. Multiplicative increase above the high watermark,
        additive decrease below the low one, hold in between. ``busy``
        weights the depth term (module docstring) — 1.0 when the caller
        has no duty-cycle measurement."""
        busy = min(1.0, max(0.0, busy))
        score = (pending_rows / self.batch_size) * busy \
            + slot_wait_p95 / SLOT_WAIT_REF_S
        self.last_score = score
        self.last_busy = busy
        if score >= self.high:
            self._pressured_since_roll = True
            if self.shed < self.shed_max:
                self.shed = min(self.shed * 2, self.shed_max)
                self._set_gauge()
        elif score <= self.low and self.shed > 1:
            self.shed -= 1
            self._set_gauge()
        return self.shed

    def window_roll(self) -> None:
        """Called at each window close: a full window with no pressure
        snaps the factor back to 1 (bounded recovery even when the feed
        goes idle and ``update`` stops running)."""
        if not self._pressured_since_roll and self.shed > 1:
            self.shed = 1
            self._set_gauge()
        self._pressured_since_roll = False

    def _set_gauge(self) -> None:
        if self._metrics is not None:
            self._metrics.sketch_shed_factor.set(self.shed)

    def admit(self, evicted):
        """Thin ``evicted`` by the current 1-in-N factor, multiplying N
        into each surviving row's ``sampling`` field (0 = unsampled counts
        as 1, matching the device de-bias; kernel sampling composes
        multiplicatively). Returns ``evicted`` untouched at factor 1;
        otherwise a thinned EvictedFlows carrying the same trace."""
        if self.shed == 1:
            return evicted
        n = len(evicted.events)
        if n == 0:
            return evicted
        # stage-boundary fault seam (chaos suite): per batch, never per row
        faultinject.fire("sketch.overload_shed")
        keep = self._rng.random(n) < (1.0 / self.shed)
        kept = int(keep.sum())
        dropped = n - kept
        self.shed_rows += dropped
        self.shed_batches += 1
        if self._metrics is not None:
            self._metrics.sketch_shed_batches_total.inc()
            if dropped:
                self._metrics.sketch_shed_rows_total.inc(dropped)
        events = evicted.events[keep]  # fancy index: a fresh copy, safe to
        samp = events["stats"]["sampling"]  # scale without aliasing input
        np.multiply(np.maximum(samp, 1), np.uint32(self.shed), out=samp)
        feats = {}
        for name in _LANES:
            col = getattr(evicted, name, None)
            if col is None or not len(col):
                continue
            # lanes may be shorter than events (zero-pad contract): thin
            # each over its own aligned prefix
            feats[name] = col[keep[:len(col)]]
        thinned = EvictedFlows(events, **feats)
        thinned.decode_stats = evicted.decode_stats
        trace = getattr(evicted, "trace", None)
        if trace is not None:
            thinned.trace = trace
        return thinned


def maybe_controller(batch_size: int, watermark: float, shed_max: int,
                     metrics=None, seed: int = 2026
                     ) -> Optional[OverloadController]:
    """The ONE gate for the zero-cost-disabled contract: an unset/zero
    watermark returns None and the exporter's shed path stays a single
    ``is None`` check."""
    if not watermark or watermark <= 0:
        return None
    return OverloadController(batch_size, watermark, shed_max=shed_max,
                              metrics=metrics, seed=seed)
