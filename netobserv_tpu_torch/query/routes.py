"""The `/query/*` routes, free of any HTTP host.

A copy of `netobserv_tpu/query/routes.py` (`QueryRoutes`, `ROUTES`,
`:1-196`). The metrics server (`metrics/server.py`) hands a parsed
``(path, params)`` in and writes the returned ``(status, body)`` out;
tests drive the routes without a socket. Every request is counted in
``query_requests_total{route, result}``, and every answer reads only a
published snapshot (`query/snapshot.py`): no device work, no exporter
lock.

Routes (GET, JSON): ``/query/topk`` (``?n=`` caps the list),
``/query/frequency`` (``?src=&dst=&src_port=&dst_port=&proto=``),
``/query/churn``, ``/query/cardinality``, ``/query/victims``,
``/query/alerts`` (404 with no alert engine), ``/query/status`` and
``/query/range`` (404 with no archive: the port's archive plane is
ROADMAP A4.4, so the exporter passes none).

Status codes: 200; 400 for a malformed parameter (``?n=bogus``, a bad
address) or a missing ``src``/``dst`` or tenant; 404 for an unknown
route, an evicted ``?window=`` (with the ids held), an unknown tenant or a
disabled plane; 500 when a route raises; 503 before the first publish.

Back-scroll: every data route takes ``?window=<id>`` for a closed window
of the publisher's ring. Tenants: with `tenant_publishers` (one
`SnapshotPublisher` a tenant) the data routes require ``?tenant=<id>``;
the exporter passes None until the port has tenants (ROADMAP A5).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from netobserv_tpu_torch.query import core

log = logging.getLogger("netobserv_tpu_torch.query")

ROUTES = ("topk", "frequency", "churn", "cardinality", "victims",
          "alerts", "status", "range")


class QueryRoutes:
    """Dispatch `/query/<route>` requests against a snapshot source.

    `snapshot_fn` returns the published snapshot dict (or None);
    `status_fn` returns the freshness/counters dict for /query/status.
    """

    def __init__(self, snapshot_fn: Callable[[], Optional[dict]],
                 status_fn: Callable[[], dict], metrics=None,
                 history_fn: Optional[Callable[[int], Optional[dict]]] = None,
                 windows_fn: Optional[Callable[[], list]] = None,
                 alerts=None, archive=None, tenant_publishers=None):
        self._snapshot = snapshot_fn
        self._status = status_fn
        self._metrics = metrics
        self._history = history_fn
        self._windows = windows_fn
        #: the alert engine (alerts/engine.py) or None when ALERT_RULES is
        #: unset — the route then answers 404 (alerting disabled)
        self._alerts = alerts
        #: the sketch warehouse (archive.SketchArchive) or None when
        #: ARCHIVE_DIR is unset — /query/range then answers 404
        self._archive = archive
        #: SKETCH_TENANTS mode: the per-tenant SnapshotPublisher list —
        #: data routes then resolve snapshot/history/windows from the
        #: requested tenant's publisher instead of the top-level fns
        self._tenant_pubs = tenant_publishers

    def index(self) -> dict:
        return {"routes": [f"/query/{r}" for r in ROUTES]}

    def handle(self, path: str, params: dict) -> tuple[int, dict]:
        """`path` is the URL path (e.g. "/query/topk"), `params` the parsed
        single-valued query dict. Returns (http status, JSON-able body)."""
        parts = [p for p in path.split("/") if p]
        # /query/range/<view> nests one level deeper than the snapshot
        # routes: the view rides as a pseudo-param so the route counter
        # still aggregates under "range"
        if len(parts) >= 2 and parts[1] == "range":
            route = "range"
            if len(parts) > 2:
                params = dict(params, view=parts[2])
        else:
            route = path.rstrip("/").rpartition("/")[2] or "index"
        try:
            code, body = self._dispatch(route, params)
        except ValueError as exc:  # malformed params (e.g. ?n=bogus)
            code, body = 400, {"error": str(exc)}
        except Exception as exc:  # the query surface must keep answering
            log.error("query route %s failed: %s", path, exc)
            code, body = 500, {"error": str(exc)}
        self._count(route, code)
        return code, body

    def _count(self, route: str, code: int) -> None:
        if self._metrics is None:
            return
        result = ("ok" if code == 200 else
                  "no_window" if code == 503 else
                  "bad_request" if code == 400 else
                  "not_found" if code == 404 else "error")
        self._metrics.query_requests_total.labels(route, result).inc()

    def _dispatch(self, route: str, params: dict) -> tuple[int, dict]:
        if route in ("index", "query"):
            return 200, self.index()
        if route not in ROUTES:
            return 404, {"error": f"unknown query route {route!r}",
                         **self.index()}
        if route == "status":
            return 200, self._status()
        if route == "alerts":
            # the alert view has its own closed-window ring (the engine's)
            # with the same ?window= back-scroll contract as the snapshot
            # routes: 404 + available ids on evicted/unknown windows
            if self._alerts is None:
                return 404, {"error": "alerting disabled "
                                      "(ALERT_RULES unset)"}
            return self._alerts.route_payload(params.get("window"))
        if route == "range":
            # the sketch warehouse's time-range surface: answered entirely
            # by the archive plane (device merge of on-disk segments —
            # never the live snapshot, never the exporter lock)
            if self._archive is None:
                return 404, {"error": "archive disabled "
                                      "(ARCHIVE_DIR unset)"}
            return self._archive.route_payload(params)
        snapshot_fn, history_fn, windows_fn = (
            self._snapshot, self._history, self._windows)
        if self._tenant_pubs is not None:
            # tenant mode: data routes answer from ONE tenant's publisher
            # (snapshot + ring) — there is no merged cross-tenant view
            if params.get("tenant") is None:
                return 400, {
                    "error": "tenant is required (SKETCH_TENANTS mode)",
                    "tenants": len(self._tenant_pubs)}
            tid = int(params["tenant"])  # malformed -> ValueError -> 400
            if not 0 <= tid < len(self._tenant_pubs):
                return 404, {"error": f"unknown tenant {tid}",
                             "tenants": len(self._tenant_pubs)}
            pub = self._tenant_pubs[tid]
            snapshot_fn, history_fn, windows_fn = (
                pub.get, pub.get_window, pub.windows)
        if params.get("window") is not None:
            wid = int(params["window"])  # malformed -> ValueError -> 400
            snap = history_fn(wid) if history_fn is not None else None
            if snap is None:
                return 404, {
                    "error": f"window {wid} not in the snapshot ring",
                    "windows": (windows_fn() if windows_fn is not None
                                else [])}
        else:
            snap = snapshot_fn()
        if snap is None:
            return 503, {"error": "no window published yet"}
        if route == "topk":
            return 200, core.topk_payload(snap, params.get("n", 100))
        if route == "churn":
            return 200, core.churn_payload(snap)
        if route == "cardinality":
            return 200, core.cardinality_payload(snap)
        if route == "victims":
            return 200, core.victims_payload(snap)
        # frequency
        if not params.get("src") or not params.get("dst"):
            return 400, {"error": "src and dst are required"}
        out = core.frequency_payload(
            snap, params["src"], params["dst"],
            int(params.get("src_port", 0)), int(params.get("dst_port", 0)),
            int(params.get("proto", 0)))
        if out is None:
            return 503, {"error": "no whole-width CM snapshot on this "
                                  "deployment (width-sharded mesh)"}
        return 200, out
