"""Cluster-wide query surface: non-blocking HTTP over the aggregator.

Counterpart of `netobserv_tpu/federation/query.py`: a thin adapter over
the port's query core (`query/core.py`), so the CM error-bar math and
victim naming exist once, for this tier and the agent's `/query/*` routes.

Every route reads the host-side snapshot the aggregator published at its
last window roll (or pure-numpy math over it): a request never launches
device work, takes the aggregator's merge lock, or waits on anything the
delta-ingest path needs. Also answers /healthz and /readyz with the
supervised-stage semantics of `metrics/server.py`.

Routes (all GET, JSON):

- /federation/topk          cluster-wide heavy hitters (?n= caps the
                            list), with CM error bars
- /federation/frequency     CM estimate + error bars for one 5-tuple
                            (?src=&dst=&src_port=&dst_port=&proto=)
- /federation/churn         cluster-wide per-key heavy-hitter churn
- /federation/cardinality   global distinct-source estimate + totals
- /federation/victims       suspect buckets per signal with victim names
- /federation/alerts        the alert engine's view (404 when the
                            aggregator has no engine)
- /federation/status        per-agent delta freshness + plane counters
- /federation/fleet         per-agent telemetry rollup from the frames'
                            telemetry blocks (the published fleet
                            snapshot, never the merge lock)
- /debug/traces             the flight recorder (?limit=/?trace=, as the
                            debug server's; an agent's trace id answers
                            here too)
- /debug/executables        the compile watch (`utils/retrace`)
- /federation/range         cluster-wide time-range answers from the
                            aggregator's archive (?from=&to=;
                            /federation/range/topk|frequency|cardinality|
                            victims), 404 without one; the one route that
                            merges on the device (`archive/query.py`,
                            under the aggregator's lock)
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from netobserv_tpu_torch.query import core as qcore

log = logging.getLogger("netobserv_tpu_torch.federation.query")

_READY_STATUSES = ("Started",)
_LIVE_STATUSES = ("NotStarted", "Starting", "Started", "Degraded",
                  "Stopping")


class _Handler(BaseHTTPRequestHandler):
    aggregator = None                      # set per-server subclass
    health_source: Optional[Callable[[], dict]] = None

    def do_GET(self):  # noqa: N802 - http.server API
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        path = url.path
        try:
            if path in ("/healthz", "/readyz"):
                self._serve_health(path)
                return
            if path in ("/", "/federation", "/federation/"):
                self._json(200, {"routes": [
                    "/federation/topk", "/federation/frequency",
                    "/federation/churn", "/federation/cardinality",
                    "/federation/victims", "/federation/alerts",
                    "/federation/range", "/federation/status",
                    "/federation/fleet", "/debug/traces",
                    "/debug/executables", "/healthz", "/readyz"]})
                return
            if path == "/federation/fleet":
                self._serve_fleet()
                return
            if path in ("/debug/traces", "/debug/executables"):
                # thin adapters over the debug server's body functions
                # (server/debug.py): one flight recorder and one compile
                # watch view, so an agent's trace id answers here too
                from netobserv_tpu_torch.server.debug import (
                    _executables_dump, _traces_dump)
                dump = (_traces_dump if path == "/debug/traces"
                        else _executables_dump)
                self._json(200, json.loads(dump(q)))
                return
            if path == "/federation/range" or \
                    path.startswith("/federation/range/"):
                # thin adapter over the archive plane's one body builder
                # (archive/query.py route_payload), fed by the
                # aggregator's merged windows
                arch = self.aggregator.archive
                if arch is None:
                    self._json(404, {"error": "archive disabled "
                                              "(ARCHIVE_DIR unset)"})
                    return
                view = path.rpartition("/")[2] \
                    if path.startswith("/federation/range/") else None
                code, body = arch.route_payload(q, view)
                self._json(code, body)
                return
            if path == "/federation/status":
                self._json(200, self.aggregator.status())
                return
            if path == "/federation/alerts":
                # the engine's route_payload, as the agent's /query/alerts
                eng = self.aggregator.alerts
                if eng is None:
                    self._json(404, {"error": "alerting disabled "
                                              "(ALERT_RULES unset)"})
                    return
                try:
                    code, body = eng.route_payload(q.get("window"))
                except ValueError as exc:  # malformed ?window=
                    code, body = 400, {"error": str(exc)}
                self._json(code, body)
                return
            snap = self.aggregator.snapshot()
            if path == "/federation/frequency":
                if not q.get("src") or not q.get("dst"):
                    self._json(400, {"error": "src and dst are required"})
                    return
                out = self.aggregator.query_frequency(
                    q["src"], q["dst"], int(q.get("src_port", 0)),
                    int(q.get("dst_port", 0)), int(q.get("proto", 0)))
                if out is None:
                    self._no_window()
                    return
                self._json(200, out)
                return
            if snap is None and path.startswith("/federation/"):
                self._no_window()
                return
            # every snapshot-backed route carries the publish sequence
            # number (stamped by the query core): the aggregator swaps
            # whole snapshots atomically, so a reader seeing (seq, window,
            # payload) from one dict never sees a torn mix of two windows;
            # seq is in-memory and restarts at 1 with the process
            if path == "/federation/topk":
                self._json(200, qcore.topk_payload(snap, q.get("n", 100)))
                return
            if path == "/federation/churn":
                # the query core's churn body function
                self._json(200, qcore.churn_payload(snap))
                return
            if path == "/federation/cardinality":
                self._json(200, qcore.cardinality_payload(snap))
                return
            if path == "/federation/victims":
                self._json(200, qcore.victims_payload(snap))
                return
            self.send_error(404)
        except Exception as exc:  # the query surface must keep answering
            log.error("federation query %s failed: %s", path, exc)
            self._json(500, {"error": str(exc)})

    def _no_window(self) -> None:
        self._json(503, {"error": "no window published yet"})

    def _serve_fleet(self) -> None:
        # reads only the published fleet reference (whole-dict seq-stamped
        # swaps on the timer thread) — never the aggregator's merge lock
        fleet = self.aggregator.fleet()
        m = getattr(self.aggregator, "_metrics", None)
        if fleet is None:
            if m is not None:
                m.federation_fleet_requests_total.labels("no_window").inc()
            self._json(503, {"error": "no fleet snapshot published yet"})
            return
        if m is not None:
            m.federation_fleet_requests_total.labels("ok").inc()
        self._json(200, fleet)

    def _serve_health(self, path: str) -> None:
        try:
            health = self.health_source() if self.health_source else {
                "status": "Started", "degraded": False, "stages": {}}
        except Exception as exc:
            health = {"status": "Unknown", "degraded": True,
                      "error": str(exc), "stages": {}}
        status = health.get("status", "Unknown")
        degraded = bool(health.get("degraded"))
        if path == "/readyz":
            ok = status in _READY_STATUSES and not degraded
        else:
            ok = status in _LIVE_STATUSES
        self._json(200 if ok else 503, health)

    def _json(self, code: int, obj: dict) -> None:
        payload = json.dumps(obj, separators=(",", ":")).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):
        log.debug("federation query http: " + fmt, *args)


def start_query_server(aggregator, port: int, address: str = "",
                       health_source: Optional[Callable[[], dict]] = None,
                       ) -> ThreadingHTTPServer:
    """Start the query surface on a daemon thread; returns the server."""
    handler = type("Handler", (_Handler,),
                   {"aggregator": aggregator,
                    "health_source": (staticmethod(health_source)
                                      if health_source is not None
                                      else None)})
    srv = ThreadingHTTPServer((address or "0.0.0.0", port), handler)
    srv.timeout = 10
    t = threading.Thread(target=srv.serve_forever,
                         name="federation-query", daemon=True)
    t.start()
    log.info("federation query surface on %s:%d", address or "0.0.0.0",
             srv.server_address[1])
    return srv
