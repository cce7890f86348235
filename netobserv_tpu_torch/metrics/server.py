"""The metrics HTTP server: /metrics, /healthz, /readyz and /query/*.

Counterpart of `netobserv_tpu/metrics/server.py` (`_Handler`,
`start_metrics_server`, `:1-167`), with TLS 1.3 as the minimum when a
certificate and key are given. One difference: `prometheus_client` is
optional where the port runs, so the server renders `/metrics` (and `/`)
through `metrics/registry.exposition` only when it was given a registry.
With none there is no `/metrics`: it answers 404, as an unknown path does,
and `/healthz`, `/readyz` and `/query/*` answer all the same.

- ``/healthz`` and ``/readyz`` (given a `health_source` callable returning
  ``{"status", "degraded", "stages", ...}``): 200 while the status is live
  (readiness: "Started" and not degraded), 503 otherwise, with the
  source's JSON as the body; a raising source answers 503 JSON. Without a
  source both answer 404.
- ``/query`` and ``/query/*`` (given `query_routes`, a
  `query/routes.QueryRoutes`): the route's status and JSON body. Without
  routes they answer 404.
"""

from __future__ import annotations

import json
import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("netobserv_tpu_torch.metrics.server")

#: health_source contract: () -> {"status": str, "degraded": bool,
#: "stages": {...}}
HealthSource = Callable[[], dict]

_READY_STATUSES = ("Started",)
# "Stopping" stays live: a graceful shutdown publishes its last window
_LIVE_STATUSES = ("NotStarted", "Starting", "Started", "Degraded",
                  "Stopping")


class _Handler(BaseHTTPRequestHandler):
    registry = None  # set per server; None: no /metrics
    health_source: Optional[HealthSource] = None
    query_routes = None  # query.routes.QueryRoutes

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?")[0]
        if path in ("/healthz", "/readyz"):
            self._serve_health(path)
            return
        if path == "/query" or path.startswith("/query/"):
            self._serve_query()
            return
        if path not in ("/metrics", "/") or self.registry is None:
            self.send_error(404)
            return
        from netobserv_tpu_torch.metrics.registry import exposition
        payload, ctype = exposition(self.registry)
        self._send(200, ctype, payload)

    def _send(self, code: int, ctype: str, payload: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _serve_query(self) -> None:
        if self.query_routes is None:
            self.send_error(404, explain="no query source configured")
            return
        url = urlparse(self.path)
        params = {k: v[0] for k, v in parse_qs(url.query).items()}
        code, obj = self.query_routes.handle(url.path, params)
        self._send(code, "application/json",
                   json.dumps(obj, separators=(",", ":")).encode())

    def _serve_health(self, path: str) -> None:
        if self.health_source is None:
            self.send_error(404, explain="no health source configured")
            return
        try:
            health = self.health_source()
        except Exception as exc:  # a broken probe must still answer
            health = {"status": "Unknown", "degraded": True,
                      "error": str(exc), "stages": {}}
        status = health.get("status", "Unknown")
        degraded = bool(health.get("degraded"))
        if path == "/readyz":
            ok = status in _READY_STATUSES and not degraded
        else:
            ok = status in _LIVE_STATUSES
        self._send(200 if ok else 503, "application/json",
                   json.dumps(health, separators=(",", ":")).encode())

    def log_message(self, fmt, *args):  # quiet access logs
        log.debug("metrics http: " + fmt, *args)


def start_metrics_server(registry=None, address: str = "",
                         port: int = 9090, tls_cert_path: str = "",
                         tls_key_path: str = "",
                         health_source: Optional[HealthSource] = None,
                         query_routes=None) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it; `port` 0 takes an
    ephemeral port (`server_address[1]`). Stop it with `shutdown()` and
    `server_close()`. `registry` is a `prometheus_client`
    `CollectorRegistry` (a `metrics/registry.Metrics`'s `registry`) or
    None."""
    # staticmethod keeps a plain-function health_source from being bound
    # as a method of the handler
    handler = type("Handler", (_Handler,),
                   {"registry": registry,
                    "query_routes": query_routes,
                    "health_source": (staticmethod(health_source)
                                      if health_source is not None
                                      else None)})
    srv = ThreadingHTTPServer((address or "0.0.0.0", port), handler)
    srv.timeout = 10
    if tls_cert_path and tls_key_path:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(tls_cert_path, tls_key_path)
        srv.socket = ctx.wrap_socket(srv.socket, server_side=True)
    t = threading.Thread(target=srv.serve_forever, name="metrics-http",
                         daemon=True)
    t.start()
    log.info("metrics server listening on %s:%d (tls=%s, health=%s, "
             "metrics=%s)", address or "0.0.0.0", srv.server_address[1],
             bool(tls_cert_path), health_source is not None,
             registry is not None)
    return srv
