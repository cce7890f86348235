"""The aggregator-tier process (`FEDERATION_MODE=aggregator`).

A copy of `netobserv_tpu/federation/service.py` (lines 1-146) over the
port's parts. It has `agent.FlowsAgent`'s shape: a status machine
(Starting, Started, Degraded, Stopping, Stopped), a supervisor
(`agent/supervisor.py`) watching the aggregator's window thread,
`health_snapshot` for `/healthz` and `/readyz`, and `run`/`stop`/
`shutdown` for `__main__`'s SIGTERM. It assembles the Federation gRPC
collector (`grpc/federation.start_federation_collector` over the port's
`grpc/h2.py`, TLS with METRICS_TLS_CERT_PATH and METRICS_TLS_KEY_PATH as
the reference's does), the `FederationAggregator` (the device merge and
the cluster window, `FederationAggregator.from_config`: the SKETCH_*
geometry and thresholds, ALERT_RULES, ARCHIVE_DIR and the report sink)
and the query surface (`federation/query.start_query_server`, off when
FEDERATION_QUERY_PORT < 0). `__main__` starts the Prometheus server, as
for every agent.

SKETCH_DEVICES=cpu runs the aggregator on the CPU; otherwise it runs on
the card, and without CUDA it raises `RuntimeError` when it is made, as
the agent does. It never falls back. The aggregator is made, and on CUDA
its merge captured, in the constructor, before `start()` opens the
collector whose worker threads call `ingest_frame` (ROADMAP C4: every
CUDA call of the window plane then holds the aggregator's lock).
`shutdown()` stops the collector and waits for its calls in flight (at
most its 2 s grace and the joins after it), then closes the aggregator,
which publishes the last window synchronously, then the query server.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from netobserv_tpu_torch.agent.supervisor import Supervisor
from netobserv_tpu_torch.federation.aggregator import FederationAggregator
from netobserv_tpu_torch.metrics.registry import Metrics, MetricsSettings

log = logging.getLogger("netobserv_tpu_torch.federation.service")

#: seconds the collector serves its calls in flight at shutdown
GRPC_GRACE_S = 2.0


class FederationAggregatorService:
    """The central aggregator as a runnable process (module docstring)."""

    def __init__(self, cfg, metrics: Optional[Metrics] = None,
                 sink=None):
        self.cfg = cfg
        self.metrics = metrics or Metrics(MetricsSettings(
            prefix=cfg.metrics_prefix, level=cfg.metrics_level))
        self._status = "Starting"
        self._status_lock = threading.Lock()
        self.aggregator = FederationAggregator.from_config(
            cfg, metrics=self.metrics, sink=sink)
        self.supervisor = Supervisor(
            metrics=self.metrics,
            check_period_s=cfg.supervisor_check_period,
            on_degraded=self._on_degraded)
        self.aggregator.register_supervised(
            self.supervisor,
            heartbeat_timeout_s=cfg.supervisor_heartbeat_timeout,
            max_restarts=cfg.supervisor_max_restarts,
            backoff_initial_s=cfg.supervisor_backoff_initial,
            backoff_max_s=cfg.supervisor_backoff_max,
            healthy_reset_s=cfg.supervisor_healthy_reset)
        self._grpc_server = None
        self._query_server = None
        self._stop = threading.Event()
        self._active_stop: Optional[threading.Event] = None
        self.grpc_port = 0
        self.query_port = 0

    def _on_degraded(self, stage: str) -> None:
        with self._status_lock:
            if self._status == "Started":
                self._status = "Degraded"
        log.error("aggregator DEGRADED: stage %s exhausted its restart "
                  "budget", stage)

    def health_snapshot(self) -> dict:
        with self._status_lock:
            status = self._status
        return {"status": status,
                "degraded": self.supervisor.degraded,
                "stages": self.supervisor.snapshot()}

    def start(self) -> None:
        from netobserv_tpu_torch.federation.query import start_query_server
        from netobserv_tpu_torch.grpc.federation import (
            start_federation_collector,
        )

        cfg = self.cfg
        self._grpc_server, self.grpc_port, _ = start_federation_collector(
            port=cfg.federation_listen_port,
            handler=self.aggregator.ingest_frame,
            tls_cert=cfg.metrics_tls_cert_path,
            tls_key=cfg.metrics_tls_key_path)
        if cfg.federation_query_port >= 0:
            self._query_server = start_query_server(
                self.aggregator, cfg.federation_query_port,
                health_source=self.health_snapshot)
            self.query_port = self._query_server.server_address[1]
        if cfg.supervisor_enable:
            self.supervisor.start()
        with self._status_lock:
            self._status = "Started"
        log.info("federation aggregator up: deltas on :%d, queries on :%s",
                 self.grpc_port,
                 self.query_port if self._query_server else "disabled")

    def run(self, stop: Optional[threading.Event] = None) -> None:
        self.start()
        self._active_stop = stop = stop or self._stop
        stop.wait()
        self.shutdown()

    def stop(self) -> None:
        self._stop.set()
        if self._active_stop is not None:
            self._active_stop.set()

    def shutdown(self) -> None:
        with self._status_lock:
            if self._status in ("Stopping", "Stopped"):
                return
            self._status = "Stopping"
        self.supervisor.stop()
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=GRPC_GRACE_S).wait(
                timeout=GRPC_GRACE_S + 11.0)
        self.aggregator.close()  # the last window publishes synchronously
        if self._query_server is not None:
            self._query_server.shutdown()
            self._query_server.server_close()
        with self._status_lock:
            self._status = "Stopped"
