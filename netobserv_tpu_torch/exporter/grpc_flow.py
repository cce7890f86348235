"""gRPC flow exporter.

A copy of `netobserv_tpu/exporter/grpc_flow.py` (lines 1-54) on the
port's `grpc/flow.FlowClient`: batches split at GRPC_MESSAGE_MAX_FLOWS,
and an optional periodic reconnect with randomization so that a
load-balanced collector tier rebalances.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Optional

from netobserv_tpu_torch.exporter.base import Exporter
from netobserv_tpu_torch.exporter.pb_convert import records_to_pb
from netobserv_tpu_torch.grpc.flow import FlowClient
from netobserv_tpu_torch.model.record import Record

log = logging.getLogger("netobserv_tpu_torch.exporter.grpc")


class GRPCFlowExporter(Exporter):
    """`GRPCFlowExporter` (`grpc_flow.py:23-54`)."""

    name = "grpc"

    def __init__(self, host: str, port: int, max_flows_per_message: int = 10000,
                 tls_ca: str = "", tls_cert: str = "", tls_key: str = "",
                 reconnect_every_s: Optional[float] = None,
                 reconnect_randomization_s: float = 0.0, metrics=None,
                 client: Optional[FlowClient] = None):
        self._client = client or FlowClient(host, port, tls_ca, tls_cert, tls_key)
        self._max_flows = max_flows_per_message
        self._reconnect_every = reconnect_every_s
        self._reconnect_rand = reconnect_randomization_s
        self._next_reconnect = self._compute_next_reconnect()

    def _compute_next_reconnect(self) -> Optional[float]:
        if not self._reconnect_every:
            return None
        jitter = random.uniform(-1, 1) * self._reconnect_rand
        return time.monotonic() + max(self._reconnect_every + jitter, 1.0)

    def export_batch(self, records: list[Record]) -> None:
        if (self._next_reconnect is not None
                and time.monotonic() >= self._next_reconnect):
            log.debug("periodic gRPC reconnect for collector rebalancing")
            self._client.connect()
            self._next_reconnect = self._compute_next_reconnect()
        for start in range(0, len(records), self._max_flows):
            chunk = records[start:start + self._max_flows]
            self._client.send(records_to_pb(chunk))

    def close(self) -> None:
        self._client.close()
