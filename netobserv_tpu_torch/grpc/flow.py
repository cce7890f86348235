"""Flow collector gRPC client and server (service `pbflow.Collector`).

A copy of `netobserv_tpu/grpc/flow.py` (lines 1-95) on the port's own
transport (`grpc/h2.py`) and flow wire (`pb/flow.py`) in place of grpcio
and `flow_pb2`. A received `Records` parses to the port's message class.
"""

from __future__ import annotations

import logging
import queue
from typing import Optional

from netobserv_tpu_torch.grpc import h2
from netobserv_tpu_torch.pb import flow as pbflow

log = logging.getLogger("netobserv_tpu_torch.grpc.flow")

_SEND = "/pbflow.Collector/Send"


def _channel_credentials(ca_path: str = "", cert_path: str = "",
                         key_path: str = ""):
    """`_channel_credentials` (`flow.py:18-28`): None for plain TCP, else
    a TLS context with the CA and, for mTLS, the key pair."""
    if not ca_path and not cert_path:
        return None
    return h2.client_ssl_context(ca_path, cert_path, key_path)


def _server_credentials(cert_path: str, key_path: str):
    if cert_path and key_path:
        return h2.server_ssl_context(cert_path, key_path)
    return None


class FlowClient:
    """Thin client for Collector.Send (`flow.py:31-66`)."""

    def __init__(self, host: str, port: int, tls_ca: str = "",
                 tls_cert: str = "", tls_key: str = ""):
        self._target = f"{host}:{port}"
        self._creds = _channel_credentials(tls_ca, tls_cert, tls_key)
        self._channel: Optional[h2.Channel] = None
        self._send = None
        self.connect()

    def connect(self) -> None:
        """A new channel; it connects on its first call."""
        self.close()
        self._channel = h2.Channel(self._target, self._creds)
        self._send = self._channel.unary_unary(
            _SEND,
            request_serializer=pbflow.Records.SerializeToString,
            response_deserializer=pbflow.CollectorReply.FromString)

    def send(self, records: pbflow.Records,
             timeout_s: float = 10.0) -> pbflow.CollectorReply:
        return self._send(records, timeout=timeout_s)

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None


def start_flow_collector(port: int = 0,
                         out: Optional["queue.Queue[pbflow.Records]"] = None,
                         tls_cert: str = "", tls_key: str = ""):
    """In-process collector server; returns (server, bound_port, queue).

    `start_flow_collector` (`flow.py:69-95`): every received Records
    message goes to `out`, and the reply is an empty CollectorReply. A
    request that does not parse is INTERNAL, as grpc answers a failed
    request deserializer."""
    out = out if out is not None else queue.Queue()

    def send(request: bytes) -> bytes:
        try:
            msg = pbflow.Records.FromString(request)
        except ValueError as exc:
            raise h2.RpcError(h2.StatusCode.INTERNAL,
                              f"Exception deserializing request: {exc}"
                              ) from None
        out.put(msg)
        return pbflow.CollectorReply().SerializeToString()

    server = h2.Server(max_workers=4)
    server.add_unary(_SEND, send)
    bound = server.add_port(f"0.0.0.0:{port}",
                            _server_credentials(tls_cert, tls_key))
    server.start()
    return server, bound, out
