"""Packet collector gRPC client and server (service `pbpacket.Collector`).

The port's counterpart of the client and server halves of
`netobserv_tpu/exporter/grpc_packets.py` (`PacketClient` `:28-47`,
`start_packet_collector` `:74-104`) on the port's own transport
(`grpc/h2.py`) and packet wire (`pb/packet.py`) in place of grpcio and
`packet_pb2`. TLS and mTLS take the flow client's options
(`grpc/flow.py`).
"""

from __future__ import annotations

import queue
from typing import Optional

from netobserv_tpu_torch.grpc import h2
from netobserv_tpu_torch.grpc.flow import (
    _channel_credentials, _server_credentials,
)
from netobserv_tpu_torch.pb import packet as pbpacket

_SEND = "/pbpacket.Collector/Send"


class PacketClient:
    """Thin client for Collector.Send (`grpc_packets.py:28-47`)."""

    def __init__(self, host: str, port: int, tls_ca: str = "",
                 tls_cert: str = "", tls_key: str = ""):
        self._channel = h2.Channel(
            f"{host}:{port}", _channel_credentials(tls_ca, tls_cert, tls_key))
        self._send = self._channel.unary_unary(
            _SEND,
            request_serializer=pbpacket.Packet.SerializeToString,
            response_deserializer=pbpacket.CollectorReply.FromString)

    def send_bytes(self, payload: bytes, timeout_s: float = 10.0
                   ) -> pbpacket.CollectorReply:
        """One pcap-framed chunk, wrapped as `Any(BytesValue)`."""
        return self._send(pbpacket.wrap_pcap(payload), timeout=timeout_s)

    def close(self) -> None:
        self._channel.close()


def start_packet_collector(port: int = 0,
                           out: Optional["queue.Queue[bytes]"] = None,
                           tls_cert: str = "", tls_key: str = ""):
    """In-process collector server; returns (server, bound_port, queue of
    bytes): each received packet's pcap bytes go to `out`, and the reply
    is an empty CollectorReply. A request that does not parse, or holds
    no `BytesValue`, is INTERNAL, as grpc answers a failed request
    deserializer."""
    out = out if out is not None else queue.Queue()

    def send(request: bytes) -> bytes:
        try:
            payload = pbpacket.unwrap_pcap(
                pbpacket.Packet.FromString(request))
        except ValueError as exc:
            raise h2.RpcError(h2.StatusCode.INTERNAL,
                              f"Exception deserializing request: {exc}"
                              ) from None
        out.put(payload)
        return pbpacket.CollectorReply().SerializeToString()

    server = h2.Server(max_workers=2)
    server.add_unary(_SEND, send)
    bound = server.add_port(f"0.0.0.0:{port}",
                            _server_credentials(tls_cert, tls_key))
    server.start()
    return server, bound, out
