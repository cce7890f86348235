"""Federation gRPC plumbing (service `pbsketch.Federation`).

A copy of `netobserv_tpu/grpc/federation.py` (lines 1-152) on the port's
own transport (`grpc/h2.py`): a thin unary client and an in-process
server. Delta frames travel as raw bytes on both ends, so the one
encode/decode site stays `federation/delta.py`; the acks are pbwire's
`DeltaAck`.
"""

from __future__ import annotations

import logging
import queue
from typing import Callable, Optional

from netobserv_tpu_torch.federation.pbwire import DeltaAck
from netobserv_tpu_torch.grpc import h2
from netobserv_tpu_torch.grpc.flow import (
    _channel_credentials, _server_credentials,
)
from netobserv_tpu_torch.grpc.h2 import RpcError, StatusCode

log = logging.getLogger("netobserv_tpu_torch.grpc.federation")

_PUSH = "/pbsketch.Federation/Push"

#: gRPC status codes worth a retry of the SAME frame bytes
#: (`federation.py:33-44`). UNAVAILABLE is the aggregator restarting;
#: DEADLINE_EXCEEDED is the ambiguous one (the push may have been
#: applied), safe only because v2 frames carry an idempotency key the
#: aggregator dedups on.
RETRY_SAFE_CODES = frozenset((
    StatusCode.UNAVAILABLE,
    StatusCode.DEADLINE_EXCEEDED,
    StatusCode.RESOURCE_EXHAUSTED,
    StatusCode.ABORTED,
    StatusCode.INTERNAL,
    StatusCode.UNKNOWN,
))

#: codes where resending the same bytes cannot succeed
#: (`federation.py:46-55`)
TERMINAL_CODES = frozenset((
    StatusCode.INVALID_ARGUMENT,
    StatusCode.UNIMPLEMENTED,
    StatusCode.FAILED_PRECONDITION,
    StatusCode.PERMISSION_DENIED,
    StatusCode.UNAUTHENTICATED,
    StatusCode.NOT_FOUND,
))


def classify_rpc_error(exc: Exception) -> str:
    """`retry` / `terminal` for a push failure (`federation.py:58-64`).
    Anything that is not an `RpcError` classifies as terminal."""
    code = exc.code() if isinstance(exc, RpcError) else None
    if code in TERMINAL_CODES:
        return "terminal"
    if code in RETRY_SAFE_CODES:
        return "retry"
    return "retry" if code is not None else "terminal"


class FederationClient:
    """Unary Push client (`federation.py:67-107`); `send` takes an
    already-serialized delta frame."""

    def __init__(self, host: str, port: int, tls_ca: str = "",
                 tls_cert: str = "", tls_key: str = ""):
        self._target = f"{host}:{port}"
        self._creds = _channel_credentials(tls_ca, tls_cert, tls_key)
        self._channel: Optional[h2.Channel] = None
        self._push = None
        self.connect()

    def connect(self) -> None:
        """A fresh channel with no state of the last one: it dials anew on
        its first call and inherits no backoff, which the reference gets
        from grpc's local subchannel pool."""
        self.close()
        self._channel = h2.Channel(self._target, self._creds)
        self._push = self._channel.unary_unary(
            _PUSH, response_deserializer=DeltaAck.FromString)

    def send(self, frame: bytes, timeout_s: float = 10.0) -> DeltaAck:
        return self._push(frame, timeout=timeout_s)

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None


def start_federation_collector(
        port: int = 0,
        handler: Optional[Callable[[bytes], DeltaAck]] = None,
        out: Optional["queue.Queue[bytes]"] = None,
        tls_cert: str = "", tls_key: str = "", max_workers: int = 4):
    """In-process Federation server; returns (server, bound_port, queue).

    `start_federation_collector` (`federation.py:110-152`):
    `handler(frame_bytes) -> DeltaAck` is the aggregator's ingest entry;
    without one, frames land on `out` and are blanket-acked. A handler
    exception acks `accepted=0` with the reason: one malformed frame must
    never tear down the stream every other agent pushes on."""
    out = out if out is not None else queue.Queue()

    def push(request: bytes) -> bytes:
        if handler is None:
            out.put(request)
            return DeltaAck(accepted=1).SerializeToString()
        try:
            ack = handler(request)
        except Exception as exc:  # one bad frame, not the server
            log.error("federation push handler failed: %s", exc)
            ack = DeltaAck(accepted=0, reason=str(exc))
        return ack.SerializeToString()

    server = h2.Server(max_workers=max_workers)
    server.add_unary(_PUSH, push)
    bound = server.add_port(f"0.0.0.0:{port}",
                            _server_credentials(tls_cert, tls_key))
    server.start()
    return server, bound, out
