"""Unary gRPC over HTTP/2, client and server, with the standard library only.

The port's own module: the JAX package speaks gRPC through `grpcio`,
which the card's machine does not have, so this module puts gRPC's unary
calls on the wire itself with `socket`, `ssl` and `threading`. It is the
transport of `grpc/flow.py` and `grpc/federation.py`; messages are bytes
here, and each caller serializes its own.

What it speaks (RFC 7540 HTTP/2, RFC 7541 HPACK, gRPC's PROTOCOL-HTTP2):

- **Frames.** DATA, HEADERS with CONTINUATION, RST_STREAM, SETTINGS,
  PING, GOAWAY and WINDOW_UPDATE; PRIORITY, padding, unknown SETTINGS and
  unknown frame types are accepted and ignored. PING and SETTINGS are
  acknowledged (grpc sends BDP pings).
- **HPACK.** The decoder takes indexed fields, every literal form, the
  dynamic table with its size updates and Huffman-coded strings; the
  Huffman code of RFC 7541 Appendix B is canonical, so it is built from
  its 257 code lengths (`_HUFFMAN_LENGTHS`). The encoder writes literals
  without indexing, never Huffman-coded, so it keeps no state.
- **Flow control.** A sender never exceeds the peer's connection and
  stream windows, nor 16,384 bytes a frame: grpc checks frames against
  its settings only once our ACK of them has reached it, so a larger
  MAX_FRAME_SIZE it offers is not taken. A sender waits for
  WINDOW_UPDATE while the connection's reader thread goes on reading. A receiver advertises
  `STREAM_WINDOW` a stream and `CONNECTION_WINDOW` in all, and gives
  back what it consumed once half a window is used.
- **Calls.** A request is HEADERS (`:method POST`, `:scheme`, `:path`,
  `:authority`, `content-type: application/grpc`, `te: trailers`,
  `grpc-timeout`) and DATA holding one 5-byte length-prefixed message. A
  reply is HEADERS, DATA and trailers, or trailers alone.
- **Status.** `StatusCode` has grpc's names and numbers; `RpcError` has
  `.code()` and `.details()`. A refused, reset or lost connection, or a
  GOAWAY before the reply, is UNAVAILABLE; the client's deadline is
  DEADLINE_EXCEEDED, and the stream is reset with CANCEL; otherwise the
  trailers' `grpc-status` with their percent-decoded `grpc-message`.
  A message over `MAX_MESSAGE` (4 MiB, grpc's default receive limit) is
  refused with RESOURCE_EXHAUSTED on either side.
- **TLS.** `ssl` with ALPN `h2` (grpc refuses TLS without it), run over
  memory BIOs so that one connection's reader and writers never touch
  the TLS object at once.

The client (`Channel`) connects lazily on its first call, as a grpc
channel does, and opens a new connection for the next call once the
last one failed or was told to go away. The server (`Server`) listens on
`host:port` (port 0 takes a free one), runs handlers on a pool of
`max_workers`, many streams to a connection, answers UNIMPLEMENTED for a
path it does not serve, and stops with `stop(grace)`, which returns an
event, as grpc's does. It does not enforce a call's `grpc-timeout`: the
client keeps its own deadline. Every thread is a daemon and every wait
has a timeout.
"""

from __future__ import annotations

import enum
import logging
import socket
import ssl
import struct
import threading
import time
from concurrent import futures
from typing import Callable, Optional

log = logging.getLogger("netobserv_tpu_torch.grpc.h2")

#: grpc's default receive limit, which the reference's servers keep
MAX_MESSAGE = 4 * 1024 * 1024
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
#: the window a receiver advertises for each stream, and in all
STREAM_WINDOW = 1 << 20
CONNECTION_WINDOW = 4 << 20
_DEFAULT_WINDOW = 65535
_DEFAULT_FRAME = 16384
_MAX_WINDOW = (1 << 31) - 1

# frame types and flags
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0, 1, 2, 3, 4
PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 6, 7, 8, 9
END_STREAM, ACK, END_HEADERS, PADDED, PRIORITY_FLAG = 0x1, 0x1, 0x4, 0x8, 0x20
# settings
S_ENABLE_PUSH, S_INITIAL_WINDOW, S_MAX_FRAME = 2, 4, 5
# error codes
NO_ERROR, REFUSED_STREAM, CANCEL = 0x0, 0x7, 0x8
ENHANCE_YOUR_CALM, INADEQUATE_SECURITY = 0xB, 0xC


class StatusCode(enum.IntEnum):
    """gRPC's status codes, with grpc's names and numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A failed call: `.code()` a `StatusCode`, `.details()` its text."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


#: grpc's mapping of a RST_STREAM error code to a status
_RST_STATUS = {REFUSED_STREAM: StatusCode.UNAVAILABLE,
               CANCEL: StatusCode.CANCELLED,
               ENHANCE_YOUR_CALM: StatusCode.RESOURCE_EXHAUSTED,
               INADEQUATE_SECURITY: StatusCode.PERMISSION_DENIED}
#: grpc's mapping of an HTTP status without grpc-status
_HTTP_STATUS = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                403: StatusCode.PERMISSION_DENIED,
                404: StatusCode.UNIMPLEMENTED, 429: StatusCode.UNAVAILABLE,
                502: StatusCode.UNAVAILABLE, 503: StatusCode.UNAVAILABLE,
                504: StatusCode.UNAVAILABLE}


# ------------------------------------------------------------------ HPACK

_STATIC = [
    (b":authority", b""), (b":method", b"GET"), (b":method", b"POST"),
    (b":path", b"/"), (b":path", b"/index.html"), (b":scheme", b"http"),
    (b":scheme", b"https"), (b":status", b"200"), (b":status", b"204"),
    (b":status", b"206"), (b":status", b"304"), (b":status", b"400"),
    (b":status", b"404"), (b":status", b"500"), (b"accept-charset", b""),
    (b"accept-encoding", b"gzip, deflate"), (b"accept-language", b""),
    (b"accept-ranges", b""), (b"accept", b""),
    (b"access-control-allow-origin", b""), (b"age", b""), (b"allow", b""),
    (b"authorization", b""), (b"cache-control", b""),
    (b"content-disposition", b""), (b"content-encoding", b""),
    (b"content-language", b""), (b"content-length", b""),
    (b"content-location", b""), (b"content-range", b""),
    (b"content-type", b""), (b"cookie", b""), (b"date", b""),
    (b"etag", b""), (b"expect", b""), (b"expires", b""), (b"from", b""),
    (b"host", b""), (b"if-match", b""), (b"if-modified-since", b""),
    (b"if-none-match", b""), (b"if-range", b""),
    (b"if-unmodified-since", b""), (b"last-modified", b""), (b"link", b""),
    (b"location", b""), (b"max-forwards", b""),
    (b"proxy-authenticate", b""), (b"proxy-authorization", b""),
    (b"range", b""), (b"referer", b""), (b"refresh", b""),
    (b"retry-after", b""), (b"server", b""), (b"set-cookie", b""),
    (b"strict-transport-security", b""), (b"transfer-encoding", b""),
    (b"user-agent", b""), (b"vary", b""), (b"via", b""),
    (b"www-authenticate", b"")]

#: RFC 7541 Appendix B: the code length of each symbol 0-255 and EOS (256)
_HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30)
_EOS = 256


def _canonical_codes(lengths) -> list[int]:
    """The canonical code of each symbol: by length, then by symbol."""
    codes = [0] * len(lengths)
    code, prev = 0, 0
    for sym in sorted(range(len(lengths)), key=lambda s: (lengths[s], s)):
        code <<= lengths[sym] - prev
        prev = lengths[sym]
        codes[sym] = code
        code += 1
    return codes


HUFFMAN_CODES = _canonical_codes(_HUFFMAN_LENGTHS)
#: (length, code) -> symbol
_HUFFMAN_DECODE = {(n, c): s for s, (n, c) in
                   enumerate(zip(_HUFFMAN_LENGTHS, HUFFMAN_CODES))}
_HUFFMAN_MIN = min(_HUFFMAN_LENGTHS)


class HpackError(ValueError):
    """A header block HPACK cannot decode (a COMPRESSION_ERROR)."""


def huffman_decode(data: bytes) -> bytes:
    """RFC 7541 5.2; padding longer than 7 bits, padding that is not the
    EOS prefix, and an EOS symbol raise `HpackError`."""
    out = bytearray()
    code = n = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if n < _HUFFMAN_MIN:
                continue
            sym = _HUFFMAN_DECODE.get((n, code))
            if sym is None:
                if n > 30:
                    raise HpackError("invalid Huffman code")
                continue
            if sym == _EOS:
                raise HpackError("EOS in a Huffman string")
            out.append(sym)
            code = n = 0
    if n > 7 or code != (1 << n) - 1:
        raise HpackError("invalid Huffman padding")
    return bytes(out)


def _encode_int(value: int, prefix: int, first: int) -> bytes:
    """RFC 7541 5.1, `first` holding the bits above the prefix."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _decode_int(buf: bytes, pos: int, prefix: int) -> tuple[int, int]:
    if pos >= len(buf):
        raise HpackError("truncated integer")
    limit = (1 << prefix) - 1
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise HpackError("truncated integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 28:
            raise HpackError("integer too large")


def _encode_str(data: bytes) -> bytes:
    return _encode_int(len(data), 7, 0) + data


def encode_headers(headers) -> bytes:
    """A header block of literals without indexing, new names, no
    Huffman coding (RFC 7541 6.2.2), so the encoder has no state."""
    return b"".join(b"\x00" + _encode_str(name) + _encode_str(value)
                    for name, value in headers)


class HpackDecoder:
    """RFC 7541 decoding with a dynamic table of at most `max_size`
    bytes (the SETTINGS_HEADER_TABLE_SIZE this side advertised)."""

    def __init__(self, max_size: int = 4096):
        self._limit = max_size
        self._size_max = max_size
        self._table: list[tuple[bytes, bytes]] = []  # newest first
        self._size = 0

    def _evict(self) -> None:
        while self._size > self._size_max and self._table:
            name, value = self._table.pop()
            self._size -= len(name) + len(value) + 32

    def _add(self, name: bytes, value: bytes) -> None:
        self._table.insert(0, (name, value))
        self._size += len(name) + len(value) + 32
        self._evict()

    def _entry(self, index: int) -> tuple[bytes, bytes]:
        if index == 0:
            raise HpackError("index 0")
        if index <= len(_STATIC):
            return _STATIC[index - 1]
        index -= len(_STATIC) + 1
        if index >= len(self._table):
            raise HpackError("index past the dynamic table")
        return self._table[index]

    def _string(self, buf: bytes, pos: int) -> tuple[bytes, int]:
        if pos >= len(buf):
            raise HpackError("truncated string")
        huff = buf[pos] & 0x80
        size, pos = _decode_int(buf, pos, 7)
        if size > len(buf) - pos:
            raise HpackError("string past the header block")
        raw = bytes(buf[pos:pos + size])
        return (huffman_decode(raw) if huff else raw), pos + size

    def decode(self, block: bytes) -> list[tuple[bytes, bytes]]:
        out = []
        pos = 0
        seen_field = False
        while pos < len(block):
            b = block[pos]
            if b & 0x80:  # indexed
                index, pos = _decode_int(block, pos, 7)
                out.append(self._entry(index))
                seen_field = True
                continue
            if b & 0xE0 == 0x20:  # dynamic table size update
                if seen_field:
                    raise HpackError("size update after a field")
                size, pos = _decode_int(block, pos, 5)
                if size > self._limit:
                    raise HpackError("table size past the setting")
                self._size_max = size
                self._evict()
                continue
            indexing = b & 0xC0 == 0x40
            index, pos = _decode_int(block, pos, 6 if indexing else 4)
            if index:
                name = self._entry(index)[0]
            else:
                name, pos = self._string(block, pos)
            value, pos = self._string(block, pos)
            if indexing:
                self._add(name, value)
            out.append((name, value))
            seen_field = True
        return out


# ------------------------------------------------------------------ status


def encode_grpc_message(text: str) -> bytes:
    """gRPC's percent-encoding of `grpc-message`: UTF-8, with every byte
    outside 0x20-0x7E and '%' written %XX."""
    return b"".join(bytes([c]) if 0x20 <= c <= 0x7E and c != 0x25
                    else b"%%%02X" % c for c in text.encode("utf-8"))


def decode_grpc_message(raw: bytes) -> str:
    out = bytearray()
    i = 0
    while i < len(raw):
        if raw[i] == 0x25 and _is_hex(raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def _is_hex(pair: bytes) -> bool:
    return len(pair) == 2 and all(c in b"0123456789abcdefABCDEF"
                                  for c in pair)


def _timeout_header(seconds: float) -> bytes:
    """grpc-timeout: at most 8 digits, in the finest unit that fits."""
    for unit, scale in ((b"u", 1e6), (b"m", 1e3), (b"S", 1.0),
                        (b"M", 1 / 60), (b"H", 1 / 3600)):
        value = int(max(seconds, 0.0) * scale + 0.999999)
        if value < 100_000_000:
            return b"%d" % value + unit
    return b"99999999H"


def _status_from(headers: dict, http_ok: bool) -> tuple[StatusCode, str]:
    raw = headers.get(b"grpc-status")
    if raw is None:
        if not http_ok:
            code = int(headers.get(b":status", b"0") or 0)
            return (_HTTP_STATUS.get(code, StatusCode.UNKNOWN),
                    f"Received http2 header with status: {code}")
        return StatusCode.UNKNOWN, "missing grpc-status"
    try:
        code = StatusCode(int(raw))
    except ValueError:
        code = StatusCode.UNKNOWN
    return code, decode_grpc_message(headers.get(b"grpc-message", b""))


def _frame_message(message: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", len(message)) + message


# -------------------------------------------------------------- transports


class _Plain:
    """A TCP socket; writers serialize on the connection's send lock."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def recv(self) -> bytes:
        return self.sock.recv(65536)


class _Tls:
    """TLS over memory BIOs: the TLS object is touched only under
    `_obj_lock`, raw bytes go out in the order they were made (under the
    connection's send lock), and the reader and writers run at once."""

    def __init__(self, sock: socket.socket, ctx: ssl.SSLContext,
                 server_side: bool, hostname: Optional[str],
                 send_lock: threading.Lock, deadline: float):
        self.sock = sock
        self._in, self._out = ssl.MemoryBIO(), ssl.MemoryBIO()
        self._obj = ctx.wrap_bio(self._in, self._out,
                                 server_side=server_side,
                                 server_hostname=hostname)
        self._obj_lock = threading.Lock()
        self._send_lock = send_lock
        while True:
            try:
                self._obj.do_handshake()
                break
            except ssl.SSLWantReadError:
                self.sock.sendall(self._out.read())
                sock.settimeout(max(deadline - time.monotonic(), 0.001))
                data = sock.recv(65536)
                if not data:
                    raise ConnectionError("closed during the TLS handshake")
                self._in.write(data)
        self.sock.sendall(self._out.read())
        sock.settimeout(None)
        if self._obj.selected_alpn_protocol() != "h2":
            raise ConnectionError("the peer did not negotiate ALPN h2")

    def send(self, data: bytes) -> None:  # under the send lock
        view = memoryview(data)
        while view:
            with self._obj_lock:  # a write may take only part of it
                view = view[self._obj.write(view):]
                out = self._out.read()
            self.sock.sendall(out)

    def recv(self) -> bytes:
        while True:
            raw = self.sock.recv(65536)
            if not raw:
                return b""
            chunks = []
            with self._obj_lock:
                self._in.write(raw)
                while True:
                    try:
                        chunks.append(self._obj.read(65536))
                    except (ssl.SSLWantReadError, ssl.SSLZeroReturnError):
                        break
                pending = self._out.pending
            if pending:  # a TLS reply of its own (key update, alert)
                with self._send_lock, self._obj_lock:
                    out = self._out.read()
                    if out:
                        self.sock.sendall(out)
            data = b"".join(chunks)
            if data:
                return data


def client_ssl_context(ca_path: str = "", cert_path: str = "",
                       key_path: str = "") -> ssl.SSLContext:
    """TLS for a client, as `_channel_credentials`
    (`netobserv_tpu/grpc/flow.py:18-28`): the CA file (else the system's
    roots) and, for mTLS, a certificate chain and key."""
    ctx = ssl.create_default_context(cafile=ca_path or None)
    if cert_path and key_path:
        ctx.load_cert_chain(cert_path, key_path)
    ctx.set_alpn_protocols(["h2"])
    return ctx


def server_ssl_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    """TLS for a server, as `grpc.ssl_server_credentials` with one key
    pair and no client-certificate requirement."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert_path, key_path)
    ctx.set_alpn_protocols(["h2"])
    return ctx


# -------------------------------------------------------------- connection


class _Stream:
    __slots__ = ("id", "headers", "trailers", "data", "done", "error",
                 "send_window", "unacked", "path", "discard", "cancelled")

    def __init__(self, sid: int, send_window: int):
        self.id = sid
        self.headers: Optional[dict] = None
        self.trailers: Optional[dict] = None
        self.data = bytearray()
        self.done = False
        self.error: Optional[RpcError] = None
        self.send_window = send_window
        self.unacked = 0
        self.path = b""
        self.discard = False
        self.cancelled = False


class _Connection:
    """One HTTP/2 connection: a reader thread and any number of writers.

    `on_request(stream)` (server side) is called by the reader when a
    request stream ends; the client side waits on `cv` instead."""

    def __init__(self, transport, client: bool, send_lock: threading.Lock,
                 on_request: Optional[Callable] = None, name: str = "h2"):
        self.t = transport
        self.client = client
        self.send_lock = send_lock
        self.cv = threading.Condition()
        self.streams: dict[int, _Stream] = {}
        self.on_request = on_request
        self.conn_window = _DEFAULT_WINDOW
        self.peer_initial = _DEFAULT_WINDOW
        self.peer_frame = _DEFAULT_FRAME
        self.recv_unacked = 0
        self.next_id = 1
        self.goaway: Optional[int] = None
        self.closed = False
        self.failure = "connection closed"
        self.decoder = HpackDecoder()
        self._buf = bytearray()
        self._block: Optional[tuple[int, int, bytearray]] = None
        self.reader = threading.Thread(target=self._read_loop, daemon=True,
                                       name=name)

    # ---------------------------------------------------------- writing

    def start(self) -> None:
        settings = struct.pack(">HIHI", S_ENABLE_PUSH, 0, S_INITIAL_WINDOW,
                               STREAM_WINDOW)
        with self.send_lock:
            self.t.send((PREFACE if self.client else b"")
                        + _frame(SETTINGS, 0, 0, settings)
                        + _frame(WINDOW_UPDATE, 0, 0, struct.pack(
                            ">I", CONNECTION_WINDOW - _DEFAULT_WINDOW)))
        self.reader.start()

    def send_frames(self, frames: bytes) -> None:
        with self.send_lock:
            self.t.send(frames)

    def send_headers(self, stream: _Stream, headers, end_stream: bool
                     ) -> None:
        block = encode_headers(headers)
        first, rest = block[:_DEFAULT_FRAME], block[_DEFAULT_FRAME:]
        flags = (END_STREAM if end_stream else 0) | (0 if rest
                                                     else END_HEADERS)
        out = _frame(HEADERS, flags, stream.id, first)
        while rest:
            chunk, rest = rest[:_DEFAULT_FRAME], rest[_DEFAULT_FRAME:]
            out += _frame(CONTINUATION, 0 if rest else END_HEADERS,
                          stream.id, chunk)
        self.send_frames(out)

    def send_data(self, stream: _Stream, payload: bytes,
                  deadline: Optional[float], end_stream: bool = True
                  ) -> bool:
        """DATA within the peer's windows and frame size; False when the
        stream ended (a reply, a reset) before all of it went out."""
        view = memoryview(payload)
        pos = 0
        while True:
            with self.cv:
                while True:
                    if stream.done or stream.cancelled or self.closed:
                        return False
                    room = min(self.conn_window, stream.send_window,
                               self.peer_frame, _DEFAULT_FRAME,
                               len(view) - pos)
                    if room > 0 or pos == len(view):
                        break
                    wait = 1.0 if deadline is None else min(
                        deadline - time.monotonic(), 1.0)
                    if wait <= 0:
                        raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                                       "Deadline Exceeded")
                    self.cv.wait(wait)
                self.conn_window -= room
                stream.send_window -= room
            last = pos + room == len(view)
            self.send_frames(_frame(
                DATA, END_STREAM if (last and end_stream) else 0, stream.id,
                bytes(view[pos:pos + room])))
            pos += room
            if last:
                return True

    def reset(self, sid: int, code: int) -> None:
        try:
            self.send_frames(_frame(RST_STREAM, 0, sid,
                                    struct.pack(">I", code)))
        except OSError:
            pass

    def close(self, goaway: bool = True) -> None:
        """GOAWAY, then shut the socket down: the reader wakes, fails the
        open streams and closes the socket."""
        if goaway and not self.closed:
            try:
                with self.cv:
                    last = 0 if self.client else max(self.streams,
                                                     default=0)
                self.send_frames(_frame(GOAWAY, 0, 0,
                                        struct.pack(">II", last, NO_ERROR)))
            except OSError:
                pass
        try:
            self.t.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # ---------------------------------------------------------- reading

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.t.recv()
            if not chunk:
                raise ConnectionError("connection closed by the peer")
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def _read_loop(self) -> None:
        try:
            if not self.client and self._read_exact(len(PREFACE)) != PREFACE:
                raise ConnectionError("not an HTTP/2 client preface")
            while True:
                head = self._read_exact(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                sid = int.from_bytes(head[5:9], "big") & _MAX_WINDOW
                self._on_frame(ftype, flags, sid, self._read_exact(length))
        except (OSError, ConnectionError, ValueError, ssl.SSLError) as exc:
            self.failure = str(exc) or type(exc).__name__
        finally:
            with self.cv:
                self.closed = True
                for s in self.streams.values():
                    if not s.done:
                        s.error = s.error or RpcError(
                            StatusCode.UNAVAILABLE, self.failure)
                        s.done = True
                self.cv.notify_all()
            try:
                self.t.sock.close()
            except OSError:
                pass

    def _on_frame(self, ftype: int, flags: int, sid: int, body: bytes
                  ) -> None:
        if self._block is not None and ftype != CONTINUATION:
            raise ConnectionError("a frame inside a header block")
        if ftype == DATA:
            self._on_data(flags, sid, body)
        elif ftype == HEADERS:
            if flags & PADDED:
                body = body[1:len(body) - body[0]]
            if flags & PRIORITY_FLAG:
                body = body[5:]
            self._block = (sid, flags, bytearray(body))
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == CONTINUATION:
            if self._block is None or self._block[0] != sid:
                raise ConnectionError("CONTINUATION out of a header block")
            self._block[2].extend(body)
            if flags & END_HEADERS:
                self._end_block()
        elif ftype == RST_STREAM:
            self._on_reset(sid, struct.unpack(">I", body[:4])[0])
        elif ftype == SETTINGS:
            if not flags & ACK:
                self._on_settings(body)
        elif ftype == PING:
            if not flags & ACK:
                self.send_frames(_frame(PING, ACK, 0, body))
        elif ftype == GOAWAY:
            self._on_goaway(struct.unpack(">I", body[:4])[0] & _MAX_WINDOW)
        elif ftype == WINDOW_UPDATE:
            inc = struct.unpack(">I", body[:4])[0] & _MAX_WINDOW
            with self.cv:
                if sid == 0:
                    self.conn_window += inc
                elif sid in self.streams:
                    self.streams[sid].send_window += inc
                self.cv.notify_all()
        # PRIORITY, PUSH_PROMISE (push is disabled) and unknown types:
        # nothing to do

    def _on_settings(self, body: bytes) -> None:
        with self.cv:
            for i in range(0, len(body) - len(body) % 6, 6):
                key, value = struct.unpack(">HI", body[i:i + 6])
                if key == S_INITIAL_WINDOW:
                    delta = value - self.peer_initial
                    self.peer_initial = value
                    for s in self.streams.values():
                        s.send_window += delta
                elif key == S_MAX_FRAME:
                    self.peer_frame = value
            self.cv.notify_all()
        self.send_frames(_frame(SETTINGS, ACK, 0, b""))

    def _on_goaway(self, last: int) -> None:
        with self.cv:
            self.goaway = last
            for s in self.streams.values():
                if s.id > last and not s.done:
                    s.error = RpcError(StatusCode.UNAVAILABLE,
                                       "GOAWAY before the reply")
                    s.done = True
            self.cv.notify_all()

    def _on_reset(self, sid: int, code: int) -> None:
        with self.cv:
            s = (self.streams.get(sid) if self.client
                 else self.streams.pop(sid, None))
            if s is None:
                return
            s.cancelled = True
            if not s.done:
                s.error = RpcError(_RST_STATUS.get(code, StatusCode.INTERNAL),
                                   f"Received RST_STREAM with error code "
                                   f"{code}")
                s.done = True
            self.cv.notify_all()

    def _on_data(self, flags: int, sid: int, body: bytes) -> None:
        size = len(body)
        if flags & PADDED:
            body = body[1:len(body) - body[0]]
        updates = b""
        with self.cv:
            self.recv_unacked += size
            if self.recv_unacked >= CONNECTION_WINDOW // 2:
                updates += _frame(WINDOW_UPDATE, 0, 0,
                                  struct.pack(">I", self.recv_unacked))
                self.recv_unacked = 0
            s = self.streams.get(sid)
            if s is not None and not s.done:
                if not s.discard:
                    s.data += body
                s.unacked += size
                if s.unacked >= STREAM_WINDOW // 2 and not flags & END_STREAM:
                    updates += _frame(WINDOW_UPDATE, 0, sid,
                                      struct.pack(">I", s.unacked))
                    s.unacked = 0
        if updates:
            self.send_frames(updates)
        if s is None or s.done:
            return
        if self.client:
            if len(s.data) >= 5 and _prefix_len(s.data) > MAX_MESSAGE:
                self._fail_stream(s, RpcError(
                    StatusCode.RESOURCE_EXHAUSTED, _too_large(s.data, "")))
                self.reset(sid, CANCEL)
            elif flags & END_STREAM:
                self._fail_stream(s, RpcError(StatusCode.INTERNAL,
                                              "stream ended without trailers"))
            return
        if (not s.discard and len(s.data) >= 5
                and _prefix_len(s.data) > MAX_MESSAGE):
            s.discard = True
            self.on_request(s, RpcError(StatusCode.RESOURCE_EXHAUSTED,
                                        _too_large(s.data, "SERVER: ")))
            s.data = bytearray()
            return
        if flags & END_STREAM and not s.discard:
            self.on_request(s, None)

    def _fail_stream(self, s: _Stream, err: RpcError) -> None:
        with self.cv:
            if not s.done:
                s.error, s.done = err, True
            self.cv.notify_all()

    def _end_block(self) -> None:
        sid, flags, block = self._block
        self._block = None
        try:
            fields = self.decoder.decode(bytes(block))
        except HpackError as exc:
            raise ConnectionError(f"HPACK: {exc}") from exc
        headers = dict(fields)
        end = bool(flags & END_STREAM)
        if self.client:
            with self.cv:
                s = self.streams.get(sid)
                if s is None or s.done:
                    return
                if s.headers is None and not end:
                    s.headers = headers
                else:
                    if s.headers is None:
                        s.headers = headers
                    s.trailers = headers
                    s.done = True
                self.cv.notify_all()
            return
        with self.cv:
            s = self.streams.get(sid)
            if s is None:
                s = _Stream(sid, self.peer_initial)
                s.path = headers.get(b":path", b"")
                self.streams[sid] = s
        if end:
            self.on_request(s, None)


def _prefix_len(data: bytearray) -> int:
    return struct.unpack_from(">I", data, 1)[0]


def _too_large(data: bytearray, side: str) -> str:
    """grpc's words for a message past the limit, `side` as grpc prefixes
    them ("SERVER: " on a server)."""
    return (f"{side}Received message larger than max ({_prefix_len(data)} "
            f"vs. {MAX_MESSAGE})")


def _frame(ftype: int, flags: int, sid: int, body: bytes) -> bytes:
    return (len(body).to_bytes(3, "big") + bytes([ftype, flags])
            + sid.to_bytes(4, "big") + body)


def _parse_target(target: str) -> tuple[str, int]:
    host, _, port = target.rpartition(":")
    return host.strip("[]") or "127.0.0.1", int(port)


# ------------------------------------------------------------------ client


class Channel:
    """A lazily connected client channel to `host:port`."""

    def __init__(self, target: str,
                 ssl_context: Optional[ssl.SSLContext] = None):
        self._target = target
        self._host, self._port = _parse_target(target)
        self._ssl = ssl_context
        self._lock = threading.Lock()
        self._conn: Optional[_Connection] = None
        self._closed = False

    def unary_unary(self, path: str, request_serializer=None,
                    response_deserializer=None):
        """A callable `(request, timeout=None) -> response`."""
        ser = request_serializer or (lambda b: b)
        de = response_deserializer or (lambda b: b)
        path_b = path.encode()

        def call(request, timeout: Optional[float] = None):
            return de(self.call(path_b, ser(request), timeout))
        return call

    def _connection(self, deadline: Optional[float]) -> _Connection:
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "Channel closed!")
            conn = self._conn
            if conn is not None and not conn.closed and conn.goaway is None:
                return conn
            if conn is not None:
                conn.close(goaway=False)
            self._conn = self._connect(deadline)
            return self._conn

    def _connect(self, deadline: Optional[float]) -> _Connection:
        limit = 20.0 if deadline is None else deadline - time.monotonic()
        if limit <= 0:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        try:
            sock = socket.create_connection((self._host, self._port),
                                            timeout=limit)
        except socket.timeout:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED if deadline else
                           StatusCode.UNAVAILABLE,
                           f"failed to connect to {self._target}") from None
        except OSError as exc:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to all addresses; "
                           f"{self._target}: {exc}") from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_lock = threading.Lock()
        try:
            if self._ssl is not None:
                transport = _Tls(sock, self._ssl, False, self._host,
                                 send_lock, time.monotonic() + limit)
            else:
                sock.settimeout(None)
                transport = _Plain(sock)
        except (OSError, ConnectionError, ssl.SSLError) as exc:
            sock.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"TLS handshake with {self._target} failed: "
                           f"{exc}") from None
        conn = _Connection(transport, True, send_lock,
                           name=f"h2-client-{self._target}")
        try:
            conn.start()
        except OSError as exc:
            sock.close()
            raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from None
        return conn

    def call(self, path: bytes, message: bytes,
             timeout: Optional[float] = None) -> bytes:
        """One unary call; returns the reply's message bytes or raises
        `RpcError`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        conn = self._connection(deadline)
        headers = [(b":method", b"POST"),
                   (b":scheme", b"https" if self._ssl else b"http"),
                   (b":path", path), (b":authority", self._target.encode()),
                   (b"content-type", b"application/grpc"),
                   (b"te", b"trailers")]
        if timeout is not None:
            headers.append((b"grpc-timeout", _timeout_header(timeout)))
        with conn.send_lock:  # stream ids go out in increasing order
            with conn.cv:
                if conn.closed or conn.goaway is not None:
                    raise RpcError(StatusCode.UNAVAILABLE, conn.failure)
                sid = conn.next_id
                conn.next_id += 2
                stream = _Stream(sid, conn.peer_initial)
                conn.streams[sid] = stream
            block = encode_headers(headers)
            try:
                conn.t.send(_frame(HEADERS, END_HEADERS, sid, block))
            except OSError as exc:
                raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from None
        try:
            return self._finish(conn, stream, message, deadline)
        finally:
            with conn.cv:
                conn.streams.pop(sid, None)

    def _finish(self, conn: _Connection, stream: _Stream, message: bytes,
                deadline: Optional[float]) -> bytes:
        try:
            conn.send_data(stream, _frame_message(message), deadline)
        except RpcError:
            conn.reset(stream.id, CANCEL)
            raise
        except OSError as exc:
            raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from None
        with conn.cv:
            while not stream.done:
                wait = 1.0 if deadline is None else min(
                    deadline - time.monotonic(), 1.0)
                if wait <= 0:
                    break
                conn.cv.wait(wait)
            done = stream.done
        if not done:
            conn.reset(stream.id, CANCEL)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        if stream.trailers is None:
            raise stream.error or RpcError(StatusCode.INTERNAL,
                                           "no trailers")
        http_ok = stream.headers.get(b":status") == b"200"
        code, details = _status_from(stream.trailers, http_ok)
        if code != StatusCode.OK:
            raise RpcError(code, details)
        data = stream.data
        if len(data) < 5 or len(data) != 5 + _prefix_len(data):
            raise RpcError(StatusCode.INTERNAL,
                           "the reply holds no single message")
        if data[0]:
            raise RpcError(StatusCode.INTERNAL,
                           "a compressed reply without grpc-encoding")
        return bytes(data[5:])

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()
            conn.reader.join(timeout=5.0)


# ------------------------------------------------------------------ server


class _Listener:
    def __init__(self, sock: socket.socket, ctx: Optional[ssl.SSLContext]):
        self.sock = sock
        self.ctx = ctx
        self.thread: Optional[threading.Thread] = None


class Server:
    """A unary gRPC server: `add_unary`, `add_port`, `start`, `stop`."""

    def __init__(self, max_workers: int = 4):
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="h2-handler")
        self._handlers: dict[bytes, Callable[[bytes], bytes]] = {}
        self._listeners: list[_Listener] = []
        self._conns: set[_Connection] = set()
        self._lock = threading.Lock()
        self._active = 0
        self._idle = threading.Condition(self._lock)
        self._stopping = False

    def add_unary(self, path: str, handler: Callable[[bytes], bytes]
                  ) -> None:
        """`handler(request_bytes) -> reply_bytes`; it may raise
        `RpcError` to answer with that status (any other exception is
        UNKNOWN, as grpc answers an exception in a handler)."""
        self._handlers[path.encode()] = handler

    def add_port(self, address: str,
                 ssl_context: Optional[ssl.SSLContext] = None) -> int:
        """Listen on `host:port` (port 0 takes a free one); returns the
        bound port."""
        host, port = _parse_target(address)
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((host, port))
        sock.listen(64)
        self._listeners.append(_Listener(sock, ssl_context))
        return sock.getsockname()[1]

    def start(self) -> None:
        for lst in self._listeners:
            lst.thread = threading.Thread(target=self._accept_loop,
                                          args=(lst,), daemon=True,
                                          name="h2-accept")
            lst.thread.start()

    def _accept_loop(self, lst: _Listener) -> None:
        while True:
            try:
                sock, _ = lst.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock, lst.ctx),
                             daemon=True, name="h2-handshake").start()

    def _serve(self, sock: socket.socket, ctx) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_lock = threading.Lock()
        try:
            transport = (_Tls(sock, ctx, True, None, send_lock,
                              time.monotonic() + 10.0)
                         if ctx is not None else _Plain(sock))
        except (OSError, ConnectionError, ssl.SSLError) as exc:
            log.debug("handshake failed: %s", exc)
            sock.close()
            return
        sock.settimeout(None)
        conn = _Connection(transport, False, send_lock, name="h2-server")
        conn.on_request = lambda s, err: self._dispatch(conn, s, err)
        with self._lock:
            if self._stopping:
                sock.close()
                return
            self._conns.add(conn)
        try:
            conn.start()
        except OSError:
            sock.close()
            return
        conn.reader.join()
        with self._lock:
            self._conns.discard(conn)

    def _dispatch(self, conn: _Connection, stream: _Stream,
                  err: Optional[RpcError]) -> None:
        """Called on the reader: a request ended, or was refused."""
        with self._lock:
            if self._stopping and err is None:
                err = RpcError(StatusCode.UNAVAILABLE, "server stopping")
            self._active += 1
        try:
            self._pool.submit(self._handle, conn, stream, err)
        except RuntimeError:  # the pool is shut down
            self._done()

    def _done(self) -> None:
        with self._lock:
            self._active -= 1
            self._idle.notify_all()

    def _handle(self, conn: _Connection, stream: _Stream,
                err: Optional[RpcError]) -> None:
        try:
            reply = None
            if err is None:
                reply, err = self._run(stream)
            self._reply(conn, stream, reply, err)
        except OSError:
            pass  # the connection went away under the reply
        except Exception:  # noqa: BLE001 - a reply must not kill the pool
            log.exception("gRPC reply failed")
        finally:
            with conn.cv:
                stream.done = True
                conn.streams.pop(stream.id, None)
            self._done()

    def _run(self, stream: _Stream):
        handler = self._handlers.get(stream.path)
        if handler is None:
            return None, RpcError(StatusCode.UNIMPLEMENTED,
                                  "Method not found!")
        data = stream.data
        if len(data) < 5 or len(data) != 5 + _prefix_len(data):
            return None, RpcError(StatusCode.INTERNAL,
                                  "the request holds no single message")
        if data[0]:
            return None, RpcError(StatusCode.UNIMPLEMENTED,
                                  "a compressed request without "
                                  "grpc-encoding")
        try:
            return handler(bytes(data[5:])), None
        except RpcError as exc:
            return None, exc
        except Exception as exc:  # noqa: BLE001 - grpc answers UNKNOWN
            log.error("gRPC handler for %s raised: %s",
                      stream.path.decode(errors="replace"), exc)
            return None, RpcError(StatusCode.UNKNOWN,
                                  f"Exception calling application: {exc}")

    def _reply(self, conn: _Connection, stream: _Stream,
               reply: Optional[bytes], err: Optional[RpcError]) -> None:
        if stream.cancelled or conn.closed:
            return
        head = [(b":status", b"200"), (b"content-type", b"application/grpc")]
        if err is not None:  # trailers only
            conn.send_headers(stream, head + [
                (b"grpc-status", b"%d" % int(err.code())),
                (b"grpc-message", encode_grpc_message(err.details()))],
                end_stream=True)
            if stream.discard:  # the rest of the request is not wanted
                conn.reset(stream.id, NO_ERROR)
            return
        conn.send_headers(stream, head, end_stream=False)
        if conn.send_data(stream, _frame_message(reply), None,
                          end_stream=False):
            conn.send_headers(stream, [(b"grpc-status", b"0")],
                              end_stream=True)

    def stop(self, grace: Optional[float] = None) -> threading.Event:
        """Stop listening and end every connection after `grace` seconds
        of in-flight calls (None or 0: at once); returns an event set
        when the server has stopped."""
        stopped = threading.Event()
        with self._lock:
            self._stopping = True
        for lst in self._listeners:
            try:
                lst.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            lst.sock.close()

        def finish():
            if grace:
                end = time.monotonic() + grace
                with self._lock:
                    while self._active and time.monotonic() < end:
                        self._idle.wait(min(end - time.monotonic(), 0.1))
            with self._lock:
                conns = list(self._conns)
            for conn in conns:
                conn.close()
            for conn in conns:
                conn.reader.join(timeout=5.0)
            for lst in self._listeners:
                if lst.thread is not None:
                    lst.thread.join(timeout=5.0)
            self._pool.shutdown(wait=False, cancel_futures=True)
            stopped.set()

        if grace:
            threading.Thread(target=finish, daemon=True,
                             name="h2-stop").start()
        else:
            finish()
        return stopped
