"""IPFIX exporter (RFC 7011), pure-python encoder, UDP or TCP transport.

A copy of `netobserv_tpu/exporter/ipfix.py` (lines 1-169): v4 and v6
templates carrying the core flow fields (IANA information elements;
feature metrics such as DNS/RTT/drops are not part of the IPFIX schema),
UDP datagrams kept MTU-safe, TCP messages up to 32 KiB, the template set
at the start of each connection and every `template_refresh_s`.
"""

from __future__ import annotations

import logging
import socket
import struct
import time

from netobserv_tpu_torch.exporter.base import Exporter
from netobserv_tpu_torch.model.flow import IP4_IN_6_PREFIX
from netobserv_tpu_torch.model.record import Record

log = logging.getLogger("netobserv_tpu_torch.exporter.ipfix")

IPFIX_VERSION = 10
TEMPLATE_SET_ID = 2
TEMPLATE_V4 = 256
TEMPLATE_V6 = 257

# (IANA IE id, length) — shared prefix of both templates
_COMMON_HEAD = [
    (152, 8),  # flowStartMilliseconds
    (153, 8),  # flowEndMilliseconds
    (1, 8),    # octetDeltaCount
    (2, 8),    # packetDeltaCount
    (10, 4),   # ingressInterface
    (61, 1),   # flowDirection
    (56, 6),   # sourceMacAddress
    (80, 6),   # destinationMacAddress
    (256, 2),  # ethernetType
    (4, 1),    # protocolIdentifier
    (6, 2),    # tcpControlBits
    (7, 2),    # sourceTransportPort
    (11, 2),   # destinationTransportPort
]
_V4_FIELDS = _COMMON_HEAD + [
    (8, 4),    # sourceIPv4Address
    (12, 4),   # destinationIPv4Address
    (176, 1),  # icmpTypeIPv4
    (177, 1),  # icmpCodeIPv4
]
_V6_FIELDS = _COMMON_HEAD + [
    (27, 16),  # sourceIPv6Address
    (28, 16),  # destinationIPv6Address
    (178, 1),  # icmpTypeIPv6
    (179, 1),  # icmpCodeIPv6
]


def _template_set() -> bytes:
    """`_template_set` (`ipfix.py:57-63`)."""
    recs = b""
    for tid, fields in ((TEMPLATE_V4, _V4_FIELDS), (TEMPLATE_V6, _V6_FIELDS)):
        recs += struct.pack(">HH", tid, len(fields))
        for ie, length in fields:
            recs += struct.pack(">HH", ie, length)
    return struct.pack(">HH", TEMPLATE_SET_ID, 4 + len(recs)) + recs


def _data_record(r: Record, v6: bool) -> bytes:
    """`_data_record` (`ipfix.py:66-79`)."""
    out = struct.pack(
        ">QQQQIB6s6sHBHHH",
        r.time_flow_start_ns // 1_000_000,
        r.time_flow_end_ns // 1_000_000,
        r.bytes_, r.packets, r.if_index, r.direction & 0xFF,
        r.src_mac, r.dst_mac, r.eth_protocol, r.key.proto,
        r.tcp_flags & 0xFFFF, r.key.src_port, r.key.dst_port)
    if v6:
        out += r.key.src_ip + r.key.dst_ip
    else:
        out += r.key.src_ip[12:16] + r.key.dst_ip[12:16]
    out += struct.pack(">BB", r.key.icmp_type, r.key.icmp_code)
    return out


class IPFIXExporter(Exporter):
    """`IPFIXExporter` (`ipfix.py:82-169`)."""

    name = "ipfix"

    def __init__(self, host: str, port: int, transport: str = "udp",
                 obs_domain: int = 1, metrics=None,
                 template_refresh_s: float = 600.0):
        self._addr = (host, port)
        self._transport = transport
        self._obs_domain = obs_domain
        self._seq = 0
        self._template_refresh = template_refresh_s
        self._last_template = float("-inf")
        self._sock: socket.socket | None = None
        self._connect()

    def _connect(self) -> None:
        if self._sock is not None:
            self._sock.close()
        family = socket.AF_INET6 if ":" in self._addr[0] else socket.AF_INET
        if self._transport == "udp":
            self._sock = socket.socket(family, socket.SOCK_DGRAM)
            self._sock.connect(self._addr)
        else:
            self._sock = socket.create_connection(self._addr, timeout=10)
        self._last_template = float("-inf")  # (re)send templates on next message

    def _message(self, sets: bytes) -> bytes:
        hdr = struct.pack(
            ">HHIII", IPFIX_VERSION, 16 + len(sets), int(time.time()),
            self._seq, self._obs_domain)
        return hdr + sets

    # keep UDP datagrams MTU-safe; TCP messages can be larger
    MAX_UDP_PAYLOAD = 1400
    MAX_TCP_PAYLOAD = 32768

    def export_batch(self, records: list[Record]) -> None:
        # The v4 template can only hold records whose BOTH addresses are
        # v4-mapped; anything else (either address native-v6, or the datapath
        # tagged the frame 0x86DD) must use the v6 template — classifying on
        # src alone would let a mixed record truncate its dst address.
        def is_v6(r: Record) -> bool:
            return (r.eth_protocol == 0x86DD
                    or r.key.src_ip[:12] != IP4_IN_6_PREFIX
                    or r.key.dst_ip[:12] != IP4_IN_6_PREFIX)

        v4 = [r for r in records if not is_v6(r)]
        v6 = [r for r in records if is_v6(r)]
        limit = (self.MAX_UDP_PAYLOAD if self._transport == "udp"
                 else self.MAX_TCP_PAYLOAD)
        pending: list[tuple[int, bool, list[Record]]] = []
        for tid, recs, is6 in ((TEMPLATE_V4, v4, False), (TEMPLATE_V6, v6, True)):
            rec_size = len(_data_record(recs[0], is6)) if recs else 0
            per_msg = max((limit - 16 - 4 - len(_template_set())) // rec_size,
                          1) if rec_size else 0
            for s in range(0, len(recs), per_msg or 1):
                pending.append((tid, is6, recs[s:s + per_msg]))
        for tid, is6, chunk in pending:
            if not chunk:
                continue
            self._send_chunk(tid, is6, chunk)

    def _send_chunk(self, tid: int, is6: bool, chunk: list[Record],
                    retried: bool = False) -> None:
        sets = b""
        now = time.monotonic()
        if now - self._last_template > self._template_refresh:
            sets += _template_set()
            self._last_template = now
        payload = b"".join(_data_record(r, is6) for r in chunk)
        sets += struct.pack(">HH", tid, 4 + len(payload)) + payload
        msg = self._message(sets)
        try:
            self._sock.sendall(msg) if self._transport == "tcp" else \
                self._sock.send(msg)
        except OSError:
            if retried:
                raise
            # reconnect resets _last_template, so the rebuilt message carries
            # a template set — RFC 7011 scopes templates to the TCP session
            self._connect()
            self._send_chunk(tid, is6, chunk, retried=True)
            return
        self._seq += len(chunk)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
