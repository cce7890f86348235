"""Copies of the flow-model pieces the sketch plane and the agent need.

Counterpart of `netobserv_tpu/model/flow.py` (`Direction`, `TcpFlags`,
`classify_tcp_flags`, `GlobalCounter`, `FlowKey`, `FlowFeatures`,
`ip_from_16`, `ip_to_16`, `MAX_OBSERVED_INTERFACES`, `MAX_NETWORK_EVENTS`,
`MAX_EVENT_MD`), kept as a copy so the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import enum
import ipaddress
import socket
from dataclasses import dataclass, field

IP_LEN = 16  # all addresses stored as 16B; IPv4 as ::ffff:a.b.c.d
IP4_IN_6_PREFIX = b"\x00" * 10 + b"\xff\xff"
#: interfaces a flow record lists (the datapath's NO_MAX_OBSERVED_INTERFACES)
MAX_OBSERVED_INTERFACES = 6
#: network events a flow keeps, and the metadata bytes of each (the
#: datapath's MAX_NETWORK_EVENTS and MAX_EVENT_MD)
MAX_NETWORK_EVENTS = 4
MAX_EVENT_MD = 8


class Direction(enum.IntEnum):
    """IPFIX field 61 semantics (reference: `bpf/types.h` direction_t)."""

    INGRESS = 0
    EGRESS = 1
    BOTH = 3  # observed-both marker used in per-interface dedup bookkeeping


class TcpFlags(enum.IntFlag):
    """RFC 9293 flags plus the datapath's synthetic combination flags."""

    FIN = 0x01
    SYN = 0x02
    RST = 0x04
    PSH = 0x08
    ACK = 0x10
    URG = 0x20
    ECE = 0x40
    CWR = 0x80
    SYN_ACK = 0x100
    FIN_ACK = 0x200
    RST_ACK = 0x400


def classify_tcp_flags(raw: int) -> int:
    """Raw TCP flags byte -> datapath flag encoding with the synthetic
    composite bits (single source for every userspace packet parser; kernel
    twins: parse.h no_classify_tcp_flags, asm_flowpath tcp branch)."""
    flags = raw
    if raw & (TcpFlags.SYN | TcpFlags.ACK) == (TcpFlags.SYN | TcpFlags.ACK):
        flags |= TcpFlags.SYN_ACK
    if raw & (TcpFlags.FIN | TcpFlags.ACK) == (TcpFlags.FIN | TcpFlags.ACK):
        flags |= TcpFlags.FIN_ACK
    if raw & (TcpFlags.RST | TcpFlags.ACK) == (TcpFlags.RST | TcpFlags.ACK):
        flags |= TcpFlags.RST_ACK
    return int(flags)


class GlobalCounter(enum.IntEnum):
    """Keys of the datapath's per-CPU global counter array.

    Reference: `bpf/types.h` global_counters_key_t; scraped each eviction into
    Prometheus (`pkg/tracer/tracer.go:1149-1185`).
    """

    HASHMAP_FAIL_UPDATE_FLOW = 0
    HASHMAP_FAIL_CREATE_FLOW = 1
    HASHMAP_FAIL_UPDATE_DNS = 2
    FILTER_REJECT = 3
    FILTER_ACCEPT = 4
    FILTER_NOMATCH = 5
    NETWORK_EVENTS_ERR = 6
    NETWORK_EVENTS_ERR_GROUPID_MISMATCH = 7
    NETWORK_EVENTS_ERR_UPDATE_MAP_FLOWS = 8
    NETWORK_EVENTS_GOOD = 9
    NETWORK_EVENTS_OVERFLOW = 10
    NETWORK_EVENTS_COOKIE_TOO_BIG = 11
    OBSERVED_INTF_MISSED = 12
    MAX = 13


def ip_from_16(raw: bytes) -> str:
    """Render a 16-byte address, collapsing v4-mapped back to dotted quad."""
    if raw[:12] == IP4_IN_6_PREFIX:
        return socket.inet_ntop(socket.AF_INET, raw[12:16])
    return socket.inet_ntop(socket.AF_INET6, raw)


def ip_to_16(addr: str | bytes) -> bytes:
    """Normalize an address to the datapath's 16-byte form (v4 mapped)."""
    if isinstance(addr, bytes):
        if len(addr) == 16:
            return addr
        if len(addr) == 4:
            return IP4_IN_6_PREFIX + addr
        raise ValueError(f"bad raw IP length {len(addr)}")
    ip = ipaddress.ip_address(addr)
    if ip.version == 4:
        return IP4_IN_6_PREFIX + ip.packed
    return ip.packed


@dataclass(frozen=True, slots=True)
class FlowKey:
    """The 5-tuple-ish flow identity (reference: `bpf/types.h` flow_id_t)."""

    src_ip: bytes = b"\x00" * IP_LEN  # always 16B
    dst_ip: bytes = b"\x00" * IP_LEN
    src_port: int = 0
    dst_port: int = 0
    proto: int = 0
    icmp_type: int = 0
    icmp_code: int = 0

    def __post_init__(self):
        if len(self.src_ip) != IP_LEN or len(self.dst_ip) != IP_LEN:
            raise ValueError("FlowKey IPs must be 16 bytes (use ip_to_16)")

    @classmethod
    def make(cls, src: str, dst: str, sport: int = 0, dport: int = 0,
             proto: int = 0, icmp_type: int = 0, icmp_code: int = 0) -> "FlowKey":
        return cls(ip_to_16(src), ip_to_16(dst), sport, dport, proto,
                   icmp_type, icmp_code)

    @property
    def src(self) -> str:
        return ip_from_16(self.src_ip)

    @property
    def dst(self) -> str:
        return ip_from_16(self.dst_ip)

    def normalized(self) -> "FlowKey":
        """Direction-normalized key: both directions of a conversation map to the
        same value (used for Kafka partitioning; reference:
        `pkg/exporter/kafka_proto.go:181-191`)."""
        if (self.src_ip, self.src_port) <= (self.dst_ip, self.dst_port):
            return self
        return FlowKey(self.dst_ip, self.src_ip, self.dst_port, self.src_port,
                       self.proto, self.icmp_type, self.icmp_code)


@dataclass(slots=True)
class FlowFeatures:
    """Optional per-feature metrics attached to a flow at eviction time.

    Mirrors the reference's per-feature per-CPU maps, already merged
    (`pkg/model/flow_content.go:9-22`). All times are monotonic ns.
    """

    dns_id: int = 0
    dns_flags: int = 0
    dns_latency_ns: int = 0
    dns_errno: int = 0
    dns_name: str = ""
    drop_bytes: int = 0
    drop_packets: int = 0
    drop_latest_flags: int = 0
    drop_latest_state: int = 0
    drop_latest_cause: int = 0
    rtt_ns: int = 0
    ipsec_encrypted: bool = False
    ipsec_encrypted_ret: int = 0
    xlat_src_ip: bytes = b""
    xlat_dst_ip: bytes = b""
    xlat_src_port: int = 0
    xlat_dst_port: int = 0
    xlat_zone_id: int = 0
    network_events: list[bytes] = field(default_factory=list)
    quic_version: int = 0
    quic_seen_long_hdr: bool = False
    quic_seen_short_hdr: bool = False
    # OpenSSL-uprobe plaintext<->flow correlation (userspace, procfs-based;
    # goes beyond the reference, which only logs/counts SSL events —
    # tracer_ringbuf.go:136-190)
    ssl_plaintext_events: int = 0
    ssl_plaintext_bytes: int = 0
