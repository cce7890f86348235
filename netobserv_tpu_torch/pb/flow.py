"""The flow wire, `proto/flow.proto` (package `pbflow`), as plain classes.

The port's own module: its original is `proto/flow.proto`, which the JAX
package compiles into `netobserv_tpu/pb/flow_pb2.py`. Every message is a
`federation/pbwire.Message`, so `SerializeToString()` gives the bytes of
protobuf's `SerializeToString(deterministic=True)` and `FromString`
parses as upb does (pbwire's docstring lists the rules). An absent
sub-message is None, where protobuf hands out a default instance; an IP's
address is the oneof `ip_family` (`ipv4` a fixed32, `ipv6` bytes).
`Timestamp` and `Duration` are `google/protobuf/timestamp.proto` and
`duration.proto` with the two nanosecond helpers of protobuf's
well-known-type mixins.
"""

from __future__ import annotations

from netobserv_tpu_torch.federation.pbwire import Field, Message

#: `Direction` (`flow.proto:96-100`)
INGRESS = 0
EGRESS = 1

_NANOS = 1_000_000_000


class Timestamp(Message):
    """`google.protobuf.Timestamp`."""

    FIELDS = (Field(1, "seconds", "int64"), Field(2, "nanos", "int32"))

    def FromNanoseconds(self, nanos: int) -> None:  # noqa: N802
        """As protobuf's `Timestamp.FromNanoseconds`: floored seconds and
        a nanosecond part in [0, 1e9)."""
        self.seconds, self.nanos = nanos // _NANOS, nanos % _NANOS

    def ToNanoseconds(self) -> int:  # noqa: N802
        return self.seconds * _NANOS + self.nanos


class Duration(Message):
    """`google.protobuf.Duration`."""

    FIELDS = (Field(1, "seconds", "int64"), Field(2, "nanos", "int32"))

    def FromNanoseconds(self, nanos: int) -> None:  # noqa: N802
        """As protobuf's `Duration.FromNanoseconds`: seconds and nanos
        carry the same sign."""
        seconds, rem = nanos // _NANOS, nanos % _NANOS
        if seconds < 0 and rem > 0:
            seconds, rem = seconds + 1, rem - _NANOS
        self.seconds, self.nanos = seconds, rem

    def ToNanoseconds(self) -> int:  # noqa: N802
        return self.seconds * _NANOS + self.nanos


class IP(Message):
    FIELDS = (Field(1, "ipv4", "fixed32", oneof="ip_family"),
              Field(2, "ipv6", "bytes", oneof="ip_family"))


class DataLink(Message):
    FIELDS = (Field(1, "src_mac", "uint64"), Field(2, "dst_mac", "uint64"))


class Network(Message):
    FIELDS = (Field(1, "src_addr", "message", message=IP),
              Field(2, "dst_addr", "message", message=IP),
              Field(3, "dscp", "uint32"))


class Transport(Message):
    FIELDS = (Field(1, "src_port", "uint32"), Field(2, "dst_port", "uint32"),
              Field(3, "protocol", "uint32"))


class Xlat(Message):
    FIELDS = (Field(1, "src_addr", "message", message=IP),
              Field(2, "dst_addr", "message", message=IP),
              Field(3, "src_port", "uint32"), Field(4, "dst_port", "uint32"),
              Field(5, "zone_id", "uint32"))


class Quic(Message):
    FIELDS = (Field(1, "version", "uint32"),
              Field(2, "seen_long_hdr", "uint32"),
              Field(3, "seen_short_hdr", "uint32"))


class DupMapEntry(Message):
    FIELDS = (Field(1, "interface", "string"),
              Field(2, "direction", "enum"), Field(3, "udn", "string"))


class NetworkEvent(Message):
    FIELDS = (Field(1, "events", "map"),)


class Record(Message):
    FIELDS = (
        Field(1, "eth_protocol", "uint32"), Field(2, "direction", "enum"),
        Field(3, "time_flow_start", "message", message=Timestamp),
        Field(4, "time_flow_end", "message", message=Timestamp),
        Field(5, "data_link", "message", message=DataLink),
        Field(6, "network", "message", message=Network),
        Field(7, "transport", "message", message=Transport),
        Field(8, "bytes", "uint64"), Field(9, "packets", "uint64"),
        Field(10, "interface", "string"), Field(11, "duplicate", "bool"),
        Field(12, "agent_ip", "message", message=IP),
        Field(13, "flags", "uint32"), Field(14, "icmp_type", "uint32"),
        Field(15, "icmp_code", "uint32"),
        Field(16, "pkt_drop_bytes", "uint64"),
        Field(17, "pkt_drop_packets", "uint64"),
        Field(18, "pkt_drop_latest_flags", "uint32"),
        Field(19, "pkt_drop_latest_state", "uint32"),
        Field(20, "pkt_drop_latest_drop_cause", "uint32"),
        Field(21, "dns_id", "uint32"), Field(22, "dns_flags", "uint32"),
        Field(23, "dns_latency", "message", message=Duration),
        Field(24, "time_flow_rtt", "message", message=Duration),
        Field(25, "dns_errno", "uint32"),
        Field(26, "dup_list", "message", repeated=True, message=DupMapEntry),
        Field(27, "network_events_metadata", "message", repeated=True,
              message=NetworkEvent),
        Field(28, "xlat", "message", message=Xlat),
        Field(29, "sampling", "uint32"),
        Field(30, "ipsec_encrypted", "uint32"),
        Field(31, "ipsec_encrypted_ret", "int32"),
        Field(32, "dns_name", "string"), Field(33, "ssl_version", "uint32"),
        Field(34, "ssl_mismatch", "bool"), Field(35, "tls_types", "uint32"),
        Field(36, "tls_cipher_suite", "uint32"),
        Field(37, "tls_key_share", "uint32"),
        Field(38, "quic", "message", message=Quic))


class Records(Message):
    FIELDS = (Field(1, "entries", "message", repeated=True, message=Record),)


class CollectorReply(Message):
    FIELDS = ()
