"""The packet wire, `proto/packet.proto` (package `pbpacket`), as plain
classes.

The port's own module: its original is `proto/packet.proto`, which the
JAX package compiles into `netobserv_tpu/pb/packet_pb2.py` and fills
through protobuf's `any_pb2` and `wrappers_pb2`
(`netobserv_tpu/exporter/grpc_packets.py:15-20`). `Packet` holds one
`google.protobuf.Any` whose payload is a `google.protobuf.BytesValue`
of pcap-framed bytes. Each message is a `federation/pbwire.Message`, so
`SerializeToString()` gives protobuf's deterministic bytes and
`FromString` parses as upb does; `Any.Pack` and `Any.Unpack` follow
protobuf's well-known-type mixin (the type URL prefix
`type.googleapis.com/`, and `Unpack` answers False for another type).
"""

from __future__ import annotations

from netobserv_tpu_torch.federation.pbwire import MAX_DEPTH, Field, Message

#: protobuf's default type URL prefix for `Any.Pack`
TYPE_URL_PREFIX = "type.googleapis.com/"


class BytesValue(Message):
    """`google.protobuf.BytesValue` (`wrappers.proto`)."""

    FULL_NAME = "google.protobuf.BytesValue"
    FIELDS = (Field(1, "value", "bytes"),)


class Any(Message):
    """`google.protobuf.Any` (`any.proto`)."""

    FULL_NAME = "google.protobuf.Any"
    FIELDS = (Field(1, "type_url", "string"), Field(2, "value", "bytes"))

    def Pack(self, msg: Message) -> None:  # noqa: N802 - protobuf's name
        self.type_url = TYPE_URL_PREFIX + msg.FULL_NAME
        self.value = msg.SerializeToString()

    def Is(self, cls) -> bool:  # noqa: N802 - protobuf's name
        """Whether the payload is a `cls` (any prefix before the last
        '/', as protobuf compares)."""
        return self.type_url.rpartition("/")[2] == cls.FULL_NAME

    def Unpack(self, msg: Message) -> bool:  # noqa: N802 - protobuf's name
        """Parse the payload into `msg`; False, and `msg` untouched, when
        the payload is another type. Malformed bytes raise `WireError`."""
        if not self.Is(type(msg)):
            return False
        buf = memoryview(self.value).cast("B")
        msg._merge(buf, 0, len(buf), MAX_DEPTH)
        return True


class Packet(Message):
    """`pbpacket.Packet`: `google.protobuf.Any pcap = 1`."""

    FIELDS = (Field(1, "pcap", "message", message=Any),)


class CollectorReply(Message):
    """`pbpacket.CollectorReply`: no field."""

    FIELDS = ()


def wrap_pcap(payload: bytes) -> Packet:
    """A `Packet` carrying `payload` as a packed `BytesValue`, as the
    reference's `PacketClient.send_bytes` builds it."""
    wrapped = Any()
    wrapped.Pack(BytesValue(value=payload))
    return Packet(pcap=wrapped)


def unwrap_pcap(packet: Packet) -> bytes:
    """The pcap bytes of a received `Packet`; `ValueError` where it holds
    no `BytesValue`."""
    val = BytesValue()
    if packet.pcap is None or not packet.pcap.Unpack(val):
        raise ValueError("the packet holds no google.protobuf.BytesValue")
    return bytes(val.value)
