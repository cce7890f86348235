"""The port's flow wire (netobserv_tpu_torch/pb/flow.py on
federation/pbwire.py) and its converters (exporter/pb_convert.py)
against the generated `netobserv_tpu/pb/flow_pb2` and the reference's
`exporter/pb_convert.py`, on the CPU.

- The goldens `tests/golden/pbflow_vector_{a,b}.hex` byte for byte from
  the records `tests/test_pb_golden.py` builds, and parsed back.
- Seeded records (v4, v6, 0.0.0.0 and ::, zero times, negative
  `ipsec_encrypted_ret`, network events whose maps hold several keys, dup
  lists, xlat, QUIC, TLS) serialize to protobuf's deterministic bytes,
  and each side parses the other's bytes to equal records.
- Maps in upb's order, and parse corner cases (oneof, int32, bool, enum,
  map entries with unknown fields) as upb takes them.
- 500 seeded mutations of a `Records` message through both parsers: the
  same accept/reject verdicts and equal records.
- The field numbers and kinds against `proto/flow.proto` and the
  generated descriptors.
"""

from __future__ import annotations

import dataclasses
import os
import re
import socket

import numpy as np
import pytest
from google.protobuf.descriptor import FieldDescriptor

from netobserv_tpu.exporter import pb_convert as rconv
from netobserv_tpu.model import flow as rflow
from netobserv_tpu.model import record as rrecord
from netobserv_tpu.pb import flow_pb2
from netobserv_tpu_torch.exporter import pb_convert as pconv
from netobserv_tpu_torch.federation import pbwire
from netobserv_tpu_torch.model import flow as pflow
from netobserv_tpu_torch.model import record as precord
from netobserv_tpu_torch.pb import flow as pbflow
from tests import test_pb_golden as golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _convert(r, record_cls, key_cls, feat_cls):
    d = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
    d["key"] = key_cls(**{f.name: getattr(r.key, f.name)
                          for f in dataclasses.fields(r.key)})
    d["features"] = feat_cls(**{
        f.name: (list(getattr(r.features, f.name))
                 if f.name == "network_events"
                 else getattr(r.features, f.name))
        for f in dataclasses.fields(r.features)})
    d["dup_list"] = list(r.dup_list)
    return record_cls(**d)


def to_port(r) -> precord.Record:
    return _convert(r, precord.Record, pflow.FlowKey, pflow.FlowFeatures)


def to_ref(r) -> rrecord.Record:
    return _convert(r, rrecord.Record, rflow.FlowKey, rflow.FlowFeatures)


def as_tuple(r) -> tuple:
    """A record as plain values, comparable across the two packages."""
    return dataclasses.astuple(to_port(r))


# ------------------------------------------------------------ seeded records

_NAMES = ("eth0", "br-ex", "genev_sys_6081", "ens5f0np0", "vethé1", "")


def _addr(rng, kind: str) -> str:
    if kind == "v4":
        return socket.inet_ntop(socket.AF_INET, rng.bytes(4))
    if kind == "v6":
        return socket.inet_ntop(socket.AF_INET6, rng.bytes(16))
    return {"zero4": "0.0.0.0", "zero6": "::"}[kind]


def seeded_record(rng, i: int = 0) -> precord.Record:
    """One port record drawn from `rng`; every optional block appears in
    some records and not in others."""
    kinds = ("v4", "v6", "zero4", "zero6")
    src = _addr(rng, kinds[int(rng.integers(0, 4))])
    dst = _addr(rng, kinds[int(rng.integers(0, 4))])
    proto = int(rng.choice([6, 17, 1, 58, 132]))
    key = pflow.FlowKey.make(src, dst, int(rng.integers(0, 65536)),
                             int(rng.integers(0, 65536)), proto,
                             int(rng.integers(0, 256)) if proto in (1, 58)
                             else 0,
                             int(rng.integers(0, 256)) if proto in (1, 58)
                             else 0)
    zero_time = rng.random() < 0.2
    start = 0 if zero_time else int(rng.integers(0, 1 << 62))
    f = pflow.FlowFeatures()
    if rng.random() < 0.4:
        f.drop_bytes = int(rng.integers(0, 1 << 40))
        f.drop_packets = int(rng.integers(0, 1 << 20))
        f.drop_latest_flags = int(rng.integers(0, 1 << 16))
        f.drop_latest_state = int(rng.integers(0, 16))
        f.drop_latest_cause = int(rng.integers(0, 1 << 10))
    if rng.random() < 0.4:
        f.dns_id = int(rng.integers(0, 1 << 16))
        f.dns_flags = int(rng.integers(0, 1 << 16))
        f.dns_latency_ns = int(rng.integers(0, 5_000_000_000))
        f.dns_errno = int(rng.integers(0, 3))
        f.dns_name = rng.choice(["example.com", "", "xn--bcher-kva.ch",
                                 "ünï.test"])
    if rng.random() < 0.5:
        f.rtt_ns = int(rng.integers(1, 3_000_000_000))
    if rng.random() < 0.5:
        f.ipsec_encrypted = bool(rng.random() < 0.5)
        f.ipsec_encrypted_ret = int(rng.integers(-(1 << 31), 1 << 31))
    if rng.random() < 0.3:
        f.xlat_src_ip = pflow.ip_to_16(_addr(rng, "v4" if rng.random() < .5
                                             else "v6"))
        f.xlat_dst_ip = pflow.ip_to_16(_addr(rng, kinds[int(
            rng.integers(0, 4))]))
        f.xlat_src_port = int(rng.integers(0, 65536))
        f.xlat_dst_port = int(rng.integers(0, 65536))
        f.xlat_zone_id = int(rng.integers(0, 1 << 16))
    if rng.random() < 0.3:
        f.quic_version = int(rng.integers(0, 3))
        f.quic_seen_long_hdr = bool(rng.random() < 0.5)
        f.quic_seen_short_hdr = bool(rng.random() < 0.5)
    f.network_events = [rng.bytes(int(rng.choice([8, 8, 8, 3, 0])))
                        for _ in range(int(rng.integers(0, 4)))]
    tls = rng.random() < 0.4
    r = precord.Record(
        key=key, bytes_=int(rng.integers(0, 1 << 63)),
        packets=int(rng.integers(0, 1 << 40)),
        eth_protocol=int(rng.choice([0x0800, 0x86DD, 0])),
        tcp_flags=int(rng.integers(0, 1 << 12)),
        direction=int(rng.integers(0, 2)),
        src_mac=rng.bytes(6), dst_mac=rng.bytes(6),
        if_index=int(rng.integers(0, 64)),
        interface=str(rng.choice(_NAMES)), dscp=int(rng.integers(0, 64)),
        sampling=int(rng.integers(0, 3)),
        time_flow_start_ns=start,
        time_flow_end_ns=0 if zero_time else start + int(
            rng.integers(0, 10**12)),
        agent_ip=str(rng.choice(["", "192.0.2.1", "2001:db8::7",
                                 "0.0.0.0"])),
        dup_list=[(str(rng.choice(_NAMES)), int(rng.integers(0, 2)),
                   str(rng.choice(["", "udn-a", "ns/net"])))
                  for _ in range(int(rng.integers(0, 4)))],
        features=f,
        ssl_version=int(rng.choice([0x0303, 0x0304])) if tls else 0,
        tls_cipher_suite=int(rng.integers(0, 1 << 16)) if tls else 0,
        tls_key_share=int(rng.integers(0, 1 << 16)) if tls else 0,
        tls_types=int(rng.integers(0, 64)) if tls else 0,
        ssl_mismatch=bool(tls and rng.random() < 0.5))
    return r


def seeded_records(seed: int, n: int) -> list[precord.Record]:
    rng = np.random.default_rng(seed)
    return [seeded_record(rng, i) for i in range(n)]


#: the named cases the seeded draw must include
def _named() -> list[precord.Record]:
    base = dict(bytes_=1, packets=1, interface="eth0")
    f_neg = pflow.FlowFeatures(ipsec_encrypted_ret=-22)
    f_events = pflow.FlowFeatures(network_events=[
        bytes([1, 1, 2, 0, 7, 0, 0, 0]), bytes(range(1, 9)), b"\x01\x02"])
    return [
        precord.Record(key=pflow.FlowKey.make("0.0.0.0", "::", 0, 0, 0),
                       agent_ip="0.0.0.0", **base),
        precord.Record(key=pflow.FlowKey.make("::", "0.0.0.0", 1, 2, 17),
                       features=f_neg, **base),
        precord.Record(key=pflow.FlowKey.make("10.0.0.1", "10.0.0.2", 3, 4,
                                              6), features=f_events,
                       dup_list=[("a", 0, ""), ("b", 1, "u"), ("", 0, "")],
                       **base),
        precord.Record(key=pflow.FlowKey.make("2001:db8::1", "::1"), **base),
    ]


NAMED = ["zero_addrs", "negative_ipsec_ret", "events_and_dups", "v6"]


@pytest.mark.parametrize("name", sorted(golden.VECTORS))
def test_goldens_byte_for_byte(name):
    build_vec, build_rec = golden.VECTORS[name]
    with open(os.path.join(golden.GOLDEN_DIR, name + ".hex")) as fh:
        want = bytes.fromhex(fh.read().strip())
    assert build_vec() == want
    got = pconv.record_to_pb(to_port(build_rec())).SerializeToString()
    assert got == want, (got.hex(), want.hex())
    back = pconv.pb_to_record(pbflow.Record.FromString(want))
    assert as_tuple(back) == as_tuple(rconv.pb_to_record(
        flow_pb2.Record.FromString(want)))
    assert pconv.record_to_pb(back).SerializeToString() == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_records_serialize_as_protobuf(seed):
    recs = seeded_records(seed, 60)
    for r in recs:
        want = rconv.record_to_pb(to_ref(r)).SerializeToString(
            deterministic=True)
        assert pconv.record_to_pb(r).SerializeToString() == want, r
    want = rconv.records_to_pb([to_ref(r) for r in recs]
                               ).SerializeToString(deterministic=True)
    assert pconv.records_to_pb(recs).SerializeToString() == want


@pytest.mark.parametrize("idx", range(len(NAMED)), ids=NAMED)
def test_named_cases_serialize_as_protobuf(idx):
    r = _named()[idx]
    want = rconv.record_to_pb(to_ref(r)).SerializeToString(
        deterministic=True)
    got = pconv.record_to_pb(r).SerializeToString()
    assert got == want, (got.hex(), want.hex())
    if idx == 0:  # 0.0.0.0 goes out as a present fixed32 0
        assert bytes.fromhex("0d00000000") in got


@pytest.mark.parametrize("seed", [10, 11])
def test_each_side_parses_the_others_bytes(seed):
    recs = seeded_records(seed, 60) + _named()
    ours = pconv.records_to_pb(recs).SerializeToString()
    theirs = rconv.records_to_pb([to_ref(r) for r in recs]
                                 ).SerializeToString(deterministic=True)
    from_ours = [rconv.pb_to_record(e) for e in
                 flow_pb2.Records.FromString(ours).entries]
    from_theirs = [pconv.pb_to_record(e) for e in
                   pbflow.Records.FromString(theirs).entries]
    want = [as_tuple(rconv.pb_to_record(rconv.record_to_pb(to_ref(r))))
            for r in recs]
    assert [as_tuple(r) for r in from_ours] == want
    assert [as_tuple(r) for r in from_theirs] == want


@pytest.mark.parametrize("keys", [
    ["b", "a", "", "ab", "abc", "B", "é", "zz", "z"], ["x", "a"], [""],
    ["Feature", "Action", "Type", "Direction", "Name"], []],
    ids=["prefixes", "two", "empty_key", "ovn", "none"])
def test_maps_write_in_upbs_order(keys):
    ours = pbflow.NetworkEvent(events={k: k.upper() + "v" for k in keys})
    ref = flow_pb2.NetworkEvent()
    for k in keys:
        ref.events[k] = k.upper() + "v"
    assert ours.SerializeToString() == ref.SerializeToString(
        deterministic=True)
    empty = pbflow.NetworkEvent(events={k: "" for k in keys})
    ref = flow_pb2.NetworkEvent()
    for k in keys:
        ref.events[k] = ""
    assert empty.SerializeToString() == ref.SerializeToString(
        deterministic=True)


#: (message, hex bytes): parse corner cases both parsers must agree on
CORNERS = [
    ("IP", "0d01000000" "1200"), ("IP", "1200" "0d01000000"),
    ("IP", "0d00000000"), ("Record", "f80102"),
    ("Record", "f801ffffffff0f"), ("Record", "f801ffffffffff0f"),
    ("Record", "1002"), ("Record", "10ffffffffffffffffff01"),
    ("Record", "5802"), ("Record", "900280ffffffffff01"),
    ("NetworkEvent", "0a030a0161" "0a060a0161120162"),
    ("NetworkEvent", "0a00"), ("NetworkEvent", "0a030a01ff"),
    ("NetworkEvent", "0a08" "120176" "0a016b" "1801"),
    ("NetworkEvent", "0a04" "0801" "1200"),
    ("NetworkEvent", "0a05" "0a0161" "0b0c"),
    ("NetworkEvent", "0a05" "0a0161" "12ff"),
    ("NetworkEvent", "0a06" "0a0161" "1201ff"),
    ("Record", "5201ff"), ("Record", "1a0b08ffffffffffffffffff01"),
    ("Record", "1a0b10ffffffffffffffffff01"), ("Record", "0a0161"),
    ("Records", "0a03" "0a0161"), ("Records", "0a00" "0a02" "5801"),
    ("Record", "6a03" "0d0000"), ("Record", "320a" "0a05" "1203" "010203"),
]


@pytest.mark.parametrize("msg,raw", CORNERS,
                         ids=[f"{m}-{h}" for m, h in CORNERS])
def test_parse_corner_cases_as_upb(msg, raw):
    data = bytes.fromhex(raw)
    try:
        want = getattr(flow_pb2, msg).FromString(data)
    except Exception:  # noqa: BLE001 - protobuf's DecodeError
        with pytest.raises(pbwire.WireError):
            getattr(pbflow, msg).FromString(data)
        return
    got = getattr(pbflow, msg).FromString(data)
    assert _dump(got) == _dump_pb(want)


def _dump(m) -> dict:
    """A port message as plain values, absent fields at their defaults."""
    out = {}
    for f in m.FIELDS:
        v = getattr(m, f.name)
        if f.repeated:
            v = [_dump(x) for x in v]
        elif f.kind == "message":
            v = None if v is None else _dump(v)
        elif f.kind == "bytes" and v is not None:
            v = bytes(v)
        out[f.name] = v
    return out


def _dump_pb(m) -> dict:
    out = {}
    for fd in m.DESCRIPTOR.fields:
        v = getattr(m, fd.name)
        if fd.message_type is not None and fd.message_type.GetOptions(
                ).map_entry:
            v = dict(v)
        elif fd.is_repeated:
            v = [_dump_pb(x) for x in v]
        elif fd.message_type is not None:
            v = _dump_pb(v) if m.HasField(fd.name) else None
        elif fd.containing_oneof is not None:
            v = v if m.WhichOneof(fd.containing_oneof.name) == fd.name \
                else None
        out[fd.name] = v
    return out


# --------------------------------------------------------- the mutation fuzz


def _fuzz_base() -> bytes:
    recs = seeded_records(99, 6) + _named()
    return pconv.records_to_pb(recs).SerializeToString()


def _fields(data: bytes) -> list[bytes]:
    buf, pos, out = memoryview(data), 0, []
    while pos < len(data):
        start = pos
        _, wire, pos = pbwire._read_tag(buf, pos, len(data))
        pos = pbwire._skip(buf, pos, len(data), 0, wire, 100)
        out.append(bytes(data[start:pos]))
    return out


def _mutant(rng, base: bytes, kind: str) -> bytes:
    b = bytearray(base)
    if kind == "truncate":
        return bytes(b[:rng.integers(0, len(b))])
    if kind == "flip":
        for _ in range(rng.integers(1, 4)):
            j = int(rng.integers(0, len(b)))
            if rng.random() < 0.5:
                b[j] ^= 1 << int(rng.integers(0, 8))
            else:
                b[j] = int(rng.integers(0, 256))
        return bytes(b)
    if kind == "inner":  # mutate inside one record's bytes
        fields = _fields(base)
        j = int(rng.integers(0, len(fields)))
        entry = _fields(bytes(fields[j][_len_prefix(fields[j]):]))
        rng.shuffle(entry)
        if entry and rng.random() < 0.5:
            entry.insert(int(rng.integers(0, len(entry) + 1)),
                         entry[int(rng.integers(0, len(entry)))])
        body = b"".join(entry)
        fields[j] = pbwire._tag(1, 2) + pbwire._varint(len(body)) + body
        return b"".join(fields)
    fields = _fields(base)
    if kind == "duplicate":
        for _ in range(rng.integers(1, 3)):
            j = int(rng.integers(0, len(fields)))
            fields.insert(int(rng.integers(0, len(fields) + 1)), fields[j])
    else:  # reorder, with a stray unknown field
        fields = [fields[i] for i in rng.permutation(len(fields))]
        fields.insert(int(rng.integers(0, len(fields) + 1)),
                      pbwire._tag(int(rng.integers(2, 40)), 0) + b"\x05")
    return b"".join(fields)


def _len_prefix(field: bytes) -> int:
    """The bytes of a length-delimited field's tag and length."""
    buf = memoryview(field)
    _, _, pos = pbwire._read_tag(buf, 0, len(field))
    _, pos = pbwire._read_varint(buf, pos, len(field))
    return pos


def _records_or_error(parse, convert, data):
    try:
        msg = parse(data)
    except Exception as exc:  # noqa: BLE001 - either parser's error
        return "reject", type(exc).__name__
    out = []
    for e in msg.entries:
        try:
            out.append(as_tuple(convert(e)))
        except ValueError:
            out.append("ValueError")
    return "accept", out


@pytest.mark.parametrize("kind", ["truncate", "flip", "duplicate",
                                  "reorder", "inner"])
def test_mutated_records_parse_alike(kind):
    rng = np.random.default_rng(["truncate", "flip", "duplicate",
                                 "reorder", "inner"].index(kind) + 40)
    base = _fuzz_base()
    accepted = 0
    for _ in range(100):
        data = _mutant(rng, base, kind)
        want = _records_or_error(flow_pb2.Records.FromString,
                                 rconv.pb_to_record, data)
        got = _records_or_error(pbflow.Records.FromString,
                                pconv.pb_to_record, data)
        assert got[0] == want[0], (data.hex(), want, got)
        if want[0] == "accept":
            assert got[1] == want[1], data.hex()
            accepted += 1
        else:
            assert got[1] == "WireError"
    if kind in ("duplicate", "reorder", "inner"):
        assert accepted == 100


# ------------------------------------------------------------- the schema


def _proto_messages() -> dict:
    with open(os.path.join(ROOT, "proto", "flow.proto")) as fh:
        src = fh.read()
    out = {}
    for name, body in re.findall(
            r"message (\w+) \{((?:[^{}]|\{[^{}]*\})*)\}", src):
        out[name] = {f: int(n) for f, n in
                     re.findall(r"(\w+) = (\d+);", body)}
    return out


_KINDS = {FieldDescriptor.TYPE_UINT32: "uint32",
          FieldDescriptor.TYPE_UINT64: "uint64",
          FieldDescriptor.TYPE_INT32: "int32",
          FieldDescriptor.TYPE_INT64: "int64",
          FieldDescriptor.TYPE_BOOL: "bool", FieldDescriptor.TYPE_ENUM: "enum",
          FieldDescriptor.TYPE_FIXED32: "fixed32",
          FieldDescriptor.TYPE_STRING: "string",
          FieldDescriptor.TYPE_BYTES: "bytes",
          FieldDescriptor.TYPE_MESSAGE: "message"}


@pytest.mark.parametrize("name", ["Records", "Record", "DupMapEntry",
                                  "NetworkEvent", "DataLink", "Network",
                                  "IP", "Transport", "Xlat", "Quic",
                                  "CollectorReply"])
def test_field_numbers_and_kinds_match_the_schema(name):
    ours = getattr(pbflow, name)
    assert {f.name: f.number for f in ours.FIELDS} == \
        _proto_messages().get(name, {})
    desc = getattr(flow_pb2, name).DESCRIPTOR
    want = {}
    for fd in desc.fields:
        kind = _KINDS[fd.type]
        if kind == "message" and fd.message_type.GetOptions().map_entry:
            kind = "map"
        want[fd.name] = (fd.number, kind, fd.is_repeated and kind != "map",
                         fd.containing_oneof.name if fd.containing_oneof
                         else "")
    got = {f.name: (f.number, f.kind, f.repeated, f.oneof)
           for f in ours.FIELDS}
    assert got == want
    for well_known in ("Timestamp", "Duration"):
        assert {f.name: (f.number, f.kind) for f in getattr(
            pbflow, well_known).FIELDS} == {"seconds": (1, "int64"),
                                            "nanos": (2, "int32")}


@pytest.mark.parametrize("ns", [0, 1, 999_999_999, 10**9, -1,
                                -1_500_000_001, 1700000101999999999])
def test_time_helpers_equal_protobufs(ns):
    from google.protobuf import duration_pb2, timestamp_pb2
    for ours, ref in ((pbflow.Timestamp(), timestamp_pb2.Timestamp()),
                      (pbflow.Duration(), duration_pb2.Duration())):
        ours.FromNanoseconds(ns)
        ref.FromNanoseconds(ns)
        assert (ours.seconds, ours.nanos) == (ref.seconds, ref.nanos)
        assert ours.ToNanoseconds() == ref.ToNanoseconds() == ns
        assert ours.SerializeToString() == ref.SerializeToString(
            deterministic=True)
