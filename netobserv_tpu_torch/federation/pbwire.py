"""The delta wire's proto3 messages, written and parsed without protobuf.

The port's own module; its original is `proto/sketch_delta.proto` (the
JAX package serializes it through the generated
`netobserv_tpu/pb/sketch_delta_pb2.py`). The card's machine has no
protobuf package, so `SketchDelta`, `Tensor`, `TraceContext`,
`AgentTelemetry`, `TenantInfo` and `DeltaAck` are plain classes here, and
this module writes and parses their wire form itself. `pb/flow.py`
declares the flow wire (`proto/flow.proto`) on the same `Message`, with
the kinds that only it uses: int32, int64, bool, fixed32, enum, a oneof
and `map<string, string>`.

Writing (`SerializeToString`) gives the bytes of protobuf's
`SerializeToString(deterministic=True)`:

- fields in field-number order;
- an implicit-presence scalar is left out at its default: 0, an empty
  string or bytes, and a double whose bits are all zero (so ``-0.0`` is
  written, as protobuf writes it);
- `repeated uint32` is packed; a repeated string or message writes one
  field per element;
- a sub-message is written whenever it is present (not None), even empty;
- varints of up to 10 bytes, doubles as little-endian fixed64;
- a negative int32, int64 or enum as its 64-bit two's complement, a
  10-byte varint; a bool as 0 or 1; a fixed32 as 4 little-endian bytes;
- a oneof member has explicit presence: it is written whenever it is set
  (not None), at its default too, so an IPv4 0.0.0.0 goes out as fixed32
  0. Setting one member clears its siblings;
- a map writes one entry message a key, key (1) and value (2) both
  written even when empty, the entries in upb's deterministic order:
  keys compared as bytes over their common prefix, and of a key and its
  prefix the longer first (upb sorts in reverse for its back-to-front
  encoder), so "ab" precedes "a" and the empty key comes last.

Parsing (`FromString`) follows protobuf's (upb's) rules:

- fields in any order; the last value wins for a scalar given twice, and a
  sub-message given twice merges into the first;
- a packed and an unpacked `repeated uint32` are both accepted;
- an unknown field is skipped by its wire type, a group by its matching
  end tag, nested at most 100 deep. A known field whose wire type is not
  its own is skipped as unknown too, as upb does;
- a truncated varint, tag, length or fixed field, a varint longer than 10
  bytes, a tag of field 0 or of wire type 6 or 7, an end tag that closes
  no group, a length past the buffer (checked before anything is sliced)
  and invalid UTF-8 in a `string` field raise `WireError`;
- a uint32 field keeps the low 32 bits of its varint, an int32 or enum
  field those bits as a signed value, an int64 field the low 64 bits
  signed; a bool is any nonzero varint. A `bytes` field parses to a
  `memoryview` of the input, never a copy;
- a oneof member given after a sibling replaces it;
- a map entry may come with its fields in any order or missing (an
  empty key or value); the last entry for a key wins. An entry holding
  any other field, or a key or value in another wire type, is not put in
  the map (upb keeps it as an unknown field of the parent).
"""

from __future__ import annotations

import functools
import struct
from typing import Any, ClassVar, NamedTuple


class WireError(ValueError):
    """Malformed proto3 wire bytes."""


_U32 = (1 << 32) - 1
_U64 = (1 << 64) - 1
#: upb's default nesting limit for sub-messages and groups
MAX_DEPTH = 100
_I32_MAX = (1 << 31) - 1
_I64_MAX = (1 << 63) - 1

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


class Field(NamedTuple):
    number: int
    name: str
    #: "uint32", "uint64", "int32", "int64", "bool", "enum", "fixed32",
    #: "double", "string", "bytes", "message" or "map" (string to string)
    kind: str
    repeated: bool = False
    #: the sub-message class of a "message" field
    message: Any = None
    #: the oneof a member belongs to ("" for none)
    oneof: str = ""


_WIRE = {"uint32": _VARINT, "uint64": _VARINT, "int32": _VARINT,
         "int64": _VARINT, "bool": _VARINT, "enum": _VARINT,
         "fixed32": _I32, "double": _I64, "string": _LEN, "bytes": _LEN,
         "message": _LEN, "map": _LEN}
_DEFAULT = {"uint32": 0, "uint64": 0, "int32": 0, "int64": 0,
            "bool": False, "enum": 0, "fixed32": 0, "double": 0.0,
            "string": "", "bytes": b""}
#: the kinds written as varints
_VARINTS = frozenset(("uint32", "uint64", "int32", "int64", "enum"))
#: the value range each integer kind writes
_RANGE = {"uint32": (0, _U32), "uint64": (0, _U64), "fixed32": (0, _U32),
          "int32": (-_I32_MAX - 1, _I32_MAX), "enum": (-_I32_MAX - 1,
                                                       _I32_MAX),
          "int64": (-_I64_MAX - 1, _I64_MAX)}


#: the one-byte varints
_BYTE = [bytes((i,)) for i in range(128)]


def _varint(value: int) -> bytes:
    if value < 0x80:
        return _BYTE[value]
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _tag(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _read_varint(buf: memoryview, pos: int, end: int) -> tuple[int, int]:
    """A varint of at most 10 bytes at `pos`; bits past 64 are dropped."""
    if pos < end and buf[pos] < 0x80:
        return buf[pos], pos + 1
    value = shift = 0
    for _ in range(10):
        if pos >= end:
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & _U64, pos
        shift += 7
    raise WireError("varint longer than 10 bytes")


def _read_tag(buf: memoryview, pos: int, end: int) -> tuple[int, int, int]:
    if pos < end and 0x08 <= buf[pos] < 0x80:  # a one-byte tag, field >= 1
        return buf[pos] >> 3, buf[pos] & 7, pos + 1
    start = pos
    tag, pos = _read_varint(buf, pos, end)
    if pos - start > 5 or tag > _U32:
        raise WireError("tag out of range")
    number, wire = tag >> 3, tag & 7
    if number == 0:
        raise WireError("field number 0")
    return number, wire, pos


def _read_len(buf: memoryview, pos: int, end: int) -> tuple[int, int]:
    """A length and its payload's start, checked against the buffer."""
    size, pos = _read_varint(buf, pos, end)
    if size >= _I32_MAX or size > end - pos:
        raise WireError(f"length {size} past the end of the buffer")
    return pos + size, pos


def _skip(buf: memoryview, pos: int, end: int, number: int, wire: int,
          depth: int) -> int:
    """Skip one unknown field's value; returns the position after it."""
    if wire == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire in (_I64, _I32):
        width = 8 if wire == _I64 else 4
        if end - pos < width:
            raise WireError("truncated fixed field")
        return pos + width
    if wire == _LEN:
        return _read_len(buf, pos, end)[0]
    if wire == _SGROUP:
        if depth < 0:
            raise WireError("nesting deeper than the limit")
        while True:
            if pos >= end:
                raise WireError("unterminated group")
            n, w, pos = _read_tag(buf, pos, end)
            if w == _EGROUP:
                if n != number:
                    raise WireError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, n, w, depth - 1)
    raise WireError(f"invalid wire type {wire}")


class Message:
    """A proto3 message: its fields as attributes (a repeated field a
    list, an absent sub-message None)."""

    FIELDS: ClassVar[tuple[Field, ...]] = ()
    _BY_NUMBER: ClassVar[dict]
    #: each oneof member's siblings, by member name
    _SIBLINGS: ClassVar[dict]

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        #: each field's default, and the fields that take a new container
        cls._DEFAULTS = {f.name: None if (f.kind == "message" or f.oneof)
                         else _DEFAULT[f.kind] for f in cls.FIELDS
                         if not f.repeated and f.kind != "map"}
        cls._CONTAINERS = tuple((f.name, dict if f.kind == "map" else list)
                                for f in cls.FIELDS
                                if f.repeated or f.kind == "map")
        cls._NAMES = frozenset(f.name for f in cls.FIELDS)
        #: each field with its tag's bytes (a packed repeated uint32 and
        #: every message, string, bytes and map field are length-delimited)
        cls._PLAN = tuple((f, _tag(f.number, _LEN if f.repeated
                                   and f.kind == "uint32" else
                                   _WIRE[f.kind])) for f in cls.FIELDS)
        cls._SIBLINGS = {
            f.name: tuple(g.name for g in cls.FIELDS
                          if g.oneof == f.oneof and g is not f)
            for f in cls.FIELDS if f.oneof}
        if cls._SIBLINGS:
            cls.__setattr__ = Message._set_member

    def _set_member(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        if value is not None:
            for sibling in self._SIBLINGS.get(name, ()):
                object.__setattr__(self, sibling, None)

    def WhichOneof(self, group: str):  # noqa: N802 - protobuf's name
        """The name of the set member of oneof `group`, or None."""
        for f in self.FIELDS:
            if f.oneof == group and getattr(self, f.name) is not None:
                return f.name
        return None

    def __init__(self, **values):
        d = self.__dict__
        d.update(self._DEFAULTS)
        for name, container in self._CONTAINERS:
            d[name] = container()
        for name, value in values.items():
            if name not in self._NAMES:
                raise TypeError(f"{type(self).__name__} has no field "
                                f"{name!r}")
            if isinstance(value, (list, tuple)):
                value = list(value)
            elif isinstance(value, dict):
                value = dict(value)
            setattr(self, name, value)

    def HasField(self, name: str) -> bool:  # noqa: N802 - protobuf's name
        """Presence of a sub-message field."""
        return getattr(self, name) is not None

    def __repr__(self) -> str:
        body = ", ".join(f"{f.name}={getattr(self, f.name)!r}"
                         for f in self.FIELDS)
        return f"{type(self).__name__}({body})"

    # ------------------------------------------------------------ write

    def SerializeToString(self, deterministic: bool = True  # noqa: N802
                          ) -> bytes:
        """The wire bytes (module docstring); `deterministic` is accepted
        for protobuf's signature, and the output always is."""
        out = bytearray()
        d = self.__dict__
        for f, tag in self._PLAN:
            value = d[f.name]
            kind = f.kind
            if f.repeated:
                if kind == "uint32":
                    if value:
                        body = b"".join(_varint(_check_int(v, f))
                                        for v in value)
                        out += tag
                        out += _varint(len(body))
                        out += body
                    continue
                for v in value:
                    _write_one(out, f, tag, v)
            elif kind == "map":
                for key in sorted(value, key=_MAP_ORDER):
                    entry = (_write_str(1, key) + _write_str(2, value[key]))
                    out += tag
                    out += _varint(len(entry))
                    out += entry
            elif kind == "message" or f.oneof:
                if value is not None:
                    _write_one(out, f, tag, value)
            elif not _is_default(kind, value):
                _write_one(out, f, tag, value)
        return bytes(out)

    # ------------------------------------------------------------ parse

    @classmethod
    def FromString(cls, data) -> "Message":  # noqa: N802 - protobuf's name
        """Parse wire bytes (module docstring); raises WireError."""
        msg = cls()
        buf = memoryview(data).cast("B") if not isinstance(
            data, memoryview) else data.cast("B")
        msg._merge(buf, 0, len(buf), MAX_DEPTH)
        return msg

    def _merge(self, buf: memoryview, pos: int, end: int,
               depth: int) -> None:
        by_number = self._BY_NUMBER
        while pos < end:
            number, wire, pos = _read_tag(buf, pos, end)
            if wire == _EGROUP:
                raise WireError("end-group tag outside a group")
            f = by_number.get(number)
            if f is None or not _wire_fits(f, wire):
                pos = _skip(buf, pos, end, number, wire, depth - 1)
                continue
            kind = f.kind
            if kind in _SIGNED or kind == "bool":
                v, pos = _read_varint(buf, pos, end)
                setattr(self, f.name, _SIGNED[kind](v) if kind != "bool"
                        else v != 0)
            elif kind == "fixed32":
                if end - pos < 4:
                    raise WireError("truncated fixed32")
                setattr(self, f.name, struct.unpack_from("<I", buf, pos)[0])
                pos += 4
            elif kind == "map":
                stop, pos = _read_len(buf, pos, end)
                if depth - 1 < 0:
                    raise WireError("nesting deeper than the limit")
                _merge_entry(getattr(self, f.name), buf, pos, stop,
                             depth - 1)
                pos = stop
            elif f.kind in ("uint32", "uint64"):
                if wire == _LEN:  # packed repeated
                    stop, pos = _read_len(buf, pos, end)
                    vals = getattr(self, f.name)
                    while pos < stop:
                        v, pos = _read_varint(buf, pos, stop)
                        vals.append(v & _U32)
                    continue
                v, pos = _read_varint(buf, pos, end)
                if f.kind == "uint32":
                    v &= _U32
                if f.repeated:
                    getattr(self, f.name).append(v)
                else:
                    setattr(self, f.name, v)
            elif f.kind == "double":
                if end - pos < 8:
                    raise WireError("truncated double")
                setattr(self, f.name,
                        struct.unpack_from("<d", buf, pos)[0])
                pos += 8
            else:
                stop, pos = _read_len(buf, pos, end)
                if f.kind == "message":
                    if depth - 1 < 0:
                        raise WireError("nesting deeper than the limit")
                    if f.repeated:
                        sub = f.message()
                        getattr(self, f.name).append(sub)
                    else:
                        sub = getattr(self, f.name)
                        if sub is None:
                            sub = f.message()
                            setattr(self, f.name, sub)
                    sub._merge(buf, pos, stop, depth - 1)
                elif f.kind == "string":
                    try:
                        s = str(buf[pos:stop], "utf-8")
                    except UnicodeDecodeError as exc:
                        raise WireError(f"field {f.name!r}: invalid UTF-8"
                                        ) from exc
                    if f.repeated:
                        getattr(self, f.name).append(s)
                    else:
                        setattr(self, f.name, s)
                else:
                    setattr(self, f.name, buf[pos:stop])
                pos = stop


def _write_one(out: bytearray, f: Field, tag: bytes, value) -> None:
    """One value of field `f` after its `tag`, onto `out`."""
    kind = f.kind
    out += tag
    if kind in _VARINTS:
        out += _varint(_check_int(value, f) & _U64)
    elif kind == "bool":
        out += b"\x01" if value else b"\x00"
    elif kind == "fixed32":
        out += struct.pack("<I", _check_int(value, f))
    elif kind == "double":
        out += struct.pack("<d", float(value))
    else:
        body = (value.SerializeToString() if kind == "message"
                else value.encode("utf-8") if kind == "string"
                else bytes(value))
        out += _varint(len(body))
        out += body


def _wire_fits(f: Field, wire: int) -> bool:
    if f.repeated and f.kind == "uint32":
        return wire in (_VARINT, _LEN)
    return _WIRE[f.kind] == wire


def _is_default(kind: str, value) -> bool:
    if kind == "double":
        return struct.pack("<d", float(value)) == _ZERO8
    return not value


_ZERO8 = bytes(8)


def _check_int(value, f: Field) -> int:
    v = int(value)
    lo, hi = _RANGE[f.kind]
    if not lo <= v <= hi:
        raise ValueError(f"field {f.name!r}: value {value} out of range "
                         f"for {f.kind}")
    return v


def _signed(bits: int):
    half, full = 1 << (bits - 1), 1 << bits

    def cast(v: int) -> int:
        v &= full - 1
        return v - full if v >= half else v
    return cast


#: a varint's value as each signed kind keeps it (upb truncates)
_SIGNED = {"int32": _signed(32), "enum": _signed(32), "int64": _signed(64)}


def _write_str(number: int, value: str) -> bytes:
    body = value.encode("utf-8")
    return _tag(number, _LEN) + _varint(len(body)) + body


def _map_cmp(a: str, b: str) -> int:
    ab, bb = a.encode("utf-8"), b.encode("utf-8")
    n = min(len(ab), len(bb))
    if ab[:n] != bb[:n]:
        return -1 if ab[:n] < bb[:n] else 1
    return len(bb) - len(ab)


_MAP_ORDER = functools.cmp_to_key(_map_cmp)


def _merge_entry(into: dict, buf: memoryview, pos: int, end: int,
                 depth: int) -> None:
    """One `map<string, string>` entry into `into` (module docstring)."""
    key = value = ""
    unknown = False
    while pos < end:
        number, wire, pos = _read_tag(buf, pos, end)
        if wire == _EGROUP:
            raise WireError("end-group tag outside a group")
        if number in (1, 2) and wire == _LEN:
            stop, pos = _read_len(buf, pos, end)
            try:
                s = str(buf[pos:stop], "utf-8")
            except UnicodeDecodeError as exc:
                raise WireError("map entry: invalid UTF-8") from exc
            if number == 1:
                key = s
            else:
                value = s
            pos = stop
            continue
        unknown = True
        pos = _skip(buf, pos, end, number, wire, depth - 1)
    if not unknown:
        into[key] = value


class DeltaAck(Message):
    FIELDS = (Field(1, "accepted", "uint32"), Field(2, "version", "uint32"),
              Field(3, "reason", "string"), Field(4, "duplicate", "uint32"))


class Tensor(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "dtype", "uint32"),
              Field(3, "shape", "uint32", repeated=True),
              Field(4, "codec", "uint32"), Field(5, "data", "bytes"))


class TraceContext(Message):
    FIELDS = (Field(1, "trace_id", "string"), Field(2, "origin", "string"),
              Field(3, "sampled", "uint32"))


class AgentTelemetry(Message):
    FIELDS = (Field(1, "shed_factor", "double"),
              Field(2, "conditions", "string", repeated=True),
              Field(3, "host_records_per_s", "double"),
              Field(4, "map_occupancy", "double"),
              Field(5, "windows_published", "uint64"))


class TenantInfo(Message):
    FIELDS = (Field(1, "id", "uint32"), Field(2, "n_tenants", "uint32"))


class SketchDelta(Message):
    FIELDS = (Field(1, "version", "uint32"), Field(2, "agent_id", "string"),
              Field(3, "window", "uint64"), Field(4, "ts_ms", "uint64"),
              Field(5, "cm_depth", "uint32"), Field(6, "cm_width", "uint32"),
              Field(7, "hll_precision", "uint32"),
              Field(8, "topk", "uint32"), Field(9, "ewma_buckets", "uint32"),
              Field(10, "tensors", "message", repeated=True,
                    message=Tensor),
              Field(11, "window_seq", "uint64"),
              Field(12, "frame_uuid", "string"),
              Field(13, "agent_epoch", "uint64"),
              Field(14, "trace_ctx", "message", message=TraceContext),
              Field(15, "telemetry", "message", message=AgentTelemetry),
              Field(16, "tenant", "message", message=TenantInfo))
