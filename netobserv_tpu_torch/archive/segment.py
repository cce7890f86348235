"""Archive segment codec: one closed window (or compacted super-window)
of mergeable sketch tables, serialized for the on-disk warehouse.

A copy of `netobserv_tpu/archive/segment.py` (`:1-193`) on the port's own
`federation/delta.py` (`TABLE_SPEC`, `DIM_FIELDS`,
`table_spec_fingerprint`) and `utils/tensorcodec.py`: a segment the port
writes is byte for byte the reference's for the same tables, so either
package reads the other's archive.

The segment carries exactly the delta wire's canonical table snapshot —
`federation.delta.TABLE_SPEC` names/dtypes in spec order — through the
SAME per-tensor zlib-when-smaller codec (`utils/tensorcodec.py`): one
tensor format across the wire and the warehouse, not a fifth drifting
copy. On top of the tensors sits a tiny self-describing envelope:

    8B  magic  b"NOSKARCH"
    u4< format version (SEGMENT_FORMAT_VERSION)
    u4< header length
        header: canonical JSON (sorted keys, compact separators) —
        agent_id, level, window_from/window_to/n_windows, ts_ms, the
        frame-geometry dims, and the TABLE_SPEC fingerprint
    per TABLE_SPEC entry, in spec order (names are implicit):
        u1 codec, u1 dtype code, u2< ndim, u4<*ndim shape,
        u4< payload length, payload bytes

Everything is explicit little-endian, so a segment written on any host
decodes on any other — the RAW-codec golden (tests/golden/
archive_segment_v1.hex + tests/test_archive_golden.py) pins the bytes on
the big-endian qemu CI tier exactly like the delta-frame goldens.

Host code only: segment encode runs on the exporter's window thread from
HOST copies of the roll's table snapshot and never launches device work;
decode works on hosts without a card. The TABLE_SPEC fingerprint in the
header plays the checkpoint stamp's role: a layout drift without a
format bump refuses to decode instead of silently misaligning tables.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping, NamedTuple

import numpy as np

from netobserv_tpu_torch.federation import delta as fdelta
from netobserv_tpu_torch.utils import tensorcodec

MAGIC = b"NOSKARCH"
#: bump on ANY change to the envelope, the header schema, or the tensor
#: encoding. The tensor layout itself is TABLE_SPEC — a spec change moves
#: the header fingerprint AND the delta/checkpoint versions together
#: (federation/delta.py, sketch/checkpoint.py).
SEGMENT_FORMAT_VERSION = 1

#: header keys every segment must carry (sorted-key JSON keeps the golden
#: deterministic)
_HEADER_KEYS = ("agent_id", "dims", "level", "n_windows", "table_crc",
                "ts_ms", "window_from", "window_to")

CODEC_RAW = tensorcodec.CODEC_RAW
CODEC_ZLIB = tensorcodec.CODEC_ZLIB


class ArchiveSegmentError(ValueError):
    """Malformed/incompatible segment (decode-time validation failure)."""


class Segment(NamedTuple):
    """Decoded segment: header metadata + the table dict (TABLE_SPEC names
    -> little-endian numpy arrays; RAW tensors are zero-copy read-only
    views over the segment buffer — copy before mutating)."""

    agent_id: str
    level: int
    window_from: int
    window_to: int
    n_windows: int
    ts_ms: int
    dims: dict
    tables: dict


def encode_segment(tables: Mapping[str, np.ndarray], *, agent_id: str,
                   level: int, window_from: int, window_to: int,
                   n_windows: int, ts_ms: int, dims: Mapping[str, int],
                   codec: int = CODEC_ZLIB) -> bytes:
    """Serialize one table snapshot into segment bytes.

    `tables` must carry every TABLE_SPEC name (host numpy arrays; dtypes
    coerce to the spec's little-endian types). Raw (level-0) segments have
    window_from == window_to and n_windows == 1; compacted super-windows
    span the windows they merged."""
    missing = [n for n, _ in fdelta.TABLE_SPEC if n not in tables]
    if missing:
        raise ArchiveSegmentError(
            f"table snapshot missing tensors: {missing}")
    header = {
        "agent_id": str(agent_id),
        "dims": {f: int(dims[f]) for f in fdelta.DIM_FIELDS},
        "level": int(level),
        "n_windows": int(n_windows),
        "table_crc": fdelta.table_spec_fingerprint(),
        "ts_ms": int(ts_ms),
        "window_from": int(window_from),
        "window_to": int(window_to),
    }
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode()
    out = [MAGIC, struct.pack("<II", SEGMENT_FORMAT_VERSION, len(hdr)),
           hdr]
    for name, dt in fdelta.TABLE_SPEC:
        arr = np.ascontiguousarray(np.asarray(tables[name]), dtype=dt)
        try:
            code, payload = tensorcodec.encode_payload(arr.tobytes(),
                                                       codec)
        except tensorcodec.TensorCodecError as exc:
            raise ArchiveSegmentError(str(exc)) from exc
        out.append(struct.pack("<BBH", code, tensorcodec.DTYPE_TO_CODE[dt],
                               arr.ndim))
        out.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        out.append(struct.pack("<I", len(payload)))
        out.append(payload)
    return b"".join(out)


def _take(buf: bytes, off: int, n: int, what: str) -> tuple[bytes, int]:
    if off + n > len(buf):
        raise ArchiveSegmentError(
            f"truncated segment: wanted {n}B of {what} at offset {off}, "
            f"have {len(buf) - off}B")
    return buf[off:off + n], off + n


def decode_segment(data: bytes) -> Segment:
    """Parse + validate one segment. Raises ArchiveSegmentError on
    anything structurally wrong: bad magic, unknown format version, a
    TABLE_SPEC fingerprint from a different build (layout drift), dtype
    drift, truncation, oversized or bomb payloads, trailing garbage."""
    head, off = _take(data, 0, len(MAGIC), "magic")
    if head != MAGIC:
        raise ArchiveSegmentError(
            f"not an archive segment (magic {head!r})")
    raw, off = _take(data, off, 8, "version header")
    version, hdr_len = struct.unpack("<II", raw)
    if version != SEGMENT_FORMAT_VERSION:
        raise ArchiveSegmentError(
            f"segment format version {version}; this build reads "
            f"{SEGMENT_FORMAT_VERSION} — refusing to decode")
    hdr_raw, off = _take(data, off, hdr_len, "header json")
    try:
        header = json.loads(hdr_raw)
    except ValueError as exc:
        raise ArchiveSegmentError(f"unparseable segment header: {exc}") \
            from exc
    missing = [k for k in _HEADER_KEYS if k not in header]
    if missing:
        raise ArchiveSegmentError(f"segment header missing {missing}")
    crc = int(header["table_crc"])
    if crc != fdelta.table_spec_fingerprint():
        raise ArchiveSegmentError(
            f"segment stamps table-spec crc {crc} != this build's "
            f"{fdelta.table_spec_fingerprint()}: the snapshot layout "
            "changed without a segment format bump — refuse rather than "
            "decode silently-misaligned tables")
    tables: dict[str, np.ndarray] = {}
    for name, spec_dt in fdelta.TABLE_SPEC:
        raw, off = _take(data, off, 4, f"{name} tensor header")
        code, dt_code, ndim = struct.unpack("<BBH", raw)
        dt = tensorcodec.CODE_TO_DTYPE.get(dt_code)
        if dt is None:
            raise ArchiveSegmentError(
                f"tensor {name!r}: unknown dtype code {dt_code}")
        if dt != spec_dt:
            raise ArchiveSegmentError(
                f"tensor {name!r}: dtype {dt} != spec {spec_dt}")
        raw, off = _take(data, off, 4 * ndim, f"{name} shape")
        shape = struct.unpack(f"<{ndim}I", raw)
        raw, off = _take(data, off, 4, f"{name} payload length")
        (plen,) = struct.unpack("<I", raw)
        payload, off = _take(data, off, plen, f"{name} payload")
        try:
            expected = tensorcodec.declared_nbytes(name, shape, dt)
            raw_bytes = tensorcodec.decode_payload(name, code, payload,
                                                   expected)
        except tensorcodec.TensorCodecError as exc:
            raise ArchiveSegmentError(str(exc)) from exc
        tables[name] = np.frombuffer(raw_bytes, dtype=dt).reshape(shape)
    if off != len(data):
        raise ArchiveSegmentError(
            f"{len(data) - off} trailing bytes after the last tensor")
    return Segment(
        agent_id=str(header["agent_id"]), level=int(header["level"]),
        window_from=int(header["window_from"]),
        window_to=int(header["window_to"]),
        n_windows=int(header["n_windows"]), ts_ms=int(header["ts_ms"]),
        dims={f: int(header["dims"][f]) for f in fdelta.DIM_FIELDS},
        tables=tables)
