"""Kafka protocol primitives: framing, primitive encoders, crc32c, varints.

A copy of `netobserv_tpu/kafka/wire.py` (lines 1-163) whose `crc32c` is
the pure-Python slice-by-8 loop only: the port's native packer has no
crc32c entry (the reference prefers its flowpack's when one is built),
and the two give the same checksum.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — required by record-batch v2; slice-by-8 tables keep the
# pure-python loop to one iteration per 8 bytes
# ---------------------------------------------------------------------------
_CRC32C_POLY = 0x82F63B78
_T = [[0] * 256 for _ in range(8)]
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _T[0][_i] = _c
for _i in range(256):
    _c = _T[0][_i]
    for _k in range(1, 8):
        _c = _T[0][_c & 0xFF] ^ (_c >> 8)
        _T[_k][_i] = _c


def crc32c(data: bytes) -> int:
    return _crc32c_py(data)


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    n = len(data)
    i = 0
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    while n - i >= 8:
        crc ^= (data[i] | data[i + 1] << 8 | data[i + 2] << 16
                | data[i + 3] << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[data[i + 4]] ^ t2[data[i + 5]]
               ^ t1[data[i + 6]] ^ t0[data[i + 7]])
        i += 8
    for b in data[i:]:
        crc = _T[0][(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# zigzag varints (record encoding)
# ---------------------------------------------------------------------------

def zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def varint(n: int) -> bytes:
    u = zigzag(n) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ---------------------------------------------------------------------------
# primitive encoders (classic, non-flexible protocol versions)
# ---------------------------------------------------------------------------

def kstr(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    raw = s.encode()
    return struct.pack(">h", len(raw)) + raw


def kbytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def karray(items: list[bytes]) -> bytes:
    return struct.pack(">i", len(items)) + b"".join(items)


class Reader:
    """Cursor over a response body."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        out = self.data[self.off:self.off + n]
        if len(out) != n:
            raise EOFError("short kafka response")
        self.off += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)


def unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def read_varint(data: bytes, off: int) -> tuple[int, int]:
    """Decode one zigzag varint at `off`; returns (value, next_off)."""
    shift = 0
    u = 0
    while True:
        b = data[off]
        off += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return unzigzag(u), off
        shift += 7
