"""Fetch-side Kafka client: Metadata v1, ListOffsets v1 and Fetch v4 with
the record-batch v2 decode.

A copy of `netobserv_tpu/kafka/consumer.py` (lines 1-219) over the port's
`kafka/producer.py` (`_Conn`, `API_METADATA`, `TLSSettings`,
`SASLSettings`) and `kafka/wire.py` (`karray`, `kstr`, `read_varint`). It
is the consumer leg that reads an agent's topic back (EXPORT=kafka's
pbflow records, the report sink's JSON), as a flowlogs-pipeline Kafka
ingest would; the same TLS and SASL settings apply. Host code: it has no
device and no entry point that picks one.
"""

from __future__ import annotations

import gzip
import logging
import struct
from typing import Optional

from netobserv_tpu_torch.kafka.producer import (
    API_METADATA, SASLSettings, TLSSettings, _Conn,
)
from netobserv_tpu_torch.kafka.wire import karray, kstr, read_varint

log = logging.getLogger("netobserv_tpu_torch.kafka")

API_FETCH = 1
API_LIST_OFFSETS = 2

EARLIEST = -2
LATEST = -1


def decode_record_batches(blob: bytes,
                          ) -> tuple[list[tuple[Optional[bytes], bytes]],
                                     Optional[int]]:
    """Decode a concatenation of record batches (message format v2) into
    (key, value) pairs, plus the offset AFTER the last complete batch
    (None if no complete batch decoded). Tolerates a trailing partial
    batch — brokers may truncate at the fetch size boundary."""
    out: list[tuple[Optional[bytes], bytes]] = []
    next_offset: Optional[int] = None
    off = 0
    while off + 17 <= len(blob):
        base_offset = struct.unpack(">q", blob[off:off + 8])[0]
        batch_len = struct.unpack(">i", blob[off + 8:off + 12])[0]
        end = off + 12 + batch_len
        if batch_len <= 0 or end > len(blob):
            break  # partial trailing batch
        if batch_len < 5:
            # the magic byte sits 5 bytes into the batch body: a corrupt
            # batch_len in 1..4 would make the read below peek past the
            # batch end and misroute the decoder — treat as partial
            break
        magic = blob[off + 16]
        if magic != 2:
            # legacy (v0/v1) message set (can legitimately be < 49 bytes):
            # not decoded, but the offset MUST still advance or poll()
            # would re-fetch this blob forever
            log.warning("skipping record batch with magic %d", magic)
            next_offset = max(next_offset or 0, base_offset + 1)
            off = end
            continue
        if batch_len < 49:
            # a v2 batch body is at least 49 bytes (through the record
            # count at +57..61); a corrupt batch_len in 1..48 passes the
            # end-bounds check yet would crash the header unpacks below
            # with struct.error — treat it like a partial trailing batch
            break
        attrs = struct.unpack(">h", blob[off + 21:off + 23])[0]
        last_delta = struct.unpack(">i", blob[off + 23:off + 27])[0]
        n_records = struct.unpack(">i", blob[off + 57:off + 61])[0]
        next_offset = base_offset + last_delta + 1
        body = blob[off + 61:end]
        if attrs & 0x07 == 1:
            body = gzip.decompress(body)
        elif attrs & 0x07:
            raise ValueError(f"unsupported compression codec {attrs & 0x07}")
        p = 0
        for _ in range(n_records):
            rec_len, p = read_varint(body, p)
            rec_end = p + rec_len
            p += 1  # attributes
            _, p = read_varint(body, p)  # timestamp delta
            _, p = read_varint(body, p)  # offset delta
            klen, p = read_varint(body, p)
            key = None if klen < 0 else body[p:p + max(klen, 0)]
            p += max(klen, 0)
            vlen, p = read_varint(body, p)
            value = body[p:p + max(vlen, 0)]
            p = rec_end  # headers skipped wholesale
            out.append((key, value))
        off = end
    return out, next_offset


class KafkaConsumer:
    """Minimal fetch loop over every partition of one topic.

    `pin_bootstrap=True` fetches through the bootstrap connection instead
    of the advertised leader address — the single-broker case where the
    advertised name isn't resolvable from here (e.g. a port-forwarded
    in-cluster broker)."""

    def __init__(self, brokers: list[str], topic: str,
                 tls: TLSSettings = TLSSettings(),
                 sasl: SASLSettings = SASLSettings(),
                 timeout_s: float = 10.0,
                 start_at: int = EARLIEST,
                 pin_bootstrap: bool = False):
        self._topic = topic
        self._tls, self._sasl, self._timeout = tls, sasl, timeout_s
        host, _, port = brokers[0].rpartition(":")
        self._conn = _Conn(host or brokers[0],
                           int(port) if port.isdigit() else 9092,
                           tls, sasl, timeout_s)
        self._pin = pin_bootstrap
        self._leader_conns: dict[int, _Conn] = {}
        self._partitions: list[int] = []
        self._leaders: dict[int, int] = {}
        self._brokers_meta: dict[int, tuple[str, int]] = {}
        self._refresh_metadata()
        self._offsets: dict[int, int] = {
            pid: self._list_offset(pid, start_at) for pid in self._partitions}

    def _refresh_metadata(self) -> None:
        r = self._conn.request(API_METADATA, 1, karray([kstr(self._topic)]))
        for _ in range(r.i32()):
            node = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            self._brokers_meta[node] = (host, port)
        r.i32()  # controller
        self._partitions = []
        for _ in range(r.i32()):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            for _ in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                if name == self._topic and not perr:
                    self._partitions.append(pid)
                    self._leaders[pid] = leader
            if err:
                raise IOError(f"metadata error {err} for topic {name}")
        if not self._partitions:
            raise IOError(f"topic {self._topic} has no partitions")

    def _conn_for(self, pid: int) -> _Conn:
        if self._pin:
            return self._conn
        leader = self._leaders[pid]
        conn = self._leader_conns.get(leader)
        if conn is None:
            host, port = self._brokers_meta[leader]
            conn = _Conn(host, port, self._tls, self._sasl, self._timeout)
            self._leader_conns[leader] = conn
        return conn

    def _list_offset(self, pid: int, at: int) -> int:
        body = struct.pack(">i", -1)  # replica_id
        body += karray([kstr(self._topic) + karray(
            [struct.pack(">iq", pid, at)])])
        r = self._conn_for(pid).request(API_LIST_OFFSETS, 1, body)
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                rpid = r.i32()
                err = r.i16()
                r.i64()  # timestamp
                offset = r.i64()
                if rpid == pid:
                    if err:
                        raise IOError(f"list_offsets error {err} p{pid}")
                    return offset
        raise IOError(f"partition {pid} missing from ListOffsets response")

    def poll(self, max_wait_ms: int = 500, max_bytes: int = 4 << 20
             ) -> list[tuple[Optional[bytes], bytes]]:
        """One fetch round over all partitions; advances offsets."""
        out: list[tuple[Optional[bytes], bytes]] = []
        for pid in self._partitions:
            body = struct.pack(">iiii", -1, max_wait_ms, 1, max_bytes)
            body += b"\x00"  # isolation_level: read_uncommitted
            body += karray([kstr(self._topic) + karray(
                [struct.pack(">iqi", pid, self._offsets[pid], max_bytes)])])
            r = self._conn_for(pid).request(API_FETCH, 4, body)
            r.i32()  # throttle_time_ms
            for _ in range(r.i32()):
                r.string()  # topic
                for _ in range(r.i32()):
                    rpid = r.i32()
                    err = r.i16()
                    r.i64()  # high watermark
                    r.i64()  # last stable offset
                    n_aborted = r.i32()
                    for _ in range(max(n_aborted, 0)):
                        r.i64()
                        r.i64()
                    blob = r.bytes_() or b""
                    if err:
                        raise IOError(f"fetch error {err} p{rpid}")
                    if rpid != pid or not blob:
                        continue
                    records, next_off = decode_record_batches(blob)
                    out.extend(records)
                    if next_off is not None:
                        self._offsets[pid] = max(self._offsets[pid], next_off)
        return out

    def close(self) -> None:
        self._conn.close()
        for c in self._leader_conns.values():
            c.close()
