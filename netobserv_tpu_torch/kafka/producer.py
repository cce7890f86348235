"""Produce-only Kafka client: metadata discovery + record-batch v2 produce.

A copy of `netobserv_tpu/kafka/producer.py` (lines 1-340), its imports
pointed at the port's `kafka/wire.py`.

Supports TLS, SASL PLAIN and SCRAM-SHA-256/512, acks control, batching by
message count/bytes. Compression codecs are accepted but sent uncompressed
(codec "none"); gzip is implemented since it's stdlib.
"""

from __future__ import annotations

import base64
import gzip
import hashlib
import hmac as hmac_mod
import logging
import os
import socket
import ssl
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from netobserv_tpu_torch.kafka.wire import Reader, crc32c, karray, kbytes, kstr, varint

log = logging.getLogger("netobserv_tpu_torch.kafka")

API_PRODUCE = 0
API_METADATA = 3
API_SASL_HANDSHAKE = 17
API_SASL_AUTHENTICATE = 36

_CLIENT_ID = "netobserv-tpu"


@dataclass
class TLSSettings:
    enable: bool = False
    insecure_skip_verify: bool = False
    ca_path: str = ""
    cert_path: str = ""
    key_path: str = ""


@dataclass
class SASLSettings:
    enable: bool = False
    mechanism: str = "plain"  # plain | scram-sha256 | scram-sha512
    username: str = ""
    password: str = ""


class _Conn:
    """One broker connection with request/response framing."""

    def __init__(self, host: str, port: int, tls: TLSSettings,
                 sasl: SASLSettings, timeout_s: float = 10.0):
        sock = socket.create_connection((host, port), timeout=timeout_s)
        if tls.enable:
            ctx = ssl.create_default_context(
                cafile=tls.ca_path or None)
            if tls.insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if tls.cert_path:
                ctx.load_cert_chain(tls.cert_path, tls.key_path or None)
            sock = ctx.wrap_socket(sock, server_hostname=host)
        self._sock = sock
        self._corr = 0
        self._lock = threading.Lock()
        if sasl.enable:
            self._authenticate(sasl)

    def request(self, api_key: int, api_version: int, body: bytes,
                expect_response: bool = True) -> Optional[Reader]:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = struct.pack(">hhi", api_key, api_version, corr) + \
                kstr(_CLIENT_ID)
            frame = header + body
            self._sock.sendall(struct.pack(">i", len(frame)) + frame)
            if not expect_response:
                # brokers send nothing back for acks=0 produce requests
                return None
            resp = self._read_frame()
        r = Reader(resp)
        got_corr = r.i32()
        if got_corr != corr:
            raise IOError(f"kafka correlation mismatch {got_corr} != {corr}")
        return r

    def _read_frame(self) -> bytes:
        hdr = self._recv_exact(4)
        (n,) = struct.unpack(">i", hdr)
        return self._recv_exact(n)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("kafka broker closed connection")
            buf += chunk
        return buf

    def _authenticate(self, sasl: SASLSettings) -> None:
        mech = {"plain": "PLAIN", "scram-sha256": "SCRAM-SHA-256",
                "scram-sha512": "SCRAM-SHA-512"}[sasl.mechanism.lower()]
        r = self.request(API_SASL_HANDSHAKE, 1, kstr(mech))
        err = r.i16()
        if err:
            raise IOError(f"SASL handshake rejected (error {err})")
        if mech == "PLAIN":
            token = b"\x00" + sasl.username.encode() + b"\x00" + \
                sasl.password.encode()
            self._sasl_auth(token)
        else:
            self._scram(sasl, mech)

    def _sasl_auth(self, token: bytes) -> bytes:
        r = self.request(API_SASL_AUTHENTICATE, 0, kbytes(token))
        err = r.i16()
        msg = r.string()
        if err:
            raise IOError(f"SASL auth failed (error {err}): {msg}")
        return r.bytes_() or b""

    def _scram(self, sasl: SASLSettings, mech: str) -> None:
        algo = hashlib.sha256 if mech.endswith("256") else hashlib.sha512
        nonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n={sasl.username},r={nonce}"
        server_first = self._sasl_auth(f"n,,{first_bare}".encode()).decode()
        parts = dict(p.split("=", 1) for p in server_first.split(","))
        it = int(parts["i"])
        salt = base64.b64decode(parts["s"])
        rnonce = parts["r"]
        salted = hashlib.pbkdf2_hmac(
            algo().name, sasl.password.encode(), salt, it)
        client_key = hmac_mod.new(salted, b"Client Key", algo).digest()
        stored = algo(client_key).digest()
        without_proof = f"c=biws,r={rnonce}"
        auth_msg = f"{first_bare},{server_first},{without_proof}".encode()
        sig = hmac_mod.new(stored, auth_msg, algo).digest()
        proof = base64.b64encode(
            bytes(a ^ b for a, b in zip(client_key, sig))).decode()
        self._sasl_auth(f"{without_proof},p={proof}".encode())

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _record_batch(records: list[tuple[bytes | None, bytes]],
                  compression: str = "none") -> bytes:
    """Encode one record batch (message format v2)."""
    now_ms = int(time.time() * 1000)
    body = b""
    for i, (key, value) in enumerate(records):
        rec = b"\x00"  # attributes
        rec += varint(0)  # timestamp delta
        rec += varint(i)  # offset delta
        rec += varint(len(key)) + key if key is not None else varint(-1)
        rec += varint(len(value)) + value
        rec += varint(0)  # headers
        body += varint(len(rec)) + rec
    attrs = 0
    if compression == "gzip":
        body = gzip.compress(body)
        attrs = 1
    # crc32c covers everything AFTER the crc field:
    crc_payload = struct.pack(">hi", attrs, len(records) - 1)
    crc_payload += struct.pack(">qq", now_ms, now_ms)  # first/max timestamp
    crc_payload += struct.pack(">qhi", -1, -1, -1)  # producerId/epoch/baseSeq
    crc_payload += struct.pack(">i", len(records))
    crc_payload += body
    # batchLength counts partitionLeaderEpoch(4) + magic(1) + crc(4) + payload
    batch_len = 4 + 1 + 4 + len(crc_payload)
    return (struct.pack(">qi", 0, batch_len)      # baseOffset, batchLength
            + struct.pack(">i", 0)                 # partitionLeaderEpoch
            + struct.pack(">b", 2)                 # magic
            + struct.pack(">I", crc32c(crc_payload))
            + crc_payload)


class KafkaProducer:
    def __init__(self, brokers: list[str], topic: str, acks: int = 1,
                 tls: TLSSettings = TLSSettings(),
                 sasl: SASLSettings = SASLSettings(),
                 compression: str = "none", timeout_s: float = 10.0):
        self._brokers = [self._parse(b) for b in brokers]
        self._topic = topic
        self._acks = acks
        self._tls = tls
        self._sasl = sasl
        self._compression = "gzip" if compression == "gzip" else "none"
        if compression not in ("none", "gzip"):
            log.warning("compression %r unsupported; sending uncompressed",
                        compression)
        self._timeout = timeout_s
        self._meta_conn: Optional[_Conn] = None
        self._leader_conns: dict[int, _Conn] = {}
        self._partitions: list[tuple[int, int]] = []  # (partition, leader id)
        self._broker_addrs: dict[int, tuple[str, int]] = {}
        self._refresh_metadata()

    @staticmethod
    def _parse(b: str) -> tuple[str, int]:
        host, _, port = b.rpartition(":")
        return host or b, int(port) if port.isdigit() else 9092

    def _connect_any(self) -> _Conn:
        last: Exception = RuntimeError("no brokers")
        for host, port in self._brokers:
            try:
                return _Conn(host, port, self._tls, self._sasl, self._timeout)
            except OSError as exc:
                last = exc
        raise last

    def _refresh_metadata(self) -> None:
        if self._meta_conn is None:
            self._meta_conn = self._connect_any()
        body = karray([kstr(self._topic)])
        r = self._meta_conn.request(API_METADATA, 1, body)
        n_brokers = r.i32()
        self._broker_addrs = {}
        for _ in range(n_brokers):
            node = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            self._broker_addrs[node] = (host, port)
        r.i32()  # controller id
        n_topics = r.i32()
        self._partitions = []
        for _ in range(n_topics):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            n_parts = r.i32()
            for _ in range(n_parts):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                if name == self._topic and not perr:
                    self._partitions.append((pid, leader))
            if err:
                raise IOError(f"kafka topic metadata error {err} for {name}")
        if not self._partitions:
            raise IOError(f"no partitions for topic {self._topic}")

    def _leader_conn(self, leader: int) -> _Conn:
        conn = self._leader_conns.get(leader)
        if conn is None:
            host, port = self._broker_addrs[leader]
            conn = _Conn(host, port, self._tls, self._sasl, self._timeout)
            self._leader_conns[leader] = conn
        return conn

    def partition_for(self, key: bytes | None) -> tuple[int, int]:
        if key is None:
            idx = int(time.monotonic_ns() // 1000) % len(self._partitions)
        else:
            # partition assignment needs no cross-client compatibility; use
            # C-speed zlib.crc32 instead of the pure-python crc32c
            import zlib
            idx = zlib.crc32(key) % len(self._partitions)
        return self._partitions[idx]

    def send_batch(self, messages: list[tuple[bytes | None, bytes]]) -> None:
        """Send (key, value) messages, grouped by partition, one produce call
        per leader."""
        by_partition: dict[int, list] = {}
        leaders: dict[int, int] = {}
        for key, value in messages:
            pid, leader = self.partition_for(key)
            by_partition.setdefault(pid, []).append((key, value))
            leaders[pid] = leader
        by_leader: dict[int, dict[int, list]] = {}
        for pid, msgs in by_partition.items():
            by_leader.setdefault(leaders[pid], {})[pid] = msgs
        for leader, parts in by_leader.items():
            self._produce(leader, parts)

    def _produce(self, leader: int, parts: dict[int, list]) -> None:
        try:
            self._produce_once(leader, parts)
        except (OSError, ConnectionError):
            # the usual reason a send fails is that partition leadership
            # moved: refresh metadata, then re-group the partitions by their
            # *current* leaders before retrying (not the stale leader id)
            self._leader_conns.pop(leader, None)
            self._refresh_metadata()
            current = dict(self._partitions)
            regrouped: dict[int, dict[int, list]] = {}
            for pid, msgs in parts.items():
                new_leader = current.get(pid)
                if new_leader is None:
                    raise IOError(
                        f"partition {pid} missing after metadata refresh")
                regrouped.setdefault(new_leader, {})[pid] = msgs
            for new_leader, new_parts in regrouped.items():
                self._produce_once(new_leader, new_parts)

    def _produce_once(self, leader: int, parts: dict[int, list]) -> None:
        partition_data = []
        for pid, msgs in parts.items():
            batch = _record_batch(msgs, self._compression)
            partition_data.append(struct.pack(">i", pid) + kbytes(batch))
        topic_data = karray([kstr(self._topic) + karray(partition_data)])
        body = kstr(None) + struct.pack(">hi", self._acks,
                                        int(self._timeout * 1000)) + topic_data
        conn = self._leader_conn(leader)
        expect = self._acks != 0
        r = conn.request(API_PRODUCE, 3, body, expect_response=expect)
        if self._acks:
            n_topics = r.i32()
            for _ in range(n_topics):
                r.string()
                for _ in range(r.i32()):
                    r.i32()  # partition
                    err = r.i16()
                    r.i64()  # base offset
                    r.i64()  # log append time
                    if err:
                        raise IOError(f"kafka produce error {err}")

    def close(self) -> None:
        for conn in self._leader_conns.values():
            conn.close()
        if self._meta_conn is not None:
            self._meta_conn.close()
