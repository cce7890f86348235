"""The port's Kafka client and report sink (netobserv_tpu_torch/kafka/,
exporter/report.py `KafkaReportSink`) against the JAX package's, on the
CPU.

- The wire encoders (varints, zigzag, strings, bytes, arrays, crc32c)
  and the uncompressed record batch are equal byte for byte; a gzip batch
  is equal after decompression (gzip stamps the time, as the batch
  header does; the clock is pinned for the uncompressed batch).
- Both packages' `KafkaReportSink`, built from the same environment, send
  the same report through the in-process fake broker of
  tests/test_kafka_broker.py, which receives equal messages, with and
  without acks, gzip and SASL PLAIN.
"""

import gzip
import json
import struct
import time

import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.exporter.tpu_sketch import KafkaReportSink as JSink
from netobserv_tpu.kafka import producer as jprod
from netobserv_tpu.kafka import wire as jwire
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.exporter.report import KafkaReportSink
from netobserv_tpu_torch.kafka import producer as tprod
from netobserv_tpu_torch.kafka import wire as twire
from tests.test_kafka_broker import FakeBroker

INTS = [0, 1, -1, 63, -64, 64, 127, 128, 300, -300, 2**31 - 1, -2**31,
        2**40, -2**40]


@pytest.mark.parametrize("n", INTS)
def test_varints_and_zigzag_are_equal(n):
    assert twire.varint(n) == jwire.varint(n)
    assert twire.zigzag(n) == jwire.zigzag(n)
    enc = twire.varint(n)
    assert twire.read_varint(enc, 0) == jwire.read_varint(enc, 0)
    assert twire.unzigzag(twire.zigzag(n)) == n


@pytest.mark.parametrize("value", ["", "network-flows", "é" * 40, None])
def test_strings_bytes_and_arrays_are_equal(value):
    assert twire.kstr(value) == jwire.kstr(value)
    raw = None if value is None else value.encode()
    assert twire.kbytes(raw) == jwire.kbytes(raw)
    items = [twire.kstr(value), b"\x00\x01"]
    assert twire.karray(items) == jwire.karray(items)
    r1, r2 = twire.Reader(twire.kstr(value)), jwire.Reader(jwire.kstr(value))
    assert r1.string() == r2.string() == value


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1000, 65536 + 3])
def test_crc32c_is_equal(size):
    data = np.random.default_rng(size).bytes(size)
    assert twire.crc32c(data) == jwire.crc32c(data) == jwire._crc32c_py(data)


def _messages(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(None if i % 3 == 0 else rng.bytes(int(rng.integers(1, 40))),
             rng.bytes(int(rng.integers(0, 300)))) for i in range(n)]


@pytest.mark.parametrize("n", [1, 5, 200])
def test_uncompressed_record_batch_is_equal(n, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.125)
    msgs = _messages(n, n)
    ours = tprod._record_batch(msgs)
    assert ours == jprod._record_batch(msgs)
    assert _batch_records(ours) == msgs


@pytest.mark.parametrize("n", [1, 5, 200])
def test_gzip_record_batch_is_equal_after_decompression(n):
    msgs = _messages(100 + n, n)
    ours = tprod._record_batch(msgs, "gzip")
    ref = jprod._record_batch(msgs, "gzip")
    assert _batch_records(ours) == _batch_records(ref) == msgs
    assert ours[21:23] == ref[21:23] == b"\x00\x01"  # attributes: gzip
    assert ours[57:61] == ref[57:61]


def _batch_records(batch: bytes) -> list:
    """(key, value) of each record of a v2 record batch."""
    attrs = struct.unpack(">h", batch[21:23])[0]
    (n,) = struct.unpack(">i", batch[57:61])
    body = batch[61:]
    if attrs & 1:
        body = gzip.decompress(body)
    out, off = [], 0
    for _ in range(n):
        length, off = twire.read_varint(body, off)
        rec, off = body[off:off + length], off + length
        p = 1  # attributes
        _, p = twire.read_varint(rec, p)  # timestamp delta
        _, p = twire.read_varint(rec, p)  # offset delta
        klen, p = twire.read_varint(rec, p)
        key = None if klen < 0 else rec[p:p + klen]
        p += max(klen, 0)
        vlen, p = twire.read_varint(rec, p)
        out.append((key, rec[p:p + vlen]))
    return out


REPORT = {"Type": "sketch_window_report", "Window": 3, "Records": 12345.0,
          "Bytes": 9.5e6, "HeavyHitters": [{"SrcAddr": "10.0.0.1",
                                            "EstBytes": 1.5}],
          "SynFloodSuspectBuckets": [], "TimestampMs": 1700000000000}


@pytest.mark.parametrize("env", [
    {}, {"KAFKA_ASYNC": "false"}, {"KAFKA_COMPRESSION": "gzip"},
    {"KAFKA_ENABLE_SASL": "true", "KAFKA_ASYNC": "false"}],
    ids=["async", "acks", "gzip", "sasl"])
def test_report_sinks_send_the_same_messages(env, tmp_path):
    messages, tokens = [], []
    for pkg_cfg, sink_cls in ((jcfg, JSink), (tcfg, KafkaReportSink)):
        broker = FakeBroker(topic="sketch-reports",
                            require_sasl="KAFKA_ENABLE_SASL" in env)
        broker.start()
        try:
            (tmp_path / "id").write_text("agent\n")
            (tmp_path / "secret").write_text("s3cret\n")
            cfg = pkg_cfg.load_config({
                "SKETCH_REPORT_SINK": "kafka", "KAFKA_TOPIC": "sketch-reports",
                "KAFKA_BROKERS": f"127.0.0.1:{broker.port}",
                "KAFKA_SASL_CLIENT_ID_PATH": str(tmp_path / "id"),
                "KAFKA_SASL_CLIENT_SECRET_PATH": str(tmp_path / "secret"),
                **env})
            sink = sink_cls(cfg)
            sink(REPORT)
            sink(dict(REPORT, Window=4))
            deadline = time.monotonic() + 10
            while len(broker.produced) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            sink.close()
            messages.append([(pid, _batch_records(b))
                             for pid, b in broker.produced])
            tokens.append(list(broker.sasl_tokens))
        finally:
            broker.stop()
    assert messages[0] == messages[1]
    assert len(messages[1]) == 2
    (_, [(key, value)]), _ = messages[1]
    assert key == b"sketch_report" and json.loads(value) == REPORT
    assert tokens[0] == tokens[1]
    if "KAFKA_ENABLE_SASL" in env:
        assert tokens[1] and set(tokens[1]) == {b"\x00agent\x00s3cret"}
