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
- The consumer (`kafka/consumer.py`), the twins of
  tests/test_kafka_broker.py:263-360: `decode_record_batches` on the same
  blobs gives the reference's (key, value) pairs and next offset, or its
  error, for good batches (uncompressed and gzip), a truncated tail, a
  runt, a corrupt short batch alone and after a good one, a legacy-magic
  set and an unsupported codec; `KafkaConsumer` reads back through
  `FakeBroker` what the port's producer sent, as the reference's consumer
  reads it, and nothing more on a second poll; and an EXPORT=kafka
  pbflow round trip (the port's `KafkaExporter`, then each package's
  consumer and pbflow parser) gives equal records.
"""

import gzip
import json
import struct
import time

import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.exporter.tpu_sketch import KafkaReportSink as JSink
from netobserv_tpu.kafka import consumer as jcons
from netobserv_tpu.kafka import producer as jprod
from netobserv_tpu.kafka import wire as jwire
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.exporter.report import KafkaReportSink
from netobserv_tpu_torch.kafka import consumer as tcons
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


# ---------------------------------------------------------------- consumer

_GOOD = [(b"k1", b"v1"), (None, b"v2"), (b"", b"x" * 1000)]


def _blob(case: str) -> bytes:
    """The blobs of tests/test_kafka_broker.py:263-322, by name."""
    good = tprod._record_batch(_GOOD[:1])
    if case in ("none", "gzip"):
        return tprod._record_batch(_GOOD, compression=case)
    if case == "truncated_tail":
        two = tprod._record_batch(_GOOD[:1]) + tprod._record_batch(_GOOD[1:])
        return two + two[:10]
    if case == "runt":
        runt = struct.pack(">q", 7) + struct.pack(">i", 2) + b"\x00\x00"
        return good + runt + good
    if case.startswith("corrupt"):
        bad_len = int(case.split("_")[1])
        corrupt = (struct.pack(">q", 7) + struct.pack(">i", bad_len)
                   + b"\x00\x00\x00\x00\x02" + b"\x00" * (bad_len - 5))
        return corrupt if case.endswith("alone") else good + corrupt
    if case == "legacy":
        return good + struct.pack(">q", 7) + struct.pack(">i", 17) \
            + b"\x00\x00\x00\x00\x01" + b"\x00" * 12
    if case == "snappy":
        batch = bytearray(tprod._record_batch(_GOOD))
        batch[21:23] = struct.pack(">h", 2)
        return bytes(batch)
    if case == "seeded":
        return b"".join(tprod._record_batch(_messages(s, 1 + s * 7),
                                            "gzip" if s % 2 else "none")
                        for s in range(6))
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "none", "gzip", "truncated_tail", "runt", "corrupt_5", "corrupt_17",
    "corrupt_48", "corrupt_5_alone", "corrupt_48_alone", "legacy", "snappy",
    "seeded"])
def test_record_batches_decode_as_the_reference(case):
    blob = _blob(case)
    if case == "snappy":
        for mod in (tcons, jcons):
            with pytest.raises(ValueError, match="codec 2"):
                mod.decode_record_batches(blob)
        return
    got = tcons.decode_record_batches(blob)
    assert got == jcons.decode_record_batches(blob)
    if case in ("none", "gzip"):
        assert got == (_GOOD, 3)
    if case.endswith("alone"):
        assert got == ([], None)
    if case == "legacy":
        assert got == (_GOOD[:1], 8)


def _poll_all(consumer, want: int) -> list:
    got = []
    for _ in range(5):
        got.extend(consumer.poll())
        if len(got) >= want:
            break
    return got


def test_consumer_reads_what_the_producer_sent():
    broker = FakeBroker()
    broker.start()
    try:
        brokers = [f"127.0.0.1:{broker.port}"]
        producer = tprod.KafkaProducer(brokers=brokers, topic=broker.topic)
        sent = [(f"k{i}".encode(), f"value-{i}".encode()) for i in range(20)]
        producer.send_batch(sent[:12])
        producer.send_batch(sent[12:])
        producer.close()
        ours = tcons.KafkaConsumer(brokers=brokers, topic=broker.topic)
        ref = jcons.KafkaConsumer(brokers=brokers, topic=broker.topic)
        got, want = _poll_all(ours, len(sent)), _poll_all(ref, len(sent))
        assert sorted(got) == sorted(sent)
        assert got == want
        assert ours._offsets == ref._offsets
        assert sum(ours._offsets.values()) == len(sent)
        assert ours.poll() == [] == ref.poll()
        ours.close()
        ref.close()
    finally:
        broker.stop()


def test_export_then_consume_pbflow_round_trip():
    """EXPORT=kafka's pbflow messages come back through each package's
    consumer and parser with the records intact."""
    from netobserv_tpu.exporter import pb_convert as rconv
    from netobserv_tpu.pb import flow_pb2
    from netobserv_tpu_torch.exporter import pb_convert as pconv
    from netobserv_tpu_torch.exporter.kafka import KafkaExporter
    from netobserv_tpu_torch.pb import flow as pbflow
    from tests.test_torch_pbflow import as_tuple, seeded_records

    broker = FakeBroker()
    broker.start()
    try:
        brokers = [f"127.0.0.1:{broker.port}"]
        exp = KafkaExporter(tprod.KafkaProducer(brokers=brokers,
                                                topic=broker.topic))
        sent = seeded_records(41, 25)
        exp.export_batch(sent)
        exp.close()
        ours = tcons.KafkaConsumer(brokers=brokers, topic=broker.topic)
        ref = jcons.KafkaConsumer(brokers=brokers, topic=broker.topic)
        got = [pconv.pb_to_record(pbflow.Record.FromString(v))
               for _, v in _poll_all(ours, len(sent))]
        want = [rconv.pb_to_record(flow_pb2.Record.FromString(v))
                for _, v in _poll_all(ref, len(sent))]
        ours.close()
        ref.close()
    finally:
        broker.stop()
    assert len(got) == len(want) == len(sent)
    assert [as_tuple(r) for r in got] == [as_tuple(r) for r in want]
    assert sorted(as_tuple(r) for r in got) == sorted(
        as_tuple(pconv.pb_to_record(pconv.record_to_pb(r))) for r in sent)
