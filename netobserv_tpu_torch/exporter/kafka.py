"""Kafka flow exporter: one pbflow Record a message, keyed so both
directions of a conversation land on one consumer.

A copy of `netobserv_tpu/exporter/kafka.py` (lines 1-69) on the port's
`kafka/producer.py` and its own flow wire (`pb/flow.py`). A message's
value is protobuf's deterministic serialization of the reference's
`record_to_pb(r)`. The reference calls `SerializeToString()` without
`deterministic`, which writes a network event's map in upb's table
order, so for a record with network events the two values hold the same
entries in another order and parse to equal messages; every other
value is equal byte for byte.
"""

from __future__ import annotations

import logging

from netobserv_tpu_torch.exporter.base import Exporter
from netobserv_tpu_torch.exporter.pb_convert import record_to_pb
from netobserv_tpu_torch.kafka.producer import (
    KafkaProducer, SASLSettings, TLSSettings,
)
from netobserv_tpu_torch.model.record import Record

log = logging.getLogger("netobserv_tpu_torch.exporter.kafka")


def partition_key(r: Record) -> bytes:
    """Direction-normalized key: sorted (src_ip, dst_ip) concatenation
    (`kafka.py:23-26`)."""
    a, b = r.key.src_ip, r.key.dst_ip
    return a + b if a <= b else b + a


class KafkaExporter(Exporter):
    """`KafkaExporter` (`kafka.py:29-62`)."""

    name = "kafka"

    def __init__(self, producer: KafkaProducer, batch_messages: int = 1000):
        self._producer = producer
        self._batch_messages = batch_messages

    @classmethod
    def from_config(cls, cfg, metrics=None) -> "KafkaExporter":
        """`KafkaExporter.from_config` (`kafka.py:37-54`)."""
        sasl = SASLSettings(enable=cfg.kafka_enable_sasl,
                            mechanism=cfg.kafka_sasl_type)
        if sasl.enable:
            sasl.username = _read_secret(cfg.kafka_sasl_client_id_path)
            sasl.password = _read_secret(cfg.kafka_sasl_client_secret_path)
        producer = KafkaProducer(
            brokers=cfg.kafka_brokers, topic=cfg.kafka_topic,
            acks=0 if cfg.kafka_async else 1,
            tls=TLSSettings(
                enable=cfg.kafka_enable_tls,
                insecure_skip_verify=cfg.kafka_tls_insecure_skip_verify,
                ca_path=cfg.kafka_tls_ca_cert_path,
                cert_path=cfg.kafka_tls_user_cert_path,
                key_path=cfg.kafka_tls_user_key_path),
            sasl=sasl, compression=cfg.kafka_compression)
        return cls(producer, batch_messages=cfg.kafka_batch_messages)

    def export_batch(self, records: list[Record]) -> None:
        msgs = [(partition_key(r), record_to_pb(r).SerializeToString())
                for r in records]
        for start in range(0, len(msgs), self._batch_messages):
            self._producer.send_batch(msgs[start:start + self._batch_messages])

    def close(self) -> None:
        self._producer.close()


def _read_secret(path: str) -> str:
    """`_read_secret` (`kafka.py:65-69`)."""
    if not path:
        return ""
    with open(path) as fh:
        return fh.read().strip()
