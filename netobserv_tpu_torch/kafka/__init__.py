"""Minimal pure-Python Kafka produce-only client.

A copy of `netobserv_tpu/kafka/` (`wire.py`, `producer.py`): the wire
protocol spoken directly with `socket`, `ssl`, `gzip` and `struct` —
Metadata (v1) for leader discovery, Produce (v3, record-batch v2 with
crc32c), SaslHandshake/SaslAuthenticate (PLAIN/SCRAM) and TLS sockets.
The window reports' Kafka sink (`exporter/report.KafkaReportSink`) uses
it. The consumer (`netobserv_tpu/kafka/consumer.py`) is ROADMAP A8.
"""

from netobserv_tpu_torch.kafka.producer import KafkaProducer  # noqa: F401
