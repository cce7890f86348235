"""Minimal pure-Python Kafka client.

A copy of `netobserv_tpu/kafka/` (`wire.py`, `producer.py`,
`consumer.py`): the wire protocol spoken directly with `socket`, `ssl`,
`gzip` and `struct` — Metadata (v1) for leader discovery, Produce (v3,
record-batch v2 with crc32c), ListOffsets (v1) and Fetch (v4) for the
consumer, SaslHandshake/SaslAuthenticate (PLAIN/SCRAM) and TLS sockets.
The window reports' Kafka sink (`exporter/report.KafkaReportSink`) and
EXPORT=kafka produce through it; `consumer.KafkaConsumer` reads a topic
back.
"""

from netobserv_tpu_torch.kafka.producer import KafkaProducer  # noqa: F401
