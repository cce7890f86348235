"""The port's exporters and the EXPORT switch.

`base.py` holds the `Exporter` seam and the pipeline's terminal stage
(`QueueExporter`); `torch_sketch.py` the sketch exporter, with its
report renderer and sinks in `report.py` and its gRPC delta sink in
`federation.py`; `stdout_json.py`, `grpc_flow.py`, `ipfix.py` and
`kafka.py` the record exporters, on `pb_convert.py` and the port's own
gRPC transport (`grpc/h2.py`). `build_exporter` is a copy of the
reference's switch (`netobserv_tpu/exporter/__init__.py:23-55`); only
EXPORT=direct-flp still raises `ValueError`, naming ROADMAP A8.7b.
"""

from netobserv_tpu_torch import config as c


def build_exporter(cfg, metrics=None):
    """The exporter an `AgentConfig` asks for (EXPORT), as
    `build_exporter` (`netobserv_tpu/exporter/__init__.py:23-55`)."""
    if cfg.export == c.EXPORT_STDOUT:
        from netobserv_tpu_torch.exporter.stdout_json import (
            StdoutJSONExporter,
        )
        return StdoutJSONExporter(metrics=metrics)
    if cfg.export == c.EXPORT_DIRECT_FLP:
        raise ValueError(
            f"EXPORT={cfg.export!r}: the direct-FLP exporter is not ported "
            "(ROADMAP A8.7b)")
    if cfg.export == c.EXPORT_TPU_SKETCH:
        from netobserv_tpu_torch.exporter.torch_sketch import (
            TorchSketchExporter,
        )
        return TorchSketchExporter.from_config(cfg, metrics=metrics)
    if cfg.export == c.EXPORT_GRPC:
        from netobserv_tpu_torch.exporter.grpc_flow import GRPCFlowExporter
        return GRPCFlowExporter(
            host=cfg.target_host, port=cfg.target_port,
            max_flows_per_message=cfg.grpc_message_max_flows,
            tls_ca=cfg.target_tls_ca_cert_path,
            tls_cert=cfg.target_tls_user_cert_path,
            tls_key=cfg.target_tls_user_key_path,
            reconnect_every_s=cfg.grpc_reconnect_timer or None,
            reconnect_randomization_s=cfg.grpc_reconnect_timer_randomization,
            metrics=metrics)
    if cfg.export in (c.EXPORT_IPFIX_UDP, c.EXPORT_IPFIX_TCP):
        from netobserv_tpu_torch.exporter.ipfix import IPFIXExporter
        return IPFIXExporter(
            host=cfg.target_host, port=cfg.target_port,
            transport="udp" if cfg.export == c.EXPORT_IPFIX_UDP else "tcp",
            metrics=metrics)
    if cfg.export == c.EXPORT_KAFKA:
        from netobserv_tpu_torch.exporter.kafka import KafkaExporter
        return KafkaExporter.from_config(cfg, metrics=metrics)
    raise ValueError(f"unknown exporter {cfg.export!r}")
