"""The port's exporters and the EXPORT switch.

`base.py` holds the `Exporter` seam and the pipeline's terminal stage
(`QueueExporter`); `torch_sketch.py` the sketch exporter, the port's only
backend; `report.py` its report renderer and sinks. `build_exporter` is
the port's own switch (the reference's is `netobserv_tpu/exporter/
__init__.py:23-55`): EXPORT=tpu-sketch builds
`TorchSketchExporter.from_config`, and every other backend, the
reference's default `grpc` among them, raises `ValueError` naming ROADMAP
A8.
"""

from netobserv_tpu_torch.config import EXPORT_TPU_SKETCH


def build_exporter(cfg, metrics=None):
    """The exporter an `AgentConfig` asks for (EXPORT)."""
    if cfg.export == EXPORT_TPU_SKETCH:
        from netobserv_tpu_torch.exporter.torch_sketch import (
            TorchSketchExporter,
        )
        return TorchSketchExporter.from_config(cfg, metrics=metrics)
    raise ValueError(
        f"EXPORT={cfg.export!r}: the port exports only to "
        f"{EXPORT_TPU_SKETCH!r}; the other exporters are not ported "
        "(ROADMAP A8)")
