"""Flow pipeline stages of the port's agent.

Copies of `netobserv_tpu/flow/`'s `MapTracer` and `CapacityLimiter`:
threads joined by bounded queues, MapTracer -> CapacityLimiter ->
exporter (`exporter/base.QueueExporter`), lossy at one point, the
limiter. The ring-buffer fallback path (`RingBufTracer`, `Accounter`) is
ROADMAP A8.
"""

from netobserv_tpu_torch.flow.limiter import CapacityLimiter  # noqa: F401
from netobserv_tpu_torch.flow.map_tracer import MapTracer  # noqa: F401
