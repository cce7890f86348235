"""Flow pipeline stages of the port's agent.

Copies of `netobserv_tpu/flow/`'s `MapTracer`, `RingBufTracer`,
`Accounter` and `CapacityLimiter`: threads joined by bounded queues,
MapTracer -> CapacityLimiter -> exporter (`exporter/base.QueueExporter`),
with the ring-buffer fallback RingBufTracer -> Accounter feeding the same
limiter (ENABLE_FLOWS_RINGBUF_FALLBACK), lossy at one point, the limiter.
With ENABLE_OPENSSL_TRACKING the agent adds `ssl_tracer.SSLTracer` and
`ssl_correlator.SSLCorrelator`, whose credits the map tracer and the
accounter attach to records.
"""

from netobserv_tpu_torch.flow.map_tracer import MapTracer  # noqa: F401
from netobserv_tpu_torch.flow.ringbuf_tracer import RingBufTracer  # noqa: F401
from netobserv_tpu_torch.flow.accounter import Accounter  # noqa: F401
from netobserv_tpu_torch.flow.limiter import CapacityLimiter  # noqa: F401
