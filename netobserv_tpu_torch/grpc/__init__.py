"""gRPC plumbing without grpcio: the port's own HTTP/2 transport
(`h2.py`), the flow collector's client and server (`flow.py`) and the
federation push's (`federation.py`).

The port's counterpart of `netobserv_tpu/grpc/__init__.py` (lines 1-11):
the method paths and messages match `proto/flow.proto` and
`proto/sketch_delta.proto`, and the messages are the port's own wire
(`pb/flow.py`, `federation/pbwire.py`).
"""

from netobserv_tpu_torch.grpc.flow import (  # noqa: F401
    FlowClient, start_flow_collector,
)
