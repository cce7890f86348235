"""The port's wire messages, written and parsed without protobuf.

`flow.py` is the flow wire (`proto/flow.proto`, which the JAX package
serializes through the generated `netobserv_tpu/pb/flow_pb2.py`) and
`packet.py` the packet-capture wire (`proto/packet.proto`, `packet_pb2`);
the delta wire's messages live in `federation/pbwire.py`, whose
`Message` all build on.
"""
