"""gRPC packet exporter (PCA): pcap-framed packet stream to a collector.

A copy of `netobserv_tpu/exporter/grpc_packets.py` (`GRPCPacketExporter`,
lines 50-71), whose reference is `pkg/exporter/grpc_packets.go`: the pcap
file header goes out once, then each packet as a pcap-framed chunk
wrapped in pbpacket.Packet. The client and the in-process collector are
the port's (`grpc/packet.py`), re-exported here under the reference's
names.
"""

from __future__ import annotations

import logging
from typing import Optional

from netobserv_tpu_torch.grpc.packet import (  # noqa: F401
    PacketClient, start_packet_collector,
)
from netobserv_tpu_torch.model.packet_record import (
    PacketRecord, frame_packet, pcap_file_header,
)

log = logging.getLogger("netobserv_tpu_torch.exporter.grpc_packets")


class GRPCPacketExporter:
    """Terminal for PCA packet batches."""

    name = "grpc-packets"

    def __init__(self, host: str, port: int,
                 client: Optional[PacketClient] = None,
                 tls_ca: str = "", tls_cert: str = "", tls_key: str = ""):
        self._client = client or PacketClient(host, port, tls_ca=tls_ca,
                                              tls_cert=tls_cert,
                                              tls_key=tls_key)
        self._sent_header = False

    def export_packets(self, packets: list[PacketRecord]) -> None:
        if not self._sent_header:
            self._client.send_bytes(pcap_file_header())
            self._sent_header = True
        for rec in packets:
            self._client.send_bytes(frame_packet(rec))

    def close(self) -> None:
        self._client.close()
