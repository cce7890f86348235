"""PCA packet records and pcap framing.

A copy of `netobserv_tpu/model/packet_record.py` (lines 1-56), whose
reference is `pkg/model/packet_record.go` and
`pkg/utils/packets/packets.go`: the classic-pcap file and packet
headers (`scenarios/synth.py` writes its pcaps with them), `PacketRecord`,
`frame_packet` and `packets_from_events`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from netobserv_tpu_torch.model import binfmt

PCAP_MAGIC = 0xA1B2C3D4
PCAP_VERSION_MAJOR = 2
PCAP_VERSION_MINOR = 4
LINKTYPE_ETHERNET = 1
#: the datapath's packet payload cap
PCAP_SNAP_LEN = binfmt.MAX_PAYLOAD_SIZE


@dataclass
class PacketRecord:
    if_index: int
    timestamp_ns: int  # wall clock after reconstruction
    payload: bytes


def pcap_file_header(snap_len: int = PCAP_SNAP_LEN) -> bytes:
    return struct.pack(
        "<IHHiIII", PCAP_MAGIC, PCAP_VERSION_MAJOR, PCAP_VERSION_MINOR,
        0, 0, snap_len, LINKTYPE_ETHERNET)


def pcap_packet_header(ts_ns: int, captured_len: int, orig_len: int) -> bytes:
    return struct.pack(
        "<IIII", ts_ns // 1_000_000_000, (ts_ns % 1_000_000_000) // 1000,
        captured_len, orig_len)


def frame_packet(rec: PacketRecord) -> bytes:
    """One pcap-framed packet (header + captured payload)."""
    captured = len(rec.payload)
    return pcap_packet_header(rec.timestamp_ns, captured, captured) + \
        rec.payload


def packets_from_events(events: np.ndarray, mono_to_wall_offset_ns: int
                        ) -> list[PacketRecord]:
    """Decode a PACKET_EVENT structured array into PacketRecords."""
    out = []
    for i in range(len(events)):
        e = events[i]
        n = min(int(e["pkt_len"]), binfmt.MAX_PAYLOAD_SIZE)
        out.append(PacketRecord(
            if_index=int(e["if_index"]),
            timestamp_ns=int(e["timestamp_ns"]) + mono_to_wall_offset_ns,
            payload=e["payload"][:n].tobytes(),
        ))
    return out
