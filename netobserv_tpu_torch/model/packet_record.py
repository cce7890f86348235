"""pcap framing: the classic-pcap file and packet headers.

A copy of the pcap part of `netobserv_tpu/model/packet_record.py`
(`pcap_file_header`, `pcap_packet_header` and their constants, lines
12-37); `scenarios/synth.py` writes its pcaps with them. The PCA packet
records (`PacketRecord`, `frame_packet`, `packets_from_events`) are
ROADMAP A8.
"""

from __future__ import annotations

import struct

from netobserv_tpu_torch.model import binfmt

PCAP_MAGIC = 0xA1B2C3D4
PCAP_VERSION_MAJOR = 2
PCAP_VERSION_MINOR = 4
LINKTYPE_ETHERNET = 1
#: the datapath's packet payload cap
PCAP_SNAP_LEN = binfmt.MAX_PAYLOAD_SIZE


def pcap_file_header(snap_len: int = PCAP_SNAP_LEN) -> bytes:
    return struct.pack(
        "<IHHiIII", PCAP_MAGIC, PCAP_VERSION_MAJOR, PCAP_VERSION_MINOR,
        0, 0, snap_len, LINKTYPE_ETHERNET)


def pcap_packet_header(ts_ns: int, captured_len: int, orig_len: int) -> bytes:
    return struct.pack(
        "<IIII", ts_ns // 1_000_000_000, (ts_ns % 1_000_000_000) // 1000,
        captured_len, orig_len)
