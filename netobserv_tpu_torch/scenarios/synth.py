"""Deterministic packet/pcap synthesis for the scenario zoo.

A copy of `netobserv_tpu/scenarios/synth.py` (lines 1-133); the port's
scenario zoo (`scenarios/zoo.py`), its tests and `chip_smoke.py` build
their pcaps with it.

Everything is seed-free and arithmetic: a scenario built twice produces
byte-identical pcaps, so detection-quality assertions never chase RNG
noise. The one deliberate liberty vs a real capture: the IPv4 header's
``total_length`` may CLAIM more bytes than the frame carries ("jumbo"
accounting) — the replay parser accounts flows by the claimed IP length
(the kernel datapath's skb->len analog), which lets an elephant flow carry
megabytes without megabyte pcaps.
"""

from __future__ import annotations

import socket
import struct

from netobserv_tpu_torch.model.packet_record import pcap_file_header

#: classic-pcap epoch base for every scenario (any fixed wall time works:
#: the replay fetcher rebases capture timestamps to the live monotonic
#: clock before the agent sees them)
T0_SEC = 1_700_000_000


def eth(proto: int = 0x0800) -> bytes:
    return b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", proto)


def ipv4(src: str, dst: str, proto: int, payload_len: int,
         claim_len: int | None = None) -> bytes:
    """20-byte IPv4 header. `claim_len` overrides the total_length field
    (jumbo accounting; defaults to the honest 20 + payload_len)."""
    total = claim_len if claim_len is not None else 20 + payload_len
    return struct.pack(">BBHHHBBH4s4s", 0x45, 0, total, 1, 0, 64, proto,
                       0, socket.inet_aton(src), socket.inet_aton(dst))


def ipv6(src: str, dst: str, proto: int, payload_len: int,
         claim_len: int | None = None) -> bytes:
    """40-byte IPv6 header. `claim_len` claims a TOTAL IP length (header +
    payload, the v4-semantics twin — the replay parser accounts
    payload_length + 40), so scenarios state jumbo bytes identically for
    both families."""
    plen = (claim_len - 40) if claim_len is not None else payload_len
    return struct.pack(">IHBB16s16s", 0x6000_0000, plen, proto, 64,
                       socket.inet_pton(socket.AF_INET6, src),
                       socket.inet_pton(socket.AF_INET6, dst))


def canonical_ip(addr: str) -> str:
    """The textual form the agent renders (`ip_from_16`): canonical
    compressed v6, dotted-quad v4 — scenarios canonicalize their truth
    through this so string comparison never chases formatting."""
    if ":" in addr:
        return socket.inet_ntop(socket.AF_INET6,
                                socket.inet_pton(socket.AF_INET6, addr))
    return addr


def tcp(sport: int, dport: int, flags: int) -> bytes:
    """20-byte TCP header with the given raw flags byte."""
    return struct.pack(">HHIIBBHHH", sport, dport, 1, 0, 0x50, flags,
                       64240, 0, 0)


def udp(sport: int, dport: int, payload: bytes = b"") -> bytes:
    return struct.pack(">HHHH", sport, dport, 8 + len(payload), 0) + payload


def dns_query(txid: int, pad: int = 68) -> bytes:
    """Minimal DNS header (QR=0) + question padding."""
    return struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0) + b"\x00" * pad


def dns_response(txid: int, rcode: int = 0, pad: int = 80) -> bytes:
    return struct.pack(">HHHHHH", txid, 0x8180 | (rcode & 0xF),
                       1, 1, 0, 0) + b"\x00" * pad


def quic_long_header(version: int = 1, pad: int = 1195) -> bytes:
    """QUIC long-header payload (first byte 0b11......) — what the replay
    parser's UDP/443 probe recognizes, like the kernel datapath's."""
    return b"\xc3" + struct.pack(">I", version) + b"\x00" * pad


class PcapBuilder:
    """Accumulates (timestamp, frame) pairs and writes a classic pcap.
    Tracks per-flow ACCOUNTED bytes (claimed IP length + 14B ethernet, the
    replay parser's rule) so scenarios can state exact ground truth."""

    def __init__(self):
        self._packets: list[bytes] = []
        #: (src, dst, sport, dport, proto) -> accounted bytes
        self.flow_bytes: dict[tuple, int] = {}
        self.flow_packets: dict[tuple, int] = {}

    def __len__(self) -> int:
        return len(self._packets)

    def add(self, at_us: int, src: str, dst: str, proto: int, l4: bytes,
            claim_len: int | None = None, sport: int = 0,
            dport: int = 0) -> None:
        """One IP frame at T0 + at_us — IPv6 when the addresses carry a
        colon, IPv4 otherwise (mixing families in one pcap is how the
        ipv6_heavy scenario exercises the v6 spill lane under load).
        `sport`/`dport` are only for the ground-truth ledger (the l4
        bytes already carry them); `claim_len` always claims a TOTAL IP
        length, both families."""
        if ":" in src:
            ip_hdr = ipv6(src, dst, proto, len(l4), claim_len)
            frame = eth(0x86DD) + ip_hdr + l4
            honest = 40 + len(l4)
        else:
            frame = eth() + ipv4(src, dst, proto, len(l4), claim_len) + l4
            honest = 20 + len(l4)
        hdr = struct.pack("<IIII", T0_SEC + at_us // 1_000_000,
                          at_us % 1_000_000, len(frame), len(frame))
        self._packets.append(hdr + frame)
        key = (src, dst, sport, dport, proto)
        accounted = (claim_len if claim_len is not None else honest) + 14
        self.flow_bytes[key] = self.flow_bytes.get(key, 0) + accounted
        self.flow_packets[key] = self.flow_packets.get(key, 0) + 1

    def write(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(pcap_file_header(65535) + b"".join(self._packets))


def heavy_entry(src: str, dst: str, sport: int, dport: int,
                proto: int) -> dict:
    """A ground-truth heavy-hitter key in the /query/topk entry shape."""
    return {"SrcAddr": src, "DstAddr": dst, "SrcPort": sport,
            "DstPort": dport, "Proto": proto}
