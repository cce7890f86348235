"""Replay fetchers: synthetic traffic and pcap files as a datapath.

A copy of `netobserv_tpu/datapath/replay.py` (`SyntheticFetcher`,
`PcapReplayFetcher`, `PcapPacketFetcher`, `_parse_packet`, lines 1-411).
The first two implement the `FlowFetcher` seam (`fetcher.py`), so the
whole agent runs without kernel privileges: `DATAPATH=synthetic` and
`DATAPATH=pcap:<file>` (`agent/agent.build_fetcher`).
`PcapPacketFetcher` is the packet source of PCA mode (ENABLE_PCA with
`DATAPATH=pcap:<file>`, `__main__.py`).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Optional

import numpy as np

from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.flow import (
    GlobalCounter, classify_tcp_flags, ip_to_16,
)


class SyntheticFetcher:
    """Generates zipf-skewed synthetic flows, aggregated per eviction window —
    what the kernel map would hold after one CACHE_ACTIVE_TIMEOUT."""

    def __init__(self, flows_per_eviction: int = 1000, n_distinct: int = 10000,
                 zipf_a: float = 1.2, seed: int = 0):
        self._n = flows_per_eviction
        self._rng = np.random.default_rng(seed)
        self._universe = self._make_universe(n_distinct)
        self._zipf_a = zipf_a
        self.attached: dict[int, str] = {}

    def _make_universe(self, n: int) -> np.ndarray:
        keys = np.zeros(n, dtype=binfmt.FLOW_KEY_DTYPE)
        ips = self._rng.integers(1, 2**32 - 1, size=(n, 2), dtype=np.uint64)
        for i in range(n):
            keys[i]["src_ip"] = np.frombuffer(
                ip_to_16(struct.pack(">I", int(ips[i, 0]) & 0xFFFFFFFF)), np.uint8)
            keys[i]["dst_ip"] = np.frombuffer(
                ip_to_16(struct.pack(">I", int(ips[i, 1]) & 0xFFFFFFFF)), np.uint8)
        keys["src_port"] = self._rng.integers(1024, 65535, n)
        keys["dst_port"] = self._rng.choice(
            [53, 80, 123, 443, 8080], n).astype(np.uint16)
        keys["proto"] = self._rng.choice([6, 17], n).astype(np.uint8)
        return keys

    def lookup_and_delete(self) -> EvictedFlows:
        n = self._n
        ranks = np.minimum(self._rng.zipf(self._zipf_a, n) - 1,
                           len(self._universe) - 1)
        # aggregate duplicates like the kernel map would
        uniq, inv = np.unique(ranks, return_inverse=True)
        events = np.zeros(len(uniq), dtype=binfmt.FLOW_EVENT_DTYPE)
        events["key"] = self._universe[uniq]
        pkts = np.zeros(len(uniq), np.int64)
        byts = np.zeros(len(uniq), np.int64)
        np.add.at(pkts, inv, self._rng.integers(1, 10, n))
        np.add.at(byts, inv, self._rng.integers(64, 9000, n))
        now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        events["stats"]["packets"] = pkts
        events["stats"]["bytes"] = byts
        events["stats"]["first_seen_ns"] = now - 5_000_000_000
        events["stats"]["last_seen_ns"] = now
        events["stats"]["eth_protocol"] = 0x0800
        events["stats"]["if_index_first"] = 1
        extra = np.zeros(len(uniq), dtype=binfmt.EXTRA_REC_DTYPE)
        extra["rtt_ns"] = self._rng.integers(100_000, 200_000_000, len(uniq))
        return EvictedFlows(events, extra=extra)

    def read_ringbuf(self, timeout_s: float) -> Optional[bytes]:
        time.sleep(timeout_s)
        return None

    def read_global_counters(self) -> dict[GlobalCounter, int]:
        return {}

    def purge_stale(self, older_than_s: float) -> int:
        return 0

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None:
        self.attached[if_index] = if_name

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None:
        self.attached.pop(if_index, None)

    def close(self) -> None:
        pass


class PcapReplayFetcher:
    """Parses a pcap file and aggregates its packets into flow events,
    releasing one eviction window per lookup_and_delete() call.

    Minimal classic-pcap parser (no external deps): ethernet/IPv4/IPv6 + TCP/
    UDP/ICMP; non-IP packets are skipped.

    Two kernel-datapath feature twins run during the parse so replayed
    traffic exercises the same sketch signal planes as live capture
    (the scenario zoo leans on both — netobserv_tpu/scenarios):

    - DNS latency: UDP port-53 query/response pairs are correlated by
      transaction id + client endpoint (the kernel's dns tracker analog);
      the measured latency rides the RESPONSE flow's DNS feature record.
    - QUIC: a long-header first byte on UDP/443 marks the flow's QUIC
      feature record (the kernel datapath's payload probe analog).
    """

    def __init__(self, path: str, window_s: float = 5.0):
        self._windows = self._parse(path, window_s)
        self._idx = 0
        self._lock = threading.Lock()
        self.attached: dict[int, str] = {}
        # rebase capture timestamps into the monotonic domain so the standard
        # mono->wall reconstruction yields sane (current) wall times
        if self._windows:
            first_ts = min(int(w[0]["stats"]["first_seen_ns"].min())
                           for w in self._windows if len(w[0]))
            offset = time.clock_gettime_ns(time.CLOCK_MONOTONIC) - first_ts
            for w in self._windows:
                for arr in w:
                    if arr is None:
                        continue
                    stats = arr["stats"] if "stats" in (
                        arr.dtype.names or ()) else arr
                    for fld in ("first_seen_ns", "last_seen_ns"):
                        stats[fld] = (stats[fld].astype(np.int64) + offset
                                      ).astype(np.uint64)

    @property
    def n_windows(self) -> int:
        return len(self._windows)

    def exhausted(self) -> bool:
        with self._lock:
            return self._idx >= len(self._windows)

    def _parse(self, path: str, window_s: float) -> list[np.ndarray]:
        with open(path, "rb") as fh:
            data = fh.read()
        if len(data) < 24:
            raise ValueError(f"not a pcap file (too short): {path}")
        magic = struct.unpack("<I", data[:4])[0]
        if magic == 0xA1B2C3D4:
            endian, tscale = "<", 1_000  # usec -> ns
        elif magic == 0xA1B23C4D:
            endian, tscale = "<", 1  # nanosecond pcap
        elif magic == 0xD4C3B2A1:
            endian, tscale = ">", 1_000
        else:
            raise ValueError(f"not a pcap file: magic {magic:#x}")
        linktype = struct.unpack(endian + "I", data[20:24])[0]
        if linktype != 1:
            raise ValueError(f"unsupported linktype {linktype} (want ethernet)")
        off = 24
        flows: dict[bytes, list] = {}
        windows: list[tuple] = []
        window_start: Optional[int] = None
        #: (txid, client ip, client port) -> send timestamp (the kernel dns
        #: tracker's in-flight map analog; response packets pop it). The
        #: client endpoint is part of the key: 16-bit txids collide
        #: routinely across clients in real captures
        pending_dns: dict[tuple, int] = {}
        while off + 16 <= len(data):
            ts_sec, ts_sub, incl, orig = struct.unpack(
                endian + "IIII", data[off:off + 16])
            off += 16
            pkt = data[off:off + incl]
            off += incl
            ts_ns = ts_sec * 1_000_000_000 + ts_sub * tscale
            if window_start is None:
                window_start = ts_ns
            if ts_ns - window_start > window_s * 1e9 and flows:
                windows.append(self._to_events(flows))
                flows = {}
                window_start = ts_ns
            parsed = _parse_packet(pkt)
            if parsed is None:
                continue
            key_bytes, length, flags, meta = parsed
            ent = flows.get(key_bytes)
            if ent is None:
                # [bytes, pkts, flags, first, last,
                #  dns_lat_ns, dns_id, dns_errno, quic_ver, quic_long]
                ent = flows[key_bytes] = [length, 1, flags, ts_ns, ts_ns,
                                          0, 0, 0, 0, 0]
            else:
                ent[0] += length
                ent[1] += 1
                ent[2] |= flags
                ent[4] = ts_ns
            if meta is None:
                continue
            if meta[0] == "dns":
                _kind, txid, is_response, rcode, client = meta
                if not is_response:
                    pending_dns[(txid, *client)] = ts_ns
                else:
                    sent = pending_dns.pop((txid, *client), None)
                    if sent is not None:
                        # latency rides the RESPONSE flow (server->client)
                        ent[5] = max(ent[5], ts_ns - sent)
                        ent[6] = txid
                        ent[7] = rcode
            else:  # quic long header
                ent[8] = meta[1]
                ent[9] = 1
        if flows:
            windows.append(self._to_events(flows))
        return windows

    @staticmethod
    def _to_events(flows: dict[bytes, list]) -> tuple:
        """One window's (events, dns, quic) arrays; the feature arrays are
        None when no flow in the window carried that feature (exactly like
        a kernel datapath with the tracker disabled)."""
        events = np.zeros(len(flows), dtype=binfmt.FLOW_EVENT_DTYPE)
        dns = quic = None
        for i, (kb, ent) in enumerate(flows.items()):
            (byts, pkts, flags, first, last,
             dns_lat, dns_id, dns_errno, quic_ver, quic_long) = ent
            events[i]["key"] = np.frombuffer(
                kb, dtype=binfmt.FLOW_KEY_DTYPE)[0]
            s = events[i]["stats"]
            s["bytes"] = byts
            s["packets"] = pkts
            s["tcp_flags"] = flags
            s["first_seen_ns"] = first
            s["last_seen_ns"] = last
            s["eth_protocol"] = 0x0800
            s["if_index_first"] = 1
            if dns_lat:
                if dns is None:
                    dns = np.zeros(len(flows), binfmt.DNS_REC_DTYPE)
                dns[i]["latency_ns"] = dns_lat
                dns[i]["dns_id"] = dns_id
                dns[i]["errno"] = dns_errno
                dns[i]["first_seen_ns"] = first
                dns[i]["last_seen_ns"] = last
            if quic_long:
                if quic is None:
                    quic = np.zeros(len(flows), binfmt.QUIC_REC_DTYPE)
                quic[i]["version"] = quic_ver
                quic[i]["seen_long_hdr"] = 1
                quic[i]["first_seen_ns"] = first
                quic[i]["last_seen_ns"] = last
        return events, dns, quic

    def lookup_and_delete(self) -> EvictedFlows:
        with self._lock:
            if self._idx >= len(self._windows):
                return EvictedFlows(
                    np.zeros(0, dtype=binfmt.FLOW_EVENT_DTYPE))
            events, dns, quic = self._windows[self._idx]
            self._idx += 1
        return EvictedFlows(events, dns=dns, quic=quic)

    def read_ringbuf(self, timeout_s: float) -> Optional[bytes]:
        time.sleep(timeout_s)
        return None

    def read_global_counters(self) -> dict[GlobalCounter, int]:
        return {}

    def purge_stale(self, older_than_s: float) -> int:
        return 0

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None:
        self.attached[if_index] = if_name

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None:
        self.attached.pop(if_index, None)

    def close(self) -> None:
        pass


#: dns/quic feature-probe ports (kernel twins: DNS_TRACKING_PORT and the
#: QUIC payload probe's UDP/443 gate)
_DNS_PORT = 53
_QUIC_PORT = 443


class PcapPacketFetcher:
    """PCA-mode packet source from a pcap file: each captured frame becomes a
    packet event (payload truncated at NO_MAX_PAYLOAD_SIZE), released in
    arrival order at a configurable pace. Implements the PacketFetcher seam
    so the full PCA pipeline (PerfTracer -> PerfBuffer -> pcap gRPC stream)
    runs without kernel privileges."""

    def __init__(self, path: str, rate_pps: float = 0.0):
        self._events: list[bytes] = []
        self._idx = 0
        self._lock = threading.Lock()
        self._interval = 1.0 / rate_pps if rate_pps > 0 else 0.0
        self._parse(path)

    def _parse(self, path: str) -> None:
        with open(path, "rb") as fh:
            data = fh.read()
        if len(data) < 24:
            raise ValueError(f"not a pcap file (too short): {path}")
        magic = struct.unpack("<I", data[:4])[0]
        if magic == 0xA1B2C3D4:
            endian, tscale = "<", 1_000
        elif magic == 0xA1B23C4D:
            endian, tscale = "<", 1
        elif magic == 0xD4C3B2A1:
            endian, tscale = ">", 1_000
        else:
            raise ValueError(f"not a pcap file: magic {magic:#x}")
        mono_now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
        first_ts = None
        off = 24
        while off + 16 <= len(data):
            ts_sec, ts_sub, incl, orig = struct.unpack(
                endian + "IIII", data[off:off + 16])
            off += 16
            payload = data[off:off + incl]
            off += incl
            ts_ns = ts_sec * 1_000_000_000 + ts_sub * tscale
            if first_ts is None:
                first_ts = ts_ns
            ev = np.zeros(1, dtype=binfmt.PACKET_EVENT_DTYPE)
            ev[0]["if_index"] = 1
            ev[0]["pkt_len"] = orig
            ev[0]["timestamp_ns"] = mono_now - first_ts + ts_ns
            n = min(len(payload), binfmt.MAX_PAYLOAD_SIZE)
            ev[0]["payload"][:n] = np.frombuffer(payload[:n], np.uint8)
            self._events.append(ev.tobytes())

    def read_packet(self, timeout_s: float) -> Optional[bytes]:
        with self._lock:
            if self._idx >= len(self._events):
                time.sleep(timeout_s)
                return None
            ev = self._events[self._idx]
            self._idx += 1
        if self._interval:
            time.sleep(self._interval)
        return ev

    def exhausted(self) -> bool:
        with self._lock:
            return self._idx >= len(self._events)

    def close(self) -> None:
        pass


def _parse_packet(pkt: bytes):
    """Ethernet frame -> (flow_key bytes, ip_len, tcp_flags, meta) or None.

    `meta` is the feature-probe result: ``("dns", txid, is_response,
    rcode, (client_ip16, client_port))`` for a UDP port-53 packet with a
    DNS header, ``("quic", version)`` for a long-header QUIC packet on
    UDP/443, else None.
    """
    if len(pkt) < 14:
        return None
    ethertype = struct.unpack(">H", pkt[12:14])[0]
    key = np.zeros(1, dtype=binfmt.FLOW_KEY_DTYPE)[0]
    if ethertype == 0x0800 and len(pkt) >= 34:  # IPv4
        ihl = (pkt[14] & 0x0F) * 4
        if len(pkt) < 14 + ihl:
            return None
        total_len = struct.unpack(">H", pkt[16:18])[0]
        proto = pkt[23]
        key["src_ip"] = np.frombuffer(ip_to_16(pkt[26:30]), np.uint8)
        key["dst_ip"] = np.frombuffer(ip_to_16(pkt[30:34]), np.uint8)
        l4 = pkt[14 + ihl:]
    elif ethertype == 0x86DD and len(pkt) >= 54:  # IPv6
        total_len = struct.unpack(">H", pkt[18:20])[0] + 40
        proto = pkt[20]
        key["src_ip"] = np.frombuffer(pkt[22:38], np.uint8)
        key["dst_ip"] = np.frombuffer(pkt[38:54], np.uint8)
        l4 = pkt[54:]
    else:
        return None
    key["proto"] = proto
    flags = 0
    meta = None
    if proto in (6, 17) and len(l4) >= 4:  # TCP/UDP ports
        sport, dport = struct.unpack(">HH", l4[:4])
        key["src_port"], key["dst_port"] = sport, dport
        if proto == 6 and len(l4) >= 14:
            flags = classify_tcp_flags(l4[13])
        elif proto == 17:
            payload = l4[8:]
            if _DNS_PORT in (sport, dport) and len(payload) >= 4:
                txid = struct.unpack(">H", payload[:2])[0]
                is_resp = bool(payload[2] & 0x80)
                # the pairing key carries the CLIENT endpoint (query src /
                # response dst) — txids collide across clients
                client = ((key["dst_ip"].tobytes(), dport) if is_resp
                          else (key["src_ip"].tobytes(), sport))
                meta = ("dns", txid, is_resp, payload[3] & 0x0F, client)
            elif (_QUIC_PORT in (sport, dport) and len(payload) >= 5
                  and payload[0] & 0xC0 == 0xC0):
                meta = ("quic", struct.unpack(">I", payload[1:5])[0])
    elif proto in (1, 58) and len(l4) >= 2:  # ICMP type/code
        key["icmp_type"], key["icmp_code"] = l4[0], l4[1]
    # L2 frame length (IP total + ethernet header) — the same accounting as
    # the kernel datapath's skb->len
    return key.tobytes(), total_len + 14, flags, meta
