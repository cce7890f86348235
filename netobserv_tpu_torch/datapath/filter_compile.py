"""Flow-filter rule compiler: config rules -> LPM trie entries.

Reference analog: `pkg/tracer/flow_filter.go` — converts the JSON
FLOW_FILTER_RULES into the datapath's `filter_rules` LPM entries (struct
no_filter_rule in bpf/maps.h, byte layout pinned here) plus `filter_peers`
entries for peer-CIDR predicates. Used by the kernel loader at program time;
pure and fully testable without a kernel.

The port's copy of `netobserv_tpu/datapath/filter_compile.py`, kept so
that the port imports nothing of the JAX package; each function names
its original by line.
"""

from __future__ import annotations

import ipaddress
import struct
from dataclasses import dataclass

from netobserv_tpu_torch.config import FlowFilterRule
from netobserv_tpu_torch.model.flow import TcpFlags, ip_to_16

_PROTOS = {"TCP": 6, "UDP": 17, "SCTP": 132, "ICMP": 1, "ICMPV6": 58}
_DIRECTIONS = {"": 255, "INGRESS": 0, "EGRESS": 1}
_TCP_FLAG_NAMES = {
    "FIN": TcpFlags.FIN, "SYN": TcpFlags.SYN, "RST": TcpFlags.RST,
    "PSH": TcpFlags.PSH, "ACK": TcpFlags.ACK, "URG": TcpFlags.URG,
    "ECE": TcpFlags.ECE, "CWR": TcpFlags.CWR,
    "SYN-ACK": TcpFlags.SYN_ACK, "FIN-ACK": TcpFlags.FIN_ACK,
    "RST-ACK": TcpFlags.RST_ACK,
}

import numpy as np

from netobserv_tpu_torch.model import binfmt

# layouts are pinned against the C structs by tests/test_layout_parity.py;
# the dtype is the single source of truth for the value encoding
FILTER_KEY_SIZE = binfmt.FILTER_KEY_DTYPE.itemsize  # 20
FILTER_RULE_SIZE = binfmt.FILTER_RULE_DTYPE.itemsize  # 40
# LPM trie capacity in bpf/maps.h (MAX_FILTER_ENTRIES analog)
MAX_FILTER_RULES = 16


@dataclass(frozen=True)
class CompiledFilter:
    """Reference: `netobserv_tpu/datapath/filter_compile.py:42`."""
    rules: list[tuple[bytes, bytes]]  # (lpm key, rule value)
    peers: list[tuple[bytes, bytes]]  # (lpm key, 1-byte marker)


def _check_port(p: int) -> int:
    """Reference: `netobserv_tpu/datapath/filter_compile.py:47`."""
    if not 0 <= p <= 65535:
        raise ValueError(f"port {p} out of range 0-65535")
    return p


def _parse_ports(single: int, range_: str, list_: str) -> tuple[int, int, int, int]:
    """-> (start, end, p1, p2); reference semantics: range XOR up-to-2 ports.

    Reference: `netobserv_tpu/datapath/filter_compile.py:53`."""
    if range_ and (single or list_):
        raise ValueError("port range is exclusive with port/ports")
    if range_:
        lo, _, hi = range_.partition("-")
        start, end = _check_port(int(lo)), _check_port(int(hi))
        if start >= end:
            raise ValueError(f"invalid port range {range_!r}")
        return start, end, 0, 0
    if list_:
        ports = [_check_port(int(p)) for p in list_.split(",") if p.strip()]
        if not 1 <= len(ports) <= 2:
            raise ValueError("ports list supports one or two ports")
        p1 = ports[0]
        p2 = ports[1] if len(ports) > 1 else ports[0]
        return 0, 0, p1, p2
    if single:
        _check_port(single)
        return 0, 0, single, single
    return 0, 0, 0, 0


def _lpm_key(cidr: str) -> bytes:
    """Reference: `netobserv_tpu/datapath/filter_compile.py:76`."""
    net = ipaddress.ip_network(cidr, strict=False)
    raw = ip_to_16(str(net.network_address))
    prefix = net.prefixlen + (96 if net.version == 4 else 0)
    return struct.pack("=I", prefix) + raw


def _tcp_flags_value(name: str) -> int:
    """Reference: `netobserv_tpu/datapath/filter_compile.py:83`."""
    if not name:
        return 0
    key = name.strip().upper()
    if key not in _TCP_FLAG_NAMES:
        raise ValueError(f"unknown tcp flag {name!r}")
    return int(_TCP_FLAG_NAMES[key])


def compile_rule(rule: FlowFilterRule) -> tuple[bytes, bytes, list[bytes]]:
    """-> (lpm key, rule value bytes, peer lpm keys).

    Reference: `netobserv_tpu/datapath/filter_compile.py:92`."""
    proto = 0
    if rule.protocol:
        key = rule.protocol.strip().upper()
        if key not in _PROTOS:
            raise ValueError(f"unknown protocol {rule.protocol!r}")
        proto = _PROTOS[key]
    direction = _DIRECTIONS.get(rule.direction.strip().upper(), None)
    if direction is None:
        raise ValueError(f"unknown direction {rule.direction!r}")
    action = {"ACCEPT": 0, "REJECT": 1}.get(rule.action.strip().upper())
    if action is None:
        raise ValueError(f"unknown action {rule.action!r}")

    dstart, dend, d1, d2 = _parse_ports(
        rule.destination_port, rule.destination_port_range,
        rule.destination_ports)
    sstart, send_, s1, s2 = _parse_ports(
        rule.source_port, rule.source_port_range, rule.source_ports)
    pstart, pend, p1, p2 = _parse_ports(rule.port, rule.port_range, rule.ports)

    peer_keys: list[bytes] = []
    peer_cidr = rule.peer_cidr or (f"{rule.peer_ip}/32" if rule.peer_ip and
                                   ":" not in rule.peer_ip else
                                   f"{rule.peer_ip}/128" if rule.peer_ip else "")
    if peer_cidr:
        peer_keys.append(_lpm_key(peer_cidr))

    rec = np.zeros(1, dtype=binfmt.FILTER_RULE_DTYPE)[0]
    rec["proto"] = proto
    rec["icmp_type"] = rule.icmp_type
    rec["icmp_code"] = rule.icmp_code
    rec["direction"] = direction
    rec["action"] = action
    rec["want_drops"] = 1 if rule.drops else 0
    rec["peer_cidr_check"] = 1 if peer_keys else 0
    rec["dport_start"], rec["dport_end"] = dstart, dend
    rec["dport1"], rec["dport2"] = d1, d2
    rec["sport_start"], rec["sport_end"] = sstart, send_
    rec["sport1"], rec["sport2"] = s1, s2
    rec["port_start"], rec["port_end"] = pstart, pend
    rec["port1"], rec["port2"] = p1, p2
    rec["tcp_flags"] = _tcp_flags_value(rule.tcp_flags)
    rec["sample_override"] = rule.sample
    return _lpm_key(rule.ip_cidr), rec.tobytes(), peer_keys


def compile_filters(rules: list[FlowFilterRule]) -> CompiledFilter:
    """Reference: `netobserv_tpu/datapath/filter_compile.py:140`."""
    if len(rules) > MAX_FILTER_RULES:
        raise ValueError(
            f"{len(rules)} filter rules exceed the datapath LPM capacity of "
            f"{MAX_FILTER_RULES}")
    out_rules: list[tuple[bytes, bytes]] = []
    out_peers: list[tuple[bytes, bytes]] = []
    seen_keys: set[bytes] = set()
    for rule in rules:
        key, value, peers = compile_rule(rule)
        if key in seen_keys:
            raise ValueError(
                f"duplicate filter CIDR {rule.ip_cidr!r}: LPM tries hold one "
                "rule per prefix")
        seen_keys.add(key)
        out_rules.append((key, value))
        for pk in peers:
            out_peers.append((pk, b"\x01"))
    return CompiledFilter(rules=out_rules, peers=out_peers)
