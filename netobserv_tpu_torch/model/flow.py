"""Copies of the flow-model pieces the sketch plane needs.

Counterpart of `netobserv_tpu/model/flow.py` (`TcpFlags`, `ip_from_16`,
`MAX_OBSERVED_INTERFACES`), kept as a copy so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import enum
import socket

IP4_IN_6_PREFIX = b"\x00" * 10 + b"\xff\xff"
#: interfaces a flow record lists (the datapath's NO_MAX_OBSERVED_INTERFACES)
MAX_OBSERVED_INTERFACES = 6


class TcpFlags(enum.IntFlag):
    """RFC 9293 flags plus the datapath's synthetic combination flags."""

    FIN = 0x01
    SYN = 0x02
    RST = 0x04
    PSH = 0x08
    ACK = 0x10
    URG = 0x20
    ECE = 0x40
    CWR = 0x80
    SYN_ACK = 0x100
    FIN_ACK = 0x200
    RST_ACK = 0x400


def ip_from_16(raw: bytes) -> str:
    """Render a 16-byte address, collapsing v4-mapped back to dotted quad."""
    if raw[:12] == IP4_IN_6_PREFIX:
        return socket.inet_ntop(socket.AF_INET, raw[12:16])
    return socket.inet_ntop(socket.AF_INET6, raw)
