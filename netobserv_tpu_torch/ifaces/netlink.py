"""Minimal rtnetlink client: link dumps and link-event subscription.

Speaks NETLINK_ROUTE directly over an AF_NETLINK socket — the pure-python
replacement for the reference's vishvananda/netlink dependency.

A copy of `netobserv_tpu/ifaces/netlink.py` (lines 1-164): `dump_links`,
`dump_addrs`, `subscribe_links` and `read_link_events`.
"""

from __future__ import annotations

import os
import socket
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

NETLINK_ROUTE = 0
RTMGRP_LINK = 1
RTM_NEWLINK = 16
RTM_DELLINK = 17
RTM_GETLINK = 18
RTM_NEWADDR = 20
RTM_GETADDR = 22
NLM_F_REQUEST = 1
NLM_F_DUMP = 0x300
NLMSG_DONE = 3
NLMSG_ERROR = 2

IFLA_ADDRESS = 1
IFLA_IFNAME = 3
IFA_ADDRESS = 1
IFF_UP = 0x1


@dataclass
class LinkInfo:
    index: int
    name: str
    mac: bytes
    flags: int
    change_type: int = RTM_NEWLINK  # NEWLINK or DELLINK for events

    @property
    def up(self) -> bool:
        return bool(self.flags & IFF_UP)


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _parse_attrs(data: bytes) -> dict[int, bytes]:
    attrs = {}
    off = 0
    while off + 4 <= len(data):
        alen, atype = struct.unpack_from("=HH", data, off)
        if alen < 4:
            break
        attrs[atype] = data[off + 4:off + alen]
        off += _align4(alen)
    return attrs


def _parse_link_msg(msg_type: int, payload: bytes) -> Optional[LinkInfo]:
    if len(payload) < 16:
        return None
    _family, _pad, _dev_type, index, flags, _change = struct.unpack_from(
        "=BBHiII", payload, 0)
    attrs = _parse_attrs(payload[16:])
    name = attrs.get(IFLA_IFNAME, b"").split(b"\x00")[0].decode(
        "ascii", "replace")
    mac = attrs.get(IFLA_ADDRESS, b"\x00" * 6)[:6].ljust(6, b"\x00")
    return LinkInfo(index=index, name=name, mac=mac, flags=flags,
                    change_type=msg_type)


def _recv_messages(sock: socket.socket) -> Iterator[tuple[int, bytes]]:
    data = sock.recv(65536)
    off = 0
    while off + 16 <= len(data):
        mlen, mtype, _flags, _seq, _pid = struct.unpack_from("=IHHII", data, off)
        if mlen < 16:
            break
        yield mtype, data[off + 16:off + mlen]
        off += _align4(mlen)


def dump_links() -> list[LinkInfo]:
    """One RTM_GETLINK dump: all interfaces in the current netns."""
    sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_ROUTE)
    try:
        sock.bind((0, 0))
        req = struct.pack("=IHHIIBBHiII", 16 + 16, RTM_GETLINK,
                          NLM_F_REQUEST | NLM_F_DUMP, 1, 0,
                          socket.AF_UNSPEC, 0, 0, 0, 0, 0)
        sock.send(req)
        links = []
        done = False
        while not done:
            for mtype, payload in _recv_messages(sock):
                if mtype == NLMSG_DONE:
                    done = True
                    break
                if mtype == NLMSG_ERROR:
                    raise OSError("netlink error on RTM_GETLINK dump")
                if mtype == RTM_NEWLINK:
                    link = _parse_link_msg(mtype, payload)
                    if link is not None:
                        links.append(link)
        return links
    finally:
        sock.close()


def dump_addrs() -> list[tuple[int, bytes]]:
    """RTM_GETADDR dump: (ifindex, raw address bytes) pairs (v4 and v6)."""
    sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_ROUTE)
    try:
        sock.bind((0, 0))
        req = struct.pack("=IHHIIBBBBi", 16 + 8, RTM_GETADDR,
                          NLM_F_REQUEST | NLM_F_DUMP, 1, 0,
                          socket.AF_UNSPEC, 0, 0, 0, 0)
        sock.send(req)
        out = []
        done = False
        while not done:
            for mtype, payload in _recv_messages(sock):
                if mtype == NLMSG_DONE:
                    done = True
                    break
                if mtype == NLMSG_ERROR:
                    raise OSError("netlink error on RTM_GETADDR dump")
                if mtype == RTM_NEWADDR and len(payload) >= 8:
                    _family, _plen, _flags, _scope, index = struct.unpack_from(
                        "=BBBBi", payload, 0)
                    attrs = _parse_attrs(payload[8:])
                    addr = attrs.get(IFA_ADDRESS)
                    if addr:
                        out.append((index, addr))
        return out
    finally:
        sock.close()


def subscribe_links() -> socket.socket:
    """Socket subscribed to link add/remove events (RTMGRP_LINK)."""
    sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_ROUTE)
    # port id 0: the kernel assigns a unique id, so several subscription
    # sockets (one per watched namespace) can coexist in one process
    sock.bind((0, RTMGRP_LINK))
    sock.settimeout(0.5)
    return sock


def read_link_events(sock: socket.socket) -> list[LinkInfo]:
    """Drain pending link events from a subscribed socket (may be empty)."""
    try:
        events = []
        for mtype, payload in _recv_messages(sock):
            if mtype in (RTM_NEWLINK, RTM_DELLINK):
                link = _parse_link_msg(mtype, payload)
                if link is not None:
                    events.append(link)
        return events
    except socket.timeout:
        return []
