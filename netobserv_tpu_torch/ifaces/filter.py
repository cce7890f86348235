"""Interface selection filters.

Reference analog: `pkg/ifaces/filter.go` — either name-based allow/exclude
lists (exact or /regex/) or selection by interface IP CIDR membership.

A copy of `netobserv_tpu/ifaces/filter.py` (lines 1-64).
"""

from __future__ import annotations

import ipaddress
import re
from typing import Optional

from netobserv_tpu_torch.ifaces import netlink
from netobserv_tpu_torch.ifaces.informers import Interface


class InterfaceFilter:
    def __init__(self, allowed: Optional[list[str]] = None,
                 excluded: Optional[list[str]] = None,
                 ip_cidrs: Optional[list[str]] = None):
        if ip_cidrs and (allowed or excluded):
            raise ValueError(
                "INTERFACE_IPS is mutually exclusive with INTERFACES/"
                "EXCLUDE_INTERFACES")
        self._allowed = [self._compile(p) for p in (allowed or [])]
        self._excluded = [self._compile(p) for p in (excluded or [])]
        self._cidrs = [ipaddress.ip_network(c, strict=False)
                       for c in (ip_cidrs or [])]

    @staticmethod
    def _compile(pattern: str):
        pattern = pattern.strip()
        if len(pattern) > 1 and pattern.startswith("/") and pattern.endswith("/"):
            return re.compile(pattern[1:-1])
        return pattern

    @staticmethod
    def _matches(pattern, name: str) -> bool:
        if isinstance(pattern, re.Pattern):
            return bool(pattern.search(name))
        return pattern == name

    def allowed(self, iface: Interface) -> bool:
        if self._cidrs:
            return self._ip_allowed(iface)
        for pattern in self._excluded:
            if self._matches(pattern, iface.name):
                return False
        if not self._allowed:
            return True
        return any(self._matches(p, iface.name) for p in self._allowed)

    def _ip_allowed(self, iface: Interface) -> bool:
        try:
            addrs = netlink.dump_addrs()
        except OSError:
            return False
        for idx, raw in addrs:
            if idx != iface.index or len(raw) not in (4, 16):
                continue
            ip = ipaddress.ip_address(raw)
            if any(ip in net for net in self._cidrs):
                return True
        return False
