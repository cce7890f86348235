"""Registerer: caches (ifindex, MAC) -> name for interface naming.

Reference analog: `pkg/ifaces/registerer.go` — a decorator over an informer
that remembers every interface it has seen, so flow records can be named even
after the interface disappears. MAC is part of the key because ifindexes are
reused across namespaces; when several names share an index, a matching MAC
wins, with an optional preferred-name tie-break for MAC-prefix collisions
(PREFERRED_INTERFACE_FOR_MAC_PREFIX).

A copy of `netobserv_tpu/ifaces/registerer.py` (lines 1-63).
"""

from __future__ import annotations

import threading

from netobserv_tpu_torch.ifaces.informers import Event, EventType, Interface


class Registerer:
    def __init__(self, preferred_for_mac_prefix: str = ""):
        self._lock = threading.Lock()
        self._by_index: dict[int, list[Interface]] = {}
        # comma-separated "mac_prefix=name" pairs with colon-delimited MACs,
        # e.g. "0a:58=eth0,02:42=docker" (reference env-var contract)
        self._prefs: list[tuple[bytes, str]] = []
        for pair in preferred_for_mac_prefix.split(","):
            pair = pair.strip()
            if not pair or "=" not in pair:
                continue
            prefix_str, name = pair.split("=", 1)
            try:
                prefix = bytes.fromhex(prefix_str.replace(":", ""))
            except ValueError:
                continue  # malformed prefix: ignore the pair, don't crash
            if prefix and name:
                self._prefs.append((prefix, name))

    def observe(self, event: Event) -> None:
        iface = event.interface
        with self._lock:
            entries = self._by_index.setdefault(iface.index, [])
            if event.type == EventType.ADDED:
                if all(e.mac != iface.mac or e.name != iface.name
                       for e in entries):
                    entries.append(iface)
            # REMOVED keeps the cache entry: records may still reference it

    def name_for(self, if_index: int, mac: bytes) -> str:
        """The interfaceNamer hook (`model.set_interface_namer` target)."""
        with self._lock:
            entries = self._by_index.get(if_index, [])
            if not entries:
                return str(if_index)
            matches = [e for e in entries if e.mac == mac]
            if not matches:
                return entries[-1].name
            if len(matches) > 1:
                for prefix, pref_name in self._prefs:
                    if not mac.startswith(prefix):
                        continue
                    for e in matches:
                        if e.name.startswith(pref_name):
                            return e.name
            return matches[-1].name
