"""UDN (user-defined network) mapping for interfaces.

Reference analog: the ENABLE_UDN_MAPPING path, which resolves OVN/OVS
interface metadata to a user-defined-network name attached to flow records.
Without an OVS database in scope, the mapping source here is either:
- a JSON file (`UDN_MAPPING_FILE`, {"<iface-name>": "<udn>", ...}), or
- the OVS external-ids via `ovs-vsctl`, when the binary exists.

The result feeds `Record.udn` / the dup-list UDN column through the same
namer-style hook the interface Registerer uses.

A copy of `netobserv_tpu/ifaces/udn.py` (lines 1-90).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import threading
import time

log = logging.getLogger("netobserv_tpu_torch.ifaces.udn")

MAPPING_FILE_ENV = "UDN_MAPPING_FILE"
_CACHE_TTL_S = 30.0


class UdnMapper:
    def __init__(self, mapping_file: str = ""):
        self._file = mapping_file or os.environ.get(MAPPING_FILE_ENV, "")
        self._lock = threading.Lock()
        self._cache: dict[str, str] = {}
        self._loaded_at = 0.0
        self._refreshing = False
        self._refresh_sync()  # initial load before serving

    def _refresh_sync(self) -> None:
        self._do_refresh()
        with self._lock:
            self._loaded_at = time.monotonic()
            self._refreshing = False

    def _maybe_refresh_async(self) -> None:
        """Kick a background refresh when stale; callers keep the stale cache
        meanwhile — the ovs-vsctl probe (up to 5s) must never stall the
        eviction path."""
        with self._lock:
            if (time.monotonic() - self._loaded_at < _CACHE_TTL_S
                    or self._refreshing):
                return
            self._refreshing = True
        threading.Thread(target=self._refresh_sync, name="udn-refresh",
                         daemon=True).start()

    def _do_refresh(self) -> None:
        if self._file:
            try:
                with open(self._file) as fh:
                    data = json.load(fh)
                if isinstance(data, dict):
                    cache = {str(k): str(v) for k, v in data.items()}
                    with self._lock:
                        self._cache = cache
            except (OSError, ValueError) as exc:
                log.warning("UDN mapping file unreadable: %s", exc)
            return
        if shutil.which("ovs-vsctl"):
            try:
                out = subprocess.run(
                    ["ovs-vsctl", "--format=json", "--columns=name,external_ids",
                     "list", "Interface"],
                    capture_output=True, text=True, timeout=5, check=True)
                data = json.loads(out.stdout)
                cache = {}
                for row in data.get("data", []):
                    name = row[0]
                    ids = dict(row[1][1]) if isinstance(row[1], list) else {}
                    udn = ids.get("k8s.ovn.org/udn", ids.get("udn", ""))
                    if udn:
                        cache[name] = udn
                with self._lock:
                    self._cache = cache
            except (OSError, ValueError, subprocess.SubprocessError) as exc:
                log.debug("ovs-vsctl UDN probe failed: %s", exc)

    def udn_for(self, if_name: str) -> str:
        self._maybe_refresh_async()
        with self._lock:
            return self._cache.get(if_name, "")
