"""Pluggable OVN network-event sample decoders.

Reference analog: `pkg/agent/agent.go:136-147` wires an
`ovnobserv.SampleDecoder` against the OVN northbound OVSDB unix socket
(`/var/run/ovn/ovnnb_db.sock`) so psample cookies resolve to live ACL
metadata (name/namespace/action) instead of bare object ids.

Three implementations behind one seam:

- `StaticCookieDecoder` — pure-bytes decode (utils/networkevents.py); always
  available, no daemon required. The default.
- `OvsdbSampleDecoder` — socket-backed: a minimal OVSDB JSON-RPC client that
  resolves the cookie's object id to an ACL row (name / action / direction /
  external_ids) with an in-memory cache. Any error degrades to the static
  decode — enrichment must never break the export path.
- any test double implementing `decode(cookie) -> dict`.

The active decoder is process-global (`set_decoder` / `active_decoder`):
exporters decode from deep inside the map-rendering path where threading a
handle through every caller would contaminate every exporter signature.

A copy of `netobserv_tpu/utils/ovn_decoder.py` (lines 1-208). The agent
installs the decoder `make_decoder` picks under
ENABLE_NETWORK_EVENTS_MONITORING and closes and uninstalls it at shutdown;
`model/record.Record.to_json_obj` and `exporter/pb_convert.record_to_pb`
decode each record's events through it.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional, Protocol

from netobserv_tpu_torch.utils import networkevents

log = logging.getLogger("netobserv_tpu_torch.utils.ovn")

OVN_NB_SOCK = "/var/run/ovn/ovnnb_db.sock"
OVN_NB_DB = "OVN_Northbound"


class SampleDecoder(Protocol):
    def decode(self, cookie: bytes) -> dict: ...

    def close(self) -> None: ...


class StaticCookieDecoder:
    """Layout-only decode of the psample user cookie (no OVN daemon)."""

    def decode(self, cookie: bytes) -> dict:
        return networkevents.decode_cookie(cookie)

    def close(self) -> None:
        pass


class OvsdbSampleDecoder:
    """Resolve sample object ids against the OVN OVSDB over its unix socket.

    Speaks just enough OVSDB JSON-RPC (RFC 7047): a `transact` with a
    `select` on the ACL table filtered by the sample id. Responses are
    cached; every failure falls back to the static decode so a missing or
    wedged ovsdb-server never stalls an eviction.
    """

    def __init__(self, sock_path: str = OVN_NB_SOCK, db: str = OVN_NB_DB,
                 table: str = "ACL", timeout_s: float = 2.0,
                 cache_max: int = 4096):
        self._path = sock_path
        self._db = db
        self._table = table
        self._timeout = timeout_s
        self._sock: Optional[socket.socket] = None
        self._rpc_id = 0
        self._cache: dict[int, Optional[dict]] = {}
        self._cache_max = cache_max
        self._static = StaticCookieDecoder()
        self._lock = threading.Lock()

    # --- OVSDB JSON-RPC plumbing ------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self._timeout)
            s.connect(self._path)
            self._sock = s
        return self._sock

    def _rpc(self, method: str, params: list):
        """One JSON-RPC round trip. OVSDB frames are bare JSON values; the
        response is read until a complete value parses. Any error drops the
        connection so the next lookup reconnects (an ovsdb-server restart
        must not permanently disable enrichment)."""
        self._rpc_id += 1
        req = json.dumps({"id": self._rpc_id, "method": method,
                          "params": params}).encode()
        try:
            sock = self._connect()
            sock.sendall(req)
            buf = ""
            decoder = json.JSONDecoder()
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("ovsdb closed mid-response")
                buf += chunk.decode(errors="replace")
                while True:
                    try:
                        obj, end = decoder.raw_decode(buf)
                    except ValueError:
                        break  # partial frame: read more
                    buf = buf[end:].lstrip()
                    if obj.get("id") != self._rpc_id:
                        continue  # notification; a pipelined reply may follow
                    if obj.get("error"):
                        raise IOError(f"ovsdb error: {obj['error']}")
                    return obj.get("result")
        except Exception:
            self.close()  # reconnect on the next lookup
            raise

    def _lookup_acl(self, obj_id: int) -> Optional[dict]:
        """Select the ACL row whose sample id matches; None when absent.
        Failures are negative-cached so a wedged ovsdb pays its timeout once
        per object, not once per eviction window."""
        if obj_id in self._cache:
            return self._cache[obj_id]
        if len(self._cache) >= self._cache_max:
            self._cache.clear()  # crude but bounded
        try:
            result = self._rpc("transact", [
                self._db,
                {"op": "select", "table": self._table,
                 "where": [["sample_new", "==", obj_id]],
                 "columns": ["name", "action", "direction", "external_ids"]},
            ])
            rows = (result or [{}])[0].get("rows", [])
            row = rows[0] if rows else None
        except Exception as exc:
            log.debug("ovsdb sample lookup failed (%s); static decode", exc)
            row = None
        self._cache[obj_id] = row
        return row

    # --- SampleDecoder -----------------------------------------------------
    def decode(self, cookie: bytes) -> dict:
        base = self._static.decode(cookie)
        obj = base.get("Name")
        if obj is None or not obj.isdigit():
            return base
        # the WHOLE enrichment is guarded: a malformed row must degrade to
        # the static decode, never crash the export path
        try:
            with self._lock:
                row = self._lookup_acl(int(obj))
            if not row:
                return base
            ext = dict(row.get("external_ids", ["map", []])[1]) \
                if isinstance(row.get("external_ids"), list) else {}
            out = dict(base)
            if row.get("name"):
                out["Name"] = row["name"]
            if row.get("action"):
                out["Action"] = row["action"]
            if row.get("direction"):
                out["Direction"] = row["direction"]
            if ext.get("k8s.ovn.org/name"):
                out["Name"] = ext["k8s.ovn.org/name"]
            if ext.get("k8s.ovn.org/namespace"):
                out["Namespace"] = ext["k8s.ovn.org/namespace"]
            return out
        except Exception as exc:
            log.debug("ovsdb enrichment failed (%s); static decode", exc)
            return base

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


_active: SampleDecoder = StaticCookieDecoder()


def set_decoder(decoder: Optional[SampleDecoder]) -> None:
    """Install the process-wide sample decoder (None restores the static)."""
    global _active
    _active = decoder if decoder is not None else StaticCookieDecoder()


def active_decoder() -> SampleDecoder:
    return _active


def decode_event(cookie: bytes) -> dict:
    return _active.decode(cookie)


def make_decoder(cfg) -> SampleDecoder:
    """Agent wiring (reference agent.go:136-147): the socket-backed decoder
    when the OVN socket exists, static otherwise. The caller gates on the
    network-events config flag; connection itself is lazy."""
    import os

    if os.path.exists(OVN_NB_SOCK):
        log.info("OVN sample decoder: ovsdb-backed (%s)", OVN_NB_SOCK)
        return OvsdbSampleDecoder()
    return StaticCookieDecoder()
