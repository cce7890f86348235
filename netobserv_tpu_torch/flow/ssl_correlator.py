"""SSL plaintext <-> flow correlation.

The OpenSSL uprobe events (flow/ssl_tracer.py) carry only (pid, timestamp,
plaintext); the flow datapath keys on 5-tuples. This bridges them in
userspace: the event's pid is resolved to its live TCP sockets through
procfs (/proc/<pid>/fd -> socket:[inode] -> /proc/net/tcp{,6} rows), and the
plaintext activity is credited to those flow keys; MapTracer enrichment then
surfaces `ssl_plaintext_events/bytes` on matching Records.

Reference analog: `pkg/flow/tracer_ringbuf.go:136-190` receives the same
events but only logs and counts them — the association with flows is this
framework's extension (VERDICT round-1 item #10 asked for exactly this).

The pid->sockets resolver is pluggable (tests inject a fake); the procfs
implementation caches per-pid results briefly since one SSL_write burst
produces many events for the same connection set.

A copy of `netobserv_tpu/flow/ssl_correlator.py` (lines 1-167):
`SSLCorrelator` and `procfs_resolver`.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from netobserv_tpu_torch.model.flow import FlowKey

log = logging.getLogger("netobserv_tpu_torch.flow.ssl_correlator")

# (local_ip_16, local_port, remote_ip_16, remote_port)
SocketTuple = tuple[bytes, int, bytes, int]
PidResolver = Callable[[int], list[SocketTuple]]


def _parse_proc_net_tcp(path: str, want_inodes: set[str],
                        v6: bool) -> dict[str, SocketTuple]:
    """inode -> socket tuple for rows of /proc/net/tcp or tcp6."""
    out: dict[str, SocketTuple] = {}
    try:
        with open(path) as fh:
            next(fh)  # header
            for line in fh:
                parts = line.split()
                if len(parts) < 10:
                    continue
                inode = parts[9]
                if inode not in want_inodes:
                    continue
                if parts[3] != "01":
                    # only ESTABLISHED connections map to trackable flows;
                    # LISTEN/TIME_WAIT rows would credit keys like
                    # local<->0.0.0.0:0 that no eviction can ever consume
                    continue
                laddr, lport = parts[1].rsplit(":", 1)
                raddr, rport = parts[2].rsplit(":", 1)
                out[inode] = (_hexaddr_to_16(laddr, v6), int(lport, 16),
                              _hexaddr_to_16(raddr, v6), int(rport, 16))
    except OSError:
        pass
    return out


def _hexaddr_to_16(hexaddr: str, v6: bool) -> bytes:
    """procfs hex address (little-endian 32-bit words) -> 16-byte form."""
    raw = bytes.fromhex(hexaddr)
    if not v6:
        # the 32-bit group is little-endian: reversing yields network-order
        # bytes, wrapped in the v4-mapped 16-byte form
        return b"\x00" * 10 + b"\xff\xff" + raw[::-1]
    # v6: four LE 32-bit groups
    words = [raw[i:i + 4][::-1] for i in range(0, 16, 4)]
    return b"".join(words)


def procfs_resolver(pid: int) -> list[SocketTuple]:
    """Live TCP sockets owned by pid, via /proc (needs same-host visibility;
    CAP_SYS_PTRACE or same-user for foreign processes)."""
    inodes: set[str] = set()
    try:
        fd_dir = f"/proc/{pid}/fd"
        for fd in os.listdir(fd_dir):
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target.startswith("socket:["):
                inodes.add(target[8:-1])
    except OSError:
        return []
    if not inodes:
        return []
    found = _parse_proc_net_tcp("/proc/net/tcp", inodes, v6=False)
    found.update(_parse_proc_net_tcp("/proc/net/tcp6", inodes, v6=True))
    return list(found.values())


class SSLCorrelator:
    """Accumulates per-flow-key SSL plaintext counters, consumed at
    enrichment time (MapTracer._attach_features)."""

    def __init__(self, resolver: Optional[PidResolver] = None,
                 pid_cache_ttl_s: float = 1.0, max_keys: int = 8192):
        self._resolver = resolver or procfs_resolver
        self._ttl = pid_cache_ttl_s
        self._pid_cache: dict[int, tuple[float, list[SocketTuple]]] = {}
        self._counters: dict[bytes, tuple[int, int]] = {}  # key -> (n, bytes)
        self._max_keys = max_keys
        self._lock = threading.Lock()

    def observe(self, event) -> int:
        """Credit one SSLEvent to the pid's flows; returns flows credited."""
        now = time.monotonic()
        with self._lock:
            cached = self._pid_cache.get(event.pid)
        if cached is not None and now - cached[0] < self._ttl:
            tuples = cached[1]
        else:
            tuples = self._resolver(event.pid)
            with self._lock:
                if len(self._pid_cache) >= 1024:
                    # evict the oldest half BEFORE inserting, so the entry
                    # just resolved survives (clearing after insert made the
                    # cache useless exactly at >1024 active pids)
                    from itertools import islice
                    for stale in list(islice(self._pid_cache, 512)):
                        del self._pid_cache[stale]
                self._pid_cache[event.pid] = (now, tuples)
        credited = 0
        with self._lock:
            if len(self._counters) >= self._max_keys:
                # bound never-consumed credits (filtered flows, orientations
                # the kernel never tracked): drop the oldest half — dicts
                # preserve insertion order, so this is a crude FIFO eviction
                from itertools import islice
                for stale in list(islice(self._counters,
                                         self._max_keys // 2)):
                    del self._counters[stale]
            for laddr, lport, raddr, rport in tuples:
                # credit both orientations: SSL I/O belongs to the local
                # endpoint, but the kernel may key this flow egress
                # (local->remote) or ingress (remote->local)
                for key in (
                    FlowKey(laddr, raddr, lport, rport, 6),
                    FlowKey(raddr, laddr, rport, lport, 6),
                ):
                    kb = self._pack(key)
                    n, b = self._counters.get(kb, (0, 0))
                    self._counters[kb] = (n + 1, b + len(event.data))
                    credited += 1
        return credited

    @staticmethod
    def _pack(key: FlowKey) -> bytes:
        return (key.src_ip + key.dst_ip
                + key.src_port.to_bytes(2, "little")
                + key.dst_port.to_bytes(2, "little")
                + bytes([key.proto]))

    def take(self, key: FlowKey) -> tuple[int, int]:
        """Consume (events, bytes) credited to a flow key (zeroing them)."""
        with self._lock:
            return self._counters.pop(self._pack(key), (0, 0))

    def pending(self) -> int:
        with self._lock:
            return len(self._counters)
