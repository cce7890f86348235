"""Informers: interface lifecycle event sources.

Reference analog: `pkg/ifaces/watcher.go` (netlink subscription + netns dir
watching) and `pkg/ifaces/poller.go` (periodic LinkList diff). Both emit the
same Event stream into a queue.

A copy of `netobserv_tpu/ifaces/informers.py` (lines 1-211): `EventType`,
`Interface`, `Event`, `Poller`, and `Watcher` with its netns watch and
poll fallback.
"""

from __future__ import annotations

import enum
import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import Optional

from netobserv_tpu_torch.ifaces import netlink

log = logging.getLogger("netobserv_tpu_torch.ifaces")

NETNS_DIR = "/var/run/netns"


class EventType(enum.Enum):
    ADDED = "added"
    REMOVED = "removed"


@dataclass(frozen=True)
class Interface:
    index: int
    name: str
    mac: bytes
    netns: str = ""  # "" = default namespace


@dataclass
class Event:
    type: EventType
    interface: Interface


class _InformerBase:
    def __init__(self, out: "Optional[queue.Queue[Event]]" = None):
        self.events: "queue.Queue[Event]" = out if out is not None else queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._known: dict[tuple[str, int], Interface] = {}

    def subscribe(self) -> "queue.Queue[Event]":
        self._thread = threading.Thread(
            target=self._loop, name=type(self).__name__.lower(), daemon=True)
        self._thread.start()
        return self.events

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def _emit_current(self, links: list[netlink.LinkInfo], netns: str = "") -> None:
        """Diff a full link list against known state, emitting add/remove."""
        current = {}
        for link in links:
            if not link.up:
                continue
            iface = Interface(link.index, link.name, link.mac, netns)
            current[(netns, link.index)] = iface
        for key, iface in current.items():
            if key not in self._known:
                self._known[key] = iface
                self.events.put(Event(EventType.ADDED, iface))
        for key in [k for k in self._known if k[0] == netns]:
            if key not in current:
                iface = self._known.pop(key)
                self.events.put(Event(EventType.REMOVED, iface))

    def _loop(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class Poller(_InformerBase):
    """Periodic full link dumps, diffed (LISTEN_INTERFACES=poll)."""

    def __init__(self, period_s: float = 10.0, **kw):
        super().__init__(**kw)
        self._period = period_s

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._emit_current(netlink.dump_links())
            except OSError as exc:
                log.warning("link dump failed: %s", exc)
            self._stop.wait(self._period)


class Watcher(_InformerBase):
    """netlink link-event subscription with an initial dump; namespaces
    appearing under /var/run/netns are ENTERED (setns): their links are
    enumerated and a per-namespace netlink subscription keeps following them
    (LISTEN_INTERFACES=watch; reference pkg/ifaces/watcher.go:57-271).
    """

    def __init__(self, netns_dir: str = NETNS_DIR, **kw):
        super().__init__(**kw)
        self._netns_dir = netns_dir
        # netns name -> its subscription socket (None when entry failed —
        # e.g. no CAP_SYS_ADMIN — and only the namespace's existence is known)
        self._netns_socks: dict[str, Optional[object]] = {}

    def _loop(self) -> None:
        try:
            sock = netlink.subscribe_links()
        except OSError as exc:
            log.warning("netlink subscription failed (%s); falling back to "
                        "polling", exc)
            self._poll_fallback()
            return
        try:
            self._emit_current(netlink.dump_links())
            self._check_netns()
            while not self._stop.is_set():
                for link in netlink.read_link_events(sock):
                    self._handle_event(link, "")
                for name, ns_sock in list(self._netns_socks.items()):
                    if ns_sock is None:
                        continue
                    try:
                        for link in netlink.read_link_events(ns_sock):
                            self._handle_event(link, name)
                    except OSError:
                        pass
                self._check_netns()
        finally:
            sock.close()
            for ns_sock in self._netns_socks.values():
                if ns_sock is not None:
                    ns_sock.close()

    def _handle_event(self, link: netlink.LinkInfo, netns: str) -> None:
        key = (netns, link.index)
        if link.change_type == netlink.RTM_DELLINK or not link.up:
            iface = self._known.pop(key, None)
            if iface is not None:
                self.events.put(Event(EventType.REMOVED, iface))
        else:
            iface = Interface(link.index, link.name, link.mac, netns)
            if key not in self._known:
                self._known[key] = iface
                self.events.put(Event(EventType.ADDED, iface))

    def _check_netns(self) -> None:
        """Follow /var/run/netns: enter each new namespace to enumerate its
        links and subscribe to its events; on namespace removal, emit REMOVED
        for its interfaces and drop the subscription."""
        from netobserv_tpu_torch.ifaces import netns as nsmod

        try:
            names = set(os.listdir(self._netns_dir))
        except OSError:
            names = set()
        for name in names - set(self._netns_socks):
            try:
                ns_sock = nsmod.subscribe_links_in(name, self._netns_dir)
            except OSError as exc:
                import errno as _errno

                if exc.errno in (_errno.EPERM, _errno.EACCES):
                    # cannot enter (no CAP_SYS_ADMIN): permanent — remember
                    # the namespace so this doesn't retry/log every cycle
                    log.warning("cannot enter netns %s (%s); observing only",
                                name, exc)
                    self._netns_socks[name] = None
                else:
                    # transient (fd pressure, netns racing away): leave the
                    # name unknown so the next cycle retries
                    log.debug("netns %s subscribe failed (%s); will retry",
                              name, exc)
                continue
            try:
                links = nsmod.links_in(name, self._netns_dir)
            except OSError as exc:
                # transient (namespace raced away / netlink error): drop the
                # socket and leave the name unknown so the next cycle retries
                log.debug("netns %s link dump failed (%s); will retry",
                          name, exc)
                ns_sock.close()
                continue
            # drain events with a short poll so the watcher loop's cadence
            # stays driven by the default-namespace socket
            ns_sock.settimeout(0.01)
            self._emit_current(links, netns=name)
            log.info("watching network namespace %s (%d links)", name,
                     len(links))
            self._netns_socks[name] = ns_sock
        for name in set(self._netns_socks) - names:
            ns_sock = self._netns_socks.pop(name)
            if ns_sock is not None:
                ns_sock.close()
            self._emit_current([], netns=name)
            log.info("network namespace %s removed", name)

    def _poll_fallback(self) -> None:
        while not self._stop.is_set():
            try:
                self._emit_current(netlink.dump_links())
            except OSError:
                pass
            self._stop.wait(10.0)
