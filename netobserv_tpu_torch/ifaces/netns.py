"""Named network-namespace entry (setns) for discovery and attach.

Reference analog: `pkg/ifaces/watcher.go:57-271` (per-namespace netlink
subscription + link enumeration with netns handles) and
`pkg/agent/interfaces_listener.go:272-298` (attach inside the namespace).

setns(2) affects only the CALLING THREAD, so `netns_context` is safe to use
from worker threads (listener, watcher): the thread enters the namespace, does
its work, and restores its original namespace on exit. Namespace-bound
resources created inside (netlink sockets, TCX links, tc subprocesses forked
while inside) remain bound to the target namespace afterwards.

A copy of `netobserv_tpu/ifaces/netns.py` (lines 1-92): `netns_context`
and `list_netns`, which the self-managed fetchers' attach and detach enter
(`datapath/loader._SelfManagedAttach`), and the netlink enumeration inside
a namespace (`links_in`, `subscribe_links_in`) that the `Watcher` of
`ifaces/informers.py` runs.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger("netobserv_tpu_torch.ifaces.netns")

NETNS_DIR = "/var/run/netns"


class netns_context:
    """Run the calling thread inside the named netns; restore on exit.

    A falsy name is a no-op, so call sites can wrap unconditionally:

        with netns_context(iface.netns):
            ...attach/dump...

    Reference: `netobserv_tpu/ifaces/netns.py:25`.
    """

    def __init__(self, name: Optional[str], netns_dir: str = NETNS_DIR):
        self._name = name
        self._dir = netns_dir
        self._saved = -1
        self._target = -1

    def __enter__(self) -> "netns_context":
        if not self._name:
            return self
        self._saved = os.open("/proc/self/ns/net", os.O_RDONLY)
        try:
            self._target = os.open(
                os.path.join(self._dir, self._name), os.O_RDONLY)
            os.setns(self._target, os.CLONE_NEWNET)
        except BaseException:
            os.close(self._saved)
            self._saved = -1
            if self._target >= 0:
                os.close(self._target)
                self._target = -1
            raise
        return self

    def __exit__(self, *exc) -> bool:
        if self._saved >= 0:
            try:
                os.setns(self._saved, os.CLONE_NEWNET)
            finally:
                os.close(self._saved)
                self._saved = -1
        if self._target >= 0:
            os.close(self._target)
            self._target = -1
        return False


def list_netns(netns_dir: str = NETNS_DIR) -> list[str]:
    """Reference: `netobserv_tpu/ifaces/netns.py:70`."""
    try:
        return sorted(os.listdir(netns_dir))
    except OSError:
        return []



def links_in(name: str, netns_dir: str = NETNS_DIR):
    """Enumerate links inside a named namespace (enter, dump, restore).

    Reference: `netobserv_tpu/ifaces/netns.py:77`."""
    from netobserv_tpu_torch.ifaces import netlink

    with netns_context(name, netns_dir):
        return netlink.dump_links()


def subscribe_links_in(name: str, netns_dir: str = NETNS_DIR):
    """Create a netlink RTMGRP_LINK subscription bound INSIDE the namespace;
    the socket keeps delivering that namespace's events after the thread
    returns to its original namespace.

    Reference: `netobserv_tpu/ifaces/netns.py:85`."""
    from netobserv_tpu_torch.ifaces import netlink

    with netns_context(name, netns_dir):
        return netlink.subscribe_links()
