"""Interface discovery: informers of link events, the interface filter,
the registerer of names, UDN mapping and network-namespace entry.

A copy of `netobserv_tpu/ifaces/__init__.py` (lines 1-13) and its
exports: an informer (a `Watcher` over a netlink subscription, or a
`Poller` over periodic link dumps) feeds attach and detach events, a
`Registerer` caches (ifindex, MAC) -> name, and `InterfaceFilter` selects
by name or CIDR; all over raw AF_NETLINK sockets (no external deps).
"""

from netobserv_tpu_torch.ifaces.informers import (  # noqa: F401
    Event, EventType, Interface, Poller, Watcher,
)
from netobserv_tpu_torch.ifaces.registerer import Registerer  # noqa: F401
from netobserv_tpu_torch.ifaces.filter import InterfaceFilter  # noqa: F401
