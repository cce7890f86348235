"""Interface listener: discovery events -> filtered attach/detach with retry.

Reference analog: `pkg/agent/interfaces_listener.go` — allow/deny filtering,
per-event retry with linear backoff (TC_ATTACH_RETRIES, 300ms*attempt),
tcx/tc/any attach-mode fallback, and registration of the interface namer.

A copy of `netobserv_tpu/agent/interfaces_listener.py` (lines 1-139):
`DoNotRetryError`, and `InterfaceListener`, which attaches the fetcher to
every interface its informer adds and `ifaces.InterfaceFilter` allows
(INTERFACES, EXCLUDE_INTERFACES, INTERFACE_IPS), retrying TC_ATTACH_RETRIES
times 300 ms times the attempt apart, detaches on removal, counts each
event in `interface_events_total`, installs the registerer as the
interface namer on start and restores `default_namer` on stop.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

from netobserv_tpu_torch.config import AgentConfig
from netobserv_tpu_torch.datapath.fetcher import FlowFetcher
from netobserv_tpu_torch.ifaces import (
    Event, EventType, InterfaceFilter, Poller, Registerer, Watcher,
)
from netobserv_tpu_torch.model.record import (
    interface_namer, set_interface_namer,
)
from netobserv_tpu_torch.utils import faultinject

log = logging.getLogger("netobserv_tpu_torch.agent.ifaces")

_RETRY_BACKOFF_S = 0.3


class DoNotRetryError(Exception):
    """Attach failure that retrying cannot fix (reference: tracer.Error with
    DoNotRetry, `pkg/tracer/errors.go`)."""


class InterfaceListener:
    def __init__(self, cfg: AgentConfig, fetcher: FlowFetcher,
                 metrics=None, informer=None):
        self._cfg = cfg
        self._fetcher = fetcher
        self._metrics = metrics
        if informer is not None:
            self._informer = informer
        elif cfg.listen_interfaces == "poll":
            self._informer = Poller(period_s=cfg.listen_poll_period)
        else:
            self._informer = Watcher()
        self._filter = InterfaceFilter(
            allowed=cfg.interfaces, excluded=cfg.exclude_interfaces,
            ip_cidrs=cfg.interface_ips)
        self._registerer = Registerer(cfg.preferred_interface_for_mac_prefix)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.attached: set[tuple[str, int]] = set()
        #: supervision hook: beats once per poll (agent/supervisor.py)
        self.heartbeat = lambda: None
        self._events: Optional["queue.Queue[Event]"] = None

    def start(self) -> None:
        set_interface_namer(self._registerer.name_for)
        # a supervisor restart reuses the live subscription — resubscribing
        # would replay/miss discovery events depending on the informer
        if self._events is None:
            self._events = self._informer.subscribe()
        self._thread = threading.Thread(
            target=self._loop, args=(self._events,), name="iface-listener",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._informer.stop()
        if self._thread:
            self._thread.join(timeout=2.0)
        # drop the global namer hook: it closes over this listener's
        # registerer, which stops updating now (and would leak stale names
        # into any later agent instance in the same process)
        from netobserv_tpu_torch.model.record import default_namer
        if interface_namer() == self._registerer.name_for:
            set_interface_namer(default_namer)

    def _loop(self, events: "queue.Queue[Event]") -> None:
        while not self._stop.is_set():
            self.heartbeat()
            faultinject.fire("iface_listener.loop")
            try:
                event = events.get(timeout=0.2)
            except queue.Empty:
                continue
            self._registerer.observe(event)
            self._count_attach(event.type.value, event.interface, 0)
            iface = event.interface
            if event.type == EventType.ADDED:
                if not self._filter.allowed(iface):
                    log.debug("interface %s excluded by filter", iface.name)
                    continue
                self._attach_with_retry(iface)
            else:
                try:
                    self._fetcher.detach(iface.index, iface.name,
                                         netns=iface.netns)
                    self.attached.discard((iface.netns, iface.index))
                except Exception as exc:
                    log.debug("detach %s failed: %s", iface.name, exc)

    def _count_attach(self, kind: str, iface, attempt: int) -> None:
        # reference counts attach_tc/attach_tcx/attach_fail with the attempt
        # number (interfaces_listener.go:192-247); level gates cardinality,
        # so the mac string is only built when trace level will expose it
        if self._metrics is not None:
            mac = (":".join(f"{b:02x}" for b in iface.mac)
                   if self._metrics.level == "trace" else "")
            self._metrics.count_interface_event(
                kind, ifname=iface.name, ifindex=iface.index,
                netns=iface.netns, mac=mac, retries=attempt)

    def _attach_with_retry(self, iface) -> None:
        retries = max(self._cfg.tc_attach_retries, 1)
        for attempt in range(1, retries + 1):
            if self._stop.is_set():
                return
            try:
                self._fetcher.attach(iface.index, iface.name,
                                     self._cfg.direction, netns=iface.netns)
                self.attached.add((iface.netns, iface.index))
                self._count_attach("attach", iface, attempt)
                log.info("attached to %s (index %d, netns %r)", iface.name,
                         iface.index, iface.netns)
                return
            except DoNotRetryError as exc:
                self._count_attach("attach_fail", iface, attempt)
                log.warning("attach %s failed permanently: %s",
                            iface.name, exc)
                return
            except Exception as exc:
                self._count_attach("attach_fail", iface, attempt)
                log.warning("attach %s failed (attempt %d/%d): %s",
                            iface.name, attempt, retries, exc)
                time.sleep(_RETRY_BACKOFF_S * attempt)
        if self._metrics is not None:
            self._metrics.count_error("iface-listener")
