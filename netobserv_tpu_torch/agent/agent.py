"""FlowsAgent: builds and runs the flow pipeline of the port.

A copy of `netobserv_tpu/agent/agent.py` (`Status`, `FlowsAgent`,
`build_fetcher`, `resolve_agent_ip`, lines 28-419): it builds the metrics,
the exporter and the fetcher, wires the stages with bounded queues
(MapTracer -> CapacityLimiter -> QueueExporter, and with
ENABLE_FLOWS_RINGBUF_FALLBACK the ring-buffer fallback RingBufTracer ->
Accounter into the same evicted queue, `:152-167`), registers every stage
and the exporter's threads with the stage supervisor
(`agent/supervisor.py`), and exposes a status state machine and
`health_snapshot` for `/healthz` and `/readyz`. Inject the fetcher and
exporter to test it. The exporter is any that `exporter.build_exporter`
builds: the sketch exporter takes evictions columnar
(`supports_columnar`), every record exporter (grpc, stdout, ipfix, kafka)
the map tracer's and the accounter's records through `export_batch`.

The feature branches (`:66-94`, `:135-167`): ENABLE_UDN_MAPPING gives
the map tracer an `ifaces/udn.UdnMapper`; ENABLE_NETWORK_EVENTS_MONITORING
installs the OVN sample decoder `utils/ovn_decoder.make_decoder` picks,
closed and uninstalled at shutdown; ENABLE_OPENSSL_TRACKING, with a
fetcher that reads SSL events (`read_ssl`), adds the `ssl-tracer` stage
(`flow/ssl_tracer.SSLTracer`) and an `SSLCorrelator` whose credits the
map tracer and the accounter attach to records, except on the columnar
path, which never makes records and only warns. The interface listener
(`agent/interfaces_listener.py`, `:172-183`) is built when the fetcher
asks (`needs_iface_discovery`, the self-managed kernel fetchers) or an
informer is injected (`iface_informer`); it registers as the
`iface-listener` stage, starts first and stops first. The fused drain's
binding is here (`:120-131`): a fetcher with `bind_pack_surface` is given
the exporter's `resident_pack_surface()` where that is not None; so is the
kernel flow filters' programming (`:170-171`): with FLOW_FILTER_RULES set,
a fetcher with `program_filters` is given the parsed rules.
`build_fetcher` is the reference's ladder (`:333-375`): DATAPATH=pcap:<file>
and DATAPATH=synthetic replay; with EBPF_PROGRAM_MANAGER_MODE the bpfman
datapath; otherwise (unset, `auto`, `kernel`) `datapath/loader.KernelFetcher`
(the clang-built object through libbpf, else the hand-assembled
datapath), then `MinimalKernelFetcher`, then synthetic replay with a
warning, except that DATAPATH=kernel raises the last rung's error.
DATAPATH=grpc:<port> serves the pbflow collector on that port
(`datapath/grpc_ingest.GrpcIngestFetcher`): the collector-tier worker
that per-node EXPORT=grpc agents feed.
"""

from __future__ import annotations

import enum
import logging
import os
import queue
import socket
import threading
from typing import Optional

from netobserv_tpu_torch.agent.supervisor import Supervisor
from netobserv_tpu_torch.config import AgentConfig
from netobserv_tpu_torch.datapath.fetcher import FlowFetcher
from netobserv_tpu_torch.exporter import build_exporter
from netobserv_tpu_torch.exporter.base import Exporter, QueueExporter
from netobserv_tpu_torch.flow import (
    Accounter, CapacityLimiter, MapTracer, RingBufTracer,
)
from netobserv_tpu_torch.metrics.registry import Metrics, MetricsSettings
from netobserv_tpu_torch.utils import retrace, tracing

log = logging.getLogger("netobserv_tpu_torch.agent")


class Status(enum.Enum):
    NOT_STARTED = "NotStarted"
    STARTING = "Starting"
    STARTED = "Started"
    #: a supervised stage exhausted its restart budget: the agent keeps
    #: serving with the surviving stages, but /readyz reports 503 and the
    #: condition is explicit (never a silent stall)
    DEGRADED = "Degraded"
    STOPPING = "Stopping"
    STOPPED = "Stopped"


class FlowsAgent:
    """Build with `FlowsAgent.from_config(cfg)` for the real wiring, or inject
    fetcher/exporter directly for tests."""

    def __init__(self, cfg: AgentConfig, fetcher: FlowFetcher,
                 exporter: Exporter, metrics: Optional[Metrics] = None,
                 agent_ip: str = "", iface_informer=None):
        self.cfg = cfg
        self.fetcher = fetcher
        self.exporter = exporter
        self.metrics = metrics or Metrics(MetricsSettings(
            prefix=cfg.metrics_prefix, level=cfg.metrics_level))
        # observability plumbing (utils/tracing.py, utils/retrace.py):
        # sampled flight-recorder spans feed stage_seconds{stage=...}, and
        # recaptures alarm via sketch_retraces_total{fn=...}
        tracing.set_metrics(self.metrics)
        retrace.set_metrics(self.metrics)
        self._status = Status.NOT_STARTED
        self._status_lock = threading.Lock()
        self._stop = threading.Event()

        buf = cfg.buffers_length
        export_buf = cfg.exporter_buffer_length or buf
        self._evicted_q: queue.Queue = queue.Queue(maxsize=buf)
        self._export_q: queue.Queue = queue.Queue(maxsize=export_buf)

        udn_mapper = None
        if cfg.enable_udn_mapping:
            from netobserv_tpu_torch.ifaces.udn import UdnMapper
            udn_mapper = UdnMapper()
        self._ovn_decoder = None
        if cfg.enable_network_events_monitoring:
            # install the OVN sample decoder (ovsdb-backed when the OVN
            # socket exists, static otherwise; reference agent.go:136-147)
            from netobserv_tpu_torch.utils import ovn_decoder
            self._ovn_decoder = ovn_decoder.make_decoder(cfg)
            ovn_decoder.set_decoder(self._ovn_decoder)
        columnar = getattr(exporter, "supports_columnar", False)
        ssl_tracking = (cfg.enable_openssl_tracking
                        and hasattr(fetcher, "read_ssl"))
        self.ssl_correlator = None
        if ssl_tracking:
            if columnar:
                # _attach_features never runs on the columnar fast path, so
                # credits would accumulate forever and never export
                log.warning("SSL plaintext correlation is a no-op on the "
                            "columnar fast path (records are never "
                            "materialized)")
            else:
                from netobserv_tpu_torch.flow.ssl_correlator import (
                    SSLCorrelator,
                )
                self.ssl_correlator = SSLCorrelator()
        # map capacity for the occupancy histogram + pressure relief: a
        # fetcher that knows its map's capacity reports it, else the
        # datapath was sized from CACHE_MAX_FLOWS
        probe = getattr(fetcher, "map_capacity", None)
        map_capacity = probe() if probe is not None else 0
        if not map_capacity:
            map_capacity = cfg.cache_max_flows
        self.map_tracer = MapTracer(
            fetcher, self._evicted_q,
            active_timeout_s=cfg.cache_active_timeout, agent_ip=agent_ip,
            metrics=self.metrics,
            stale_purge_s=cfg.stale_entries_evict_timeout,
            # columnar fast path: exporters that consume raw evictions skip
            # per-record Python object materialization entirely
            columnar=columnar,
            udn_mapper=udn_mapper,
            force_gc=cfg.force_garbage_collection,
            ssl_correlator=self.ssl_correlator,
            map_capacity=map_capacity,
            pressure_watermark=cfg.map_pressure_watermark,
            # fleet telemetry: a sketch exporter records the last drain's
            # occupancy so its delta frames carry it
            occupancy_sink=getattr(exporter, "note_map_occupancy", None))
        # the fused drain (reference `agent.py:120-131`): where the fetcher
        # runs one (`bind_pack_surface`) and the exporter's ring takes
        # pre-packed regions (`resident_pack_surface`), the drain packs
        # them with the ring's dictionaries
        bind = getattr(fetcher, "bind_pack_surface", None)
        surface_of = getattr(exporter, "resident_pack_surface", None)
        if bind is not None and surface_of is not None:
            surface = surface_of()
            if surface is not None:
                bind(surface)
        self.limiter = CapacityLimiter(
            self._evicted_q, self._export_q, metrics=self.metrics)
        self.terminal = QueueExporter(
            exporter, self._export_q, metrics=self.metrics)

        self.ssl_tracer = None
        if ssl_tracking:
            from netobserv_tpu_torch.flow.ssl_tracer import SSLTracer

            def _ssl_handle(event):
                if self.ssl_correlator is not None:
                    credited = self.ssl_correlator.observe(event)
                else:
                    credited = 0
                log.debug("ssl %s pid=%d %dB -> %d flow keys credited",
                          "write" if event.direction else "read", event.pid,
                          len(event.data), credited)

            self.ssl_tracer = SSLTracer(fetcher, _ssl_handle)

        self.rb_tracer: Optional[RingBufTracer] = None
        self.accounter: Optional[Accounter] = None
        if cfg.enable_flows_ringbuf_fallback:
            self._rb_q: queue.Queue = queue.Queue(maxsize=buf * 10)
            self.rb_tracer = RingBufTracer(
                fetcher, self._rb_q, flusher=self.map_tracer.flush,
                metrics=self.metrics)
            self.accounter = Accounter(
                self._rb_q, self._evicted_q,
                max_entries=cfg.cache_max_flows,
                evict_timeout_s=cfg.cache_active_timeout,
                agent_ip=agent_ip, metrics=self.metrics,
                ssl_correlator=self.ssl_correlator)

        if cfg.sampling:
            self.metrics.sampling_rate.set(cfg.sampling)

        # program kernel flow filters when the datapath supports it
        if cfg.flow_filter_rules and hasattr(fetcher, "program_filters"):
            fetcher.program_filters(cfg.parsed_filter_rules())

        # discovery is only useful when the datapath attaches to interfaces
        # (the kernel loaders); replay and fake fetchers skip it unless an
        # informer is injected
        self.iface_listener = None
        if iface_informer is not None or getattr(
                fetcher, "needs_iface_discovery", False):
            from netobserv_tpu_torch.agent.interfaces_listener import (
                InterfaceListener,
            )
            self.iface_listener = InterfaceListener(
                cfg, fetcher, metrics=self.metrics, informer=iface_informer)

        # query plane: the sketch exporter's QueryRoutes, which the metrics
        # server serves at /query/*
        self.query_routes = getattr(exporter, "query_routes", None)

        # supervision: every stage thread registers a heartbeat + restart;
        # crashed/hung stages restart with bounded backoff, exhausted
        # budgets degrade the agent explicitly (agent/supervisor.py)
        self.supervisor = Supervisor(
            metrics=self.metrics,
            check_period_s=cfg.supervisor_check_period,
            on_degraded=self._on_stage_degraded)
        self._register_stages()

    def _register_stages(self) -> None:
        cfg = self.cfg
        budget = dict(max_restarts=cfg.supervisor_max_restarts,
                      backoff_initial_s=cfg.supervisor_backoff_initial,
                      backoff_max_s=cfg.supervisor_backoff_max,
                      healthy_reset_s=cfg.supervisor_healthy_reset)
        hb = cfg.supervisor_heartbeat_timeout
        sup = self.supervisor
        # the map tracer beats once per eviction wakeup, so its hang
        # deadline rides on top of the eviction period
        sup.register_stage("map-tracer", self.map_tracer,
                           heartbeat_timeout_s=cfg.cache_active_timeout + hb,
                           **budget)
        sup.register_stage("capacity-limiter", self.limiter,
                           heartbeat_timeout_s=hb, **budget)
        sup.register_stage("exporter", self.terminal,
                           heartbeat_timeout_s=hb, **budget)
        if self.accounter is not None:
            sup.register_stage("accounter", self.accounter,
                               heartbeat_timeout_s=hb, **budget)
        if self.rb_tracer is not None:
            sup.register_stage("ringbuf-tracer", self.rb_tracer,
                               heartbeat_timeout_s=hb, **budget)
        if self.ssl_tracer is not None:
            sup.register_stage("ssl-tracer", self.ssl_tracer,
                               heartbeat_timeout_s=hb, **budget)
        if self.iface_listener is not None:
            sup.register_stage("iface-listener", self.iface_listener,
                               heartbeat_timeout_s=hb, **budget)
        # the sketch exporter supervises its own window and fold threads
        register = getattr(self.exporter, "register_supervised", None)
        if register is not None:
            register(sup, heartbeat_timeout_s=hb, **budget)

    def _on_stage_degraded(self, stage: str) -> None:
        with self._status_lock:
            if self._status == Status.STARTED:
                self._status = Status.DEGRADED
        log.error("agent DEGRADED: stage %s is down for good "
                  "(restart budget exhausted)", stage)

    def health_snapshot(self) -> dict:
        """Machine-readable agent health for /healthz + /readyz
        (metrics/server.py). `conditions` carries supervisor-registered
        stage conditions (e.g. the overload controller's OVERLOADED);
        `overloaded` hoists that one to the top level — it is DISTINCT
        from `degraded`: an overloaded agent is healthy and serving,
        deliberately trading resolution for stability, so it stays
        ready (pulling it from rotation would just shift the load)."""
        conditions = self.supervisor.conditions()
        return {
            "status": self.status.value,
            "degraded": self.supervisor.degraded,
            "overloaded": bool(
                conditions.get("overloaded", {}).get("active")),
            "conditions": conditions,
            "stages": self.supervisor.snapshot(),
        }

    @classmethod
    def from_config(cls, cfg: AgentConfig) -> "FlowsAgent":
        cfg.validate()
        agent_ip = resolve_agent_ip(cfg)
        metrics = Metrics(MetricsSettings(
            prefix=cfg.metrics_prefix, level=cfg.metrics_level))
        # the fetcher first: a DATAPATH that cannot start raises before
        # the exporter builds its kernels and captures its graphs (the
        # gRPC ingest's server threads only parse and queue, no CUDA
        # call); a fetcher's maps, pins or server are released if the
        # exporter fails
        fetcher = build_fetcher(cfg)
        try:
            exporter = build_exporter(cfg, metrics=metrics)
        except BaseException:
            fetcher.close()
            raise
        return cls(cfg, fetcher, exporter, metrics=metrics, agent_ip=agent_ip)

    @property
    def status(self) -> Status:
        with self._status_lock:
            return self._status

    def _set_status(self, s: Status) -> None:
        with self._status_lock:
            self._status = s
        log.debug("agent status: %s", s.value)

    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Start the pipeline and block until `stop` is set (or .stop())."""
        self._set_status(Status.STARTING)
        if self.iface_listener is not None:
            self.iface_listener.start()
        self.terminal.start()
        self.limiter.start()
        if self.accounter is not None:
            self.accounter.start()
        if self.rb_tracer is not None:
            self.rb_tracer.start()
        if self.ssl_tracer is not None:
            self.ssl_tracer.start()
        self.map_tracer.start()
        if self.cfg.supervisor_enable:
            self.supervisor.start()
        self._set_status(Status.STARTED)
        self._active_stop = stop = stop or self._stop
        stop.wait()
        self.shutdown()

    def stop(self) -> None:
        self._stop.set()
        active = getattr(self, "_active_stop", None)
        if active is not None:
            active.set()

    def shutdown(self) -> None:
        if self.status in (Status.STOPPING, Status.STOPPED):
            return
        self._set_status(Status.STOPPING)
        # the supervisor goes first: a stopping stage's dead thread must not
        # be mistaken for a crash and restarted mid-shutdown
        self.supervisor.stop()
        # stop stages source-first, with a final eviction so nothing is
        # lost; the terminal drains its queue, then closes the exporter,
        # which publishes the last window
        if self.iface_listener is not None:
            self.iface_listener.stop()
        self.map_tracer.stop(final_evict=True)
        if self.ssl_tracer is not None:
            self.ssl_tracer.stop()
        if self.rb_tracer is not None:
            self.rb_tracer.stop()
        if self.accounter is not None:
            self.accounter.stop()
        self.limiter.stop()
        self.terminal.stop()
        self.fetcher.close()
        if self._ovn_decoder is not None:
            from netobserv_tpu_torch.utils import ovn_decoder
            self._ovn_decoder.close()
            ovn_decoder.set_decoder(None)  # drop this agent's global install
            self._ovn_decoder = None
        self._set_status(Status.STOPPED)


def build_fetcher(cfg: AgentConfig) -> FlowFetcher:
    """Datapath selection: kernel loader when available, replay otherwise
    (`netobserv_tpu/agent/agent.py:333-375`).

    DATAPATH ("kernel" | "synthetic" | "pcap:<path>" | "grpc:<port>")
    overrides; the default tries the kernel loader (bpfman mode when
    EBPF_PROGRAM_MANAGER_MODE is set) and falls back to synthetic replay
    with a warning. "grpc:<port>" is the collector tier's ingest: a
    `GrpcIngestFetcher` serving the pbflow collector on that port.
    """
    mode = os.environ.get("DATAPATH", "auto")
    # an explicit DATAPATH replay request overrides everything (debug/replay)
    if mode.startswith("pcap:"):
        from netobserv_tpu_torch.datapath.replay import PcapReplayFetcher
        return PcapReplayFetcher(mode[5:], window_s=cfg.cache_active_timeout)
    if mode == "synthetic":
        from netobserv_tpu_torch.datapath.replay import SyntheticFetcher
        return SyntheticFetcher()
    if mode.startswith("grpc:"):
        from netobserv_tpu_torch.datapath.grpc_ingest import GrpcIngestFetcher
        return GrpcIngestFetcher(int(mode[5:]))
    if cfg.ebpf_program_manager_mode:
        from netobserv_tpu_torch.datapath.loader import BpfmanFetcher
        return BpfmanFetcher.load(cfg)
    try:
        from netobserv_tpu_torch.datapath.loader import KernelFetcher
        return KernelFetcher.load(cfg)
    except Exception as exc:
        log.debug("full kernel datapath unavailable: %s", exc)
    try:
        # hand-assembled minimal datapath: real IPv4 TCP/UDP flow capture
        # without a compiled BPF object (datapath/asm_flowpath.py)
        from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher
        fetcher = MinimalKernelFetcher.load(cfg)
        log.info("using the minimal hand-assembled kernel datapath "
                 "(IPv4 TCP/UDP base flows; build the clang object for "
                 "full features)")
        return fetcher
    except Exception as exc:
        if mode == "kernel":
            raise
        log.warning("kernel datapath unavailable (%s); using synthetic replay",
                    exc)
        from netobserv_tpu_torch.datapath.replay import SyntheticFetcher
        return SyntheticFetcher()


def resolve_agent_ip(cfg: AgentConfig) -> str:
    """Agent IP resolution (`netobserv_tpu/agent/agent.py:385-419`).

    AGENT_IP takes precedence; otherwise derive from the routing table
    (external) or hostname (local), honoring AGENT_IP_TYPE (any/ipv4/ipv6).
    A box without a route answers 127.0.0.1: the external probe only
    connects a UDP socket, which sends nothing.
    """
    if cfg.agent_ip:
        return cfg.agent_ip
    want = cfg.agent_ip_type
    if cfg.agent_ip_iface == "local":
        host = socket.gethostname()
        try:
            infos = socket.getaddrinfo(host, None)
        except OSError:
            return "127.0.0.1"
        for family in ((socket.AF_INET,) if want in ("any", "ipv4")
                       else ()) + ((socket.AF_INET6,)
                                   if want in ("any", "ipv6") else ()):
            for info in infos:
                if info[0] == family:
                    return info[4][0]
        return "127.0.0.1"
    # "external": learn the egress address by opening a dummy UDP socket
    probes = []
    if want in ("any", "ipv4"):
        probes.append((socket.AF_INET, "8.8.8.8"))
    if want in ("any", "ipv6"):
        probes.append((socket.AF_INET6, "2001:4860:4860::8888"))
    for family, target in probes:
        try:
            s = socket.socket(family, socket.SOCK_DGRAM)
            s.connect((target, 80))
            ip = s.getsockname()[0]
            s.close()
            return ip
        except OSError:
            continue
    return "127.0.0.1"
