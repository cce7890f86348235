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
exporter to test it.

Left out, each refused by `config.AgentConfig.validate` when asked for
(ROADMAP A8): SSL correlation and tracing (ENABLE_OPENSSL_TRACKING), so
the accounter takes no SSL correlator; UDN mapping (ENABLE_UDN_MAPPING)
and the OVN network-events decoder (ENABLE_NETWORK_EVENTS_MONITORING);
and the interface listener, which only the self-managed kernel fetchers
ask for (`needs_iface_discovery`, ROADMAP A8.5). The fused drain's
binding is here (`:120-131`): a fetcher with `bind_pack_surface` is given
the exporter's `resident_pack_surface()` where that is not None; so is the
kernel flow filters' programming (`:170-171`): with FLOW_FILTER_RULES set,
a fetcher with `program_filters` is given the parsed rules.
`build_fetcher` knows `DATAPATH=synthetic`, `DATAPATH=pcap:<file>` and,
with EBPF_PROGRAM_MANAGER_MODE, the bpfman datapath
(`datapath/loader.BpfmanFetcher` over the pinned maps, `:353-355`); every
other value, unset, `auto` and `kernel` among them, raises `ValueError`
naming ROADMAP A8.4b and A8.5 (the clang-built kernel datapath, its
fallback ladder and the interface listener), where the reference loads a
kernel datapath or falls back to synthetic replay.
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
                 agent_ip: str = ""):
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

        columnar = getattr(exporter, "supports_columnar", False)
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
            force_gc=cfg.force_garbage_collection,
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
                agent_ip=agent_ip, metrics=self.metrics)

        if cfg.sampling:
            self.metrics.sampling_rate.set(cfg.sampling)

        # program kernel flow filters when the datapath supports it
        if cfg.flow_filter_rules and hasattr(fetcher, "program_filters"):
            fetcher.program_filters(cfg.parsed_filter_rules())

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
        # the fetcher first: an unported DATAPATH raises before the
        # exporter builds its kernels and captures its graphs
        fetcher = build_fetcher(cfg)
        exporter = build_exporter(cfg, metrics=metrics)
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
        self.terminal.start()
        self.limiter.start()
        if self.accounter is not None:
            self.accounter.start()
        if self.rb_tracer is not None:
            self.rb_tracer.start()
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
        self.map_tracer.stop(final_evict=True)
        if self.rb_tracer is not None:
            self.rb_tracer.stop()
        if self.accounter is not None:
            self.accounter.stop()
        self.limiter.stop()
        self.terminal.stop()
        self.fetcher.close()
        self._set_status(Status.STOPPED)


def build_fetcher(cfg: AgentConfig) -> FlowFetcher:
    """The datapath DATAPATH names: "synthetic" (zipf-skewed synthetic
    flows) or "pcap:<path>" (a pcap replayed one CACHE_ACTIVE_TIMEOUT of
    capture an eviction); else, with EBPF_PROGRAM_MANAGER_MODE, the bpfman
    datapath over the maps pinned at BPFMAN_BPF_FS_PATH (reference
    `agent.py:353-355`). The gRPC ingest is ROADMAP A8, and the
    reference's default ("auto": the kernel loader, else synthetic replay)
    and "kernel" are A8.4b and A8.5: each raises."""
    mode = os.environ.get("DATAPATH", "auto")
    if mode.startswith("pcap:"):
        from netobserv_tpu_torch.datapath.replay import PcapReplayFetcher
        return PcapReplayFetcher(mode[5:], window_s=cfg.cache_active_timeout)
    if mode == "synthetic":
        from netobserv_tpu_torch.datapath.replay import SyntheticFetcher
        return SyntheticFetcher()
    if mode.startswith("grpc:"):
        raise ValueError(
            f"DATAPATH={mode!r}: the gRPC ingest is not ported (ROADMAP A8)")
    if cfg.ebpf_program_manager_mode:
        from netobserv_tpu_torch.datapath.loader import BpfmanFetcher
        return BpfmanFetcher.load(cfg)
    raise ValueError(
        f"DATAPATH={mode!r}: the port replays DATAPATH=synthetic or "
        "DATAPATH=pcap:<file>, or drains bpfman's pinned maps with "
        "EBPF_PROGRAM_MANAGER_MODE; the self-managed kernel datapath and "
        "its fallback ladder are not ported (ROADMAP A8.4b, A8.5)")


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
