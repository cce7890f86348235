"""Agent settings of the port, and the sketch plane's thresholds and feeds.

`AgentConfig`, `load_config`, `FlowFilterRule`, `parse_filter_rules` and
the `EXPORT_*` names are a copy of `netobserv_tpu/config.py` (`:53-141`,
`:142-823`): every field with its environment name and default, read by
the same rules, so one environment gives equal configurations in both
packages. `AgentConfig.validate` runs the reference's checks (the
alert-rule check, `:726-734`, through the port's `alerts/rules` and
`alerts/sinks`); every setting of the flow agent, of EXPORT=direct-flp
(FLP_CONFIG, FLP_KUBE_MAP, FLP_LOCATION_DB) and of the packets agent
(ENABLE_PCA, PCA_SERVER_PORT) is ported, and the modes the port lacks
(FEDERATION_MODE=aggregator, DATAPATH=grpc:) are refused where they are
read (`__main__.py`, `agent.build_fetcher`), naming their ROADMAP item
(A8.9). The agents (`agent/agent.py`, `agent/packets_agent.py`),
`exporter.build_exporter` and `TorchSketchExporter.from_config` read it.

The `DEFAULT_*` thresholds are copies of the reference's: the window
report renderer (`exporter/report.py`) reads them as its defaults.
`resolved_pack_threads` and `parse_superbatch_ladder` are copies of
`AgentConfig.resolved_pack_threads` and `parsed_superbatch_ladder`
(`:592-620`) as functions of their setting. The per-plane settings
classes hold the settings of one plane each for callers that make that
plane alone, under the reference's field names, so `AgentConfig` serves
wherever they do: `QuerySettings` the query and alerting planes'
(`:443-451`, `:495-518`) with their checks (`:693-733`), which
`alerts/engine.maybe_engine` takes; `FederationSettings` the federation
aggregator's and the delta sender's (`:545-590`); `ArchiveSettings` the
archive's (`:520-544`) with their checks (`:735-750`), which
`archive.maybe_archive` takes; `CheckpointSettings` the exporter's and the
aggregator's checkpoints' (`:325-326`, `:581-590`); `OverloadSettings` the
overload controller's and the overlapped fold thread's (`:455-482`) with
their checks (`:697-712`); and `SupervisorSettings` the stage
supervisor's (`:247-270`). `parse_duration` is a copy of the reference's
(`:18-43`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional

log = logging.getLogger("netobserv_tpu_torch.config")

#: port-scan fan-out: distinct (dst addr, dst port) pairs per source bucket
DEFAULT_SCAN_FANOUT = 512
#: DDoS z-score threshold
DEFAULT_DDOS_Z = 6.0
#: SYN flood: minimum half-open attempts per victim bucket per window, and
#: the offered:accepted (SYN : SYN-ACK) ratio both required to report
DEFAULT_SYNFLOOD_MIN = 128
DEFAULT_SYNFLOOD_RATIO = 8.0
#: drop-anomaly z-score threshold
DEFAULT_DROP_Z = 6.0
#: conversation asymmetry: minimum window bytes of a pair bucket and the
#: one-way share at which it is reported
DEFAULT_ASYM_MIN_BYTES = 1 << 20
DEFAULT_ASYM_RATIO = 0.95
#: heavy-hitter churn: ascent factor and minimum current mass
DEFAULT_CHURN_ASCENT = 8.0
DEFAULT_CHURN_MIN_BYTES = 1 << 20


def resolved_pack_threads(pack_threads: int) -> int:
    """SKETCH_PACK_THREADS with 0 = auto (the CPU count, at most 8)."""
    if pack_threads > 0:
        return pack_threads
    return min(os.cpu_count() or 1, 8)


def parse_superbatch_ladder(spec) -> tuple[int, ...]:
    """A superbatch ladder ("1,2,4" as SKETCH_SUPERBATCH gives it, or an
    iterable of ints) as a sorted tuple without repeats. It must include 1,
    be positive and stay at most 64 (each entry costs k-batch buffers and
    key-table rows, so a larger one is taken for a typo)."""
    try:
        toks = spec.split(",") if isinstance(spec, str) else list(spec)
        ladder = tuple(sorted({int(tok) for tok in toks if tok != ""}))
    except (TypeError, ValueError) as exc:
        raise ValueError(f"superbatch ladder {spec!r}: want comma-separated "
                         "ints, e.g. 1,2,4") from exc
    if not ladder or ladder[0] != 1 or any(k < 1 for k in ladder):
        raise ValueError(f"superbatch ladder {spec!r}: the ladder must "
                         "include 1 and be positive")
    if ladder[-1] > 64:
        raise ValueError(f"superbatch ladder {spec!r}: entries above 64 are "
                         "almost certainly a typo (each costs k*batch-sized "
                         "buffers and key-table rows)")
    return ladder


@dataclass
class QuerySettings:
    """The query plane's and the alerting plane's settings, under the
    reference's names: `sketch_query_refresh` (SKETCH_QUERY_REFRESH, the
    mid-window refresh period in seconds, 0 = off), `sketch_query_history`
    (SKETCH_QUERY_HISTORY, the closed-window snapshots kept for
    ``?window=``), `alert_rules` (ALERT_RULES, "" = no engine),
    `alert_raise_evals`, `alert_clear_evals`, `alert_sinks`,
    `alert_webhook_url`, `alert_webhook_interval` (seconds) and
    `alert_ring`. A value the reference refuses raises here."""

    sketch_query_refresh: float = 0.0
    sketch_query_history: int = 8
    alert_rules: str = ""
    alert_raise_evals: int = 2
    alert_clear_evals: int = 2
    alert_sinks: str = "log,metrics"
    alert_webhook_url: str = ""
    alert_webhook_interval: float = 1.0
    alert_ring: int = 256

    def __post_init__(self):
        if self.sketch_query_refresh < 0:
            raise ValueError(
                "SKETCH_QUERY_REFRESH must be >= 0 (0 disables the "
                "mid-window refresh)")
        if self.sketch_query_history < 0:
            raise ValueError("SKETCH_QUERY_HISTORY must be >= 0 "
                             "(0 disables the back-scroll ring)")
        if self.alert_raise_evals < 1 or self.alert_clear_evals < 1:
            raise ValueError("ALERT_RAISE_EVALS and ALERT_CLEAR_EVALS "
                             "must be >= 1")
        if self.alert_ring < 1:
            raise ValueError("ALERT_RING must be >= 1")
        if self.alert_webhook_interval < 0:
            raise ValueError("ALERT_WEBHOOK_INTERVAL must be >= 0")
        if self.alert_rules:
            # a malformed rule spec or sink set fails here, not at the
            # exporter's construction
            from netobserv_tpu_torch.alerts.rules import parse_rules
            from netobserv_tpu_torch.alerts.sinks import build_sinks
            parse_rules(self.alert_rules)
            build_sinks(self)


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
    "h": 3600.0,
}


def parse_duration(text: str) -> float:
    """Parse a Go-style duration string ("5s", "300ms", "1m30s") into
    seconds; a plain number is seconds, an empty string 0."""
    text = text.strip()
    if not text:
        return 0.0
    try:
        return float(text)
    except ValueError:
        pass
    total = 0.0
    pos = 0
    for m in _DURATION_RE.finditer(text):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {text!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(text):
        raise ValueError(f"invalid duration: {text!r}")
    return total


@dataclass
class FederationSettings:
    """The federation plane's settings, under the reference's names and
    defaults: `federation_window` (FEDERATION_WINDOW, the aggregator's
    window in seconds), `federation_stale_after` (FEDERATION_STALE_AFTER,
    seconds without a delta before an agent reads as stale),
    `federation_agent_ttl` (FEDERATION_AGENT_TTL, seconds before a silent
    agent is evicted, 0 = never) and `federation_agent_id`
    (FEDERATION_AGENT_ID, the agent identity its frames carry; "" = the
    host name). `from_env` reads them as the reference does: the three
    durations through `parse_duration`, which raises on a malformed one."""

    federation_window: float = 60.0
    federation_stale_after: float = 120.0
    federation_agent_ttl: float = 600.0
    federation_agent_id: str = ""

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "FederationSettings":
        env = os.environ if environ is None else environ
        out = cls()
        for name in ("federation_window", "federation_stale_after",
                     "federation_agent_ttl"):
            raw = env.get(name.upper())
            if raw:  # set but empty reads as unset, as the reference's
                setattr(out, name, parse_duration(raw))
        out.federation_agent_id = env.get("FEDERATION_AGENT_ID",
                                          out.federation_agent_id)
        return out


def _env_int(env: Mapping[str, str], name: str, default: int) -> int:
    """An integer setting; set but empty reads as unset, as the
    reference's."""
    raw = env.get(name)
    return int(raw) if raw else default


@dataclass
class ArchiveSettings:
    """The archive's settings, under the reference's names and defaults:
    `archive_dir` (ARCHIVE_DIR, "" = no archive), `archive_raw_windows`
    (ARCHIVE_RAW_WINDOWS, raw segments a level keeps before its oldest
    group compacts), `archive_compact_group` (ARCHIVE_COMPACT_GROUP, the
    coarsening factor), `archive_max_levels` (ARCHIVE_MAX_LEVELS) and
    `archive_merge_ladder_max` (ARCHIVE_MERGE_LADDER_MAX, the largest
    merge of one dispatch, a power of two in [1, 64]: every power of two
    up to it is a CUDA graph). A value the reference refuses raises
    here."""

    archive_dir: str = ""
    archive_raw_windows: int = 64
    archive_compact_group: int = 8
    archive_max_levels: int = 3
    archive_merge_ladder_max: int = 16

    def __post_init__(self):
        if self.archive_compact_group < 2:
            raise ValueError("ARCHIVE_COMPACT_GROUP must be >= 2 (it is "
                             "the RRD coarsening factor)")
        if self.archive_raw_windows < self.archive_compact_group:
            raise ValueError(
                f"ARCHIVE_RAW_WINDOWS ({self.archive_raw_windows}) must "
                f"be >= ARCHIVE_COMPACT_GROUP "
                f"({self.archive_compact_group})")
        if self.archive_max_levels < 1:
            raise ValueError("ARCHIVE_MAX_LEVELS must be >= 1")
        v = self.archive_merge_ladder_max
        if v < 1 or v & (v - 1) or v > 64:
            raise ValueError(
                f"ARCHIVE_MERGE_LADDER_MAX must be a power of two in "
                f"[1, 64] (got {v}) — every power of two up to it costs "
                "a pre-built merge executable")

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "ArchiveSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(archive_dir=env.get("ARCHIVE_DIR", ""), **{
            name: _env_int(env, name.upper(), d[name].default)
            for name in ("archive_raw_windows", "archive_compact_group",
                         "archive_max_levels", "archive_merge_ladder_max")})


@dataclass
class CheckpointSettings:
    """The checkpoint settings, under the reference's names and defaults:
    `sketch_checkpoint_dir` (SKETCH_CHECKPOINT_DIR, "" = none) and
    `sketch_checkpoint_every` (SKETCH_CHECKPOINT_EVERY, every Nth window
    roll, 0 = never) of the exporter; `federation_checkpoint_dir`
    (FEDERATION_CHECKPOINT_DIR) and `federation_checkpoint_every`
    (FEDERATION_CHECKPOINT_EVERY, default every roll) of the
    aggregator."""

    sketch_checkpoint_dir: str = ""
    sketch_checkpoint_every: int = 0
    federation_checkpoint_dir: str = ""
    federation_checkpoint_every: int = 1

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "CheckpointSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(
            sketch_checkpoint_dir=env.get("SKETCH_CHECKPOINT_DIR", ""),
            federation_checkpoint_dir=env.get("FEDERATION_CHECKPOINT_DIR",
                                              ""),
            **{name: _env_int(env, name.upper(), d[name].default)
               for name in ("sketch_checkpoint_every",
                            "federation_checkpoint_every")})


def _parse_bool(text: str) -> bool:
    """A boolean setting as the reference reads one."""
    return text.strip().lower() in ("1", "true", "yes", "on")


def _env_typed(env: Mapping[str, str], fields: dict, durations=()) -> dict:
    """The settings of `fields` (name -> default) that `env` sets under
    their upper-case names, each read as its default's type (a name in
    `durations` through `parse_duration`); set but empty reads as unset,
    as the reference's."""
    out = {}
    for name, default in fields.items():
        raw = env.get(name.upper())
        if not raw:
            continue
        if name in durations:
            out[name] = parse_duration(raw)
        elif isinstance(default, bool):
            out[name] = _parse_bool(raw)
        else:
            out[name] = type(default)(raw)
    return out


@dataclass
class OverloadSettings:
    """The overload controller's and the overlapped fold thread's settings,
    under the reference's names and defaults: `sketch_shed_watermark`
    (SKETCH_SHED_WATERMARK, the pressure score in batches above which the
    exporter sheds; 0 = no controller), `sketch_shed_max`
    (SKETCH_SHED_MAX, the largest 1-in-N factor), `sketch_shed_slot_budget`
    (SKETCH_SHED_SLOT_BUDGET, a duration: the longest one fold waits for a
    staging slot while a controller exists) and `sketch_overlap`
    (SKETCH_OVERLAP, the handoff depth of the fold thread; 0 = no thread).
    A value the reference refuses raises here. The exporter takes them as
    `shed_watermark`, `shed_max`, `shed_slot_budget_s` and
    `overlap_depth`."""

    sketch_shed_watermark: float = 0.0
    sketch_shed_max: int = 64
    sketch_shed_slot_budget: float = 30.0
    sketch_overlap: int = 0

    def __post_init__(self):
        if self.sketch_shed_watermark < 0:
            raise ValueError("SKETCH_SHED_WATERMARK must be >= 0 (0 disables)")
        if self.sketch_overlap < 0:
            raise ValueError("SKETCH_OVERLAP must be >= 0 (0 keeps the "
                             "synchronous export seam)")
        if self.sketch_shed_max < 2:
            raise ValueError("SKETCH_SHED_MAX must be >= 2 (it bounds the "
                             "1-in-N shed factor)")

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "OverloadSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(**_env_typed(env, {n: f.default for n, f in d.items()},
                                durations=("sketch_shed_slot_budget",)))


@dataclass
class SupervisorSettings:
    """The stage supervisor's settings, under the reference's names and
    defaults: `supervisor_enable` (SUPERVISOR_ENABLE), and the durations
    `supervisor_check_period` (SUPERVISOR_CHECK_PERIOD),
    `supervisor_backoff_initial`, `supervisor_backoff_max`,
    `supervisor_healthy_reset` and `supervisor_heartbeat_timeout`, and
    `supervisor_max_restarts` (the consecutive failures before a stage is
    DEGRADED). `agent/supervisor.Supervisor` takes the check period;
    `register_supervised` the rest."""

    supervisor_enable: bool = True
    supervisor_check_period: float = 0.25
    supervisor_max_restarts: int = 5
    supervisor_backoff_initial: float = 0.2
    supervisor_backoff_max: float = 30.0
    supervisor_healthy_reset: float = 30.0
    supervisor_heartbeat_timeout: float = 300.0

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "SupervisorSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(**_env_typed(
            env, {n: f.default for n, f in d.items()},
            durations=("supervisor_check_period",
                       "supervisor_backoff_initial", "supervisor_backoff_max",
                       "supervisor_healthy_reset",
                       "supervisor_heartbeat_timeout")))


def _env(name: str, default: str = "") -> dict:
    return {"metadata": {"env": name, "default": default}}


# Exporter backend names (`netobserv_tpu/config.py:53-62`).
EXPORT_GRPC = "grpc"
EXPORT_KAFKA = "kafka"
EXPORT_IPFIX_UDP = "ipfix+udp"
EXPORT_IPFIX_TCP = "ipfix+tcp"
EXPORT_DIRECT_FLP = "direct-flp"
EXPORT_TPU_SKETCH = "tpu-sketch"
EXPORT_STDOUT = "stdout"


VALID_EXPORTERS = (
    EXPORT_GRPC, EXPORT_KAFKA, EXPORT_IPFIX_UDP, EXPORT_IPFIX_TCP,
    EXPORT_DIRECT_FLP, EXPORT_TPU_SKETCH, EXPORT_STDOUT,
)



@dataclass
class FlowFilterRule:
    """One flow-filter rule (`netobserv_tpu/config.py:101-129`)."""

    ip_cidr: str = "0.0.0.0/0"
    action: str = "Accept"  # Accept | Reject
    direction: str = ""  # Ingress | Egress | ""
    protocol: str = ""  # TCP | UDP | SCTP | ICMP | ICMPv6
    source_port: int = 0
    source_port_range: str = ""
    source_ports: str = ""
    destination_port: int = 0
    destination_port_range: str = ""
    destination_ports: str = ""
    port: int = 0
    port_range: str = ""
    ports: str = ""
    icmp_type: int = 0
    icmp_code: int = 0
    peer_ip: str = ""
    peer_cidr: str = ""
    tcp_flags: str = ""  # e.g. "SYN", "SYN-ACK"
    drops: bool = False
    sample: int = 0  # per-rule sampling override

    @classmethod
    def from_json_obj(cls, obj: dict) -> "FlowFilterRule":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in names})


def parse_filter_rules(text: str) -> list[FlowFilterRule]:
    """Parse the JSON-in-env FLOW_FILTER_RULES list
    (`netobserv_tpu/config.py:132-139`)."""
    if not text.strip():
        return []
    data = json.loads(text)
    if not isinstance(data, list):
        raise ValueError("FLOW_FILTER_RULES must be a JSON array")
    return [FlowFilterRule.from_json_obj(o) for o in data]


@dataclass
class AgentConfig:  # noqa: PLR0902 - deliberately wide, as the reference's
    """All agent settings, a copy of `netobserv_tpu/config.py`'s
    `AgentConfig` (`:142-772`): every field with its environment name and
    default in its metadata, so one environment reads the same in both
    packages (each field's comment is at the reference). `validate` runs
    the reference's checks."""

    # --- identity / export target ---
    agent_ip: str = field(default="", **_env("AGENT_IP"))
    agent_ip_iface: str = field(default="external", **_env("AGENT_IP_IFACE", "external"))
    agent_ip_type: str = field(default="any", **_env("AGENT_IP_TYPE", "any"))
    export: str = field(default="grpc", **_env("EXPORT", "grpc"))
    target_host: str = field(default="", **_env("TARGET_HOST"))
    target_port: int = field(default=0, **_env("TARGET_PORT", "0"))
    target_tls_ca_cert_path: str = field(default="", **_env("TARGET_TLS_CA_CERT_PATH"))
    target_tls_user_cert_path: str = field(default="", **_env("TARGET_TLS_USER_CERT_PATH"))
    target_tls_user_key_path: str = field(default="", **_env("TARGET_TLS_USER_KEY_PATH"))
    grpc_message_max_flows: int = field(default=10000, **_env("GRPC_MESSAGE_MAX_FLOWS", "10000"))
    grpc_reconnect_timer: float = field(default=0.0, **_env("GRPC_RECONNECT_TIMER"))
    grpc_reconnect_timer_randomization: float = field(
        default=0.0, **_env("GRPC_RECONNECT_TIMER_RANDOMIZATION"))

    # --- interface selection ---
    interfaces: list[str] = field(default_factory=list, **_env("INTERFACES"))
    exclude_interfaces: list[str] = field(
        default_factory=lambda: ["lo"], **_env("EXCLUDE_INTERFACES", "lo"))
    interface_ips: list[str] = field(default_factory=list, **_env("INTERFACE_IPS"))
    listen_interfaces: str = field(default="watch", **_env("LISTEN_INTERFACES", "watch"))
    listen_poll_period: float = field(default=10.0, **_env("LISTEN_POLL_PERIOD", "10s"))
    preferred_interface_for_mac_prefix: str = field(
        default="", **_env("PREFERRED_INTERFACE_FOR_MAC_PREFIX"))

    # --- pipeline sizing ---
    buffers_length: int = field(default=50, **_env("BUFFERS_LENGTH", "50"))
    exporter_buffer_length: int = field(default=0, **_env("EXPORTER_BUFFER_LENGTH", "0"))
    cache_max_flows: int = field(default=5000, **_env("CACHE_MAX_FLOWS", "5000"))
    cache_active_timeout: float = field(default=5.0, **_env("CACHE_ACTIVE_TIMEOUT", "5s"))
    evict_drain_lanes: int = field(default=0, **_env("EVICT_DRAIN_LANES", "0"))
    evict_native_pipeline: bool = field(
        default=False, **_env("EVICT_NATIVE_PIPELINE", "false"))
    direction: str = field(default="both", **_env("DIRECTION", "both"))
    sampling: int = field(default=0, **_env("SAMPLING", "0"))
    enable_flows_ringbuf_fallback: bool = field(
        default=False, **_env("ENABLE_FLOWS_RINGBUF_FALLBACK", "false"))
    force_garbage_collection: bool = field(
        default=True, **_env("FORCE_GARBAGE_COLLECTION", "true"))
    stale_entries_evict_timeout: float = field(
        default=5.0, **_env("STALE_ENTRIES_EVICT_TIMEOUT", "5s"))

    # --- attach behavior ---
    tc_attach_mode: str = field(default="tcx", **_env("TC_ATTACH_MODE", "tcx"))
    tc_attach_retries: int = field(default=4, **_env("TC_ATTACH_RETRIES", "4"))
    tcx_attach_anchor_ingress: str = field(
        default="none", **_env("TCX_ATTACH_ANCHOR_INGRESS", "none"))
    tcx_attach_anchor_egress: str = field(
        default="none", **_env("TCX_ATTACH_ANCHOR_EGRESS", "none"))

    # --- kafka ---
    kafka_brokers: list[str] = field(default_factory=list, **_env("KAFKA_BROKERS"))
    kafka_topic: str = field(default="network-flows", **_env("KAFKA_TOPIC", "network-flows"))
    kafka_batch_messages: int = field(default=1000, **_env("KAFKA_BATCH_MESSAGES", "1000"))
    kafka_batch_size: int = field(default=1048576, **_env("KAFKA_BATCH_SIZE", "1048576"))
    kafka_async: bool = field(default=True, **_env("KAFKA_ASYNC", "true"))
    kafka_compression: str = field(default="none", **_env("KAFKA_COMPRESSION", "none"))
    kafka_enable_tls: bool = field(default=False, **_env("KAFKA_ENABLE_TLS", "false"))
    kafka_tls_insecure_skip_verify: bool = field(
        default=False, **_env("KAFKA_TLS_INSECURE_SKIP_VERIFY", "false"))
    kafka_tls_ca_cert_path: str = field(default="", **_env("KAFKA_TLS_CA_CERT_PATH"))
    kafka_tls_user_cert_path: str = field(default="", **_env("KAFKA_TLS_USER_CERT_PATH"))
    kafka_tls_user_key_path: str = field(default="", **_env("KAFKA_TLS_USER_KEY_PATH"))
    kafka_enable_sasl: bool = field(default=False, **_env("KAFKA_ENABLE_SASL", "false"))
    kafka_sasl_type: str = field(default="plain", **_env("KAFKA_SASL_TYPE", "plain"))
    kafka_sasl_client_id_path: str = field(default="", **_env("KAFKA_SASL_CLIENT_ID_PATH"))
    kafka_sasl_client_secret_path: str = field(
        default="", **_env("KAFKA_SASL_CLIENT_SECRET_PATH"))

    # --- observability ---
    log_level: str = field(default="info", **_env("LOG_LEVEL", "info"))
    pprof_addr: str = field(default="", **_env("PPROF_ADDR"))
    metrics_enable: bool = field(default=False, **_env("METRICS_ENABLE", "false"))
    metrics_level: str = field(default="info", **_env("METRICS_LEVEL", "info"))
    metrics_server_address: str = field(default="", **_env("METRICS_SERVER_ADDRESS"))
    metrics_server_port: int = field(default=9090, **_env("METRICS_SERVER_PORT", "9090"))
    metrics_tls_cert_path: str = field(default="", **_env("METRICS_TLS_CERT_PATH"))
    metrics_tls_key_path: str = field(default="", **_env("METRICS_TLS_KEY_PATH"))
    metrics_prefix: str = field(default="ebpf_agent_", **_env("METRICS_PREFIX", "ebpf_agent_"))

    # --- pipeline supervision (agent/supervisor.py; new) ---
    supervisor_enable: bool = field(
        default=True, **_env("SUPERVISOR_ENABLE", "true"))
    supervisor_check_period: float = field(
        default=0.25, **_env("SUPERVISOR_CHECK_PERIOD", "250ms"))
    supervisor_max_restarts: int = field(
        default=5, **_env("SUPERVISOR_MAX_RESTARTS", "5"))
    supervisor_backoff_initial: float = field(
        default=0.2, **_env("SUPERVISOR_BACKOFF_INITIAL", "200ms"))
    supervisor_backoff_max: float = field(
        default=30.0, **_env("SUPERVISOR_BACKOFF_MAX", "30s"))
    supervisor_healthy_reset: float = field(
        default=30.0, **_env("SUPERVISOR_HEALTHY_RESET", "30s"))
    supervisor_heartbeat_timeout: float = field(
        default=300.0, **_env("SUPERVISOR_HEARTBEAT_TIMEOUT", "5m"))

    # --- feature enables (propagated to the datapath as compile-time consts) ---
    enable_rtt: bool = field(default=False, **_env("ENABLE_RTT", "false"))
    enable_pkt_drops: bool = field(default=False, **_env("ENABLE_PKT_DROPS", "false"))
    enable_dns_tracking: bool = field(default=False, **_env("ENABLE_DNS_TRACKING", "false"))
    dns_tracking_port: int = field(default=53, **_env("DNS_TRACKING_PORT", "53"))
    enable_network_events_monitoring: bool = field(
        default=False, **_env("ENABLE_NETWORK_EVENTS_MONITORING", "false"))
    network_events_monitoring_group_id: int = field(
        default=10, **_env("NETWORK_EVENTS_MONITORING_GROUP_ID", "10"))
    enable_pkt_translation: bool = field(
        default=False, **_env("ENABLE_PKT_TRANSLATION", "false"))
    enable_ipsec_tracking: bool = field(
        default=False, **_env("ENABLE_IPSEC_TRACKING", "false"))
    enable_openssl_tracking: bool = field(
        default=False, **_env("ENABLE_OPENSSL_TRACKING", "false"))
    openssl_path: str = field(default="/usr/bin/openssl", **_env("OPENSSL_PATH", "/usr/bin/openssl"))
    enable_tls_tracking: bool = field(default=False, **_env("ENABLE_TLS_TRACKING", "false"))
    quic_tracking_mode: int = field(default=0, **_env("QUIC_TRACKING_MODE", "0"))
    enable_udn_mapping: bool = field(default=False, **_env("ENABLE_UDN_MAPPING", "false"))

    # --- filtering ---
    flow_filter_rules: str = field(default="", **_env("FLOW_FILTER_RULES"))

    # --- program-manager (bpfman) mode ---
    ebpf_program_manager_mode: bool = field(
        default=False, **_env("EBPF_PROGRAM_MANAGER_MODE", "false"))
    bpfman_bpf_fs_path: str = field(
        default="/run/netobserv/maps", **_env("BPFMAN_BPF_FS_PATH", "/run/netobserv/maps"))

    # --- PCA (packet capture) mode ---
    enable_pca: bool = field(default=False, **_env("ENABLE_PCA", "false"))
    pca_server_port: int = field(default=0, **_env("PCA_SERVER_PORT", "0"))

    # --- direct-FLP ---
    flp_config: str = field(default="", **_env("FLP_CONFIG"))
    flp_kube_map: str = field(default="", **_env("FLP_KUBE_MAP"))
    flp_location_db: str = field(default="", **_env("FLP_LOCATION_DB"))

    # --- deprecated aliases (reference: `config.go:298-323`) ---
    flows_target_host: str = field(default="", **_env("FLOWS_TARGET_HOST"))
    flows_target_port: int = field(default=0, **_env("FLOWS_TARGET_PORT", "0"))

    # --- sketch backend ---
    sketch_batch_size: int = field(default=8192, **_env("SKETCH_BATCH_SIZE", "8192"))
    sketch_cm_depth: int = field(default=4, **_env("SKETCH_CM_DEPTH", "4"))
    sketch_cm_width: int = field(default=65536, **_env("SKETCH_CM_WIDTH", "65536"))
    sketch_hll_precision: int = field(default=14, **_env("SKETCH_HLL_PRECISION", "14"))
    sketch_topk: int = field(default=1024, **_env("SKETCH_TOPK", "1024"))
    sketch_window: float = field(default=60.0, **_env("SKETCH_WINDOW", "60s"))
    sketch_ewma_alpha: float = field(default=0.3, **_env("SKETCH_EWMA_ALPHA", "0.3"))
    sketch_checkpoint_dir: str = field(default="", **_env("SKETCH_CHECKPOINT_DIR"))
    sketch_checkpoint_every: int = field(default=0, **_env("SKETCH_CHECKPOINT_EVERY", "0"))
    sketch_mesh_shape: str = field(default="", **_env("SKETCH_MESH_SHAPE"))  # e.g. "2x4"
    sketch_devices: str = field(default="", **_env("SKETCH_DEVICES"))  # "" (the card) or "cpu"
    sketch_use_pallas: str = field(default="auto",
                                   **_env("SKETCH_USE_PALLAS", "auto"))
    sketch_window_mode: str = field(default="reset", **_env("SKETCH_WINDOW_MODE", "reset"))
    sketch_scan_fanout: int = field(
        default=DEFAULT_SCAN_FANOUT,
        **_env("SKETCH_SCAN_FANOUT", str(DEFAULT_SCAN_FANOUT)))
    sketch_ddos_z: float = field(default=DEFAULT_DDOS_Z,
                                 **_env("SKETCH_DDOS_Z", str(DEFAULT_DDOS_Z)))
    sketch_synflood_min: int = field(
        default=DEFAULT_SYNFLOOD_MIN,
        **_env("SKETCH_SYNFLOOD_MIN", str(DEFAULT_SYNFLOOD_MIN)))
    sketch_synflood_ratio: float = field(
        default=DEFAULT_SYNFLOOD_RATIO,
        **_env("SKETCH_SYNFLOOD_RATIO", str(DEFAULT_SYNFLOOD_RATIO)))
    sketch_drop_z: float = field(default=DEFAULT_DROP_Z,
                                 **_env("SKETCH_DROP_Z", str(DEFAULT_DROP_Z)))
    sketch_asym_min_bytes: int = field(
        default=DEFAULT_ASYM_MIN_BYTES,
        **_env("SKETCH_ASYM_MIN_BYTES", str(DEFAULT_ASYM_MIN_BYTES)))
    sketch_asym_ratio: float = field(
        default=DEFAULT_ASYM_RATIO,
        **_env("SKETCH_ASYM_RATIO", str(DEFAULT_ASYM_RATIO)))
    sketch_churn_ascent: float = field(
        default=DEFAULT_CHURN_ASCENT,
        **_env("SKETCH_CHURN_ASCENT", str(DEFAULT_CHURN_ASCENT)))
    sketch_churn_min_bytes: int = field(
        default=DEFAULT_CHURN_MIN_BYTES,
        **_env("SKETCH_CHURN_MIN_BYTES", str(DEFAULT_CHURN_MIN_BYTES)))
    sketch_pack_threads: int = field(default=0,
                                     **_env("SKETCH_PACK_THREADS", "0"))
    sketch_tiered: bool = field(default=False, **_env("SKETCH_TIERED", "false"))
    sketch_tier_mid_group: int = field(
        default=32, **_env("SKETCH_TIER_MID_GROUP", "32"))
    sketch_tier_top_group: int = field(
        default=256, **_env("SKETCH_TIER_TOP_GROUP", "256"))
    sketch_tier_bytes_unit: int = field(
        default=256, **_env("SKETCH_TIER_BYTES_UNIT", "256"))
    sketch_decay_factor: float = field(default=0.5, **_env("SKETCH_DECAY_FACTOR", "0.5"))
    sketch_tenants: int = field(default=0, **_env("SKETCH_TENANTS", "0"))
    sketch_feed: str = field(default="resident", **_env("SKETCH_FEED", "resident"))
    sketch_resident_slots: int = field(
        default=1 << 18, **_env("SKETCH_RESIDENT_SLOTS", str(1 << 18)))
    sketch_report_sink: str = field(default="stdout", **_env("SKETCH_REPORT_SINK", "stdout"))
    sketch_superbatch: str = field(default="1,2,4",
                                   **_env("SKETCH_SUPERBATCH", "1,2,4"))
    sketch_query_refresh: float = field(
        default=0.0, **_env("SKETCH_QUERY_REFRESH", "0"))
    sketch_query_history: int = field(
        default=8, **_env("SKETCH_QUERY_HISTORY", "8"))
    sketch_overlap: int = field(default=0, **_env("SKETCH_OVERLAP", "0"))

    # --- overload control plane (sketch/overload.py; new) ---
    sketch_shed_watermark: float = field(
        default=0.0, **_env("SKETCH_SHED_WATERMARK", "0"))
    sketch_shed_max: int = field(default=64, **_env("SKETCH_SHED_MAX", "64"))
    sketch_shed_slot_budget: float = field(
        default=30.0, **_env("SKETCH_SHED_SLOT_BUDGET", "30s"))
    map_pressure_watermark: float = field(
        default=0.0, **_env("MAP_PRESSURE_WATERMARK", "0"))

    # --- continuous detection & alerting plane (alerts/; new) ---
    alert_rules: str = field(default="", **_env("ALERT_RULES"))
    alert_raise_evals: int = field(default=2, **_env("ALERT_RAISE_EVALS", "2"))
    alert_clear_evals: int = field(default=2, **_env("ALERT_CLEAR_EVALS", "2"))
    alert_sinks: str = field(default="log,metrics",
                             **_env("ALERT_SINKS", "log,metrics"))
    alert_webhook_url: str = field(default="", **_env("ALERT_WEBHOOK_URL"))
    alert_webhook_interval: float = field(
        default=1.0, **_env("ALERT_WEBHOOK_INTERVAL", "1s"))
    alert_ring: int = field(default=256, **_env("ALERT_RING", "256"))

    # --- sketch warehouse (archive/; new) ---
    archive_dir: str = field(default="", **_env("ARCHIVE_DIR"))
    archive_raw_windows: int = field(
        default=64, **_env("ARCHIVE_RAW_WINDOWS", "64"))
    archive_compact_group: int = field(
        default=8, **_env("ARCHIVE_COMPACT_GROUP", "8"))
    archive_max_levels: int = field(
        default=3, **_env("ARCHIVE_MAX_LEVELS", "3"))
    archive_merge_ladder_max: int = field(
        default=16, **_env("ARCHIVE_MERGE_LADDER_MAX", "16"))

    # --- sketch federation plane (federation/; new) ---
    federation_target: str = field(default="", **_env("FEDERATION_TARGET"))
    federation_agent_id: str = field(default="",
                                     **_env("FEDERATION_AGENT_ID"))
    federation_mode: str = field(default="", **_env("FEDERATION_MODE"))
    federation_listen_port: int = field(
        default=9999, **_env("FEDERATION_LISTEN_PORT", "9999"))
    federation_query_port: int = field(
        default=9998, **_env("FEDERATION_QUERY_PORT", "9998"))
    federation_window: float = field(default=60.0,
                                     **_env("FEDERATION_WINDOW", "60s"))
    federation_mesh_shape: str = field(default="",
                                       **_env("FEDERATION_MESH_SHAPE"))
    federation_stale_after: float = field(
        default=120.0, **_env("FEDERATION_STALE_AFTER", "120s"))
    federation_agent_ttl: float = field(
        default=600.0, **_env("FEDERATION_AGENT_TTL", "600s"))
    federation_checkpoint_dir: str = field(
        default="", **_env("FEDERATION_CHECKPOINT_DIR"))
    federation_checkpoint_every: int = field(
        default=1, **_env("FEDERATION_CHECKPOINT_EVERY", "1"))

    def resolved_pack_threads(self) -> int:
        """SKETCH_PACK_THREADS with 0 = auto (cpu count, capped at 8)."""
        return resolved_pack_threads(self.sketch_pack_threads)

    def parsed_superbatch_ladder(self) -> tuple:
        """SKETCH_SUPERBATCH as a sorted, deduplicated int tuple."""
        try:
            return parse_superbatch_ladder(self.sketch_superbatch)
        except ValueError as exc:
            raise ValueError(f"SKETCH_SUPERBATCH: {exc}") from None

    def parsed_filter_rules(self) -> list[FlowFilterRule]:
        return parse_filter_rules(self.flow_filter_rules)

    def manage_deprecated(self) -> None:
        """Apply deprecated-key shims (`netobserv_tpu/config.py:625-632`)."""
        if self.flows_target_host and not self.target_host:
            self.target_host = self.flows_target_host
        if self.flows_target_port and not self.target_port:
            self.target_port = self.flows_target_port
        if self.enable_pca and self.pca_server_port and not self.target_port:
            self.target_port = self.pca_server_port

    def validate(self) -> None:
        if self.export not in VALID_EXPORTERS:
            raise ValueError(
                f"EXPORT={self.export!r} is not one of {', '.join(VALID_EXPORTERS)}")
        if self.export in (EXPORT_GRPC, EXPORT_IPFIX_UDP, EXPORT_IPFIX_TCP):
            if not self.target_host or not self.target_port:
                raise ValueError(
                    f"EXPORT={self.export}: TARGET_HOST and TARGET_PORT are required")
        if self.export == EXPORT_KAFKA and not self.kafka_brokers:
            raise ValueError("EXPORT=kafka: KAFKA_BROKERS is required")
        if self.sketch_cm_width < 2 or self.sketch_cm_width & (self.sketch_cm_width - 1):
            raise ValueError("SKETCH_CM_WIDTH must be a power of two >= 2")
        if self.sketch_tiered:
            for env_name, v, floor in (
                    ("SKETCH_TIER_MID_GROUP", self.sketch_tier_mid_group, 2),
                    ("SKETCH_TIER_TOP_GROUP", self.sketch_tier_top_group, 2),
                    ("SKETCH_TIER_BYTES_UNIT", self.sketch_tier_bytes_unit,
                     1)):
                if v < floor or v & (v - 1):
                    raise ValueError(
                        f"{env_name} must be a power of two >= {floor} "
                        f"(got {v}) — tier geometry must stay power-of-two-"
                        "compatible with SKETCH_CM_WIDTH")
            if self.sketch_tier_top_group <= self.sketch_tier_mid_group:
                raise ValueError(
                    f"SKETCH_TIER_TOP_GROUP ({self.sketch_tier_top_group}) "
                    f"must exceed SKETCH_TIER_MID_GROUP "
                    f"({self.sketch_tier_mid_group}): tiers must narrow as "
                    "counters widen")
            if self.sketch_cm_width % self.sketch_tier_top_group:
                raise ValueError(
                    f"SKETCH_TIER_TOP_GROUP ({self.sketch_tier_top_group}) "
                    f"must divide SKETCH_CM_WIDTH ({self.sketch_cm_width})")
            if self.sketch_mesh_shape:
                raise ValueError(
                    "SKETCH_TIERED has no owner-sharded form yet (tiered "
                    "counter planes are single-device); unset "
                    "SKETCH_MESH_SHAPE or SKETCH_TIERED")
        if self.sketch_tenants < 0:
            raise ValueError("SKETCH_TENANTS must be >= 0")
        if self.sketch_tenants and self.sketch_mesh_shape:
            raise ValueError(
                "SKETCH_TENANTS has no mesh-sharded form yet (the tenant "
                "stack is single-device, like SKETCH_TIERED); unset "
                "SKETCH_MESH_SHAPE or SKETCH_TENANTS")
        if not (4 <= self.sketch_hll_precision <= 18):
            raise ValueError("SKETCH_HLL_PRECISION must be in [4, 18]")
        if self.sketch_window_mode not in ("reset", "decay"):
            raise ValueError(
                f"SKETCH_WINDOW_MODE={self.sketch_window_mode!r} "
                "(want reset|decay)")
        if self.sketch_window_mode == "decay" and not (
                0.0 < self.sketch_decay_factor < 1.0):
            raise ValueError("SKETCH_DECAY_FACTOR must be in (0, 1)")
        if self.sketch_report_sink not in ("", "stdout", "kafka"):
            raise ValueError(
                f"SKETCH_REPORT_SINK={self.sketch_report_sink!r} "
                "(want stdout|kafka)")
        self.parsed_superbatch_ladder()  # raises on a malformed ladder spec
        if self.sketch_query_refresh < 0:
            raise ValueError(
                "SKETCH_QUERY_REFRESH must be >= 0 (0 disables the "
                "mid-window refresh)")
        if self.sketch_shed_watermark < 0:
            raise ValueError("SKETCH_SHED_WATERMARK must be >= 0 (0 disables)")
        if self.sketch_query_history < 0:
            raise ValueError("SKETCH_QUERY_HISTORY must be >= 0 "
                             "(0 disables the back-scroll ring)")
        if self.sketch_overlap < 0:
            raise ValueError("SKETCH_OVERLAP must be >= 0 (0 keeps the "
                             "synchronous export seam)")
        if self.evict_drain_lanes < 0:
            raise ValueError("EVICT_DRAIN_LANES must be >= 0 (0 = auto, "
                             "1 = sequential)")
        if self.sketch_shed_max < 2:
            raise ValueError("SKETCH_SHED_MAX must be >= 2 (it bounds the "
                             "1-in-N shed factor)")
        if not (0.0 <= self.map_pressure_watermark < 1.0):
            raise ValueError("MAP_PRESSURE_WATERMARK must be in [0, 1) "
                             "(a fraction of CACHE_MAX_FLOWS; 0 disables)")
        if self.alert_raise_evals < 1 or self.alert_clear_evals < 1:
            raise ValueError("ALERT_RAISE_EVALS and ALERT_CLEAR_EVALS "
                             "must be >= 1")
        if self.sketch_churn_ascent <= 1.0:
            raise ValueError("SKETCH_CHURN_ASCENT must be > 1 (it is a "
                             "window-over-window growth factor)")
        if self.sketch_churn_min_bytes < 0:
            raise ValueError("SKETCH_CHURN_MIN_BYTES must be >= 0")
        if self.alert_ring < 1:
            raise ValueError("ALERT_RING must be >= 1")
        if self.alert_webhook_interval < 0:
            raise ValueError("ALERT_WEBHOOK_INTERVAL must be >= 0")
        if self.alert_rules:
            from netobserv_tpu_torch.alerts.rules import parse_rules
            from netobserv_tpu_torch.alerts.sinks import build_sinks
            parse_rules(self.alert_rules)
            build_sinks(self)
        if self.archive_compact_group < 2:
            raise ValueError("ARCHIVE_COMPACT_GROUP must be >= 2 (it is "
                             "the RRD coarsening factor)")
        if self.archive_raw_windows < self.archive_compact_group:
            raise ValueError(
                f"ARCHIVE_RAW_WINDOWS ({self.archive_raw_windows}) must "
                f"be >= ARCHIVE_COMPACT_GROUP "
                f"({self.archive_compact_group})")
        if self.archive_max_levels < 1:
            raise ValueError("ARCHIVE_MAX_LEVELS must be >= 1")
        v = self.archive_merge_ladder_max
        if v < 1 or v & (v - 1) or v > 64:
            raise ValueError(
                f"ARCHIVE_MERGE_LADDER_MAX must be a power of two in "
                f"[1, 64] (got {v}) — every power of two up to it costs "
                "a pre-built merge executable")
        if self.federation_mode not in ("", "aggregator"):
            raise ValueError(
                f"FEDERATION_MODE={self.federation_mode!r} "
                "(want empty|aggregator)")
        if self.federation_target and ":" not in self.federation_target:
            raise ValueError(
                f"FEDERATION_TARGET={self.federation_target!r} "
                "(want host:port)")
        if self.federation_target and self.sketch_window_mode == "decay":
            log.warning(
                "FEDERATION_TARGET with SKETCH_WINDOW_MODE=decay: delta "
                "export is disabled (decayed tables are cumulative, the "
                "aggregator merges per-window deltas)")
        if self.sketch_cm_width < 16 * self.sketch_topk:
            log.warning(
                "SKETCH_CM_WIDTH=%d is below 16*SKETCH_TOPK=%d: heavy-hitter "
                "precision degrades measurably at this ratio (docs/"
                "accuracy.md); widen the sketch or shrink the top-K",
                self.sketch_cm_width, 16 * self.sketch_topk)


_DURATION_FIELDS = {
    "cache_active_timeout", "listen_poll_period", "stale_entries_evict_timeout",
    "grpc_reconnect_timer", "grpc_reconnect_timer_randomization", "sketch_window",
    "supervisor_check_period", "supervisor_backoff_initial",
    "supervisor_backoff_max", "supervisor_healthy_reset",
    "supervisor_heartbeat_timeout", "federation_window",
    "federation_stale_after", "federation_agent_ttl",
    "sketch_shed_slot_budget", "sketch_query_refresh",
    "alert_webhook_interval",
}


def _coerce(f: dataclasses.Field, raw: str) -> Any:
    if f.name in _DURATION_FIELDS:
        return parse_duration(raw)
    if f.type in ("bool", bool):
        return _parse_bool(raw)
    if f.type in ("int", int):
        return int(raw)
    if f.type in ("float", float):
        return float(raw)
    if f.type in ("list[str]",):
        return [s.strip() for s in raw.split(",") if s.strip()]
    return raw


def load_config(environ: Optional[dict] = None) -> AgentConfig:
    """Build an AgentConfig from environment variables, as the reference's
    `load_config` (`netobserv_tpu/config.py:801-823`) does; it does not
    validate."""
    environ = os.environ if environ is None else environ
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(AgentConfig):
        env_name = f.metadata.get("env")
        if not env_name:
            continue
        raw = environ.get(env_name)
        if raw is None:
            continue
        if raw == "":
            # set-but-empty clears string/list fields (e.g. EXCLUDE_INTERFACES="")
            # but cannot express a numeric/bool value — treat as unset for those.
            if f.type in ("str", str):
                kwargs[f.name] = ""
            elif f.type in ("list[str]",):
                kwargs[f.name] = []
            continue
        kwargs[f.name] = _coerce(f, raw)
    cfg = AgentConfig(**kwargs)
    cfg.manage_deprecated()
    return cfg
