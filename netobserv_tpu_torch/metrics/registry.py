"""The port's metrics facade: the sketch plane's families.

A copy of the sketch-plane part of `netobserv_tpu/metrics/registry.py`
(`Metrics`, `:51-595`): `errors_total` with `count_error`; the
`sketch_*` families that the exporter (`exporter/torch_sketch.py`), the
staging rings and the pending buffer (`sketch/staging.py`) touch; the
retrace families of `utils/retrace.py` (`count_retrace`,
`observe_dispatch`); and the trace families of `utils/tracing.py`
(`observe_stage`, `trace_context_propagated_total`); and the query and
alerting planes' (`query_requests_total`, `query_snapshot_age_seconds`,
`alerts_active`, `alerts_transitions_total`, `alert_sink_errors_total`,
`alert_eval_seconds`, `:303-340`); the federation plane's
(`federation_*`, `:401-450`, with `remove_labeled`); and the archive's
and the aggregator's checkpoints' (`archive_*`,
`federation_checkpoints_total`, `:452-480`); the overload controller's
(`sketch_shed_factor`, `sketch_shed_rows_total`,
`sketch_shed_batches_total`, `:199-215`) and the supervisor's
(`stage_failures_total`, `stage_restarts_total`, `stage_degraded`,
`:352-366`, with `count_stage_failure`, `count_stage_restart` and
`set_stage_degraded`, `:530-537`); and the families of the agent's
stages, the map tracer, the limiter, the terminal, the ring-buffer
tracer and the agent (`evictions_total`, `evicted_flows_total`,
`dropped_flows_total`, `ringbuf_events_total`, `kernel_counters_total`, `exported_*`, `export_errors_total`,
`buffer_size`, `sampling_rate`, the eviction histograms,
`flowpack_*`, `host_native_pipeline_seconds`, `map_occupancy_ratio`,
`map_pressure_evictions_total` and `evict_ringbuf_fallback_total`,
`:70-143`, `:282-300`, with `observe_eviction`, `count_dropped`,
`count_ringbuf_event`, `add_global_counter`, `count_exported` and
`count_export_error`, `:483-506`); and the tenant planes' (`sketch_tenant_folds_total`,
`sketch_tenants_active`, `sketch_tenant_window_records{tenant}`,
`:248-268`) with `sketch_resident_hbm_bytes` (`:269-275`). Each
family has the reference family's name, type, help text, labels and
buckets. The port's packer raises on an ABI mismatch
instead of falling back (`datapath/flowpack.py`), so
`flowpack_abi_fallback_total` stays 0; no port datapath takes the fused
drain, so `flowpack_native_calls_total` and
`host_native_pipeline_seconds` stay empty. The interface listener's
`interface_events_total` (`:102-104`) with `count_interface_event`, its
labels gated by METRICS_LEVEL, and the janitor that removes a
trace-level series `trace_ttl_s` after its last increment (`:539-595`).

The direct-flp exporter's `encode prom` stage makes its collectors here
(`new_registry`, `make_metric`, and for its adopt and skip rules on a
rebuild `live_metric`, `metric_kind`, `metric_labels`,
`histogram_bounds`, `default_buckets`), after
`netobserv_tpu/exporter/direct_flp.py:235-300`.

`prometheus_client` is imported only when a `Metrics` is made, when one
of those functions runs, or when `exposition` renders a registry for the
metrics server's `/metrics`: no other module imports it, and the exporter
keeps plain integer counters of its own that work without a registry.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from netobserv_tpu_torch.model.flow import GlobalCounter

def exposition(registry) -> tuple[bytes, str]:
    """The text exposition of a `CollectorRegistry` and its content type
    (what the reference's server writes for `/metrics`)."""
    from prometheus_client import generate_latest
    from prometheus_client.exposition import CONTENT_TYPE_LATEST
    return generate_latest(registry), CONTENT_TYPE_LATEST


def new_registry():
    """A fresh `CollectorRegistry` (the direct-flp exporter's own, where
    the agent gives it none)."""
    from prometheus_client import CollectorRegistry
    return CollectorRegistry()


def default_buckets() -> tuple:
    """prometheus_client's default histogram buckets."""
    from prometheus_client import Histogram
    return Histogram.DEFAULT_BUCKETS


def make_metric(kind: str, name: str, documentation: str, labels: list,
                registry, buckets=None):
    """A counter, gauge or histogram (`kind` "counter", "gauge" or
    "histogram") named `name` on `registry`; a histogram takes `buckets`
    or the defaults.
    A name the registry already holds raises `ValueError`, as
    prometheus_client's constructors do."""
    from prometheus_client import Counter, Gauge, Histogram
    if kind == "histogram":
        return Histogram(name, documentation, labels,
                         buckets=buckets or Histogram.DEFAULT_BUCKETS,
                         registry=registry)
    cls = {"counter": Counter, "gauge": Gauge}[kind]
    return cls(name, documentation, labels, registry=registry)


def live_metric(registry, name: str):
    """The collector registered under `name` on `registry`, or None."""
    return getattr(registry, "_names_to_collectors", {}).get(name)


def metric_kind(metric) -> str | None:
    """The kind of one of `make_metric`'s collectors ("counter", "gauge"
    or "histogram"), None for another collector."""
    from prometheus_client import Counter, Gauge, Histogram
    for kind, cls in (("counter", Counter), ("gauge", Gauge),
                      ("histogram", Histogram)):
        if isinstance(metric, cls):
            return kind
    return None


def metric_labels(metric) -> list:
    return list(getattr(metric, "_labelnames", ()))


def histogram_bounds(metric) -> list:
    """A histogram's upper bounds, +inf last."""
    return list(getattr(metric, "_upper_bounds", ()))


LEVELS = ("info", "debug", "trace")


@dataclass
class MetricsSettings:
    """The family prefix, verbosity level and trace-series lifetime of the
    reference's settings (`metrics/registry.py:37-48`). The level sets the
    cardinality of `interface_events_total` (`count_interface_event`)."""

    prefix: str = "ebpf_agent_"
    level: str = "info"
    trace_ttl_s: float = 300.0  # trace-level series lifetime (reference: 5min)

    def normalized_level(self) -> str:
        lvl = self.level.rstrip("!").lower()  # reference spells trace "trace!"
        if lvl not in LEVELS:
            raise ValueError(
                f"invalid METRICS_LEVEL {self.level!r} (one of {LEVELS})")
        return lvl


class Metrics:
    """Facade handed to the exporter, its rings and its pending buffer
    (reference: `netobserv_tpu.metrics.registry.Metrics`)."""

    def __init__(self, settings: MetricsSettings | None = None,
                 registry=None):
        from prometheus_client import (
            CollectorRegistry, Counter, Gauge, Histogram,
        )
        if settings is None:
            settings = MetricsSettings()
        self.settings = settings
        self.level = settings.normalized_level()
        self._trace_expiry: dict[tuple[str, ...], float] = {}
        self._trace_lock = threading.Lock()
        self._trace_janitor = None
        self.registry = (registry if registry is not None
                         else CollectorRegistry())
        p = settings.prefix

        self.errors_total = Counter(
            p + "errors_total", "Agent errors by component and severity",
            ["component", "severity"], registry=self.registry)
        # the agent's stages: map tracer, limiter, terminal, agent
        self.evictions_total = Counter(
            p + "evictions_total", "Eviction cycles", ["source"],
            registry=self.registry)
        self.evicted_flows_total = Counter(
            p + "evicted_flows_total", "Flows evicted", ["source"],
            registry=self.registry)
        self.dropped_flows_total = Counter(
            p + "dropped_flows_total", "Flows dropped by the pipeline",
            ["source"], registry=self.registry)
        self.ringbuf_events_total = Counter(
            p + "ringbuf_events_total",
            "Flow events received via the map-full fallback ring buffer",
            registry=self.registry)
        self.kernel_counters_total = Counter(
            p + "kernel_counters_total",
            "Datapath global counters (scraped each eviction)", ["name"],
            registry=self.registry)
        self.exported_batches_total = Counter(
            p + "exported_batches_total", "Batches exported", ["exporter"],
            registry=self.registry)
        self.exported_flows_total = Counter(
            p + "exported_flows_total", "Flows exported", ["exporter"],
            registry=self.registry)
        self.export_errors_total = Counter(
            p + "export_errors_total", "Export errors", ["exporter", "error"],
            registry=self.registry)
        self.buffer_size = Gauge(
            p + "buffer_size", "Pipeline buffer occupancy", ["name"],
            registry=self.registry)
        self.interface_events_total = Counter(
            p + "interface_events_total", "Interface attach/detach events",
            ["type", "ifname", "ifindex", "netns", "mac", "retries"],
            registry=self.registry)
        self.sampling_rate = Gauge(
            p + "sampling_rate", "Configured sampling (1/N; 0=all)",
            registry=self.registry)
        self.eviction_seconds = Histogram(
            p + "lookup_and_delete_map_duration_seconds",
            "Map eviction (lookup+delete) latency",
            buckets=(.001, .005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5),
            registry=self.registry)
        self.eviction_decode_seconds = Histogram(
            p + "eviction_decode_seconds",
            "Columnar eviction-plane latency per drain (decode + per-CPU "
            "merge + key alignment, the userspace half of an eviction)",
            buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5, 1),
            registry=self.registry)
        self.evicted_flows_per_drain = Histogram(
            p + "evicted_flows_per_drain",
            "Flows returned by one map drain (eviction batch size)",
            buckets=(0, 10, 100, 1000, 10000, 100000, 1000000),
            registry=self.registry)
        self.flowpack_abi_fallback_total = Counter(
            p + "flowpack_abi_fallback_total",
            "Native flowpack library loads that failed (missing .so or "
            "stale ABI) — the pure-python twins carried the host path; "
            "rebuild with `make native`", registry=self.registry)
        self.flowpack_native_calls_total = Counter(
            p + "flowpack_native_calls_total",
            "Eviction drains by host path while EVICT_NATIVE_PIPELINE is "
            "enabled (fused = one fp_drain_to_resident native call; chain "
            "= the python island chain, incl. the batch-support probe "
            "drain)", ["path"], registry=self.registry)
        self.host_native_pipeline_seconds = Histogram(
            p + "host_native_pipeline_seconds",
            "Per-stage seconds inside the fused native drain pipeline "
            "(drain = batched bpf(2) syscalls, merge = per-CPU columnar "
            "merge, join = key join + feature alignment, pack = resident "
            "region pack)", ["stage"],
            buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5),
            registry=self.registry)
        self.map_occupancy_ratio = Histogram(
            p + "map_occupancy_ratio",
            "Kernel aggregation-map occupancy at each drain, as a "
            "fraction of the map capacity (the probed max_entries in "
            "bpfman mode, else CACHE_MAX_FLOWS; mass near 1.0 means the "
            "map fills between evictions — the ringbuf fallback engages)",
            buckets=(.1, .25, .5, .75, .9, .95, 1.0),
            registry=self.registry)
        self.map_pressure_evictions_total = Counter(
            p + "map_pressure_evictions_total",
            "Early (half-period) evictions triggered by the map-occupancy "
            "watermark (MAP_PRESSURE_WATERMARK)", registry=self.registry)
        self.evict_ringbuf_fallback_total = Counter(
            p + "evict_ringbuf_fallback_total",
            "Feature rows whose flow was missing from the aggregation "
            "drain and became standalone appended events (ringbuf-fallback "
            "singles or a racing eviction — the one bounded double-count "
            "overload path, shared with the reference)",
            registry=self.registry)
        # query plane (netobserv_tpu/query + the /query/* routes on the
        # metrics server)
        self.sketch_batches_total = Counter(
            p + "sketch_batches_total", "Columnar batches folded on device",
            registry=self.registry)
        self.sketch_records_total = Counter(
            p + "sketch_records_total", "Flow records folded on device",
            registry=self.registry)
        self.sketch_window_reports_total = Counter(
            p + "sketch_window_reports_total", "Window reports emitted",
            registry=self.registry)
        self.sketch_ingest_seconds = Histogram(
            p + "sketch_ingest_seconds", "Device ingest step latency",
            buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5),
            registry=self.registry)
        self.sketch_staging_stalls_total = Counter(
            p + "sketch_staging_stalls_total",
            "Staging-ring folds that had to WAIT for a slot's previous "
            "ingest (device slower than the eviction feed)",
            registry=self.registry)
        self.sketch_resident_continuations_total = Counter(
            p + "sketch_resident_continuations_total",
            "Extra resident-feed chunks shipped because a side lane filled "
            "(sustained high rates mean the caps are undersized for this "
            "traffic mix)", registry=self.registry)
        self.sketch_resident_dict_epochs_total = Counter(
            p + "sketch_resident_dict_epochs_total",
            "Resident key-dictionary epoch rolls (dictionary reached "
            "SKETCH_RESIDENT_SLOTS; size it above the flow working set)",
            registry=self.registry)
        self.sketch_dense_fallback_total = Counter(
            p + "sketch_dense_fallback_total",
            "Compact-feed batches whose non-v4/drop rows overflowed the "
            "spill lane and shipped full-width instead (synchronous, "
            "dense-path speed — sustained increments mean v6-heavy or "
            "drop-storm traffic outgrew the compact feed)",
            registry=self.registry)
        self.sketch_resident_spill_rows_total = Counter(
            p + "sketch_resident_spill_rows_total",
            "Rows that rode the full-width spill lane instead of a hot row",
            registry=self.registry)
        self.sketch_direct_fold_rows_total = Counter(
            p + "sketch_direct_fold_rows_total",
            "Rows ROUTED through the direct-to-lane fast path "
            "(batch-aligned prefixes handed to the fold as zero-copy "
            "eviction-decode views, bypassing the pending-buffer copy; "
            "the sub-batch tail still copies in). Routing, not device "
            "success — a swallowed ingest error downstream still counts "
            "here but not in sketch_records_total",
            registry=self.registry)
        self.sketch_superbatch_folds_total = Counter(
            p + "sketch_superbatch_folds_total",
            "Superbatch fold dispatches by ladder size k (k queued batches "
            "coalesced into one fixed-shape device dispatch; a healthy "
            "overloaded host shows mass at the largest k, an idle one at "
            "k=1)", ["k"], registry=self.registry)
        # overload control plane (sketch/overload.py)
        self.sketch_shed_factor = Gauge(
            p + "sketch_shed_factor",
            "Current 1-in-N load-shedding factor at the exporter seam "
            "(1 = no shedding). Driven by the AIMD overload controller "
            "when SKETCH_SHED_WATERMARK is set; surviving rows carry the "
            "factor in their sampling field so estimates stay unbiased",
            registry=self.registry)
        self.sketch_shed_rows_total = Counter(
            p + "sketch_shed_rows_total",
            "Rows dropped by overload shedding (unbiased 1-in-N row "
            "sampling; the surviving rows stand in for these, scaled)",
            registry=self.registry)
        self.sketch_shed_batches_total = Counter(
            p + "sketch_shed_batches_total",
            "Eviction batches thinned by overload shedding",
            registry=self.registry)
        self.sketch_slot_wait_seconds = Histogram(
            p + "sketch_slot_wait_seconds",
            "Staging-ring slot wait per fold (time the feed spent blocked "
            "on the device consuming a previous batch; the overload "
            "controller's backpressure signal)",
            buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5, 1, 5),
            registry=self.registry)
        self.sketch_heavy_evictions_total = Counter(
            p + "sketch_heavy_evictions_total",
            "Valid heavy-hitter slot-table occupants evicted by heavier "
            "challengers (persistent-slot top-K plane; incremented at "
            "each window publish by that window's eviction count — "
            "sustained high rates mean the table is churning under "
            "capacity pressure: raise SKETCH_TOPK)",
            registry=self.registry)
        self.sketch_tier_promotions_total = Counter(
            p + "sketch_tier_promotions_total",
            "Counters promoted out of the narrow u8 base plane "
            "(SKETCH_TIERED; incremented at each closed-window publish by "
            "that window's count of base-saturated counters, per CM "
            "table — sustained growth means the tier geometry is too "
            "narrow for the traffic: raise SKETCH_TIER_BYTES_UNIT or "
            "widen the sketch)", ["table"],
            registry=self.registry)
        self.sketch_tiered_interior_folds_total = Counter(
            p + "sketch_tiered_interior_folds_total",
            "Ingest folds served by the tier-interior Pallas walk "
            "(SKETCH_TIERED + use_pallas: the fold ran directly on the "
            "packed u8/u16/u32 tiles, no wide decode temporary — compare "
            "against sketch_batches_total to confirm the interior form is "
            "the one actually engaged)",
            registry=self.registry)
        # multi-tenant sketch planes (sketch/tenancy.py)
        self.sketch_tenant_folds_total = Counter(
            p + "sketch_tenant_folds_total",
            "Stacked tenant-fold dispatches (SKETCH_TENANTS): each folds "
            "EVERY tenant's pending rows as one vmapped executable — the "
            "dispatch-amortization the tenant stack exists for (compare "
            "against sketch_records_total for rows-per-dispatch)",
            registry=self.registry)
        self.sketch_tenants_active = Gauge(
            p + "sketch_tenants_active",
            "Tenant states stacked in the live tenant plane (0 = "
            "single-tenant path; set at exporter construction, zeroed at "
            "close when the per-tenant labelled series are evicted)",
            registry=self.registry)
        self.sketch_tenant_window_records = Gauge(
            p + "sketch_tenant_window_records",
            "Per-tenant records in the last closed window (cardinality = "
            "LIVE tenants: series ride Metrics.remove_labeled when a "
            "tenant plane is drained/closed — the federation "
            "agent-eviction hygiene pattern)",
            ["tenant"], registry=self.registry)
        self.sketch_resident_hbm_bytes = Gauge(
            p + "sketch_resident_hbm_bytes",
            "Resident sketch-state bytes on device (sum over all state "
            "arrays; shape math, set once at exporter construction). "
            "SKETCH_TIERED shrinks this ~4x over the counter tables — "
            "the windows/tenants-per-HBM capacity signal",
            registry=self.registry)
        self.sketch_reports_shed_total = Counter(
            p + "sketch_reports_shed_total",
            "Unpublished window reports shed because the report queue "
            "overflowed behind a wedged sink (that window's report is "
            "lost; the sketch state already rolled)",
            registry=self.registry)
        self.sketch_window_records = Gauge(
            p + "sketch_window_records", "Flow records in the last window",
            registry=self.registry)
        self.sketch_window_drop_bytes = Gauge(
            p + "sketch_window_drop_bytes",
            "Kernel-dropped bytes in the last window",
            registry=self.registry)
        self.sketch_window_suspects = Gauge(
            p + "sketch_window_suspects",
            "Anomaly suspects reported in the last window, by signal",
            ["signal"], registry=self.registry)
        # supervision layer (agent/supervisor.py)
        self.stage_failures_total = Counter(
            p + "stage_failures_total",
            "Supervised-stage failures detected (crash = dead thread, "
            "hang = heartbeat deadline exceeded)", ["stage", "kind"],
            registry=self.registry)
        self.stage_restarts_total = Counter(
            p + "stage_restarts_total",
            "Supervised-stage restarts performed", ["stage"],
            registry=self.registry)
        self.stage_degraded = Gauge(
            p + "stage_degraded",
            "1 when a stage exhausted its restart budget and was marked "
            "DEGRADED", ["stage"], registry=self.registry)
        self.sketch_ingest_errors_total = Counter(
            p + "sketch_ingest_errors_total",
            "Device ingest failures absorbed by dropping the batch "
            "(graceful degradation; the window timer stays alive)",
            registry=self.registry)
        self.stage_seconds = Histogram(
            p + "stage_seconds",
            "Per-stage latency of sampled batch/window traces (flight "
            "recorder spans; populated only when TRACE_SAMPLE > 0)",
            ["stage"],
            buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5, 1, 5),
            registry=self.registry)
        self.sketch_retraces_total = Counter(
            p + "sketch_retraces_total",
            "Post-warmup XLA recompilations of a watched jitted entry "
            "point — the fixed-shape ingest invariant is broken (each one "
            "is a multi-second stall; see the retrace watchdog log line "
            "for the offending abstract shapes)", ["fn"],
            registry=self.registry)
        self.executable_dispatch_seconds_total = Counter(
            p + "executable_dispatch_seconds_total",
            "Cumulative wall seconds spent dispatching each watched jitted "
            "entry point (the per-executable attribution split behind "
            "/debug/executables; one monotonic-clock pair per batch "
            "dispatch, never per record)", ["fn"],
            registry=self.registry)
        self.trace_context_propagated_total = Counter(
            p + "trace_context_propagated_total",
            "Cross-process trace contexts carried over the delta wire, by "
            "result (stamped = an agent encoded a sampled window trace "
            "into a frame; continued = the aggregator adopted a frame's "
            "context and recorded child spans under the same trace id)",
            ["result"], registry=self.registry)
        # federation plane (federation/aggregator.py; the sent counter is
        # the agent-side delta sink's, which the reference's gRPC sink
        # counts)
        self.federation_deltas_total = Counter(
            p + "federation_deltas_total",
            "Delta frames received by the aggregator, by outcome (ok / "
            "duplicate / stale / legacy / version_mismatch / "
            "shape_mismatch / decode_error / merge_error). duplicate and "
            "stale are acked-and-discarded by the idempotency ledger; "
            "legacy is a merged v1 frame with no delivery header",
            ["result"], registry=self.registry)
        self.federation_delta_bytes_total = Counter(
            p + "federation_delta_bytes_total",
            "Wire bytes of received delta frames (the federation plane's "
            "ingress volume)", registry=self.registry)
        self.federation_deltas_sent_total = Counter(
            p + "federation_deltas_sent_total",
            "Delta frames pushed by this agent, by outcome (ok / "
            "duplicate / stale / rejected / terminal / error). duplicate "
            "= an ambiguous-deadline retry the aggregator's ledger safely "
            "deduplicated; stale = the aggregator acked-and-DISCARDED the "
            "window as out-of-order (that window's data is lost); "
            "terminal = a non-retryable gRPC status "
            "(INVALID_ARGUMENT class) failed fast; error = the retry "
            "ladder was exhausted and the window's frame was dropped",
            ["result"], registry=self.registry)
        self.federation_merge_seconds = Histogram(
            p + "federation_merge_seconds",
            "On-device hierarchical merge latency per accepted delta frame",
            buckets=(.0005, .001, .005, .01, .05, .1, .5, 1, 5),
            registry=self.registry)
        self.federation_agent_staleness_seconds = Gauge(
            p + "federation_agent_staleness_seconds",
            "Seconds since each known agent's last accepted delta "
            "(cardinality = LIVE fleet size: series are deleted when the "
            "agent is evicted past FEDERATION_AGENT_TTL; an agent past "
            "~2 windows is dark)",
            ["agent"], registry=self.registry)
        self.federation_active_agents = Gauge(
            p + "federation_active_agents",
            "Agents that contributed a delta to the last aggregator window",
            registry=self.registry)
        self.federation_fleet_requests_total = Counter(
            p + "federation_fleet_requests_total",
            "Fleet-table requests (/federation/fleet), by result (ok / "
            "error). Served from the aggregator's published host-side "
            "fleet snapshot only — no device op, no merge lock",
            ["result"], registry=self.registry)
        self.federation_agent_evictions_total = Counter(
            p + "federation_agent_evictions_total",
            "Agents evicted from the aggregator's ownership view after "
            "FEDERATION_AGENT_TTL seconds without a delta (their "
            "staleness gauge series is deleted at the same time)",
            registry=self.registry)
        # sketch warehouse (archive/): on-disk window archive and
        # device-merged range queries
        self.archive_segments_total = Counter(
            p + "archive_segments_total",
            "Archive segments written (raw closed-window segments AND "
            "compacted super-windows)", registry=self.registry)
        self.archive_bytes_total = Counter(
            p + "archive_bytes_total",
            "Bytes written into the archive directory (the warehouse's "
            "write amplification numerator; compaction rewrites count)",
            registry=self.registry)
        self.archive_compactions_total = Counter(
            p + "archive_compactions_total",
            "Retention compactions: ARCHIVE_COMPACT_GROUP segments merged "
            "into one coarser super-window one level up",
            registry=self.registry)
        self.archive_range_requests_total = Counter(
            p + "archive_range_requests_total",
            "Range-query requests against the archive (/query/range and "
            "/federation/range), by result (ok / bad_request / "
            "not_found / error)", ["result"], registry=self.registry)
        self.federation_checkpoints_total = Counter(
            p + "federation_checkpoints_total",
            "Aggregator state+ledger checkpoints at window roll, by "
            "outcome (ok / error — error means the window rolled without "
            "durability; a restart then loses back to the previous "
            "checkpoint)", ["result"], registry=self.registry)
        # query plane (query/ and the /query/* routes of metrics/server.py)
        self.query_requests_total = Counter(
            p + "query_requests_total",
            "Agent query-surface requests by route (topk / frequency / "
            "cardinality / victims / status) and result (ok / no_window / "
            "bad_request / not_found / error)", ["route", "result"],
            registry=self.registry)
        self.query_snapshot_age_seconds = Gauge(
            p + "query_snapshot_age_seconds",
            "Seconds since the agent's query snapshot was last published "
            "(resets at every window roll; with SKETCH_QUERY_REFRESH set "
            "it also resets at each mid-window refresh — growth past the "
            "window period means the publish path is failing)",
            registry=self.registry)
        # alerting plane (alerts/ and /query/alerts)
        self.alerts_active = Gauge(
            p + "alerts_active",
            "Alerts currently RAISED by the continuous detection plane "
            "(hysteresis state machine over every snapshot publish; 0 with "
            "ALERT_RULES unset — no engine exists)",
            registry=self.registry)
        self.alerts_transitions_total = Counter(
            p + "alerts_transitions_total",
            "Alert state transitions by rule and action (raise / clear), "
            "exactly one per hysteresis crossing (incremented by the "
            "metrics sink)", ["rule", "action"], registry=self.registry)
        self.alert_sink_errors_total = Counter(
            p + "alert_sink_errors_total",
            "Alert transitions a sink failed to deliver after its bounded "
            "retries (swallowed + counted; the engine state machine and "
            "the other sinks were unaffected)", ["sink"],
            registry=self.registry)
        self.alert_eval_seconds = Histogram(
            p + "alert_eval_seconds",
            "Alert-engine evaluation latency per snapshot publish (host-"
            "only rule walk on the timer thread; sink I/O excluded)",
            buckets=(.0001, .0005, .001, .005, .01, .05, .1, .5),
            registry=self.registry)

    def observe_eviction(self, source: str, n_flows: int, seconds: float) -> None:
        self.evictions_total.labels(source).inc()
        if n_flows:
            self.evicted_flows_total.labels(source).inc(n_flows)
        if seconds > 0:
            self.eviction_seconds.observe(seconds)

    def count_dropped(self, n: int, source: str) -> None:
        self.dropped_flows_total.labels(source).inc(n)

    def count_ringbuf_event(self) -> None:
        self.ringbuf_events_total.inc()

    def add_global_counter(self, key: GlobalCounter, val: int) -> None:
        if val:
            self.kernel_counters_total.labels(key.name.lower()).inc(val)

    def count_exported(self, exporter: str, n_flows: int) -> None:
        self.exported_batches_total.labels(exporter).inc()
        if n_flows:
            self.exported_flows_total.labels(exporter).inc(n_flows)

    def count_export_error(self, exporter: str, error: str) -> None:
        self.export_errors_total.labels(exporter, error).inc()

    def count_error(self, component: str, severity: str = "error") -> None:
        self.errors_total.labels(component, severity).inc()

    def remove_labeled(self, metric, *labelvalues: str) -> None:
        """Delete one labeled series from a metric family (departed
        federation agents); removing a series that never existed is a
        no-op, so callers can evict blindly."""
        try:
            metric.remove(*labelvalues)
        except KeyError:
            pass

    def observe_stage(self, stage: str, seconds: float) -> None:
        self.stage_seconds.labels(stage).observe(seconds)

    def count_retrace(self, fn: str) -> None:
        self.sketch_retraces_total.labels(fn).inc()

    def observe_dispatch(self, fn: str, seconds: float) -> None:
        self.executable_dispatch_seconds_total.labels(fn).inc(seconds)

    def count_stage_failure(self, stage: str, kind: str) -> None:
        self.stage_failures_total.labels(stage, kind).inc()

    def count_stage_restart(self, stage: str) -> None:
        self.stage_restarts_total.labels(stage).inc()

    def set_stage_degraded(self, stage: str, degraded: bool) -> None:
        self.stage_degraded.labels(stage).set(1 if degraded else 0)

    def count_interface_event(self, kind: str, ifname: str = "",
                              ifindex: int = 0, netns: str = "",
                              mac: str = "", retries: int = 0) -> None:
        """Level-gated cardinality, mirroring the reference's
        `newInterfaceEventsCounter` (`pkg/metrics/metrics.go:337-368`):
        info = type only; debug = + retries; trace = full per-interface
        series that self-expire after `trace_ttl_s`.

        Reference: `netobserv_tpu/metrics/registry.py:539`."""
        if self.level == "info":
            self.interface_events_total.labels(kind, "", "", "", "", "").inc()
        elif self.level == "debug":
            self.interface_events_total.labels(
                kind, "", "", "", "", str(retries)).inc()
        else:
            labels = (kind, ifname, str(ifindex), netns, mac, str(retries))
            # refresh the deadline BEFORE incrementing: the janitor re-checks
            # deadlines under the lock at removal time, so an increment can
            # never be swallowed by a concurrent expiry
            self._schedule_trace_expiry(labels)
            self.interface_events_total.labels(*labels).inc()

    def _schedule_trace_expiry(self, labels: tuple[str, ...]) -> None:
        """Trace-level series have unbounded cardinality (one per interface
        identity); a single janitor thread removes each series trace_ttl_s
        after its LAST increment — re-incrementing refreshes the deadline.

        Reference: `netobserv_tpu/metrics/registry.py:559`."""
        deadline = time.monotonic() + self.settings.trace_ttl_s
        with self._trace_lock:
            self._trace_expiry[labels] = deadline
            if self._trace_janitor is None:
                self._trace_janitor = threading.Thread(
                    target=self._trace_janitor_loop, name="metrics-trace-ttl",
                    daemon=True)
                self._trace_janitor.start()

    def _trace_janitor_loop(self) -> None:
        """Reference: `netobserv_tpu/metrics/registry.py:573`."""
        while True:
            with self._trace_lock:
                now = time.monotonic()
                due = [lb for lb, d in self._trace_expiry.items()
                       if d <= now]
                for labels in due:
                    del self._trace_expiry[labels]
            for labels in due:
                with self._trace_lock:
                    if labels in self._trace_expiry:
                        continue  # refreshed since collection — keep it
                    try:
                        self.interface_events_total.remove(*labels)
                    except KeyError:
                        pass  # raced with registry-level removal
            with self._trace_lock:
                if not self._trace_expiry:
                    # nothing left to expire: exit so an idle Metrics (and
                    # its registry) can be GC'd; the next trace increment
                    # restarts the janitor
                    self._trace_janitor = None
                    return
            time.sleep(min(self.settings.trace_ttl_s / 4, 5.0))
