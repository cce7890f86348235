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
`federation_checkpoints_total`, `:452-480`). Each family has the
reference family's name, type, help text, labels and buckets. The families
of the agent's other stages (evictions, interfaces, supervision) and of
overload and tenants come with the steps that port those planes (ROADMAP
A4-A5).

`prometheus_client` is imported only when a `Metrics` is made, or when
`exposition` renders a registry for the metrics server's `/metrics`: no
other module imports it, and the exporter keeps plain integer counters of
its own that work without a registry.
"""

from __future__ import annotations

from dataclasses import dataclass

def exposition(registry) -> tuple[bytes, str]:
    """The text exposition of a `CollectorRegistry` and its content type
    (what the reference's server writes for `/metrics`)."""
    from prometheus_client import generate_latest
    from prometheus_client.exposition import CONTENT_TYPE_LATEST
    return generate_latest(registry), CONTENT_TYPE_LATEST


@dataclass
class MetricsSettings:
    """The family prefix of the reference's settings
    (`metrics/registry.py:37-48`); its verbosity level and series TTL
    serve the agent's interface-event families, which the port does not
    have."""

    prefix: str = "ebpf_agent_"


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
        self.registry = (registry if registry is not None
                         else CollectorRegistry())
        p = settings.prefix

        self.errors_total = Counter(
            p + "errors_total", "Agent errors by component and severity",
            ["component", "severity"], registry=self.registry)
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
