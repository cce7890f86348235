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
`alert_eval_seconds`, `:303-340`). Each family has the reference family's
name, type, help text, labels and buckets. The families of the agent's
other stages (evictions, interfaces, supervision) and of overload,
tenants, federation and archive come with the steps that port those
planes (ROADMAP A4-A5).

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

    def observe_stage(self, stage: str, seconds: float) -> None:
        self.stage_seconds.labels(stage).observe(seconds)

    def count_retrace(self, fn: str) -> None:
        self.sketch_retraces_total.labels(fn).inc()

    def observe_dispatch(self, fn: str, seconds: float) -> None:
        self.executable_dispatch_seconds_total.labels(fn).inc(seconds)
