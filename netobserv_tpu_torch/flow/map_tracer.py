"""MapTracer: the timer-driven eviction loop.

A copy of `netobserv_tpu/flow/map_tracer.py` (`MapTracer` and
`_attach_features`, lines 1-323): a ticker drains the datapath's
aggregation map every CACHE_ACTIVE_TIMEOUT; a `flush()` forces an early
eviction; only one eviction runs at a time. It has the columnar path (the
eviction goes downstream as it is, for the sketch exporter), the record
path (`model/record.records_from_events` with the feature lanes
attached), map-pressure relief (MAP_PRESSURE_WATERMARK), the occupancy
sink, the "batch" trace born at `evict` (bound as the drain thread's
active trace while a sampled drain runs, for a kernel drain's child
spans) and finished by the exporter's next fold, and the fault points
`map_tracer.evict` and `map_tracer.pressure_evict`. On the record path
a `udn_mapper` (`ifaces/udn.UdnMapper`, ENABLE_UDN_MAPPING) names each
record's UDN and its dup list's, and an `ssl_correlator`
(`flow/ssl_correlator.SSLCorrelator`, ENABLE_OPENSSL_TRACKING) gives each
record the SSL plaintext credits of its key. Left out: the one-time sync
of the native packer's ABI fallbacks (the port's packer raises on an ABI
mismatch, so `flowpack_abi_fallback_total` stays 0). Changed:
FORCE_GARBAGE_COLLECTION collects after the first eviction of each
active timeout, where the reference collects after every one.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

from netobserv_tpu_torch.datapath.fetcher import FlowFetcher
from netobserv_tpu_torch.utils import faultinject, tracing
from netobserv_tpu_torch.utils.dnsnames import decode_qname
from netobserv_tpu_torch.model.record import (
    InterfaceNamer, MonotonicClock, Record, interface_namer,
    records_from_events,
)

log = logging.getLogger("netobserv_tpu_torch.flow.map_tracer")


class MapTracer:
    def __init__(self, fetcher: FlowFetcher, out: "queue.Queue[list[Record]]",
                 active_timeout_s: float = 5.0, agent_ip: str = "",
                 namer: Optional[InterfaceNamer] = None,
                 metrics=None, stale_purge_s: float = 5.0,
                 columnar: bool = False, udn_mapper=None,
                 force_gc: bool = False, ssl_correlator=None,
                 map_capacity: int = 0,
                 pressure_watermark: float = 0.0,
                 occupancy_sink=None):
        self._fetcher = fetcher
        self._out = out
        self._timeout = active_timeout_s
        # map-pressure relief (MAP_PRESSURE_WATERMARK): when a drain finds
        # the kernel aggregation map at or above watermark * capacity, the
        # next eviction comes EARLY — at half the configured period, so the
        # cadence is bounded at 2x — shrinking the window in which a full
        # map spills into the ringbuf fallback (whose singles can
        # double-count across interfaces). Both values 0 = disabled.
        self._map_capacity = map_capacity
        self._pressure_watermark = pressure_watermark
        self._pressure_relief = False
        # optional per-DRAIN occupancy observer (the sketch exporter's
        # fleet-telemetry block rides it): one callable-or-None check per
        # drain, never per record; errors are the observer's problem, not
        # the eviction loop's
        self._occupancy_sink = occupancy_sink
        self._agent_ip = agent_ip
        self._namer = namer
        self._clock = MonotonicClock()
        self._metrics = metrics
        self._stale_purge_s = stale_purge_s
        # columnar mode: forward EvictedFlows untouched (no per-record Python
        # objects) for exporters that consume columns directly (tpu-sketch)
        self._columnar = columnar
        self._udn_mapper = udn_mapper  # ifaces.udn.UdnMapper when enabled
        # flow/ssl_correlator.SSLCorrelator when OpenSSL tracking is on:
        # enrichment consumes its per-flow plaintext counters
        self._ssl_correlator = ssl_correlator
        if columnar and udn_mapper is not None:
            log.warning("UDN mapping is a no-op on the columnar fast path "
                        "(records are never materialized)")
        # FORCE_GARBAGE_COLLECTION: collect after an eviction so the burst
        # of short-lived record objects returns to the allocator (record
        # path only — the columnar path births no per-record objects), at
        # most once an active timeout: the reference collects after every
        # eviction, and every early eviction a ring-buffer single asks for
        # then walks the whole heap under the interpreter lock
        self._force_gc = force_gc
        self._gc_at: Optional[float] = None
        self._flush = threading.Event()
        self._stop = threading.Event()
        # one eviction at a time — ALSO load-bearing for the parallel
        # drain lanes (loader.BpfmanFetcher): a lane's zero-copy views
        # alias its map's cached batch buffers until decode copies them
        # out, so two concurrent lookup_and_delete calls would rewrite
        # buffers under a live decode; this lock is what serializes them
        self._evict_lock = threading.Lock()
        self._drain_lanes_logged = False
        self._thread: Optional[threading.Thread] = None
        #: supervision hook (agent/supervisor.py): the loop beats once per
        #: wakeup; the supervisor replaces this no-op at registration
        self.heartbeat = lambda: None

    def flush(self) -> None:
        """Force an early eviction (map-pressure relief)."""
        self._flush.set()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="map-tracer", daemon=True)
        self._thread.start()

    def stop(self, final_evict: bool = True) -> None:
        self._stop.set()
        self._flush.set()
        if self._thread:
            self._thread.join(timeout=self._timeout + 2)
        if final_evict:
            self._evict_once()

    def _loop(self) -> None:
        while not self._stop.is_set():
            # wait for either the ticker period or an explicit flush; under
            # map pressure the period halves (bounded 2x cadence)
            self._flush.wait(timeout=(self._timeout / 2
                                      if self._pressure_relief
                                      else self._timeout))
            self._flush.clear()
            self.heartbeat()
            if self._stop.is_set():
                return
            faultinject.fire("map_tracer.evict")
            self._evict_once()

    def _evict_once(self) -> None:
        with self._evict_lock:
            self._evict_locked()

    def _check_map_pressure(self, drained: int) -> None:
        """Drive the pressure-relief latch from this drain's occupancy (a
        drain empties the map, so its size IS the occupancy the drain
        interval accumulated). At or above the watermark the next eviction
        comes at half period. A LATCHED relief sustains down to HALF the
        watermark: halved drains accumulate roughly half the flows, so
        without hysteresis any watermark > 0.5 would oscillate latched/
        clear on alternating drains (and re-log every other cycle) instead
        of holding until load genuinely drops."""
        if not self._map_capacity:
            return
        occupancy = drained / self._map_capacity
        # the histogram populates whenever capacity is known — it is the
        # evidence for whether to set the watermark at all; only the
        # relief latch below is gated on the knob
        if self._metrics is not None:
            self._metrics.map_occupancy_ratio.observe(occupancy)
        if self._occupancy_sink is not None:
            try:
                self._occupancy_sink(occupancy)
            except Exception:
                log.debug("occupancy sink failed", exc_info=True)
        if not self._pressure_watermark:
            return
        pressured = occupancy >= self._pressure_watermark
        sustained = (self._pressure_relief
                     and occupancy >= self._pressure_watermark / 2)
        relief = pressured or sustained
        if relief:
            # stage-boundary chaos seam: per drain, never per record
            faultinject.fire("map_tracer.pressure_evict")
            if not self._pressure_relief:
                log.warning(
                    "kernel map at %.0f%% of capacity (>= watermark %.0f%%);"
                    " halving the eviction period until pressure clears",
                    occupancy * 100, self._pressure_watermark * 100)
            if self._metrics is not None:
                self._metrics.map_pressure_evictions_total.inc()
        self._pressure_relief = relief

    def _evict_locked(self) -> None:
        # flight recorder: a batch trace is born here and rides the evicted
        # batch to the exporter fold (columnar path); un-sampled evictions
        # get the shared NULL trace — no timestamps, no locks
        trace = tracing.start_trace("batch")
        t0 = time.perf_counter()
        with trace.stage("evict"):
            # bind the sampled trace for the drain's child spans
            # (decode/merge_percpu/align in the columnar eviction plane);
            # unsampled drains pay one bool check
            if trace.sampled:
                tracing.set_active(trace)
            try:
                evicted = self._fetcher.lookup_and_delete()
            finally:
                if trace.sampled:
                    tracing.clear_active()
            # purge orphaned auxiliary entries (e.g. DNS never answered)
            purge = getattr(self._fetcher, "purge_stale", None)
            if purge is not None:
                purge(self._stale_purge_s)
        if self._metrics is not None:
            self._metrics.observe_eviction(
                "map", len(evicted), time.perf_counter() - t0)
            self._metrics.evicted_flows_per_drain.observe(len(evicted))
            ds = getattr(evicted, "decode_stats", None)
            if ds is not None:
                self._metrics.eviction_decode_seconds.observe(
                    ds.get("seconds", 0.0))
                if not self._drain_lanes_logged and ds.get("drain_lanes"):
                    # once per process: which drain topology this agent
                    # actually resolved (EVICT_DRAIN_LANES auto rule)
                    self._drain_lanes_logged = True
                    log.info("eviction drain running with %d lane(s)",
                             ds["drain_lanes"])
                # ringbuf-fallback singles (feature rows whose flow missed
                # the aggregation drain) — the one known double-count
                # overload path, now observable per drain
                fallback = ds.get("fallback_rows", 0)
                if fallback:
                    self._metrics.evict_ringbuf_fallback_total.inc(fallback)
                # fused native pipeline (EVICT_NATIVE_PIPELINE): which host
                # path carried this drain + the fused call's per-stage split
                path = ds.get("native_path")
                if path:
                    self._metrics.flowpack_native_calls_total.labels(
                        path).inc()
                native = ds.get("native")
                if native is not None:
                    for stage in ("drain", "merge", "join", "pack"):
                        (self._metrics.host_native_pipeline_seconds
                         .labels(stage).observe(native.get(f"{stage}_s",
                                                           0.0)))
            self._metrics.buffer_size.labels("evicted").set(
                self._out.qsize())
            for key, val in self._fetcher.read_global_counters().items():
                self._metrics.add_global_counter(key, val)
        self._check_map_pressure(len(evicted))
        if self._force_gc and not self._columnar:
            # the columnar fast path materializes no per-record Python
            # objects, so a collect there is pure stall
            now = time.monotonic()
            if self._gc_at is None or now - self._gc_at >= self._timeout:
                self._gc_at = now
                import gc
                gc.collect()
        if len(evicted) == 0:
            return  # idle eviction: drop the trace unrecorded (no flows)
        if self._columnar:
            if trace.sampled:
                evicted.trace = trace  # the exporter fold finishes it
            try:
                self._out.put_nowait(evicted)
            except queue.Full:
                if self._metrics is not None:
                    self._metrics.count_dropped(len(evicted), "map_tracer")
                log.warning("eviction dropped: downstream buffer full "
                            "(%d flows)", len(evicted))
                trace.finish()  # never reaches the fold — seal what we have
            return
        with trace.stage("enrich"):
            namer = self._namer or interface_namer()
            records = records_from_events(
                evicted.events, clock=self._clock, agent_ip=self._agent_ip,
                namer=namer)
            _attach_features(records, evicted,
                             ssl_correlator=self._ssl_correlator)
            if self._udn_mapper is not None:
                for rec in records:
                    rec.udn = self._udn_mapper.udn_for(rec.interface)
                    rec.dup_list = [
                        (name, d, self._udn_mapper.udn_for(name))
                        for name, d, _u in rec.dup_list]
        # record batches are plain lists and cannot carry a trace context;
        # the record path's trace ends at enqueue (evict + enrich spans)
        trace.finish()
        try:
            self._out.put_nowait(records)
        except queue.Full:
            # downstream full: the limiter's role; count and drop
            if self._metrics is not None:
                self._metrics.count_dropped(len(records), "map_tracer")
            log.warning("eviction dropped: downstream buffer full (%d records)",
                        len(records))


def _attach_features(records: list[Record], evicted,
                     ssl_correlator=None) -> None:
    """Copy per-feature arrays onto the enriched records (already merged)."""
    for i, rec in enumerate(records):
        f = rec.features
        if ssl_correlator is not None:
            n_ev, n_bytes = ssl_correlator.take(rec.key)
            f.ssl_plaintext_events = n_ev
            f.ssl_plaintext_bytes = n_bytes
        if evicted.dns is not None and i < len(evicted.dns):
            d = evicted.dns[i]
            f.dns_id = int(d["dns_id"])
            f.dns_flags = int(d["dns_flags"])
            f.dns_latency_ns = int(d["latency_ns"])
            f.dns_errno = int(d["errno"])
            f.dns_name = decode_qname(bytes(d["name"]))
        if evicted.drops is not None and i < len(evicted.drops):
            d = evicted.drops[i]
            f.drop_bytes = int(d["bytes"])
            f.drop_packets = int(d["packets"])
            f.drop_latest_flags = int(d["latest_flags"])
            f.drop_latest_state = int(d["latest_state"])
            f.drop_latest_cause = int(d["latest_cause"])
        if evicted.extra is not None and i < len(evicted.extra):
            e = evicted.extra[i]
            f.rtt_ns = int(e["rtt_ns"])
            f.ipsec_encrypted = bool(e["ipsec_encrypted"])
            f.ipsec_encrypted_ret = int(e["ipsec_ret"])
        if evicted.xlat is not None and i < len(evicted.xlat):
            x = evicted.xlat[i]
            if x["src_ip"].any() or x["dst_ip"].any():
                f.xlat_src_ip = x["src_ip"].tobytes()
                f.xlat_dst_ip = x["dst_ip"].tobytes()
                f.xlat_src_port = int(x["src_port"])
                f.xlat_dst_port = int(x["dst_port"])
                f.xlat_zone_id = int(x["zone_id"])
        if evicted.nevents is not None and i < len(evicted.nevents):
            n = evicted.nevents[i]
            # n_events is a wrapping ring cursor (accumulate_network_events),
            # not a count: render every occupied slot instead, keyed on
            # packets[j] != 0 like the reference (pkg/model/record.go:129-131)
            for j in range(n["events"].shape[0]):
                if int(n["packets"][j]) != 0 or n["events"][j].any():
                    f.network_events.append(n["events"][j].tobytes())
        if evicted.quic is not None and i < len(evicted.quic):
            q = evicted.quic[i]
            f.quic_version = int(q["version"])
            f.quic_seen_long_hdr = bool(q["seen_long_hdr"])
            f.quic_seen_short_hdr = bool(q["seen_short_hdr"])
