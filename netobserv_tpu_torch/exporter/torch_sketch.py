"""The sketch exporter of the port: feeds, window plane and fold containment.

Counterpart of `netobserv_tpu/exporter/tpu_sketch.py` (`TpuSketchExporter`
on one device). Flow records go in through one of three entry points:

- `export_evicted` takes one map eviction (`datapath/fetcher.EvictedFlows`:
  flow events and their feature lanes) into a
  `sketch/staging.PendingEventBuffer`, which folds batch-aligned prefixes
  through the feed's staging ring and keeps each sub-batch tail for the
  next eviction or the window's close;
- `fold_events` takes raw flow events with their feature lanes as one
  eviction, the same way;
- `fold_dense` takes the pre-packed dense feed (20 words per record): each
  batch is padded to the fixed batch size, staged in one pinned host
  buffer and copied to the device without blocking; the next batch waits
  only for that copy.

The feed (`feed=`) is the reference's `_make_single_device_ring`
(`tpu_sketch.py:1575-1635`):

- "resident" (the default, the reference agent's): a
  `ShardedResidentStagingRing` at one shard, `pick_lanes(batch_size,
  lanes)` pack lanes and the superbatch ladder `superbatch` (default
  (1, 2, 4)); the pending buffer holds `superbatch_max` batches, so rows
  that arrive together fold as one k-batch dispatch;
- "compact": a `DenseStagingRing` of the compact feed, with its spill lane
  (`default_spill_cap`) and its synchronous dense fallback;
- "dense": a `DenseStagingRing` of the dense feed.

`pack_threads=0` means auto, min(CPU count, 8), as SKETCH_PACK_THREADS=0
does. The lanes take that count when it was given, or when the host has
at least 4 CPUs; an auto count on a smaller host packs one lane (lanes pay
per-lane key tables and gain only where parallel packs scale,
`tpu_sketch.py:466-473`).

The ring is made at the feed's first use: an exporter fed only dense
batches builds no packer. On CUDA, making the ring (or the dense entry's
first use) builds and loads every kernel library (`_build.load_all`), and
each fold runs as a CUDA graph (`sketch/capture.py`) in one memory pool:
the exporter's "fold_dense", the dense ring's "fold_dense_ring", the
compact ring's "fold_compact" and "fold_compact_dense", and one graph per
ladder entry, "fold_resident_lanes_x{k}". Every graph is captured before
any fold: the rings' when they are made (`warm_superbatch_ladder`,
`DenseStagingRing.warm`), the dense entry's at its first use. A build,
load or capture that fails there raises; nothing falls back to eager
folds, to plain kernels or to a smaller ladder. `capture=False` folds
eagerly, op by op, as the CPU always does.

**A failed fold is contained** (the reference's `_fold_events`, `_fold`
and `_count_ingest_error`, `tpu_sketch.py:1343-1425`, `:1636-1689`): a
fold that raises (the `sketch.ingest` fault point fires inside the same
`try`) is logged, its rows are dropped and counted in `ingest_errors` (and
`sketch_ingest_errors_total`), and every dictionary of a resident ring is
reset: an epoch roll, so that no hot row references a slot whose new-key
row never reached the device key table. The exception never reaches the
caller of `export_evicted`, `fold_events` or `fold_dense`. What such a
failure can leave behind:

- every ingest runs `sketch.state.check_fold_shapes` before its first
  in-place update, so a shape a kernel cannot hold raises with every table
  and key table untouched;
- past that point, eager folds update the state op by op: a device fault
  in the middle leaves the tables before it folded (in order: the key
  tables' new-key rows, the Count-Min planes, the heavy-hitter slot table,
  the HLL registers, the histograms, the signal planes and the window
  totals). The reference's jitted ingest folds a batch whole or not at
  all;
- a captured fold is one `graph.replay()`. A CUDA fault there is sticky
  for the context: every later CUDA call fails, and each later fold is
  contained and counted in turn. Containment cannot mend the context and
  does not try.

**The window plane** (`tpu_sketch.py:482-505`, `:947-1001`, `:1446-1470`,
`:1529-1556`, `:1691-2095`). With `window_s` set, a window thread
(`start_window_timer`) wakes every `min(1.0, window_s / 10)` seconds and
closes the window once its deadline has passed, so an idle exporter still
publishes. `export_evicted` and `fold_dense` also close a window whose
deadline passed, under the exporter lock, and return None. Closing a
window drains the pending rows (span `roll_drain`), rolls the state and
copies the report to the host (`roll_dispatch`), and queues the report;
the window thread renders it (`report_render`) and hands it to the sink
(`report_sink`) outside the lock, so a slow sink never blocks a fold. The
queue holds at most 8 reports: past that the oldest is shed, counted in
`reports_shed` and `sketch_reports_shed_total`. A sink or render failure
loses that report, counted and logged; the window has rolled. `flush()`
closes the window now and publishes synchronously; `roll()` does the same
and returns the rendered report; `close()` stops the thread, publishes the
last window (`flush`), closes the sink and frees the device buffers. With
`window_s=None` there is no thread, and only `roll`, `flush` and `close`
close windows.

Every CUDA call of the window plane runs under the exporter lock, on the
same stream as the folds: a capture (ring creation, a rebind) never sees
another thread's CUDA work, and the report is a host snapshot before the
lock is released. The window thread's render and sink are host work only.

**The query plane** (`tpu_sketch.py:723-794`, `:1558-1572`, `:1794-1939`,
`:2036-2058`). Every roll also copies the pre-roll wide Count-Min planes
to the host under the lock (`sketch/state.host_cm_planes`); they ride the
queued report. Its publish renders the report, stamps it, then publishes
a query snapshot (`window`, `ts_ms`, `report`, `cm_bytes`, `cm_pkts`;
`seq` and `mid_window` stamped by `query`, a `query/snapshot.
SnapshotPublisher` keeping `query_history` closed windows) in a `try` of
its own under the `query_snapshot` span and fault point, and only then
calls the sink: a failed publish is logged and counted
(`count_error("tpu-sketch-query")`) and never loses the report. The alert
engine (`alerts=`, an `alerts/engine.AlertEngine` or None) evaluates every
snapshot published (`safe_evaluate`). `query_routes` (a
`query/routes.QueryRoutes`) answers `/query/*` from the snapshots only;
`serve` starts the port's metrics server (`metrics/server.py`) with them,
and `query_status` is `/query/status`'s body.

With `query_refresh_s` > 0 the window thread also publishes a mid-window
snapshot every `query_refresh_s` seconds (`_refresh_query_snapshot`):
under the lock it folds the pending rows, copies the live state into a
staging state made once (`sketch/state.copy_state_`; a tiered state gets a
tiered twin, whose roll re-encodes the twin's tiers, never the live
ones), rolls the staging state and copies its report and planes to the
host; off the lock it publishes any closed window still queued (so
snapshots publish in window order, where the reference can publish a
queued closed window after the next window's refresh), then renders the
partial window and publishes it with `mid_window=True`. The live window
accumulates on, untouched. A failed refresh is logged, counted and tried
again at the next tick. The reference rolls its staged copy off the
lock; here the staged roll stays under it, with every other CUDA call of
the window plane (ROADMAP C2 names the off-lock roll as later work).

Fault points (`utils/faultinject`): `sketch.ingest`,
`sketch.query_snapshot`, `sketch.window_timer` (outside the roll's `try`:
a crash there is the supervisor's), `sketch.window_roll` (a roll error is
swallowed and counted) and `sketch.window_publish`; the rings fire
`sketch.staging_wait`, the alert engine `alerts.evaluate` and its sinks
`alerts.sink`.
`register_supervised` registers the window thread with any supervisor that
has the reference's `Supervisor.register` signature.

Metrics: with a `metrics` facade (`metrics/registry.Metrics`) the exporter,
its ring and its pending buffer count the reference's `sketch_*` families,
and `utils/retrace` and `utils/tracing` are bound to it. Without one the
plain counters below still count.

The device timeline (`utils/tracing.Timeline`, on one CUDA device without
tenants): at any TRACE_SAMPLE above 0 every dispatch's slot copy and
fold, and every roll's device work, is timed between two CUDA events
(`device_busy_seconds_total{span}`), and the device's idle time between
them is put down to the phase of the thread holding `_lock`
(`tracing.PhaseLock`: `pack`, `dispatch`, `roll`, `entry` or, the lock
free, `caller`; `device_idle_seconds_total{phase}`). `_roll_locked` times
the state's copy and roll and reads every interval back after the
report's copy to the host.

With `SketchConfig(tiered=TierSpec())` the state stays resident in tiered
form (`sketch/tiered.py`); folds, rolls and `state_tables` work the same,
`counter_table_bytes` gives the resident bytes of the tier-covered tables,
and with metrics each window counts its new promotions
(`sketch_tier_promotions_total`).

**The delta export** (`tpu_sketch.py:380-455`, `:1095-1126`,
`:1981-2035`). With a `delta_sink` (a callable taking the frame's bytes,
such as `federation/aggregator.FederationAggregator.ingest_frame`), every
roll copies the whole pre-roll `state_tables` to the host under the lock
(without one, only the CM planes), and the publish pushes one delta frame
(`federation/delta.encode_frame`) before it renders the report, in a `try`
of its own: the span `report_serialize` covers the fault point
`sketch.delta_export` and the encode, the span `delta_push` the sink. A
failure there is logged and counted (`count_error("federation")`) and
never loses the report. The frame carries `agent_id` (default: the host
name), `agent_epoch` (`time.time_ns()` when the exporter was made), the
window as its `window_seq`, the telemetry block (`_telemetry_block`: the
overload controller's shed factor, the OVERLOADED and ALERTING conditions,
the kernel map's occupancy) and, for a sampled
window trace, its `trace_ctx` (counted
`trace_context_propagated_total{stamped}`). Decay mode keeps cumulative
tables, which an aggregator would count twice: the sink is dropped (and
closed) with the reference's warning. `close()` closes the sink.

**Checkpoints** (`tpu_sketch.py:515-519`, `:807-832`, `:1730-1738`,
`:1941-1956`). With `checkpoint_dir` the exporter restores the latest
checkpoint when it is made (`sketch/checkpoint.SketchCheckpointer`), in
place, before any ring captures: a tiered exporter restores the wide form
and encodes it into its tiers. A checkpoint that is rejected or does not
fit logs and leaves a fresh window; it never raises. With
`checkpoint_every` N > 0 every Nth roll saves the post-roll state (a
tiered state's wide decode) as the window's step: its host copy is taken
under the lock at the roll (`SketchCheckpointer.stage`), and the publish
writes it off the lock after the window's report; a roll before that
write supersedes it. A failed write is logged and counted
(`count_error("tpu-sketch")`). `close()` publishes, so it writes the
last staged checkpoint before it returns.

**The archive** (`tpu_sketch.py:745-772`, `:1846-1849`, `:2063-2082`).
With `archive` (an `archive.SketchArchive`) every roll copies all of
`state_tables`, and the publish writes the window's segment after the
sink, in a `try` of its own: span `archive_write`, fault point
`sketch.archive_write`, a failure logged and counted
(`count_error("tpu-sketch-archive")`) and never losing the report.
`/query/range` answers from it, and `query_status` has its `archive`
block. The archive's device work holds the exporter lock (`SketchArchive.
share_device_lock`, ROADMAP C4).

**Overload control** (`tpu_sketch.py:705-722`, `:1080-1126`,
`:1218-1298`, `:1365-1391`, `:1699-1702`). With `shed_watermark` > 0 the
exporter makes a `sketch/overload.OverloadController` (else
`_overload` is None: one is-None check, no RNG, no copy) and sets its
ring's `slot_wait_budget_s` to `shed_slot_budget_s` when the ring is made.
`export_evicted` admits each eviction under the lock
(`_export_evicted_now`): busy is fold seconds per wall second between
arrivals (an EWMA, alpha 0.5), the controller updates on the pending rows
plus the eviction plus the rows still in the overlap handoff, the ring's
slot-wait p95 and busy, and `admit` thins the eviction 1 in N, N
multiplied into each kept row's `sampling`, before the pending buffer
takes it. `fold_dense` has no admission, as the reference's
`export_batch` has none. A fold that meets the slot-wait budget
(`staging.StagingWedged`) drops the rows not yet packed, counted in
`ingest_errors`, `sketch_ingest_errors_total` and
`count_error("tpu-sketch-ingest")`, with no dictionary epoch roll: no
slot was committed for them. Each roll calls the controller's
`window_roll`. `overloaded`, `overload_snapshot`, `note_map_occupancy`,
the frames' telemetry and `query_status` report it.

**The overlapped fold thread** (`tpu_sketch.py:837-859`, `:1218-1341`,
`:1462-1500`). With `overlap_depth` > 0 `export_evicted` puts the eviction
into a bounded handoff (`queue.Queue(maxsize=overlap_depth)`, blocking
while it is full) and returns; a "sketch-fold" thread takes each and runs
the admission and fold above, on the exporter's device. The ring is made,
and its ladder captured, in the constructor, on the caller's thread,
before that thread starts, so no capture runs on it (ROADMAP C4).
`flush` waits for the handoff first; `close` stops the thread, joins it
and folds what it left synchronously, each batch contained, before its
last roll. With depth 0 there is no queue and no thread.

`register_supervised` registers the window thread ("sketch-window"), the
fold thread ("sketch-fold") where there is one, and the `overloaded` and
`alerting` conditions (`tpu_sketch.py:954-1001`) with any supervisor of
the reference's signature, such as the port's `agent/supervisor.py`.

**The agent's seam** (`tpu_sketch.py:1004-1078`, `:1208-1216`,
`:1257-1295`, `:1346-1349`). `name` ("tpu-sketch", the metrics label)
and `supports_columnar` are the `exporter/base.Exporter` seam: the map
tracer then forwards evictions as they are, and the terminal stage calls
`export_evicted`. `export_batch` takes the record path's records without
admission, as the reference's takes them: in record order, `batch_size`
a fold, apart from the evictions, with the columns of the reference's
`FlowBatch.from_records` (`_records_to_arrays`; no QUIC markers, no drop
cause). On one device they fold through the dense entry's buffers and a
captured graph of their own (`fold_records`), in tenant mode as dense rows
routed into the stack (`TenantStack.fold_rows`), and on a mesh as a
padded batch split over the data shards into the mesh's plain ingest
(`parallel/merge.shard_batch`, `make_sharded_ingest_fn`).
`from_config` builds the exporter an `AgentConfig` describes
(`config.py`): the SKETCH_* geometry, batch, window, feed, ladder,
thresholds, overload, query, alert, archive and checkpoint settings, the
report sink of SKETCH_REPORT_SINK (stdout or Kafka) and the decay factor
of SKETCH_WINDOW_MODE=decay, and with SKETCH_TENANTS the tenant planes,
with a per-tenant archive set (`archive.tenant_archives`) where
ARCHIVE_DIR is set, and with SKETCH_MESH_SHAPE the mesh. SKETCH_DEVICES
"" means the cards (`pick_device`, which raises without CUDA) and "cpu"
the CPU with the plain versions, repeated for a mesh; any other
SKETCH_DEVICES raises `ValueError`. FEDERATION_TARGET (`host:port`)
makes the delta sink the port's `exporter/federation.FederationDeltaSink`
over its own gRPC transport (`grpc/h2.py`), as `tpu_sketch.py:1011-1015`
does.
A sampled batch trace riding an eviction (`evicted.trace`, the map
tracer's) is parked until
the next fold, which finishes it with its `fold` span; a second one
arriving before that fold is finished at once.

**The fused drain's seam** (`tpu_sketch.py:1128-1198`, `:1258-1273`,
`:1356-1362`, `:1421-1425`). `resident_pack_surface()` gives the lanes
ring's `staging.ResidentPackSurface` (making the ring if need be), which
the agent binds to a fetcher's fused drain (`bind_pack_surface`,
`datapath/loader.NativeEvictPipeline`); it is None for another ring, with
overload control on (a packed arena cannot be thinned) and with
`packer="python"` (the fused pack keys on the native dictionaries). An
eviction that carries `packed` regions ships them at once, under the
lock, before admission and before the pending buffer, through
`ShardedResidentStagingRing.fold_packed` (`_fold_packed_locked`); an
arena whose epoch is stale is freed and the eviction's rows take the raw
path. Every raw fold of the ring first calls `invalidate_for_raw_fold`,
and the ingest error's epoch roll calls `note_external_reset`.

**Tenant planes** (`tenants=N`, SKETCH_TENANTS; `tpu_sketch.py:524-535`,
`:646-693`, `:732-781`, `:1427-1444`, `:1761-1860`, `:1915-1934`,
`:2097-2210`). The state is N tenant states stacked on a leading axis
(`sketch/tenancy.py`), and the ring is a `tenancy.TenantStack`, made and
captured in the constructor ("tenant_ingest", one graph a tenant count):
the pending buffer's folds route every row to its tenant's buffer, and a
stacked dispatch folds every tenant's rows. SKETCH_FEED does not apply
(logged), `fold_dense` raises, and `export_batch` folds its records as
evictions, so only real rows are routed. The window's drain also flushes
the tenant buffers, its wedge logged and counted; the roll rolls every
tenant under the lock and copies each tenant's report and tables to the
host (`_roll_tenants`); the publish fans each window out per tenant
(`_publish_report_tenants`): N reports with their `Tenant`, each diffed
against its own previous heavy index, N delta frames with
`tenant=(t, N)`, one snapshot a tenant to its own `SnapshotPublisher`
(the routes require ``?tenant=``; `query_snapshot_age_seconds` is the
youngest; `query_status` has a `tenants` block), the per-tenant archive
segments (a single-store `archive` is disabled with a warning), the tier
metrics by tenant and `sketch_tenant_window_records{tenant}`. A refresh
rolls a staged copy of the whole stack and publishes every tenant's
partial window. Checkpoints have no stacked form: `checkpoint_dir` is
disabled with a warning. `close()` evicts the per-tenant series.
`sketch_resident_hbm_bytes` is the state's bytes, stacked or not.

**The mesh** (`mesh_shape`, `devices`; `tpu_sketch.py:521-647`). With a
mesh shape, or with more than one device (`devices`, else every visible
card when `device` is None, all on the data axis), the state is a
`parallel/merge.DistState` over `parallel/mesh.make_mesh` (a shape that
needs more devices than these raises, naming both counts; it never
shrinks). The batch rounds up to a multiple of the data axis. The ring
is a `ShardedResidentStagingRing` over the data shards,
`pick_lanes(rows a shard, lane_threads // data)` lanes each, or a
`DenseStagingRing` on the mesh (SKETCH_FEED=compact logs and takes it,
as the reference does); each device's shards fold as one captured graph
a ladder entry. The roll is `parallel/merge.make_merge_fn`: the merged
report and tables, every shard rolled in place, its slot table kept. A
width-sharded mesh has no whole-width tables: the delta sink and the
archive are dropped with the reference's warnings, the query snapshots
carry no CM planes (`/query/frequency` answers 503) and `state_tables`
raises. Tenants run as one tenant and SKETCH_TIERED as wide tables,
each with the reference's warning; the latter also shows as the
`tiered_degraded` supervisor condition and in `query_status`. The
refresh rolls a staged `DistState` through the merge; checkpoints save
and restore the `DistState` in place (`sketch/checkpoint.py`).
`fold_dense` takes one device only. `sketch_resident_hbm_bytes` sums
every shard this process holds.

**Across processes** (`parallel/distributed.py`; reference `:508-513`,
`:785-792`, `:875-925`): the constructor's first step joins the process
group when SKETCH_COORDINATOR, SKETCH_NUM_PROCESSES and
SKETCH_PROCESS_ID say so (a no-op otherwise, and a second call does not
init again), before any tensor is made. The mesh then spans every rank's
devices (`parallel/mesh.make_mesh`; with no shape, all of them on the
data axis), each rank is given the same evictions and folds its own
shards, and each roll is a collective: every rank must close its windows
in the same order, and every rank returns the same report. So on a
multi-process mesh:

- SKETCH_QUERY_REFRESH is turned off, with the reference's warning: each
  rank's timer would run the roll's collectives on its own schedule;
- the ring is made, and every ladder entry warmed, in the constructor,
  synchronously, in ladder order, on every rank; a warm failure raises;
- a fold never closes a window (the deadline is read by the window
  thread, `roll` and `flush`), so neither the fold thread nor the caller
  of `export_evicted` ever waits on another rank;
- `state_tables` is a collective too; checkpoints are gathered to and
  written by rank 0 into a directory every rank shares
  (`sketch/checkpoint.py`).

Every CUDA call of the roll, the collectives included, holds the
exporter's lock (ROADMAP C4).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import queue
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from netobserv_tpu_torch import config
from netobserv_tpu_torch.config import (
    DEFAULT_ASYM_MIN_BYTES, DEFAULT_ASYM_RATIO, DEFAULT_CHURN_ASCENT,
    DEFAULT_CHURN_MIN_BYTES, DEFAULT_DDOS_Z, DEFAULT_DROP_Z,
    DEFAULT_SCAN_FANOUT, DEFAULT_SYNFLOOD_MIN, DEFAULT_SYNFLOOD_RATIO,
)
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.report import (
    SIGNAL_FIELDS, ReportSink, _default_sink, heavy_identity_index,
    make_report_sink, report_numpy, report_to_json,
)
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.columnar import pack_key_words
from netobserv_tpu_torch.ops.kernels import _build
from netobserv_tpu_torch.parallel import distributed
from netobserv_tpu_torch.parallel import merge as pmerge
from netobserv_tpu_torch.parallel import mesh as pmesh
from netobserv_tpu_torch.query.routes import QueryRoutes
from netobserv_tpu_torch.query.snapshot import SnapshotPublisher
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch import overload, staging, tenancy, tiered
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.utils import faultinject, retrace, tracing
from netobserv_tpu_torch.utils.platform import pick_device

log = logging.getLogger("netobserv_tpu_torch.exporter.torch_sketch")
#: whether the mesh's SKETCH_TIERED degradation was logged (once a
#: process: exporters are rebuilt on restarts)
_TIERED_DEGRADE_WARNED = False

FEEDS = ("resident", "compact", "dense")
#: reports a window close may queue before the oldest is shed
MAX_QUEUED_REPORTS = 8


class _Queued:
    """A closed window waiting for its publish: the host report, the
    pre-roll wide CM planes on the host, the window trace, and the
    rendered object once published."""

    __slots__ = ("report", "tables", "trace", "out")

    def __init__(self, report, tables, trace):
        self.report = report
        self.tables = tables
        self.trace = trace
        self.out: Optional[dict] = None


class TorchSketchExporter:
    """Folds flow records into one device-resident sketch state and
    publishes a report each window (module docstring).

    `decay_factor` / `reset_sketches` choose the roll mode as in
    `sketch.state.roll_window`; the thresholds (`scan_fanout_threshold`
    ... `churn_min_bytes`) are the renderer's (`exporter/report.py`);
    `sink` takes each rendered report (default: JSON lines on standard
    output). Plain counters: `folds` (ingest dispatches; a superbatch of k
    batches is one), `records` (records of the folds that succeeded),
    `rolls` (closed windows), `ingest_errors` (folds contained),
    `reports_published` (reports the sink took) and `reports_shed`; the
    ring keeps `dict_resets`. `ring` is the feed's staging ring
    (`resident_slots` slots a region, the packer `packer` names for the
    resident feed: "native", the default, or "python"), made at the feed's
    first use, and `pending` its `PendingEventBuffer`. On a CUDA device
    `capture` folds through CUDA graphs, listed in `captures`; the CPU
    folds eagerly. `query_refresh_s`, `query_history` and `alerts` set up
    the query plane (module docstring); `agent_id` (default: the host
    name) names the exporter in `/query/status` and in its delta frames;
    `delta_sink` takes one delta frame per closed window;
    `checkpoint_dir`, `checkpoint_every` and `archive` set up checkpoints
    and the archive; `shed_watermark`, `shed_max`, `shed_slot_budget_s`
    and `shed_seed` the overload controller, `overlap_depth` the
    overlapped fold thread, and `tenants` the tenant planes (module
    docstring)."""

    #: the `exporter/base.Exporter` seam: the metrics label, and evictions
    #: taken as they are (`export_evicted`)
    name = "tpu-sketch"
    supports_columnar = True

    def __init__(self, cfg: sk.SketchConfig = sk.SketchConfig(),
                 batch_size: int = 16384,
                 device: str | torch.device | None = None,
                 window_s: Optional[float] = None,
                 reset_sketches: bool = True,
                 decay_factor: Optional[float] = None,
                 sink: Optional[ReportSink] = None,
                 packer: str = "native", capture: bool = True,
                 feed: str = "resident", pack_threads: int = 0,
                 superbatch=(1, 2, 4), resident_slots: int = 1 << 18,
                 metrics=None,
                 scan_fanout_threshold: float = DEFAULT_SCAN_FANOUT,
                 ddos_z_threshold: float = DEFAULT_DDOS_Z,
                 synflood_min: float = DEFAULT_SYNFLOOD_MIN,
                 synflood_ratio: float = DEFAULT_SYNFLOOD_RATIO,
                 drop_z_threshold: float = DEFAULT_DROP_Z,
                 asym_min_bytes: float = DEFAULT_ASYM_MIN_BYTES,
                 asym_ratio: float = DEFAULT_ASYM_RATIO,
                 churn_ascent: float = DEFAULT_CHURN_ASCENT,
                 churn_min_bytes: float = DEFAULT_CHURN_MIN_BYTES,
                 query_refresh_s: float = 0.0, query_history: int = 8,
                 alerts=None, agent_id: str = "", delta_sink=None,
                 checkpoint_dir: str = "", checkpoint_every: int = 0,
                 archive=None, shed_watermark: float = 0.0,
                 shed_max: int = 64, shed_slot_budget_s: float = 30.0,
                 shed_seed: int = 2026, overlap_depth: int = 0,
                 tenants: int = 0, mesh_shape: str = "", devices=None):
        # the process group comes first, before any tensor (module
        # docstring); a no-op without its settings
        distributed.maybe_initialize_distributed(
            devices=self._local_devices(device, devices))
        #: the mesh (`parallel/mesh.Mesh`), or None: one device
        self.mesh = self._make_mesh(device, devices, mesh_shape)
        #: whether the mesh belongs to several processes
        self._multiprocess = self.mesh is not None and \
            self.mesh.multiprocess
        self.device = (self.mesh.first if self.mesh is not None
                       else pick_device(device))
        cuda = self.device.type == "cuda"
        if packer not in ("native", "python"):
            raise ValueError(f"packer must be 'native' or 'python', not "
                             f"{packer!r}")
        if feed not in FEEDS:
            raise ValueError(f"feed must be one of {FEEDS}, not {feed!r}")
        if query_refresh_s < 0 or query_history < 0:
            raise ValueError("query_refresh_s and query_history must be >= 0")
        if overlap_depth < 0:
            raise ValueError("overlap_depth must be >= 0")
        if tenants < 0:
            raise ValueError("tenants must be >= 0")
        #: SKETCH_TIERED asked for and degraded to wide tables on a mesh
        self._tiered_degraded = False
        if self.mesh is not None:
            cfg, tenants, batch_size = self._mesh_degrade(cfg, tenants,
                                                          batch_size)
        self.cfg = cfg
        self.batch_size = batch_size
        self.window_s = window_s
        self.reset_sketches = reset_sketches
        self.decay_factor = decay_factor
        self.sink = sink or _default_sink
        self.feed = feed
        self._thresholds = dict(
            scan_fanout_threshold=scan_fanout_threshold,
            ddos_z_threshold=ddos_z_threshold, synflood_min=synflood_min,
            synflood_ratio=synflood_ratio, drop_z_threshold=drop_z_threshold,
            asym_min_bytes=asym_min_bytes, asym_ratio=asym_ratio,
            churn_ascent=churn_ascent, churn_min_bytes=churn_min_bytes)
        self.superbatch = config.parse_superbatch_ladder(superbatch)
        self.pack_threads = config.resolved_pack_threads(pack_threads)
        # pack lanes wanted: an auto count engages lanes only on a host of
        # at least 4 CPUs
        self._lane_threads = (self.pack_threads if pack_threads > 0
                              or (os.cpu_count() or 1) >= 4 else 1)
        self.resident_slots = resident_slots
        self._metrics = metrics
        if metrics is not None:
            retrace.set_metrics(metrics)
            tracing.set_metrics(metrics)
        #: the overload controller (None: no shedding, one is-None check)
        self._overload = overload.maybe_controller(
            batch_size, shed_watermark, shed_max, metrics=metrics,
            seed=shed_seed)
        self._shed_slot_budget_s = shed_slot_budget_s
        # the controller's busy weight: fold seconds since the last
        # arrival, that arrival's time, and their EWMA
        self._busy_fold_s = 0.0
        self._busy_last_t: Optional[float] = None
        self._busy_ewma = 0.0
        #: the kernel map's occupancy at its last drain (telemetry)
        self._map_occupancy = 0.0
        self._tier_form = sk.tiered_fold_form(cfg)
        #: previous window's promoted-counter masks, by CM table: in decay
        #: mode promotions persist, and only new ones count
        self._tier_prev_promoted: dict = {}
        #: the tenant count (0: one state, no tenant plane)
        self.tenants = tenants
        #: the device timeline of the folds and rolls (`utils/tracing`;
        #: one CUDA device without tenants), which times them while
        #: tracing is on, else None
        self._timeline = (tracing.device_timeline(self.device)
                          if self.mesh is None and not tenants else None)
        if self._timeline is not None:
            self._timeline.bind(metrics)
        #: each tenant's previous closed window's heavy index
        self._tenant_prev_index: dict[int, Optional[dict]] = {}
        if self.mesh is not None:
            self.state = pmerge.init_dist_state(cfg, self.mesh)
        elif tenants:
            self.state = tenancy.init_stacked_state(cfg, tenants,
                                                    self.device)
        else:
            self.state = sk.init_state(cfg, self.device)
        #: whether a roll has the whole-width merged tables (all but a
        #: width-sharded mesh), and the mesh's roll
        self._with_tables = self.mesh is None or self.mesh.sketch == 1
        self._mesh_roll = (pmerge.make_merge_fn(
            self.mesh, cfg, reset_sketches, decay_factor,
            with_tables=self._with_tables)
            if self.mesh is not None else None)
        self._ckpt = None
        self._ckpt_every = checkpoint_every
        self._n_windows_saved = 0
        #: (step, staged host copy) of the last checkpoint roll, unwritten
        self._pending_ckpt = None
        if checkpoint_dir and tenants:
            # a stacked state has no checkpoint layout: a single-tenant
            # restore into the stack (or the reverse) would tear
            log.warning("sketch checkpointing has no stacked-tenant form; "
                        "disabling it while SKETCH_TENANTS is set")
        elif checkpoint_dir:
            from netobserv_tpu_torch.sketch.checkpoint import (
                SketchCheckpointer,
            )
            self._ckpt = SketchCheckpointer(checkpoint_dir)
            self._maybe_restore()
        #: the mid-window refresh's staging state, made at its first use
        self._staging = None
        self._agent_id = agent_id or socket.gethostname()
        #: this process incarnation's delivery epoch (delta frames)
        self._agent_epoch = time.time_ns()
        self._delta_sink = delta_sink
        # the frames' telemetry block: windows published and a records/s
        # EWMA over publishes
        self._windows_published = 0
        self._host_rate_ewma = 0.0
        self._last_publish_mono: Optional[float] = None
        if delta_sink is not None and decay_factor is not None:
            # decayed tables are cumulative (a sliding window): a frame per
            # window would count every earlier window's mass again at the
            # aggregator, whose merge takes per-window deltas
            log.warning("federation delta export requires "
                        "SKETCH_WINDOW_MODE=reset (decay frames are "
                        "cumulative); disabling delta export")
            self._drop_delta_sink()
        if self._delta_sink is not None and not self._with_tables:
            # width-sharded CM planes are independent local-width sketches:
            # there is no whole-width snapshot to frame
            log.warning("federation delta export needs a data-axis-only "
                        "mesh; disabling it on this %dx%d exporter",
                        self.mesh.data, self.mesh.sketch)
            self._drop_delta_sink()
        self.query = SnapshotPublisher(history=query_history)
        #: tenant mode's query plane: one publisher a tenant, which the
        #: data routes pick by ?tenant= (`self.query` stays unused)
        self._tenant_query = ([SnapshotPublisher(history=query_history)
                               for _ in range(tenants)] if tenants else None)
        self._alerts = alerts
        if archive is not None and not self._with_tables:
            # no whole-width table snapshot to archive (the delta rule)
            log.warning("sketch archive needs a data-axis-only mesh; "
                        "disabling it on this exporter")
            archive = None
        if tenants and archive is not None and \
                not hasattr(archive, "write_tenant_window"):
            # one store would merge tenants at range-query time
            log.warning("tenant mode needs a per-tenant archive set "
                        "(archive.tenant_archives); disabling the archive "
                        "on this exporter")
            archive = None
        #: the archive plane (None: no archive object, one is-None check)
        self._archive = archive
        self.query_routes = QueryRoutes(
            self.query.get, self.query_status, metrics=metrics,
            history_fn=self.query.get_window, windows_fn=self.query.windows,
            alerts=alerts, archive=archive,
            tenant_publishers=self._tenant_query)
        if metrics is not None:
            if self._tenant_query is not None:
                # every tenant publishes at each roll and refresh
                pubs = self._tenant_query
                metrics.query_snapshot_age_seconds.set_function(
                    lambda: min(p.age_s() for p in pubs))
            else:
                metrics.query_snapshot_age_seconds.set_function(
                    self.query.age_s)
            metrics.sketch_resident_hbm_bytes.set(
                tiered.array_bytes(self.state))
        self._query_refresh_s = float(query_refresh_s)
        if self._query_refresh_s and self._multiprocess:
            # each rank's timer would dispatch the roll's collectives on its
            # own schedule: divergent collective order is a hang
            log.warning("SKETCH_QUERY_REFRESH disabled on multi-process "
                        "meshes (refresh rolls would run collectives on "
                        "unsynchronized timers)")
            self._query_refresh_s = 0.0
        self._next_refresh = (time.monotonic() + self._query_refresh_s
                              if self._query_refresh_s else None)
        # the dense entry's buffers (`fold_dense`, one device only)
        words = batch_size * sk.DENSE_WORDS if self.mesh is None else 0
        self._host = torch.zeros(words, dtype=torch.int32, pin_memory=cuda)
        self._host_u32 = self._host.numpy().view(np.uint32)
        self._dev = torch.zeros(words, dtype=torch.int32, device=self.device)
        self._copied = torch.cuda.Event() if cuda else None
        self.ring = None
        self.pending: Optional[staging.PendingEventBuffer] = None
        self._packer = packer
        self._capture = capture and cuda
        self._pool = torch.cuda.graph_pool_handle() if self._capture else None
        self._fold_dense = (CapturedFold("fold_dense", self._ingest_dense,
                                         self._pool)
                            if self._capture and self.mesh is None
                            else None)
        #: the record path's entry on one device (`export_batch`): records
        #: waiting for a whole batch, and their captured fold
        self._pending_records: list = []
        self._fold_rec = (CapturedFold("fold_records", self._ingest_records,
                                       self._pool)
                          if self._capture and self.mesh is None
                          and not tenants else None)
        for fold in (self._fold_dense, self._fold_rec):
            if fold is not None:
                fold.timeline = self._timeline
        #: the record path's ingest on a mesh, made at its first use
        self._mesh_rec_ingest = None
        #: the entries on the dense buffers prepared so far
        self._entries_ready: set = set()
        self._prev_index: Optional[dict] = None
        #: a sampled batch trace riding an eviction, parked for the next
        #: fold, which finishes it
        self._pending_trace = None
        #: the fused drain's pack surface, made by `resident_pack_surface`
        self._pack_surface: Optional[staging.ResidentPackSurface] = None
        # folds, rolls and every CUDA call of the window plane hold _lock
        # (with a timeline it marks the phases "entry" and "caller");
        # _roll_mutex serializes the roll itself; _publish_lock the
        # publishes of the queued reports
        self._lock = (tracing.PhaseLock(self._timeline)
                      if self._timeline is not None else threading.Lock())
        if archive is not None:
            archive.share_device_lock(self._lock)
        self._roll_mutex = threading.Lock()
        self._publish_lock = threading.Lock()
        self._closed = threading.Event()
        self._reports: collections.deque = collections.deque()
        self._deadline = self._next_deadline()
        self.folds = 0
        self.records = 0
        self.rolls = 0
        self.ingest_errors = 0
        self.reports_published = 0
        self.reports_shed = 0
        #: supervision hook of the window thread (`register_supervised`)
        self.heartbeat = lambda: None
        self._timer: Optional[threading.Thread] = None
        # the overlapped fold thread: a bounded handoff, the rows put and
        # not yet taken, and its supervision hook
        self._handoff: Optional[queue.Queue] = None
        self._inflight_rows = 0
        self._inflight_lock = threading.Lock()
        self.fold_heartbeat = lambda: None
        self._fold_thread: Optional[threading.Thread] = None
        if tenants and feed != "dense":
            log.info("tenant mode ships the dense stacked feed; "
                     "SKETCH_FEED=%r does not apply", feed)
        if overlap_depth > 0:
            self._handoff = queue.Queue(maxsize=overlap_depth)
        if tenants or overlap_depth > 0 or self._multiprocess:
            # the ring's captures run here, before the window thread or
            # the fold thread exists (ROADMAP C4); on a multi-process mesh
            # every rank warms its whole ladder before it takes a row
            with self._lock, self._on_device():
                self._ensure_ring()
        if overlap_depth > 0:
            self._start_fold_worker()
        if window_s is not None:
            self.start_window_timer()

    @classmethod
    def from_config(cls, cfg, metrics=None, sink=None
                    ) -> "TorchSketchExporter":
        """The exporter an `AgentConfig` describes (module docstring,
        `tpu_sketch.py:1004-1078`); `sink` overrides SKETCH_REPORT_SINK's.
        A setting that asks for what the port lacks raises `ValueError`
        naming its ROADMAP item."""
        from netobserv_tpu_torch.alerts.engine import maybe_engine
        from netobserv_tpu_torch.archive import maybe_archive, tenant_archives
        if cfg.sketch_devices not in ("", "cpu"):
            raise ValueError(
                f"SKETCH_DEVICES={cfg.sketch_devices!r} (want empty, the "
                "card, or cpu)")
        cpu = cfg.sketch_devices == "cpu"
        device = pick_device("cpu" if cpu else None)
        spec = (pmesh.MeshSpec.parse(cfg.sketch_mesh_shape, 1)
                if cfg.sketch_mesh_shape else None)
        # a CPU mesh repeats the CPU, each rank's share of it across
        # processes (the group joined first); on CUDA the mesh takes the
        # visible cards, and a shape that needs more raises in the
        # constructor
        devices = None
        if cpu and spec is not None:
            distributed.maybe_initialize_distributed(devices=[device])
            devices = pmesh.local_share(device, spec)
        sketch_cfg = sk.SketchConfig.from_agent_config(cfg)
        if sink is None:
            sink = make_report_sink(cfg)
        delta_sink = None
        if cfg.federation_target:
            from netobserv_tpu_torch.exporter.federation import (
                FederationDeltaSink,
            )
            host, _, port = cfg.federation_target.rpartition(":")
            delta_sink = FederationDeltaSink(host or "127.0.0.1", int(port),
                                             metrics=metrics)
        if spec is not None and spec.sketch > 1:
            # no whole-width table snapshot to archive: decided from the
            # shape alone, so no store is opened (it would heal and rewrite
            # its manifest for a feature that is off)
            archive = None
            if cfg.archive_dir:
                log.warning("ARCHIVE_DIR set on a width-sharded mesh "
                            "(SKETCH_MESH_SHAPE=%s): no whole-width "
                            "table snapshot exists — archive disabled",
                            cfg.sketch_mesh_shape)
        elif cfg.sketch_tenants > 0:
            # one store a tenant under ARCHIVE_DIR/tenant-<t>: ranges stay
            # tenant-scoped
            archive = tenant_archives(cfg, sketch_cfg, cfg.sketch_tenants,
                                      metrics=metrics, device=device)
        else:
            archive = maybe_archive(cfg, sketch_cfg, metrics=metrics,
                                    device=device)
        return cls(
            sketch_cfg, batch_size=cfg.sketch_batch_size,
            device=device if cpu else None, devices=devices,
            mesh_shape=cfg.sketch_mesh_shape,
            window_s=cfg.sketch_window, sink=sink, metrics=metrics,
            decay_factor=(cfg.sketch_decay_factor
                          if cfg.sketch_window_mode == "decay" else None),
            feed=cfg.sketch_feed, pack_threads=cfg.sketch_pack_threads,
            superbatch=cfg.parsed_superbatch_ladder(),
            resident_slots=cfg.sketch_resident_slots,
            scan_fanout_threshold=cfg.sketch_scan_fanout,
            ddos_z_threshold=cfg.sketch_ddos_z,
            synflood_min=cfg.sketch_synflood_min,
            synflood_ratio=cfg.sketch_synflood_ratio,
            drop_z_threshold=cfg.sketch_drop_z,
            asym_min_bytes=cfg.sketch_asym_min_bytes,
            asym_ratio=cfg.sketch_asym_ratio,
            churn_ascent=cfg.sketch_churn_ascent,
            churn_min_bytes=cfg.sketch_churn_min_bytes,
            query_refresh_s=cfg.sketch_query_refresh,
            query_history=cfg.sketch_query_history,
            alerts=maybe_engine(cfg, metrics),
            agent_id=cfg.federation_agent_id, delta_sink=delta_sink,
            checkpoint_dir=cfg.sketch_checkpoint_dir,
            checkpoint_every=cfg.sketch_checkpoint_every,
            archive=archive,
            shed_watermark=cfg.sketch_shed_watermark,
            shed_max=cfg.sketch_shed_max,
            shed_slot_budget_s=cfg.sketch_shed_slot_budget,
            overlap_depth=cfg.sketch_overlap, tenants=cfg.sketch_tenants)

    @staticmethod
    def _local_devices(device, devices) -> list:
        """This process's devices: `devices` if given, else every visible
        CUDA device when `device` is None, else `device` alone."""
        if devices is not None:
            return list(devices)
        if device is None:
            return pmesh.visible_devices()
        return [device]

    @classmethod
    def _make_mesh(cls, device, devices, mesh_shape: str):
        """The exporter's mesh (reference `tpu_sketch.py:521-583`), or
        None: over `_local_devices`, a mesh when `mesh_shape` is set, when
        there is more than one device or when the process group has more
        than one process (with no shape, every device of every rank on the
        data axis). A shape that needs more devices than there are
        raises."""
        devs = cls._local_devices(device, devices)
        if not mesh_shape and len(devs) <= 1 and \
                distributed.process_count() == 1:
            return None
        spec = pmesh.MeshSpec.parse(mesh_shape, 0) if mesh_shape else None
        return pmesh.make_mesh(spec, devs)

    def _mesh_degrade(self, cfg, tenants: int, batch_size: int):
        """What a mesh has no sharded form of (reference `:529-552`,
        `:580-581`): tenants run as one, with a warning; tiered planes
        run wide, with a warning once a process and the
        `tiered_degraded` condition; the batch rounds up to a multiple of
        the data axis."""
        global _TIERED_DEGRADE_WARNED
        if tenants:
            log.warning("SKETCH_TENANTS has no mesh-sharded form; running "
                        "the mesh exporter single-tenant")
            tenants = 0
        if cfg.tiered is not None:
            if not _TIERED_DEGRADE_WARNED:
                _TIERED_DEGRADE_WARNED = True
                log.warning("SKETCH_TIERED has no sharded form; running the "
                            "mesh exporter with wide-resident tables")
            self._tiered_degraded = True
            cfg = cfg._replace(tiered=None)
        n = self.mesh.data
        return cfg, tenants, -(-batch_size // n) * n

    def _maybe_restore(self) -> None:
        """Restore the latest checkpoint into the state in place; a tiered
        state restores the wide form, then encodes it. A rejected or
        incompatible checkpoint logs and leaves a fresh window
        (`tpu_sketch.py:807-832`)."""
        step = self._ckpt.latest_step()
        if step is None:
            return
        try:
            with self._on_device():
                if self.cfg.tiered is not None:
                    wide = self._ckpt.restore(self.cfg._replace(tiered=None),
                                              device=self.device)
                    sk.copy_state_(self.state, tiered.encode_state(
                        wide, self.cfg.tiered))
                else:
                    self._ckpt.restore(self.state)
            log.info("restored sketch state from checkpoint step %s", step)
        except Exception as exc:
            log.warning(
                "sketch checkpoint at step %s is incompatible with this "
                "version (%s); starting from a fresh window", step, exc)
            sk.copy_state_(self.state, (
                pmerge.init_dist_state(self.cfg, self.mesh)
                if self.mesh is not None
                else sk.init_state(self.cfg, self.device)))

    @property
    def captures(self) -> list[CapturedFold]:
        """The captured folds made so far: the dense entry's, the record
        path's, and the ring's once it is made."""
        ring = self.ring.captures if self.ring is not None else []
        return [c for c in (self._fold_dense, self._fold_rec, *ring)
                if c is not None]

    def _next_deadline(self) -> Optional[float]:
        return (time.monotonic() + self.window_s
                if self.window_s is not None else None)

    def _due(self) -> bool:
        return self._deadline is not None and time.monotonic() >= \
            self._deadline

    def _fold_due(self) -> bool:
        """Whether a fold path closes the window: never on a multi-process
        mesh, whose roll is a collective (module docstring)."""
        return not self._multiprocess and self._due()

    def _check_open(self) -> None:
        if self._closed.is_set():
            raise RuntimeError("exporter is closed")

    def _on_device(self):
        """The exporter's device as the calling thread's current CUDA
        device (a new thread's is device 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _ensure_ring(self) -> None:
        """Make the feed's ring and pending buffer at first use (under the
        lock), or in tenant mode the tenant stack; on CUDA build and load
        the kernels first, and capture the ring's graphs. Any failure here
        raises."""
        if self.ring is not None:
            return
        if self.device.type == "cuda":
            _build.load_all()
        kw = dict(device=self.device, enable_fanout=self.cfg.enable_fanout,
                  enable_asym=self.cfg.enable_asym, capture=self._capture,
                  graph_pool=self._pool, pack_threads=self.pack_threads,
                  metrics=self._metrics)
        if self.mesh is not None:
            ring = self._make_mesh_ring(kw)
        elif self.tenants:
            ring = tenancy.TenantStack(
                self.tenants, self.cfg, self.batch_size,
                metrics=self._metrics, reset_sketches=self.reset_sketches,
                decay_factor=self.decay_factor, device=self.device,
                capture=self._capture, graph_pool=self._pool)
        elif self.feed == "resident":
            ring = staging.ShardedResidentStagingRing(
                self.batch_size, 1, slot_cap=self.resident_slots,
                packer=self._packer,
                lanes=staging.pick_lanes(self.batch_size, self._lane_threads),
                ladder=self.superbatch, lazy_ladder=True, **kw)
        else:
            ring = staging.DenseStagingRing(
                self.batch_size,
                spill_cap=(staging.default_spill_cap(self.batch_size)
                           if self.feed == "compact" else None), **kw)
        self.pending = staging.PendingEventBuffer(
            self.batch_size, getattr(ring, "superbatch_max", 1),
            metrics=self._metrics)
        if self._overload is not None:
            ring.slot_wait_budget_s = self._shed_slot_budget_s
        self.ring = ring
        if isinstance(ring, (staging.DenseStagingRing, tenancy.TenantStack)):
            ring.warm(self.state)
        else:
            self.warm_superbatch_ladder()
        if self._timeline is not None:
            ring.timeline = self._timeline
            for fold in ring.captures:
                fold.timeline = self._timeline

    def _make_mesh_ring(self, kw: dict):
        """The mesh's ring (reference `tpu_sketch.py:607-647`): the
        resident feed over the data shards, each shard's rows in
        `pick_lanes(rows, lane_threads // data)` lanes; else the dense
        feed, SKETCH_FEED=compact included, which has no sharded form."""
        mesh = self.mesh
        del kw["device"]
        if self.feed == "resident":
            bps = self.batch_size // mesh.data
            return staging.ShardedResidentStagingRing(
                self.batch_size, mesh.data, slot_cap=self.resident_slots,
                packer=self._packer,
                lanes=staging.pick_lanes(
                    bps, max(1, self._lane_threads // mesh.data)),
                ladder=self.superbatch, lazy_ladder=True, mesh=mesh, **kw)
        if self.feed == "compact":
            log.info("SKETCH_FEED=compact has no sharded form (spill "
                     "compaction breaks the row split); using dense")
        return staging.DenseStagingRing(self.batch_size, mesh=mesh, **kw)

    def warm_superbatch_ladder(self) -> None:
        """Capture every ladder entry of the resident ring against the
        state (on CUDA, with `capture`), synchronously, and make each
        selectable as its capture lands; a capture that fails raises.
        Without captures every entry is selectable at once. The dense and
        compact rings have no ladder."""
        ring = self.ring
        if not isinstance(ring, staging.ShardedResidentStagingRing):
            return
        for k in ring.ladder:
            ring.warm(self.state, k)

    # ------------------------------------------------------------ folds

    def export_evicted(self, evicted: EvictedFlows) -> None:
        """Take one eviction: with the overlap, put it into the handoff
        (blocking while it is full) and return; else admit and fold it
        here (`_export_evicted_now`, reference `tpu_sketch.py:1218-1233`).
        A fold that fails is contained (module docstring)."""
        self._check_open()
        if self._handoff is not None:
            with self._inflight_lock:
                self._inflight_rows += len(evicted)
            self._handoff.put(evicted)
            return
        self._export_evicted_now(evicted)

    def export_batch(self, records: list) -> None:
        """Take the record path's records (`model/record.Record`) without
        admission, and close the window if its deadline passed
        (`tpu_sketch.py:1208-1216`). They fold as the reference folds them
        in every mode: queued apart from the evictions, in record order,
        `batch_size` records a fold (`_fold_record_chunk`), a partial
        batch at the next drain."""
        self._check_open()
        with self._lock:
            self._pending_records.extend(records)
            while len(self._pending_records) >= self.batch_size:
                chunk = self._pending_records[:self.batch_size]
                del self._pending_records[:self.batch_size]
                self._fold_record_chunk(chunk)
            if self._fold_due():
                self._close_window_locked()

    def _fold_record_chunk(self, records: list) -> None:
        """Under the lock: fold at most `batch_size` records, contained,
        with the columns of the reference's `FlowBatch.from_records`
        (`_records_to_arrays`; reference `_fold`, `tpu_sketch.py:1636-1689`):
        in tenant mode their dense rows routed into the stack
        (`TenantStack.fold_rows`), on a mesh the batch padded to
        `batch_size` and split over the data shards (`shard_batch`) into
        the mesh's plain ingest, else through the dense entry's buffers and
        the record path's ingest (`_ingest_records`)."""
        arrays = _records_to_arrays(records)
        if self.tenants:
            self._fold_record_rows(sk.arrays_to_dense(arrays).reshape(
                -1, sk.DENSE_WORDS))
        elif self.mesh is not None:
            self._fold_record_shards(arrays)
        else:
            self._ensure_entry("records", self._fold_rec)
            self._fold_one(sk.arrays_to_dense(arrays), records=True)

    def _fold_record_rows(self, rows: np.ndarray) -> None:
        """Tenant mode: route a record chunk's dense rows into the stack,
        contained; a wedged slot wait adopts the stack's state (reference
        `tpu_sketch.py:1652-1677`)."""
        t0 = time.perf_counter()
        folds = self.ring.folds
        trace = tracing.start_trace("fold")
        try:
            faultinject.fire("sketch.ingest")
            self.state = self.ring.fold_rows(self.state, rows, trace=trace)
        except staging.StagingWedged as exc:
            if exc.state is not None:
                self.state = exc.state
            log.error("staging slot-wait budget exceeded (up to %d rows "
                      "dropped): %s", len(rows), exc)
            self.ingest_errors += 1
            if self._metrics is not None:
                self._metrics.sketch_ingest_errors_total.inc()
                self._metrics.count_error("tpu-sketch-ingest")
            return
        except Exception as exc:
            self._count_ingest_error(len(rows), exc)
            return
        finally:
            self.folds += self.ring.folds - folds
            trace.finish()
        self._count_fold(len(rows), t0)

    def _fold_record_shards(self, arrays: dict) -> None:
        """On a mesh: the record chunk padded to `batch_size` with invalid
        rows, as `FlowBatch.from_records` pads it, and folded, contained,
        through the mesh's plain ingest (reference `tpu_sketch.py:1660-1666`)."""
        t0 = time.perf_counter()
        n = len(arrays["valid"])
        pad = self.batch_size - n
        arrays = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                                 v.dtype)])
                  for k, v in arrays.items()}
        trace = tracing.start_trace("fold")
        try:
            if self._mesh_rec_ingest is None:
                self._ensure_entry("records", None)
                self._mesh_rec_ingest = pmerge.make_sharded_ingest_fn(
                    self.mesh, self.cfg)
            faultinject.fire("sketch.ingest")
            with trace.stage("ingest_dispatch"):
                self.state = self._mesh_rec_ingest(
                    self.state, pmerge.shard_batch(self.mesh, arrays))
                self.folds += 1
        except Exception as exc:
            self._count_ingest_error(n, exc)
            return
        finally:
            trace.finish()
        self._count_fold(n, t0)

    def _queued_overlap_rows(self) -> int:
        """Rows in the overlap handoff, not yet taken by the fold thread (0
        without one): part of the pending depth the controller sees. The
        eviction in hand was taken off before its own update, so it never
        counts twice (`tpu_sketch.py:1235-1243`)."""
        if self._handoff is None:
            return 0
        with self._inflight_lock:
            return self._inflight_rows

    def _export_evicted_now(self, evicted: EvictedFlows) -> None:
        """Under the lock: admit the eviction through the controller, if
        any, take it into the pending buffer, which folds its batch-aligned
        rows and keeps the sub-batch tail, and close the window if its
        deadline passed (`tpu_sketch.py:1245-1298`). A sampled batch
        trace riding the eviction waits for the next fold."""
        trace = evicted.trace
        with self._lock:
            self._ensure_ring()
            packed = evicted.packed
            if packed is not None:
                # a fused drain's regions: ship them in place of the rows,
                # or, with a stale epoch, fold the rows below
                evicted.packed = None
                if self._fold_packed_locked(packed, trace, len(evicted)):
                    if trace is not None:
                        trace.finish()
                    if self._fold_due():
                        self._close_window_locked()
                    return
            ctl = self._overload
            if ctl is not None:
                # busy: fold seconds per wall second since the last arrival
                now = time.perf_counter()
                last, self._busy_last_t = self._busy_last_t, now
                if last is not None:
                    inst = min(1.0, self._busy_fold_s
                               / max(now - last, 1e-6))
                    self._busy_ewma = 0.5 * self._busy_ewma + 0.5 * inst
                self._busy_fold_s = 0.0
                ctl.update(self.pending.n + len(evicted)
                           + self._queued_overlap_rows(),
                           self.ring.slot_wait_p95(), busy=self._busy_ewma)
                evicted = ctl.admit(evicted)
            if trace is not None:
                if self._pending_trace is None:
                    self._pending_trace = trace  # the next fold finishes it
                else:
                    trace.finish()  # two sampled evictions in one fold
            self.pending.append(evicted, self._fold_events)
            if self._fold_due():
                self._close_window_locked()

    def resident_pack_surface(self) -> Optional[staging.ResidentPackSurface]:
        """The pack surface of the fused drain (reference
        `tpu_sketch.py:1128-1145`), made once with the ring; None when
        the ring is not the lanes ring (`ShardedResidentStagingRing`),
        with overload control on (the controller thins rows after the
        drain, and a packed arena cannot be thinned) or with
        `packer="python"` (the fused pack keys on the native
        dictionaries)."""
        if self._pack_surface is not None:
            return self._pack_surface
        if self._overload is not None or self._packer != "native":
            return None
        with self._lock, self._on_device():
            self._ensure_ring()
            if not isinstance(self.ring, staging.ShardedResidentStagingRing):
                return None
            self._pack_surface = staging.ResidentPackSurface(self.ring)
        return self._pack_surface

    def _fold_packed_locked(self, packed, trace, n: int) -> bool:
        """Under the lock: ship a fused drain's arena of n rows (reference
        `tpu_sketch.py:1147-1198`). True: shipped, or its fold failed and
        was contained (the rows are never folded twice); False: discarded
        (no surface, overload control on, or a stale epoch), and the
        caller folds the eviction's rows. The arena is freed on every
        exit."""
        surface = self._pack_surface
        if surface is None or self._overload is not None:
            packed.free()
            return False
        with surface.lock:
            if packed.epoch != surface.epoch:
                # an invalidation already reset the dictionaries this
                # arena's slots refer to
                packed.free()
                return False
            surface.outstanding -= 1
        t0 = time.perf_counter()
        chunks = self.ring.chunks
        owned = trace is None
        if owned:
            trace = tracing.start_trace("fold")
        try:
            with trace.stage("fold"):
                faultinject.fire("sketch.ingest")
                self.ring.fold_packed(self.state, packed, trace=trace)
        except staging.StagingWedged as exc:
            # the segments before the wedge folded into exc.state; the
            # rest of the arena's slot definitions are lost with it
            if exc.state is not None:
                self.state = exc.state
            surface.invalidate()
            log.error("staging slot-wait budget exceeded mid packed fold "
                      "(%d segments): %s", packed.segs, exc)
            self.ingest_errors += 1
            if self._metrics is not None:
                self._metrics.sketch_ingest_errors_total.inc()
                self._metrics.count_error("tpu-sketch-ingest")
            return True
        except Exception as exc:
            self._count_ingest_error(n, exc)  # rolls the surface's epoch
            return True
        finally:
            packed.free()
            self.folds += self.ring.chunks - chunks
            if owned:
                trace.finish()
        self._count_fold(n, t0)
        return True

    def _start_fold_worker(self) -> None:
        """(Re)start the overlap fold thread; a supervisor uses this as the
        "sketch-fold" stage's restart callable."""
        self._fold_thread = threading.Thread(
            target=self._fold_loop, name="sketch-fold", daemon=True)
        self._fold_thread.start()

    def _fold_loop(self) -> None:
        """Take each handoff item and fold it on the exporter's device
        (`tpu_sketch.py:1308-1327`)."""
        with self._on_device():
            while not self._closed.is_set():
                self.fold_heartbeat()
                try:
                    evicted = self._handoff.get(timeout=0.2)
                except queue.Empty:
                    continue
                self._fold_handed_off(evicted)

    def _fold_handed_off(self, evicted: EvictedFlows) -> None:
        """Admit and fold one handoff item; a batch whose fold path raises
        is dropped and counted, and the caller lives on."""
        try:
            with self._inflight_lock:
                self._inflight_rows -= len(evicted)
            self._export_evicted_now(evicted)
        except Exception as exc:
            log.error("overlap fold failed (batch of %d dropped): %s",
                      len(evicted), exc)
            if self._metrics is not None:
                self._metrics.count_error("tpu-sketch")
        finally:
            self._handoff.task_done()

    def _drain_handoff(self, timeout_s: float = 30.0) -> None:
        """Wait until every handed-off eviction is folded, at most
        `timeout_s`; a dead fold thread returns at once (`close` folds what
        it left) (`tpu_sketch.py:1329-1341`)."""
        if self._handoff is None:
            return
        deadline = time.monotonic() + timeout_s
        while self._handoff.unfinished_tasks and \
                time.monotonic() < deadline:
            if (self._fold_thread is None
                    or not self._fold_thread.is_alive()):
                return
            time.sleep(0.005)

    def _fold_leftovers(self) -> None:
        """Fold what the handoff still holds on this thread (`close`, after
        the fold thread's join)."""
        with self._on_device():
            while True:
                try:
                    evicted = self._handoff.get_nowait()
                except queue.Empty:
                    return
                self._fold_handed_off(evicted)

    def fold_events(self, events: np.ndarray, extra=None, dns=None,
                    drops=None, xlat=None, quic=None) -> None:
        """Fold raw flow events (`model/binfmt.FLOW_EVENT_DTYPE` rows, any
        count) and their optional feature lanes (`EXTRA_REC_DTYPE`,
        `DNS_REC_DTYPE`, `DROPS_REC_DTYPE`, `XLAT_REC_DTYPE`,
        `QUIC_REC_DTYPE`, row for row) as one eviction
        (`export_evicted`)."""
        self.export_evicted(EvictedFlows(
            events, dns=dns, drops=drops, extra=extra, xlat=xlat, quic=quic))

    def _fold_events(self, events: np.ndarray, feats: dict) -> None:
        """The pending buffer's fold: the ring's, contained."""
        t0 = time.perf_counter()
        n = len(events)
        chunks = self.ring.chunks
        # the batch trace of an eviction this fold takes (the gap from its
        # evict span to this fold span is the export queue's wait), else a
        # fold trace of its own
        trace, self._pending_trace = self._pending_trace, None
        if trace is None:
            trace = tracing.start_trace("fold")
        try:
            with trace.stage("fold"):
                faultinject.fire("sketch.ingest")
                if self._pack_surface is not None:
                    # ship order must be dictionary order: this fold packs
                    # now, so an arena still outstanding must not ship
                    # after it (a no-op with none outstanding)
                    self._pack_surface.invalidate_for_raw_fold()
                self.ring.fold(self.state, events, trace=trace, **feats)
        except staging.StagingWedged as exc:
            # the slot-wait budget tripped at a chunk boundary: the rows not
            # yet packed drop, with no slot committed for them, so no epoch
            # roll; the chunks before it dispatched into exc.state, the
            # state itself (updated in place)
            if exc.state is not None:
                self.state = exc.state
            log.error("staging slot-wait budget exceeded (up to %d rows "
                      "dropped): %s", n, exc)
            self.ingest_errors += 1
            if self._metrics is not None:
                self._metrics.sketch_ingest_errors_total.inc()
                self._metrics.count_error("tpu-sketch-ingest")
            return
        except Exception as exc:
            self._count_ingest_error(n, exc)
            return
        finally:
            self.folds += self.ring.chunks - chunks
            trace.finish()
            if self._overload is not None:
                self._busy_fold_s += time.perf_counter() - t0
        self._count_fold(n, t0)

    def _count_fold(self, n: int, t0: float) -> None:
        self.records += n
        m = self._metrics
        if m is not None:
            m.sketch_batches_total.inc()
            if self._tier_form == "interior":
                m.sketch_tiered_interior_folds_total.inc()
            m.sketch_records_total.inc(n)
            m.sketch_ingest_seconds.observe(time.perf_counter() - t0)

    def _count_ingest_error(self, n: int, exc: Exception) -> None:
        """Count a contained fold of n rows, and roll the epoch of every
        dictionary of a resident ring, and of the pack surface: the
        dropped chunk may have committed slots whose new-key rows never
        reached the device key tables (`tpu_sketch.py:1399-1425`)."""
        log.error("sketch ingest failed (batch of %d dropped): %s", n, exc)
        self.ingest_errors += 1
        m = self._metrics
        if m is not None:
            m.sketch_ingest_errors_total.inc()
            m.count_error("tpu-sketch-ingest")
        kdicts = getattr(self.ring, "kdicts", None)
        if kdicts is None:
            kd = getattr(self.ring, "kdict", None)
            kdicts = [kd] if kd is not None else []
        for kd in kdicts:
            kd.reset()
        if kdicts:
            self.ring.dict_resets += len(kdicts)
            if m is not None:
                m.sketch_resident_dict_epochs_total.inc(len(kdicts))
        if self._pack_surface is not None:
            # that reset is an epoch roll: outstanding fused arenas were
            # packed against the dictionaries before it
            self._pack_surface.note_external_reset()

    def fold_dense(self, flat: np.ndarray) -> None:
        """Fold a flat uint32 dense feed (rows of 20 words, any row count;
        it folds in batches of `batch_size`), each batch contained; close
        the window if its deadline passed. A feed that is not whole rows
        raises, and so does tenant mode, which takes evictions and records
        only."""
        self._check_open()
        if self.tenants or self.mesh is not None:
            raise ValueError("tenant mode and a mesh fold evictions and "
                             "records (export_evicted, export_batch), not "
                             "a dense feed")
        flat = np.asarray(flat).reshape(-1).view(np.uint32)
        if flat.size % sk.DENSE_WORDS:
            raise ValueError(f"dense feed of {flat.size} words is not whole "
                             f"{sk.DENSE_WORDS}-word rows")
        step = self.batch_size * sk.DENSE_WORDS
        with self._lock:
            self._ensure_entry("dense", self._fold_dense)
            for lo in range(0, flat.size, step):
                self._fold_one(flat[lo:lo + step])
            if self._due():
                self._close_window_locked()

    def _ensure_entry(self, name: str, fold: Optional[CapturedFold]) -> None:
        """The first use of an entry on the dense buffers (`fold_dense`'s or
        the record path's), under the lock: on CUDA build and load the
        kernels and capture its graph, before any fold; any failure here
        raises, where a fold's is contained."""
        if name in self._entries_ready:
            return
        if self.device.type == "cuda":
            _build.load_all()
        if fold is not None:
            fold.prepare(self.state, self._dev)
        self._entries_ready.add(name)

    def _fold_one(self, chunk: np.ndarray, records: bool = False) -> None:
        """Stage and fold one dense batch, contained (reference `_fold`,
        `tpu_sketch.py:1636-1689`): through the dense entry, or with
        `records` through the record path's."""
        t0 = time.perf_counter()
        n = chunk.size // sk.DENSE_WORDS
        trace = tracing.start_trace("fold")
        try:
            with tracing.stage(trace, "pack", self._timeline):
                if self._copied is not None:
                    self._copied.synchronize()  # the last copy is done
                self._host_u32[:chunk.size] = chunk
                self._host_u32[chunk.size:] = 0  # zero rows are invalid
            try:
                faultinject.fire("sketch.ingest")
                tl = self._timeline
                with tracing.stage(trace, "ingest_dispatch", tl):
                    with tracing.timed(tl, "ingest_dispatch"):
                        self._dev.copy_(self._host, non_blocking=True)
                    if self._copied is not None:
                        self._copied.record(
                            torch.cuda.current_stream(self.device))
                    fold, eager = ((self._fold_rec, self._ingest_records)
                                   if records else
                                   (self._fold_dense, self._ingest_dense))
                    if fold is not None:
                        fold(self.state, self._dev)
                    else:
                        with tracing.timed(tl, "ingest_dispatch"):
                            eager(self.state, self._dev)
                    self.folds += 1
            except Exception as exc:
                self._count_ingest_error(n, exc)
                return
        finally:
            trace.finish()
        self._count_fold(n, t0)

    def _ingest_dense(self, state, dev: torch.Tensor):
        return sk.ingest(state, sk.dense_to_arrays(dev),
                         enable_fanout=self.cfg.enable_fanout,
                         enable_asym=self.cfg.enable_asym)

    def _ingest_records(self, state, dev: torch.Tensor):
        """The dense rows of records, folded with the columns the
        reference's `FlowBatch` carries: it has no QUIC markers and no
        drop cause (`model/columnar.py:24-44`), so neither reaches the
        ingest (`sketch/state.py:208-224`)."""
        arrays = sk.dense_to_arrays(dev)
        del arrays["markers"], arrays["drop_cause"]
        return sk.ingest(state, arrays, enable_fanout=self.cfg.enable_fanout,
                         enable_asym=self.cfg.enable_asym)

    def state_tables(self):
        """The current (pre-roll) mergeable tables, on the host; in tenant
        mode a list of them, one a tenant; on a data-axis mesh the merged
        tables of every shard (`parallel/merge.merge_states`; a
        width-sharded mesh has none and raises)."""
        with self._lock, self._on_device():
            # on a multi-process mesh a collective: every rank calls it
            if self.tenants:
                return [sk.state_tables(tenancy.tenant_view(self.state, t))
                        for t in range(self.tenants)]
            if self.mesh is not None:
                if not self._with_tables:
                    raise ValueError("a width-sharded mesh has no "
                                     "whole-width tables")
                return sk.state_tables(pmerge.merge_states(
                    self.state, mesh=self.mesh))
            return sk.state_tables(self.state)

    def counter_table_bytes(self) -> dict[str, int]:
        """Resident bytes of each tier-covered table (CM planes, HLL
        banks), read from the state's tensors; on a mesh, summed over the
        shards."""
        if self.mesh is None:
            return tiered.counter_table_bytes(self.state)
        out: dict[str, int] = {}
        for state in self.state.flat():
            for k, v in tiered.counter_table_bytes(state).items():
                out[k] = out.get(k, 0) + v
        return out

    # ---------------------------------------------------- window plane

    def _drain_pending(self) -> None:
        """Fold the pending buffer's rows, a partial batch included, and
        in tenant mode ship the partial tenant buffers as one last stacked
        fold (reference `_drain_pending_locked`, `tpu_sketch.py:1427-1444`);
        a wedged fold is `_fold_events`'s, and a wedged flush is logged and
        counted here, its rows left in the tenant buffers."""
        if self._pending_records:
            chunk, self._pending_records = self._pending_records, []
            self._fold_record_chunk(chunk)
        if self.pending is not None:
            self.pending.flush_to(self._fold_events)
        if not self.tenants:
            return
        folds = self.ring.folds
        try:
            self.ring.flush(self.state)
        except staging.StagingWedged as exc:
            if exc.state is not None:
                self.state = exc.state
            log.error("tenant flush hit the slot-wait budget (buffered rows "
                      "dropped): %s", exc)
            self.ingest_errors += 1
            if self._metrics is not None:
                self._metrics.sketch_ingest_errors_total.inc()
                self._metrics.count_error("tpu-sketch-ingest")
        finally:
            self.folds += self.ring.folds - folds

    def _close_window_locked(self) -> _Queued:
        """Drain the pending rows and roll, under one window trace
        (`roll_drain`, `roll_dispatch`); returns the queued report."""
        wtrace = tracing.start_trace("window")
        try:
            with tracing.stage(wtrace, "roll_drain", self._timeline):
                self._drain_pending()
            return self._roll_locked(wtrace)
        except BaseException:
            wtrace.finish()  # a failed roll never reaches the queue
            raise

    def _roll_locked(self, wtrace=tracing.NULL_TRACE) -> _Queued:
        """Close the window under the lock: advance the deadline, copy the
        pre-roll tables to the host (all of `state_tables` with a delta
        sink or an archive, else the wide CM planes), roll the state and
        copy the report to the host, queue both, shed the oldest report
        beyond MAX_QUEUED_REPORTS, and stage every Nth roll's checkpoint.
        The delta frame, rendering, the query snapshot, the sink and the
        archive are `_publish_queued`'s (`tpu_sketch.py:1691-1738`)."""
        self._deadline = self._next_deadline()
        if self._overload is not None:
            # a window with no pressure snaps the shed factor back to 1
            self._overload.window_roll()
        whole = self._delta_sink is not None or self._archive is not None
        with tracing.stage(wtrace, "roll_dispatch", self._timeline):
            with self._roll_mutex:
                if self.tenants:
                    # every tenant's window, rolled here; the publish fans
                    # the per-tenant host copies out
                    report, tables = self._roll_tenants(
                        self.state, None if whole else tenancy.CM_TABLES)
                elif self.mesh is not None:
                    report, tables = self._roll_mesh(self.state, whole)
                else:
                    # the roll's device work, timed; the report's copy to
                    # the host then finds every interval's events done
                    with tracing.timed(self._timeline, "roll_dispatch"):
                        tables = (sk.state_tables(self.state) if whole
                                  else sk.host_cm_planes(self.state))
                        _, report = sk.roll_window(self.state, self.cfg,
                                                   self.reset_sketches,
                                                   self.decay_factor)
                    report = report_numpy(report)
        self.rolls += 1
        entry = _Queued(report, tables, wtrace)
        self._reports.append(entry)
        while len(self._reports) > MAX_QUEUED_REPORTS:
            try:
                shed = self._reports.popleft()
            except IndexError:
                break  # the publisher took it between len() and pop
            shed.trace.finish()
            self.reports_shed += 1
            log.error("window report queue full (sink stalled?); "
                      "dropping the oldest unpublished report")
            if self._metrics is not None:
                self._metrics.sketch_reports_shed_total.inc()
        # the post-roll state, copied to the host here; the publish writes
        # it off the lock (`_write_pending_checkpoint`)
        if self._ckpt is not None and self._ckpt_every:
            self._n_windows_saved += 1
            if self._n_windows_saved % self._ckpt_every == 0:
                superseded = (self._pending_ckpt[1] if self._pending_ckpt
                              else None)
                self._pending_ckpt = (int(report.window), self._ckpt.stage(
                    self._ckpt_state_view(), replace=superseded))
        return entry

    def _roll_mesh(self, state, whole: bool) -> tuple:
        """Roll every shard of the mesh `state` in place through the merge
        (`parallel/merge.make_merge_fn`) and copy the merged report and
        pre-roll tables (all, or with `whole` False the CM planes) to the
        host; a width-sharded mesh has no tables (None)."""
        out = self._mesh_roll(state, cm_only=not whole)
        tables = out[2] if self._with_tables else None
        return report_numpy(out[1]), tables

    def _roll_tenants(self, state, keys) -> tuple[list, list]:
        """Roll every tenant's window of the stacked `state` in place (the
        stack's `roll`) and copy the reports and the pre-roll tables (all,
        or `keys`) to the host: one list each, one entry a tenant."""
        _, report, tables = self.ring.roll(state, table_keys=keys)
        return (tenancy.split_tenants(report, self.tenants),
                tenancy.split_tenants(tables, self.tenants))

    def _ckpt_state_view(self):
        """What a checkpoint saves: the state, or a tiered state's wide
        decode (`tpu_sketch.py:1941-1956`)."""
        if self.cfg.tiered is None:
            return self.state
        return tiered.decode_state(self.state)

    def _publish_queued(self) -> None:
        """Render and deliver every queued report (the window thread, or
        `flush`), then write the staged checkpoint. A render or sink
        failure loses that report, counted and logged
        (`tpu_sketch.py:1740-1759`)."""
        with self._publish_lock:
            while self._reports:
                try:
                    entry = self._reports.popleft()
                except IndexError:
                    break  # _roll_locked's shed loop emptied it first
                try:
                    self._publish_report(entry)
                except Exception as exc:
                    log.error("window report publish failed "
                              "(report lost): %s", exc)
                    if self._metrics is not None:
                        self._metrics.count_error("tpu-sketch")
                finally:
                    entry.trace.finish()
            self._write_pending_checkpoint()

    def _write_pending_checkpoint(self) -> None:
        """Write the last roll's staged checkpoint off the lock; a failure
        is logged and counted, and the window rolls on without it."""
        with self._lock:
            pending, self._pending_ckpt = self._pending_ckpt, None
        if pending is None:
            return
        step, staged = pending
        try:
            self._ckpt.save(step, staged)
        except Exception as exc:
            log.error("sketch checkpoint of step %d failed: %s", step, exc)
            if self._metrics is not None:
                self._metrics.count_error("tpu-sketch")
        finally:
            self._ckpt.release(staged)  # a no-op once written

    def _render_report(self, report, roll: bool = True,
                       tenant: Optional[int] = None) -> dict:
        """Render a host report with this exporter's thresholds, against
        the previous roll's heavy index. A closed window's render (`roll`)
        rotates that index; a mid-window refresh renders a partial window
        and keeps it. A tenant's report diffs against that tenant's own
        index and carries its `Tenant` (`tpu_sketch.py:1761-1792`)."""
        prev = (self._prev_index if tenant is None
                else self._tenant_prev_index.get(tenant))
        obj = report_to_json(report, prev_heavy_index=prev,
                             partial_window=not roll, **self._thresholds)
        if roll:
            idx = heavy_identity_index(report)
            if tenant is None:
                self._prev_index = idx
            else:
                self._tenant_prev_index[tenant] = idx
        if tenant is not None:
            obj["Tenant"] = int(tenant)
        return obj

    def _publish_report(self, entry: _Queued) -> None:
        """Push the delta frame in its own `try`, render, stamp, publish the
        query snapshot in its own `try`, sink, write the archive segment in
        its own `try`, then the window's metrics
        (`tpu_sketch.py:1981-2095`); tenant mode fans out
        (`_publish_report_tenants`)."""
        if self.tenants:
            self._publish_report_tenants(entry)
            return
        wtrace = entry.trace
        self._windows_published += 1  # telemetry: counts this window
        if self._delta_sink is not None:
            # first and contained: a dead aggregator or an encode fault
            # loses the frame, never the report below
            try:
                self._push_delta(entry)
            except Exception as exc:
                log.error("delta frame serialize/push failed "
                          "(frame lost, report still publishes): %s", exc)
                if self._metrics is not None:
                    self._metrics.count_error("federation")
        with wtrace.stage("report_render"):
            obj = self._render_report(entry.report)
        obj["TimestampMs"] = time.time_ns() // 1_000_000
        entry.out = obj
        m = self._metrics
        if m is not None:
            m.sketch_heavy_evictions_total.inc(
                obj["HeavyChurn"]["evictions"])
        # before the sink and contained: a failed publish never loses the
        # report, and a blocked sink never delays the snapshot
        try:
            with wtrace.stage("query_snapshot"):
                faultinject.fire("sketch.query_snapshot")
                self._publish_query_snapshot(obj, entry.tables)
        except Exception as exc:
            log.error("query snapshot publish failed (window report still "
                      "publishes; /query serves the previous snapshot): %s",
                      exc)
            if m is not None:
                m.count_error("tpu-sketch-query")
        with wtrace.stage("report_sink"):
            self.sink(obj)
        self.reports_published += 1
        # last and contained: the report reached the sink and the snapshot
        # swapped in, so a failing or wedged archive disk loses only this
        # window's segment (counted); the tables are the roll's host copies
        if self._archive is not None:
            try:
                with wtrace.stage("archive_write"):
                    faultinject.fire("sketch.archive_write")
                    self._archive.write_window(
                        entry.tables, window=int(obj["Window"]),
                        ts_ms=int(obj["TimestampMs"]))
            except Exception as exc:
                log.error("archive segment write failed (window %s not "
                          "archived; report already published): %s",
                          obj["Window"], exc)
                if m is not None:
                    m.count_error("tpu-sketch-archive")
        if m is not None:
            if self.cfg.tiered is not None:
                try:
                    self._publish_tier_metrics(entry.tables)
                except Exception as exc:  # telemetry never loses a report
                    log.warning("tier metrics publish failed: %s", exc)
            m.sketch_window_reports_total.inc()
            m.sketch_window_records.set(obj["Records"])
            m.sketch_window_drop_bytes.set(obj["DropBytes"])
            for sig, key in SIGNAL_FIELDS.items():
                m.sketch_window_suspects.labels(sig).set(len(obj[key]))

    def _publish_report_tenants(self, entry: _Queued) -> None:
        """Tenant mode's publish (`tpu_sketch.py:2097-2210`): every
        tenant's report rendered against its own heavy index, then, each
        in its own `try` as in `_publish_report`: one delta frame a tenant
        (`tenant=(t, n)`, one telemetry block a window), the snapshots to
        the tenants' publishers, the sink once a tenant, the per-tenant
        archive segments; then the tier metrics by tenant, the aggregate
        gauges and `sketch_tenant_window_records{tenant}`. `entry.out` is
        the list of reports."""
        wtrace, n = entry.trace, self.tenants
        reps, tabs = entry.report, entry.tables
        m = self._metrics
        self._windows_published += 1  # telemetry: counts this window
        with wtrace.stage("report_render"):
            objs = [self._render_report(rep, roll=True, tenant=t)
                    for t, rep in enumerate(reps)]
        ts_ms = time.time_ns() // 1_000_000
        for obj in objs:
            obj["TimestampMs"] = ts_ms
        entry.out = objs
        if self._delta_sink is not None:
            try:
                self._push_tenant_deltas(wtrace, reps, tabs, ts_ms)
            except Exception as exc:
                log.error("tenant delta frame serialize/push failed "
                          "(frames lost, reports still publish): %s", exc)
                if m is not None:
                    m.count_error("federation")
        with wtrace.stage("query_snapshot"):
            for t, (obj, tab) in enumerate(zip(objs, tabs)):
                try:
                    faultinject.fire("sketch.query_snapshot")
                    self._publish_query_snapshot(obj, tab, tenant=t)
                except Exception as exc:
                    log.error("tenant %d query snapshot publish failed "
                              "(window report still publishes): %s", t, exc)
                    if m is not None:
                        m.count_error("tpu-sketch-query")
        with wtrace.stage("report_sink"):
            for obj in objs:
                self.sink(obj)
        self.reports_published += n
        if self._archive is not None:
            try:
                with wtrace.stage("archive_write"):
                    faultinject.fire("sketch.archive_write")
                    for t, tab in enumerate(tabs):
                        self._archive.write_tenant_window(
                            tab, window=int(objs[t]["Window"]), ts_ms=ts_ms,
                            tenant=t)
            except Exception as exc:
                log.error("tenant archive segment write failed (window %s "
                          "not fully archived; reports already "
                          "published): %s", objs[0]["Window"], exc)
                if m is not None:
                    m.count_error("tpu-sketch-archive")
        if m is None:
            return
        m.sketch_heavy_evictions_total.inc(
            sum(o["HeavyChurn"]["evictions"] for o in objs))
        if self.cfg.tiered is not None:
            try:
                for t, tab in enumerate(tabs):
                    self._publish_tier_metrics(tab, tenant=t)
            except Exception as exc:  # telemetry never loses a report
                log.warning("tier metrics publish failed: %s", exc)
        m.sketch_window_reports_total.inc()
        # the agent's gauges sum the tenants; the labelled series holds
        # each tenant's own records
        m.sketch_window_records.set(sum(o["Records"] for o in objs))
        m.sketch_window_drop_bytes.set(sum(o["DropBytes"] for o in objs))
        for t, obj in enumerate(objs):
            m.sketch_tenant_window_records.labels(str(t)).set(obj["Records"])
        for sig, key in SIGNAL_FIELDS.items():
            m.sketch_window_suspects.labels(sig).set(
                sum(len(o[key]) for o in objs))

    def _push_tenant_deltas(self, wtrace, reps: list, tabs: list,
                            ts_ms: int) -> None:
        """Encode one delta frame a tenant, `tenant=(t, n)`, all with the
        window's one telemetry block, and hand them to the sink; the
        aggregator's ledger keys each by (agent, tenant)
        (`federation/delta.source_key`)."""
        from netobserv_tpu_torch.federation import delta as fdelta

        with wtrace.stage("report_serialize"):
            faultinject.fire("sketch.delta_export")
            ctx = tracing.context_of(wtrace, origin=f"window@{self._agent_id}")
            if ctx is not None and self._metrics is not None:
                self._metrics.trace_context_propagated_total.labels(
                    "stamped").inc()
            tel = self._telemetry_block(
                sum(int(float(tab["scalars"][0])) for tab in tabs))
            frames = [fdelta.encode_frame(
                tab, agent_id=self._agent_id, window=int(reps[0].window),
                ts_ms=ts_ms, agent_epoch=self._agent_epoch, trace_ctx=ctx,
                telemetry=tel, tenant=(t, self.tenants), dims=self._dims())
                for t, tab in enumerate(tabs)]
        with wtrace.stage("delta_push"):
            for frame in frames:
                self._delta_sink(frame)

    def _dims(self) -> dict:
        """The frame's sketch geometry."""
        return {"cm_depth": self.cfg.cm_depth, "cm_width": self.cfg.cm_width,
                "hll_precision": self.cfg.hll_precision,
                "topk": self.cfg.topk, "ewma_buckets": self.cfg.ewma_buckets}

    def _push_delta(self, entry: _Queued) -> None:
        """Encode the window's delta frame and hand it to the sink
        (`tpu_sketch.py:1990-2035`). The frame is encoded once: a sink's
        retries resend these bytes, so the aggregator's ledger dedups."""
        from netobserv_tpu_torch.federation import delta as fdelta

        wtrace, tables = entry.trace, entry.tables
        with wtrace.stage("report_serialize"):
            faultinject.fire("sketch.delta_export")
            ctx = tracing.context_of(wtrace, origin=f"window@{self._agent_id}")
            if ctx is not None and self._metrics is not None:
                self._metrics.trace_context_propagated_total.labels(
                    "stamped").inc()
            frame = fdelta.encode_frame(
                tables, agent_id=self._agent_id,
                window=int(entry.report.window),
                ts_ms=time.time_ns() // 1_000_000,
                agent_epoch=self._agent_epoch, trace_ctx=ctx,
                telemetry=self._telemetry_block(
                    int(float(tables["scalars"][0]))),
                dims=self._dims())
        with wtrace.stage("delta_push"):
            self._delta_sink(frame)

    @property
    def overloaded(self) -> bool:
        """True while the overload controller sheds (the OVERLOADED
        condition; False without a controller)."""
        return self._overload is not None and self._overload.overloaded

    def overload_snapshot(self) -> Optional[dict]:
        """The controller's state for the health surface (None without
        one)."""
        return None if self._overload is None else self._overload.snapshot()

    def note_map_occupancy(self, ratio: float) -> None:
        """Keep the kernel map's occupancy at its last drain for the
        frames' telemetry (a map tracer's occupancy sink)."""
        self._map_occupancy = float(ratio)

    def _telemetry_block(self, records: int) -> dict:
        """The frame's agent telemetry, from values the exporter holds
        (`tpu_sketch.py:1095-1126`): the records/s EWMA over publishes
        (alpha 0.3, the first window seeds it); the controller's shed
        factor (1.0 without one); OVERLOADED while it sheds and ALERTING
        while the alert engine has an active alert; the map occupancy
        last noted."""
        now = time.monotonic()
        if self._last_publish_mono is not None:
            elapsed = max(now - self._last_publish_mono, 1e-6)
            rate = records / elapsed
            self._host_rate_ewma = (rate if self._host_rate_ewma == 0.0
                                    else 0.3 * rate
                                    + 0.7 * self._host_rate_ewma)
        self._last_publish_mono = now
        conditions = []
        if self.overloaded:
            conditions.append("OVERLOADED")
        eng = self._alerts
        if eng is not None:
            try:
                if eng.condition().get("active"):
                    conditions.append("ALERTING")
            except Exception:  # telemetry never loses the frame
                pass
        ctl = self._overload
        return {
            "shed_factor": float(ctl.shed) if ctl is not None else 1.0,
            "conditions": conditions,
            "host_records_per_s": round(self._host_rate_ewma, 3),
            "map_occupancy": round(self._map_occupancy, 6),
            "windows_published": self._windows_published,
        }

    def _drop_delta_sink(self) -> None:
        """Disable the delta export, closing the sink."""
        sink_close = getattr(self._delta_sink, "close", None)
        if sink_close is not None:
            sink_close()
        self._delta_sink = None

    def _publish_query_snapshot(self, obj: dict, tables: dict,
                                mid_window: bool = False,
                                tenant: Optional[int] = None) -> None:
        """Publish a fresh snapshot of a rendered report and its host CM
        planes, to the tenant's publisher with its `tenant` in tenant mode,
        then let the alert engine evaluate it (`safe_evaluate` contains a
        failed evaluation) (`tpu_sketch.py:1794-1823`)."""
        snap = {"window": obj["Window"], "ts_ms": obj["TimestampMs"],
                "report": obj,
                "cm_bytes": None if tables is None else tables["cm_bytes"],
                "cm_pkts": None if tables is None else tables["cm_pkts"]}
        if tenant is not None:
            snap["tenant"] = int(tenant)
            self._tenant_query[tenant].publish(snap, mid_window=mid_window)
        else:
            self.query.publish(snap, mid_window=mid_window)
        if self._alerts is not None:
            self._alerts.safe_evaluate(snap, mid_window=mid_window)

    def query_status(self) -> dict:
        """`/query/status`'s body: the publisher's counters and freshness,
        read once, the archive's block and in tenant mode the tenants'
        (`tpu_sketch.py:1825-1879`)."""
        snap = self.query.get()
        st = self.query.stats()
        st.update({"agent_id": self._agent_id, "window_s": self.window_s,
                   "refresh_s": self._query_refresh_s,
                   "overloaded": self.overloaded})
        if self._tiered_degraded:
            # why resident memory is wide despite SKETCH_TIERED
            st["tiered_degraded"] = True
        if self._alerts is not None:
            st["alerts"] = self._alerts.summary()
        if self._archive is not None:
            st["archive"] = self._archive.stats()
        if self._tenant_query is not None:
            # each tenant's publisher read once
            snaps_t = [p.get() for p in self._tenant_query]
            st["tenants"] = {
                "n": len(self._tenant_query),
                "published": sum(1 for x in snaps_t if x is not None),
                "stacked_folds": self.ring.folds,
                "routed_rows": self.ring.routed_rows,
                "windows": {str(t): (None if x is None else x["window"])
                            for t, x in enumerate(snaps_t)},
            }
        if snap is not None:
            st.update({"published": True, "seq": snap["seq"],
                       "window": snap["window"],
                       "mid_window": snap["mid_window"]})
            rep = snap["report"]
            st.update({
                "records": rep["Records"], "bytes": rep["Bytes"],
                "distinct_src_estimate": rep["DistinctSrcEstimate"],
                "drop_bytes": rep["DropBytes"],
                "quic_records": rep["QuicRecords"],
                "nat_records": rep["NatRecords"],
                "rtt_quantiles_us": rep["RttQuantilesUs"],
                "dns_latency_quantiles_us": rep["DnsLatencyQuantilesUs"],
                "suspects": {sig: len(rep[key]) for sig, key
                             in SIGNAL_FIELDS.items()},
            })
        return st

    def serve(self, address: str = "127.0.0.1", port: int = 0,
              health_source=None, tls_cert_path: str = "",
              tls_key_path: str = ""):
        """Start the port's metrics server (`metrics/server.
        start_metrics_server`) with this exporter's `/query/*` routes and,
        where it has a registry, `/metrics`; returns the server (stop it
        with `shutdown()` and `server_close()`)."""
        from netobserv_tpu_torch.metrics.server import start_metrics_server
        return start_metrics_server(
            self._metrics.registry if self._metrics is not None else None,
            address, port, tls_cert_path=tls_cert_path,
            tls_key_path=tls_key_path, health_source=health_source,
            query_routes=self.query_routes)

    def _maybe_refresh_query(self) -> None:
        """The window thread's refresh tick (`tpu_sketch.py:1558-1572`): a
        due refresh runs, and a failed one is logged, counted and tried
        again at the next tick. Off (`query_refresh_s` 0) it does
        nothing."""
        nxt = self._next_refresh
        if nxt is None or self._closed.is_set() or time.monotonic() < nxt:
            return
        self._next_refresh = time.monotonic() + self._query_refresh_s
        try:
            self._refresh_query_snapshot()
        except Exception as exc:
            log.error("mid-window query refresh failed (will retry): %s",
                      exc)
            if self._metrics is not None:
                self._metrics.count_error("tpu-sketch-query")

    def _refresh_query_snapshot(self) -> None:
        """Publish the live window as a mid-window snapshot without closing
        it (`tpu_sketch.py:1881-1939`): under the lock, fold the pending
        rows, copy the live state into the staging state, and roll that
        copy with its CM planes and report copied to the host; then, off
        the lock, publish the closed windows still queued and render and
        publish the partial window. The live state is read, never written.

        The queued windows go first: a window an eviction closed after the
        window thread's last publish would otherwise publish after the
        next window's refresh, and a poller would see the window go back
        (the reference publishes them at its next tick)."""
        with self._lock, self._on_device():
            self._drain_pending()
            if self._staging is None:
                if self.mesh is not None:
                    self._staging = pmerge.init_dist_state(self.cfg,
                                                           self.mesh)
                elif self.tenants:
                    self._staging = tenancy.init_stacked_state(
                        self.cfg, self.tenants, self.device)
                else:
                    self._staging = sk.init_state(self.cfg, self.device)
            staged = self._staging
            sk.copy_state_(staged, self.state)
            with self._roll_mutex:
                if self.tenants:
                    reports, tabs = self._roll_tenants(staged,
                                                       tenancy.CM_TABLES)
                elif self.mesh is not None:
                    report, tables = self._roll_mesh(staged, False)
                else:
                    tables = sk.host_cm_planes(staged)
                    _, report = sk.roll_window(staged, self.cfg,
                                               self.reset_sketches,
                                               self.decay_factor)
                    report = report_numpy(report)
        self._publish_queued()
        if self.tenants:
            # every tenant's partial window, to its publisher
            ts_ms = time.time_ns() // 1_000_000
            faultinject.fire("sketch.query_snapshot")
            for t, (rep, tab) in enumerate(zip(reports, tabs)):
                obj = self._render_report(rep, roll=False, tenant=t)
                obj["TimestampMs"] = ts_ms
                self._publish_query_snapshot(obj, tab, mid_window=True,
                                             tenant=t)
            return
        obj = self._render_report(report, roll=False)
        obj["TimestampMs"] = time.time_ns() // 1_000_000
        faultinject.fire("sketch.query_snapshot")
        self._publish_query_snapshot(obj, tables, mid_window=True)

    def _publish_tier_metrics(self, tables: dict,
                              tenant: Optional[int] = None) -> None:
        """Count the window's new promotions out of the u8 base plane, per
        CM table: counters at or past base saturation that were not at the
        previous publish (decay mode keeps promotions across windows; reset
        mode starts each window from fresh planes, so there every promoted
        counter is new) (`tpu_sketch.py:1957-1979`)."""
        spec = self.cfg.tiered
        for table, span in (("cm_bytes", tiered.BASE_MAX * spec.bytes_unit),
                            ("cm_pkts", tiered.BASE_MAX)):
            promoted = np.asarray(tables[table]) >= span
            fresh = promoted
            if self.decay_factor is not None:
                prev = self._tier_prev_promoted.get((table, tenant))
                if prev is not None:
                    fresh = promoted & ~prev
                self._tier_prev_promoted[(table, tenant)] = promoted
            self._metrics.sketch_tier_promotions_total.labels(
                table=table).inc(int(fresh.sum()))

    def roll(self):
        """Close the window now: fold the pending rows, roll, publish every
        queued report synchronously, and return this window's rendered
        report, in tenant mode the list of them (None if it was shed or
        failed to render)."""
        self._check_open()
        return self._roll_now()

    def _roll_now(self) -> Optional[dict]:
        with self._lock, self._on_device():
            entry = self._close_window_locked()
        self._publish_queued()
        return entry.out

    def flush(self) -> None:
        """Fold the handed-off evictions and the pending rows, close the
        window now and publish its report synchronously
        (`tpu_sketch.py:1462-1470`)."""
        self._drain_handoff()
        self.roll()

    @property
    def _window_poll_s(self) -> float:
        """The window thread's wake-up period; the supervisor's heartbeat
        deadline rides on top of it."""
        return min(1.0, self.window_s / 10)

    def start_window_timer(self) -> None:
        """(Re)start the window thread; a supervisor uses this as the
        "sketch-window" stage's restart callable."""
        self._timer = threading.Thread(
            target=self._window_loop, name="sketch-window", daemon=True)
        self._timer.start()

    def register_supervised(self, supervisor, heartbeat_timeout_s=None,
                            **kwargs) -> None:
        """Register with a supervisor of the reference's signature
        (`tpu_sketch.py:954-1001`): the window thread, its heartbeat
        deadline on top of the thread's poll period; the `overloaded`
        condition with a controller and the `alerting` one with an alert
        engine, where the supervisor takes conditions; and the fold thread,
        its deadline 0.2 s above the timeout, where there is one. With
        `window_s=None` there is no window thread to register."""
        if self.window_s is not None:
            self.heartbeat = supervisor.register(
                "sketch-window", restart=self.start_window_timer,
                thread_getter=lambda: self._timer,
                heartbeat_timeout_s=(heartbeat_timeout_s or 10.0)
                + self._window_poll_s, **kwargs)
        conditions = hasattr(supervisor, "register_condition")
        ctl = self._overload
        if ctl is not None and conditions:
            supervisor.register_condition(
                "overloaded",
                lambda: {"active": ctl.overloaded, **ctl.snapshot()})
        if self._alerts is not None and conditions:
            supervisor.register_condition("alerting", self._alerts.condition)
        if self._tiered_degraded and conditions:
            # a documented fallback, never DEGRADED: readiness is untouched
            supervisor.register_condition(
                "tiered_degraded",
                lambda: {"active": True,
                         "reason": "SKETCH_TIERED has no sharded form; "
                                   "resident tables are wide"})
        if self._handoff is not None:
            self.fold_heartbeat = supervisor.register(
                "sketch-fold", restart=self._start_fold_worker,
                thread_getter=lambda: self._fold_thread,
                heartbeat_timeout_s=(heartbeat_timeout_s or 10.0) + 0.2,
                **kwargs)

    def _window_loop(self) -> None:
        """Close a window whose deadline passed, then publish the queue
        outside the lock (`tpu_sketch.py:1529-1556`)."""
        while not self._closed.wait(timeout=self._window_poll_s):
            self.heartbeat()
            # outside the try: a fault of the thread itself is the
            # supervisor's (restart), not the swallow-and-retry path
            faultinject.fire("sketch.window_timer")
            try:
                faultinject.fire("sketch.window_roll")
                with self._lock:
                    if self._due():
                        with self._on_device():
                            self._close_window_locked()
            except Exception as exc:
                log.error("window roll failed (will retry next window): %s",
                          exc)
                if self._metrics is not None:
                    self._metrics.count_error("tpu-sketch")
            # a crash here restarts the thread; the queued report then
            # publishes once, since its deadline advanced at the roll
            if self._reports:
                faultinject.fire("sketch.window_publish")
            self._publish_queued()
            self._maybe_refresh_query()

    def close(self) -> None:
        """Stop the fold thread (after the handoff drains, at most 30 s,
        and a 10 s join) and fold what it left here, each batch contained;
        stop the window thread (within 10 s when a refresh may be running,
        else 2 s), publish the last window (`flush`) and write its staged
        checkpoint, close the checkpointer, the sink and the delta sink
        where they have `close`, wait for the device, and drop the buffers,
        the ring's pinned buffers, the staging state and the captured
        graphs. A second call does nothing (`tpu_sketch.py:1472-1527`)."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self._fold_thread is not None:
            self._drain_handoff()
            self._fold_thread.join(timeout=10.0)
            self._fold_leftovers()
        if self._timer is not None:
            self._timer.join(timeout=10.0 if self._query_refresh_s else 2.0)
        self._roll_now()
        if self._ckpt is not None:
            self._ckpt.close()
        for sink in (self.sink, self._delta_sink):
            sink_close = getattr(sink, "close", None)
            if sink_close is not None:
                sink_close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.ring is not None:
            self.ring.close()
        self.pending = None
        self._staging = None
        self._fold_dense = self._fold_rec = None
        self._host = self._host_u32 = self._dev = None


def _records_to_arrays(records: list) -> dict:
    """Records (`model/record.Record`) as the host columns the ingest reads
    of the reference's `FlowBatch.from_records` (`model/columnar.py:160-197`)
    through its `batch_to_device` (`sketch/state.py:208-224`), one row a
    record, in order."""
    n = len(records)
    keys = np.zeros(n, binfmt.FLOW_KEY_DTYPE)
    cols = {name: np.zeros(n, np.uint64 if name == "bytes" else np.uint32)
            for name in ("bytes", "packets", "rtt_us", "dns_latency_us",
                         "sampling", "tcp_flags", "dscp", "drop_bytes",
                         "drop_packets")}
    for i, r in enumerate(records):
        k, f = r.key, r.features
        keys[i]["src_ip"] = np.frombuffer(k.src_ip, np.uint8)
        keys[i]["dst_ip"] = np.frombuffer(k.dst_ip, np.uint8)
        keys[i]["src_port"], keys[i]["dst_port"] = k.src_port, k.dst_port
        keys[i]["proto"] = k.proto
        keys[i]["icmp_type"], keys[i]["icmp_code"] = k.icmp_type, k.icmp_code
        cols["bytes"][i], cols["packets"][i] = r.bytes_, r.packets
        cols["rtt_us"][i] = f.rtt_ns // 1000
        cols["dns_latency_us"][i] = f.dns_latency_ns // 1000
        cols["sampling"][i], cols["tcp_flags"][i] = r.sampling, r.tcp_flags
        cols["dscp"][i] = r.dscp
        cols["drop_bytes"][i], cols["drop_packets"][i] = f.drop_bytes, \
            f.drop_packets
    return {"keys": pack_key_words(keys), "valid": np.ones(n, bool),
            **cols}
