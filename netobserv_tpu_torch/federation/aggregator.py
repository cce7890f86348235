"""The federation aggregator on one device: the fleet's one sketch-merge plane.

Counterpart of `netobserv_tpu/federation/aggregator.py` on a single
device. Hundreds of per-host agents each send one delta frame per closed
window (`federation/delta.py`); this tier decodes, validates and merges
them on the device into one wide `SketchState`, rolls a cluster window on
a timer and publishes the cluster report and a host-side snapshot that
the query surface (`federation/query.py`) reads.

**Ingest** (`ingest_frame`, the reference's steps, `:332-554`): the fault
point `federation.delta_ingest`; decode and `upgrade_tables` (span
`delta_decode`); shape and geometry validation (`delta_validate`); an
advisory ledger verdict that discards a duplicate or stale frame before
any copy (`delta_ledger`); then, under the lock, the authoritative
verdict, the copy and the merge (`delta_merge_dispatch`), the ledger and
the agent view. Verdicts: `legacy` (a v1 frame, merged unconditionally),
`ok`, `duplicate` (same epoch, window_seq and frame_uuid as the last
applied) and `stale` (behind it). The ack is the port's
`pbwire.DeltaAck`, byte for byte the reference's.

**The device copy.** The device tables live in one flat buffer made once
from `delta.expected_shapes`, with a pinned host twin of the same layout.
A frame's tables (read-only views over its bytes) are copied into the
host twin under the lock (span `delta_h2d`, the port's own: the
reference's `device_put` is asynchronous and unspanned), then one
asynchronous copy moves the whole buffer; the next frame waits on that
copy's event before it writes the twin. uint32 lanes travel as their
int32 bits and widen to the port's int64 lanes inside the merge.

**The merge** is `statemerge.merge_tables` in place. On CUDA it runs as
one CUDA graph (`sketch/capture.CapturedFold("federation_merge")`),
captured when the aggregator is made, before any frame and before the
window thread starts; a capture that fails raises. Its compile watch is
named `federation_merge`, as the reference's jitted merge is. The CPU
merges eagerly, op by op.

**The window plane** (`:557-750`): a window thread wakes every
`min(1.0, window_s / 10)` seconds, closes a window whose deadline passed
(`_close_window_locked`: the pre-roll `state_tables` copied to the host,
then `roll_window`, span `roll_dispatch`, a report queue of 4 whose oldest
is shed and counted), evicts agents silent past `agent_ttl_s`, refreshes
the staleness gauges and the fleet snapshot, and publishes the queue
(`_publish`: the report rendered with the cluster-tier `EvictedKeys`
index, stamped `Type`/`Agents`/`TimestampMs`; the snapshot with the host
CM planes and heavy table; `alerts.safe_evaluate`;
`federation_active_agents`; then the sink). A merged, sampled agent trace
(`tracing.continue_trace`) is parked until its window closes, and the
window trace is a `tracing.group` of the aggregator's own and the parked
ones. `flush()` closes the window now and publishes synchronously;
`close()` stops the thread and flushes.

**Checkpoints** (`:193-330`, `:615-620`, `:706-718`). With
`checkpoint_dir` the aggregate state and the delivery ledger are restored
when the aggregator is made (in place, after the merge's capture, which
stays bound), with the publish marker's window fast-forward, and a
restore that fails quarantines the directory (`<dir>.corrupt-<pid>-<ns>`)
and checkpoints into a fresh one. Every `checkpoint_every`-th roll stages
its checkpoint under the lock (fault point `federation.checkpoint` at the
write): the post-roll state copied to host buffers made once
(`sketch/checkpoint.SketchCheckpointer.stage`) and the ledger. The window
thread writes the ledger sidecar, then the tensors, off the lock and
before the window publishes, so a hung disk stalls only that thread; each
publish writes the publish marker before the sink.

**The archive** (`:733-750`, `:863-864`). With `archive` (an
`archive.SketchArchive`) each merged window's tables are written at
publish, last, in a `try` of their own (fault point
`sketch.archive_write`, `count_error("federation-archive")`);
`/federation/range` answers from it (`federation/query.py`) and `status`
has its `archive` block. The archive's device work holds the aggregator's
lock (`SketchArchive.share_device_lock`).

**The mesh** (`mesh_shape`, reference `:44-47`, `:99-110`, `:505-530`):
the aggregate is a `parallel/merge.DistState` over a data-axis mesh
(`parallel/mesh.make_mesh` of `devices`, by default every visible CUDA
device; a list may repeat one). Each agent's frames fold into the data
shard that owns it (`agent_owner_shard`, a crc32 of its source key), the
owner's step of `parallel/merge.make_fold_delta_fn`: the frame is copied
into a buffer on the owner's device and merged into that shard's partial
(on CUDA one captured graph a shard, "federation_fold_delta"). The roll is
`make_merge_fn(with_tables=True)`: the merged report and tables, and every
shard rolled. A width-sharded mesh is refused with the reference's
message; `status()["mesh"]` is True. Make the aggregator, and so capture
its graphs, before any agent's ring (ROADMAP C4).

**Across processes** (`parallel/distributed.py`, reference `:66-71`,
`:99-110`, `:510-530`): the constructor first joins the process group
that FEDERATION_COORDINATOR, FEDERATION_NUM_PROCESSES and
FEDERATION_PROCESS_ID describe, else the SKETCH_ ones (the three from one
prefix only), before any tensor. The mesh then spans every rank's
devices. Every rank ingests the same frames, in the same order, so the
ledgers agree; a frame folds only on the rank that holds its owner shard
(`make_fold_delta_fn`), and every rank's ledger takes it. The roll is a
collective: every rank closes its windows in the same order (`flush`, or
the window thread; a frame never closes one there) and publishes the same
report. Checkpoints are gathered to and written by rank 0 into a
directory every rank shares (`sketch/checkpoint.py`).

Every CUDA call runs under the aggregator's lock, on the caller's current
stream of the aggregator's device.

A tiered `sketch_cfg` is refused: the merge reads the wide tables of the
aggregate (the reference's `merge_tables` reads `state.cm_bytes.counts`,
which its tiered state does not have, so each frame would be rejected as
a `merge_error`). A tiered agent sends wide tables and merges as any
other.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from netobserv_tpu_torch.exporter.report import (
    heavy_identity_index, report_numpy, report_to_json,
)
from netobserv_tpu_torch.federation import delta as fdelta
from netobserv_tpu_torch.federation import statemerge
from netobserv_tpu_torch.federation.pbwire import DeltaAck
from netobserv_tpu_torch.parallel import distributed
from netobserv_tpu_torch.parallel import merge as pmerge
from netobserv_tpu_torch.parallel import mesh as pmesh
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.utils import faultinject, retrace, tracing
from netobserv_tpu_torch.utils.platform import pick_device

log = logging.getLogger("netobserv_tpu_torch.federation.aggregator")

#: closed windows the report queue holds before the oldest is shed
MAX_QUEUED_REPORTS = 4
#: the environment prefixes of the aggregator tier's process group
#: (reference `:66-71`): its own first, then the agents' shared one
_PREFIXES = ("FEDERATION_", "SKETCH_")


def agent_owner_shard(agent_id: str, n_shards: int) -> int:
    """Stable agent -> data-shard assignment (mesh mode): one agent's
    deltas always fold into the same shard's partial (reference
    `federation/aggregator.py:44-47`)."""
    return zlib.crc32(agent_id.encode()) % max(1, n_shards)


class FederationAggregator:
    """Delta ingest, the device merge and the cluster window (module
    docstring). A bad frame is acked `accepted=0` and counted, a merge
    failure loses that frame (counted), a roll failure retries next
    window."""

    def __init__(self, sketch_cfg: Optional[sk.SketchConfig] = None,
                 window_s: float = 60.0, mesh_shape: str = "",
                 metrics=None, sink: Optional[Callable[[dict], None]] = None,
                 stale_after_s: float = 120.0,
                 report_kwargs: Optional[dict] = None,
                 checkpoint_dir: str = "", checkpoint_every: int = 1,
                 agent_ttl_s: float = 0.0, alerts=None, archive=None,
                 device: str | torch.device | None = None, devices=None):
        # the aggregator tier's group joins under its own prefix first, then
        # the shared one, before any tensor (module docstring)
        devs = (list(devices) if devices is not None
                else pmesh.visible_devices() if device is None
                else [device])
        distributed.maybe_initialize_distributed(_PREFIXES, devices=devs)
        self._cfg = sketch_cfg or sk.SketchConfig()
        if self._cfg.tiered is not None:
            raise ValueError(
                "a tiered sketch_cfg cannot aggregate: the merge reads the "
                "aggregate's wide tables (tiered agents send wide tables "
                "and merge into a wide aggregator)")
        #: the mesh (module docstring), or None: one device
        self.mesh = None
        if mesh_shape:
            self.mesh = pmesh.make_mesh(
                pmesh.MeshSpec.parse(mesh_shape, len(devs)), devs)
        self.device = (self.mesh.first if self.mesh is not None
                       else pick_device(device))
        self._window_s = window_s
        self._metrics = metrics
        self._sink = sink
        self._stale_after_s = stale_after_s
        self._report_kwargs = report_kwargs or {}
        #: previous merged window's heavy identity index (EvictedKeys diff)
        self._prev_heavy_index: Optional[dict] = None
        if metrics is not None:
            retrace.set_metrics(metrics)
            tracing.set_metrics(metrics)
        self._dims = {"cm_depth": self._cfg.cm_depth,
                      "cm_width": self._cfg.cm_width,
                      "hll_precision": self._cfg.hll_precision,
                      "topk": self._cfg.topk,
                      "ewma_buckets": self._cfg.ewma_buckets}
        cuda = self.device.type == "cuda"
        with self._on_device():
            self._expected_shapes = fdelta.expected_shapes(
                sk.state_tables(sk.init_state(self._cfg, self.device)))
            if self.mesh is not None:
                self._init_mesh(cuda)
            else:
                self._state = sk.init_state(self._cfg, self.device)
                self._make_buffers(cuda)
                if cuda:
                    # the captured merge: made now, before any frame and
                    # before the window thread, so no other thread's
                    # CUDA call can meet the capture
                    self._fold = CapturedFold(
                        "federation_merge", self._merge,
                        torch.cuda.graph_pool_handle())
                    self._fold.prepare(self._state, self._dev)
                else:
                    self._fold = retrace.watch(self._merge,
                                               "federation_merge")
                self._roll = retrace.watch(self._roll_tables,
                                           "federation_roll")

        self._lock = threading.Lock()          # aggregate state + counters
        self._publish_lock = threading.Lock()
        self._reports: collections.deque = collections.deque()
        self._window_deadline = time.monotonic() + window_s
        #: agent id -> {"frames", "window", "last_ms", "last_mono",
        #: "telemetry"?}
        self._agents: dict[str, dict] = {}
        #: idempotent-delivery ledger: source -> {"epoch", "window_seq",
        #: "frame_uuid"} of the last applied v2+ frame
        self._ledger: dict[str, dict] = {}
        self._window_agents: set[str] = set()
        self._frames_total = 0
        self._agent_ttl_s = agent_ttl_s
        #: host mirror of the aggregate's window counter (delta churn
        #: tensors re-base into the cluster window domain before merging)
        self._window_host = 0
        self._snapshot: Optional[dict] = None
        self._snap_lock = threading.Lock()
        self._snap_seq = 0
        #: continued agent traces parked for the current window
        self._window_traces: list = []
        self._max_window_traces = 32
        self._fleet: Optional[dict] = None
        self._fleet_lock = threading.Lock()
        self._fleet_seq = 0
        self._closed = threading.Event()
        self.alerts = alerts
        #: the archive plane; /federation/range reads it
        self.archive = archive
        if archive is not None:
            archive.share_device_lock(self._lock)
        # checkpoints: the post-roll state and the ledger, saved at a roll
        self._ckpt = None
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = max(1, int(checkpoint_every))
        self._n_rolls = 0
        self._pending_ckpt: Optional[tuple] = None
        if checkpoint_dir:
            from netobserv_tpu_torch.sketch.checkpoint import (
                SketchCheckpointer,
            )
            self._ckpt = SketchCheckpointer(checkpoint_dir)
            self._maybe_restore()
        self.heartbeat = lambda: None
        self._timer: Optional[threading.Thread] = None
        self.start_window_timer()

    @classmethod
    def from_config(cls, cfg, metrics=None, sink=None
                    ) -> "FederationAggregator":
        """The aggregator an `AgentConfig` describes, with the arguments
        the reference's aggregator process gives it
        (`federation/service.py:29-64`): the SKETCH_* geometry and
        thresholds, FEDERATION_WINDOW, FEDERATION_MESH_SHAPE,
        FEDERATION_STALE_AFTER, FEDERATION_AGENT_TTL, the
        FEDERATION_CHECKPOINT_* settings, ALERT_RULES, ARCHIVE_DIR and the
        report sink (`sink` overrides it). SKETCH_DEVICES=cpu runs on the
        CPU, repeated for a mesh; "" on the cards. The process around it
        (the gRPC collector, the query server, supervision) is
        `federation/service.FederationAggregatorService`."""
        from netobserv_tpu_torch.alerts.engine import maybe_engine
        from netobserv_tpu_torch.archive import maybe_archive
        from netobserv_tpu_torch.exporter.report import make_report_sink
        cpu = cfg.sketch_devices == "cpu"
        device = pick_device("cpu" if cpu else None)
        devices = None
        if cpu and cfg.federation_mesh_shape:
            distributed.maybe_initialize_distributed(_PREFIXES,
                                                     devices=[device])
            devices = pmesh.local_share(device, pmesh.MeshSpec.parse(
                cfg.federation_mesh_shape, 1))
        sketch_cfg = sk.SketchConfig.from_agent_config(cfg)
        return cls(
            sketch_cfg=sketch_cfg, window_s=cfg.federation_window,
            mesh_shape=cfg.federation_mesh_shape, metrics=metrics,
            sink=sink if sink is not None else make_report_sink(cfg),
            stale_after_s=cfg.federation_stale_after,
            report_kwargs=dict(
                scan_fanout_threshold=cfg.sketch_scan_fanout,
                ddos_z_threshold=cfg.sketch_ddos_z,
                synflood_min=cfg.sketch_synflood_min,
                synflood_ratio=cfg.sketch_synflood_ratio,
                drop_z_threshold=cfg.sketch_drop_z,
                asym_min_bytes=cfg.sketch_asym_min_bytes,
                asym_ratio=cfg.sketch_asym_ratio,
                churn_ascent=cfg.sketch_churn_ascent,
                churn_min_bytes=cfg.sketch_churn_min_bytes),
            checkpoint_dir=cfg.federation_checkpoint_dir,
            checkpoint_every=cfg.federation_checkpoint_every,
            agent_ttl_s=cfg.federation_agent_ttl,
            alerts=maybe_engine(cfg, metrics, source="federation"),
            archive=maybe_archive(cfg, sketch_cfg, metrics=metrics,
                                  agent_id="federation", device=device),
            device=device if cpu else None, devices=devices)

    def _init_mesh(self, cuda: bool) -> None:
        """The mesh's aggregate, its fold and its roll (module docstring):
        one frame buffer a data shard's device, and on CUDA one captured
        fold a data shard, made here before any frame."""
        mesh = self.mesh
        self._fold_delta = pmerge.make_fold_delta_fn(mesh, self._cfg)
        self._state = pmerge.init_dist_state(self._cfg, mesh)
        self._mesh_roll = pmerge.make_merge_fn(mesh, self._cfg,
                                               with_tables=True)
        self._roll = self._roll_mesh
        self._stacks = {}
        owned = [d for d in range(mesh.data) if mesh.is_local(d, 0)]
        for d in owned:
            dev = mesh.devices[d][0]
            if dev not in self._stacks:
                stack = statemerge.TableStack(self._expected_shapes, 1, dev)
                self._stacks[dev] = (stack, stack.host_views(),
                                     torch.cuda.Event() if cuda else None)
        self._buf = next(iter(self._stacks.values()))[0]
        self._fold = None
        self._shard_folds = None
        if cuda:
            pool = torch.cuda.graph_pool_handle()
            self._shard_folds = {}
            for d in owned:
                fold = CapturedFold("federation_fold_delta", self._merge,
                                    pool)
                fold.prepare(self._state.shards[d][0],
                             self._stacks[mesh.devices[d][0]][0].dev)
                self._shard_folds[d] = fold

    def _roll_mesh(self, state):
        """The mesh's cluster roll: the merged pre-roll tables and report
        to the host, every shard rolled in place."""
        _, report, tables = self._mesh_roll(state)
        return report_numpy(report), tables

    def _windows(self) -> list[torch.Tensor]:
        """The aggregate's window counters: one, or every shard's."""
        if self.mesh is None:
            return [self._state.window]
        return [s.window for s in self._state.flat()]

    def _fresh_state(self):
        if self.mesh is not None:
            return pmerge.init_dist_state(self._cfg, self.mesh)
        return sk.init_state(self._cfg, self.device)

    # --- checkpoint/restore -----------------------------------------------
    def _maybe_restore(self) -> None:
        """Restore the aggregate state in place and the delivery ledger
        from the latest checkpoint, then fast-forward past the publish
        marker's window; a failure starts a fresh window (logged, counted)
        and quarantines the directory (reference `:193-235`)."""
        try:
            with self._on_device():
                step = self._ckpt.latest_step()
                if step is not None:
                    self._ckpt.restore(self._state)
                    self._apply_restored_meta(
                        self._ckpt.read_metadata(step) or {})
                # with checkpoint_every > 1 (or before the first tensor
                # save) the published windows past the newest checkpoint
                # keep their ids and their ledger: the skipped windows'
                # tensors are the documented every-N loss
                pub = self._ckpt.read_publish_marker()
                restored_w = int(self._state.window)
                if pub is not None and pub["window"] >= restored_w:
                    self._apply_restored_meta(pub["meta"])
                    for w in self._windows():
                        w.add_(pub["window"] + 1 - restored_w)
                elif step is None:
                    return
                self._window_host = int(self._state.window)
            log.info("restored federation aggregate (checkpoint step %s, "
                     "next window %d, %d agents in the ledger)", step,
                     self._window_host, len(self._ledger))
        except Exception as exc:
            log.error("aggregator checkpoint restore failed "
                      "(starting a fresh window): %s", exc)
            if self._metrics is not None:
                self._metrics.count_error("federation")
            with self._on_device():
                sk.copy_state_(self._state, self._fresh_state())
            self._ledger, self._window_host = {}, 0
            self._agents.clear()
            self._quarantine_checkpoints()

    def _quarantine_checkpoints(self) -> None:
        """Move an unrestorable checkpoint directory aside (kept for
        forensics) and checkpoint into a clean one: the fresh window
        counter restarts at 0, and the retention (highest steps win) of
        the old directory would delete every new checkpoint while
        `latest_step` kept answering the broken one. If even the rename
        fails, checkpointing is disabled for this run. Across processes
        rank 0 moves the shared directory aside, and checkpointing (a
        collective) goes on on every rank or on none."""
        import os
        from netobserv_tpu_torch.sketch.checkpoint import SketchCheckpointer
        try:
            self._ckpt.close()
        except Exception:
            pass
        if distributed.process_index() != 0:
            self._ckpt = SketchCheckpointer(self._ckpt_dir)
        else:
            dest = (f"{self._ckpt_dir}.corrupt-{os.getpid()}-"
                    f"{time.time_ns()}")
            try:
                os.rename(self._ckpt_dir, dest)
                self._ckpt = SketchCheckpointer(self._ckpt_dir)
                log.warning("quarantined unrestorable checkpoint dir to "
                            "%s; checkpointing continues into a fresh %s",
                            dest, self._ckpt_dir)
            except Exception as exc:
                self._ckpt = None
                log.error("could not quarantine checkpoint dir %s (%s) — "
                          "checkpointing DISABLED for this run",
                          self._ckpt_dir, exc)
        if not all(distributed.all_gather_object(self._ckpt is not None)):
            self._ckpt = None

    def _apply_restored_meta(self, meta: dict) -> None:
        """Re-seat the delivery ledger and the agent view from checkpointed
        metadata (the roll's sidecar, or the newer publish marker);
        staleness restarts from the checkpointed wall-clock gap."""
        self._ledger = {a: dict(v)
                        for a, v in (meta.get("ledger") or {}).items()}
        now_ms, now_mono = time.time() * 1e3, time.monotonic()
        self._agents.clear()
        for a, info in (meta.get("agents") or {}).items():
            gap_s = max(0.0, (now_ms - float(info.get("last_ms", 0.0)))
                        / 1e3)
            self._agents[a] = {
                "frames": int(info.get("frames", 0)),
                "window": int(info.get("window", 0)),
                "last_ms": float(info.get("last_ms", 0.0)),
                "last_mono": now_mono - gap_s}

    def _delivery_meta_locked(self) -> dict:
        """JSON-able ledger and agent view (the caller holds the lock)."""
        return {"ledger": {a: dict(v) for a, v in self._ledger.items()},
                "agents": {a: {"frames": v["frames"], "window": v["window"],
                               "last_ms": v["last_ms"]}
                           for a, v in self._agents.items()}}

    def _stage_checkpoint_locked(self, report) -> None:
        """Stage this roll's checkpoint under the lock: the post-roll state
        copied to the checkpointer's host buffers (later merges update the
        state in place) and the ledger. The disk write happens off the
        lock (`_run_pending_checkpoint`)."""
        superseded = self._pending_ckpt[2] if self._pending_ckpt else None
        self._pending_ckpt = (int(report.window),
                              self._delivery_meta_locked(),
                              self._ckpt.stage(self._state,
                                               replace=superseded))

    def _run_pending_checkpoint(self) -> None:
        """Write the staged ledger sidecar, then the tensors, off the lock
        and before any queued publish (durable checkpoint, then publish:
        exactly-once across a restart). A failure is logged and counted: a
        wedged disk loses durability, never the live plane."""
        with self._lock:
            payload, self._pending_ckpt = self._pending_ckpt, None
        if payload is None or self._ckpt is None:
            return
        step, meta, staged = payload
        m = self._metrics
        try:
            faultinject.fire("federation.checkpoint")
            self._ckpt.save_metadata(step, meta)
            self._ckpt.save(step, staged)
            if m is not None:
                m.federation_checkpoints_total.labels("ok").inc()
        except Exception as exc:
            log.error("federation checkpoint failed (window keeps "
                      "rolling without durability): %s", exc)
            if m is not None:
                m.federation_checkpoints_total.labels("error").inc()
                m.count_error("federation")
        finally:
            self._ckpt.release(staged)  # a no-op once written

    # --- device buffers and the merge -----------------------------------
    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _make_buffers(self, cuda: bool) -> None:
        """One flat int32 device buffer holding every frame table at its
        spec dtype's bits, and its pinned host twin (module docstring)."""
        self._buf = statemerge.TableStack(self._expected_shapes, 1,
                                          self.device)
        self._host, self._dev = self._buf.host, self._buf.dev
        self._host_views = self._buf.host_views()
        self._copied = torch.cuda.Event() if cuda else None

    def _device_tables(self, dev: torch.Tensor) -> dict:
        """The frame tables as views of the flat buffer, uint32 lanes
        widened to int64."""
        return self._buf.device_tables(dev)

    def _merge(self, state: sk.SketchState, dev: torch.Tensor) -> None:
        statemerge.merge_tables(state, self._device_tables(dev))

    def _copy_in(self, host_tables: dict) -> None:
        """Copy a frame's host tables into the device buffer (under the
        lock): wait for the last copy to leave the host twin, fill the
        twin, and enqueue one asynchronous copy on the current stream."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, view in self._host_views.items():
            np.copyto(view, host_tables[name], casting="unsafe")
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record(torch.cuda.current_stream(self.device))

    def _fold_owner(self, src: str, host_tables: dict, tr) -> None:
        """Mesh mode: copy a frame's tables to its owner shard's device
        and fold them into that shard's partial (under the lock); across
        processes only on the rank that holds the owner shard."""
        d = agent_owner_shard(src, self.mesh.data)
        if not self.mesh.is_local(d, 0):
            return  # another rank holds the owner shard and folds it
        dev = self.mesh.devices[d][0]
        stack, views, ev = self._stacks[dev]
        with tr.stage("delta_h2d"):
            if ev is not None:
                ev.synchronize()
            for name, view in views.items():
                np.copyto(view, host_tables[name], casting="unsafe")
            stack.dev.copy_(stack.host, non_blocking=True)
            if ev is not None:
                ev.record(torch.cuda.current_stream(dev))
        if self._shard_folds is not None:
            self._shard_folds[d](self._state.shards[d][0], stack.dev)
        else:
            self._fold_delta(self._state, stack.device_tables(stack.dev), d)

    def _roll_tables(self, state: sk.SketchState):
        """The cluster roll: the pre-roll tables to the host, then the
        roll in place; returns (host report, host tables)."""
        tables = sk.state_tables(state)
        _, report = sk.roll_window(state, self._cfg)
        return report_numpy(report), tables

    # --- delta ingest ----------------------------------------------------
    def ingest_frame(self, data: bytes) -> DeltaAck:
        """Decode, validate, ledger-check and merge one frame; always
        returns an ack. A redelivered v2+ frame (same agent, epoch,
        window_seq and frame_uuid) acks accepted and duplicate without
        merging, and a stale window acks and is discarded."""
        t0 = time.perf_counter()
        trace = tracing.start_trace("delta")
        cont = tracing.NULL_TRACE
        parked = False
        try:
            data = faultinject.fire("federation.delta_ingest", data)
            try:
                with trace.stage("delta_decode"):
                    frame = fdelta.decode_frame(data)
                    frame = frame._replace(
                        tables=fdelta.upgrade_tables(frame))
            except fdelta.DeltaVersionError as exc:
                return self._reject("version_mismatch", str(exc))
            except fdelta.DeltaFrameError as exc:
                return self._reject("decode_error", str(exc))
            cont = tracing.continue_trace(frame.trace_ctx,
                                          "federation_delta")
            if cont.sampled and self._metrics is not None:
                self._metrics.trace_context_propagated_total.labels(
                    "continued").inc()
            tr = tracing.group(trace, cont)
            try:
                with tr.stage("delta_validate"):
                    fdelta.validate_shapes(frame, self._expected_shapes)
                    if frame.dims != self._dims:
                        raise fdelta.DeltaFrameError(
                            f"frame geometry {frame.dims} != aggregator's "
                            f"{self._dims} (agent {frame.agent_id!r})")
            except fdelta.DeltaFrameError as exc:
                return self._reject("shape_mismatch", str(exc))
            try:
                with tr.stage("delta_merge_dispatch"):
                    result = self._merge_frame(frame, tr)
            except Exception as exc:
                log.error("delta merge failed (frame from %r dropped): %s",
                          frame.agent_id, exc)
                return self._reject("merge_error", str(exc))
            if cont.sampled and result in ("ok", "legacy"):
                parked = self._park_window_trace(cont)
        finally:
            trace.finish()
            if cont.sampled and not parked:
                cont.finish()
        m = self._metrics
        if m is not None:
            m.federation_deltas_total.labels(result).inc()
            m.federation_delta_bytes_total.inc(len(data))
            if result in ("ok", "legacy"):
                m.federation_merge_seconds.observe(time.perf_counter() - t0)
        return DeltaAck(
            accepted=1, version=fdelta.DELTA_FORMAT_VERSION,
            duplicate=1 if result in ("duplicate", "stale") else 0,
            reason=(fdelta.ACK_REASON_DUPLICATE if result == "duplicate"
                    else fdelta.ACK_REASON_STALE if result == "stale"
                    else ""))

    def _reject(self, result: str, reason: str) -> DeltaAck:
        log.warning("delta frame rejected (%s): %s", result, reason)
        if self._metrics is not None:
            self._metrics.federation_deltas_total.labels(result).inc()
        return DeltaAck(accepted=0, version=fdelta.DELTA_FORMAT_VERSION,
                        reason=reason)

    def _ledger_verdict_locked(self, frame: fdelta.DeltaFrame) -> str:
        """`legacy` (v1), `ok` (a new window or a new epoch), `duplicate`
        (same epoch, window_seq and frame_uuid as the last applied) or
        `stale` (at or behind it, or a dead epoch's straggler); the
        caller holds the lock (reference `:420-449`)."""
        if frame.version < 2:
            return "legacy"
        last = self._ledger.get(fdelta.source_key(frame))
        if last is None or frame.agent_epoch > last["epoch"]:
            return "ok"
        if frame.agent_epoch < last["epoch"]:
            return "stale"
        if frame.window_seq > last["window_seq"]:
            return "ok"
        if (frame.window_seq == last["window_seq"]
                and frame.frame_uuid == last["frame_uuid"]):
            return "duplicate"
        return "stale"

    def _note_discard_locked(self, frame: fdelta.DeltaFrame,
                             verdict: str) -> None:
        """A duplicate refreshes its agent's liveness; a stale frame does
        not, so a poisoned ledger entry can age out through the TTL."""
        src = fdelta.source_key(frame)
        last = self._ledger.get(src)
        if last is not None and frame.agent_epoch < last["epoch"]:
            log.warning(
                "agent %r sent epoch %d below its ledger epoch %d (clock "
                "step-back across a restart?) — frames discarded as stale "
                "until the FEDERATION_AGENT_TTL eviction re-admits it",
                src, frame.agent_epoch, last["epoch"])
        if verdict == "duplicate" and src in self._agents:
            info = self._agents[src]
            info["last_ms"] = time.time() * 1e3
            info["last_mono"] = time.monotonic()

    def _park_window_trace(self, cont) -> bool:
        """Hold a continued agent trace until its window closes; past 32
        the oldest parked trace seals early."""
        with self._lock:
            self._window_traces.append(cont)
            shed = (self._window_traces.pop(0)
                    if len(self._window_traces) > self._max_window_traces
                    else None)
        if shed is not None:
            shed.finish()
        return True

    def _merge_frame(self, frame: fdelta.DeltaFrame,
                     tr=tracing.NULL_TRACE) -> str:
        # advisory pre-check: a redelivered or stale frame pays no copy
        with tr.stage("delta_ledger"):
            with self._lock:
                early = self._ledger_verdict_locked(frame)
                if early in ("duplicate", "stale"):
                    self._note_discard_locked(frame, early)
                    return early
        host_tables = fdelta.localize_churn(frame.tables, self._window_host)
        with self._lock, self._on_device():
            # authoritative verdict, copy, merge and ledger update are one
            # critical section: two racing copies of a frame serialize here
            verdict = self._ledger_verdict_locked(frame)
            if verdict not in ("ok", "legacy"):
                self._note_discard_locked(frame, verdict)
                return verdict
            src = fdelta.source_key(frame)
            if self.mesh is not None:
                self._fold_owner(src, host_tables, tr)
            else:
                with tr.stage("delta_h2d"):
                    self._copy_in(host_tables)
                self._fold(self._state, self._dev)
            if verdict == "ok":
                self._ledger[src] = {
                    "epoch": frame.agent_epoch,
                    "window_seq": frame.window_seq,
                    "frame_uuid": frame.frame_uuid}
            self._frames_total += 1
            self._window_agents.add(src)
            info = self._agents.setdefault(
                src, {"frames": 0, "window": 0, "last_ms": 0.0,
                      "last_mono": 0.0})
            info["frames"] += 1
            info["window"] = frame.window
            info["last_ms"] = time.time() * 1e3
            info["last_mono"] = time.monotonic()
            if frame.telemetry is not None:
                info["telemetry"] = frame.telemetry
            if time.monotonic() >= self._window_deadline and not (
                    self.mesh is not None and self.mesh.multiprocess):
                # a multi-process roll is a collective: never from ingest
                self._close_window_locked()
        return verdict

    # --- window roll -----------------------------------------------------
    def start_window_timer(self) -> None:
        self._timer = threading.Thread(
            target=self._window_loop, name="federation-window", daemon=True)
        self._timer.start()

    @property
    def _window_poll_s(self) -> float:
        return min(1.0, self._window_s / 10)

    def register_supervised(self, supervisor, heartbeat_timeout_s=None,
                            **kwargs) -> None:
        """Register the window thread with a supervisor (the reference's
        `Supervisor.register` signature)."""
        self.heartbeat = supervisor.register(
            "federation-window", restart=self.start_window_timer,
            thread_getter=lambda: self._timer,
            heartbeat_timeout_s=(heartbeat_timeout_s or 10.0)
            + self._window_poll_s, **kwargs)

    def _window_loop(self) -> None:
        while not self._closed.wait(timeout=self._window_poll_s):
            self.heartbeat()
            faultinject.fire("federation.window_timer")
            try:
                faultinject.fire("federation.window_roll")
                with self._lock:
                    if time.monotonic() >= self._window_deadline:
                        with self._on_device():
                            self._close_window_locked()
            except Exception as exc:
                log.error("federation window roll failed (will retry): %s",
                          exc)
                if self._metrics is not None:
                    self._metrics.count_error("federation")
            self._evict_stale_agents()
            self._update_staleness()
            self._update_fleet()
            self._publish_queued()

    def _close_window_locked(self) -> None:
        """Roll under the lock (the caller holds it, on the device); the
        render and publish happen outside it."""
        conts, self._window_traces = self._window_traces, []
        wtrace = tracing.group(
            tracing.start_trace("federation_window"), *conts)
        self._window_deadline = time.monotonic() + self._window_s
        try:
            with wtrace.stage("roll_dispatch"):
                report, tables = self._roll(self._state)
        except BaseException:
            wtrace.finish()
            raise
        self._window_host += 1
        agents = sorted(self._window_agents)
        self._window_agents = set()
        # the post-roll state and the ledger at this step: a restore
        # resumes the fresh window, and redelivered frames dedup
        if self._ckpt is not None:
            self._n_rolls += 1
            if self._n_rolls % self._ckpt_every == 0:
                self._stage_checkpoint_locked(report)
        self._reports.append((report, tables, agents, wtrace))
        while len(self._reports) > MAX_QUEUED_REPORTS:
            try:
                _r, _t, _a, shed = self._reports.popleft()
            except IndexError:
                break
            shed.finish()
            log.error("federation report queue full; dropping the oldest "
                      "unpublished window")
            if self._metrics is not None:
                self._metrics.count_error("federation")

    def _publish_queued(self, timeout_s: Optional[float] = None) -> None:
        if not self._publish_lock.acquire(
                timeout=-1 if timeout_s is None else timeout_s):
            log.error("publish lock busy past %.1fs — skipping publish on "
                      "this path", timeout_s)
            if self._metrics is not None:
                self._metrics.count_error("federation")
            return
        try:
            self._run_pending_checkpoint()
            while self._reports:
                try:
                    report, tables, agents, wtrace = self._reports.popleft()
                except IndexError:
                    return
                try:
                    self._publish(report, tables, agents, wtrace)
                except Exception as exc:
                    log.error("federation report publish failed "
                              "(report lost): %s", exc)
                    if self._metrics is not None:
                        self._metrics.count_error("federation")
                finally:
                    wtrace.finish()
        finally:
            self._publish_lock.release()

    def _publish(self, report, tables: dict, agents: list, wtrace) -> None:
        with wtrace.stage("report_render"):
            obj = report_to_json(report,
                                 prev_heavy_index=self._prev_heavy_index,
                                 **self._report_kwargs)
            self._prev_heavy_index = heavy_identity_index(report)
            obj["Type"] = "federation_window_report"
            obj["Agents"] = agents
            obj["TimestampMs"] = time.time_ns() // 1_000_000
            heavy = {k: tables["heavy_" + k]
                     for k in ("words", "h1", "h2", "counts", "valid",
                               "prev_counts", "first_seen", "epoch")}
        with self._snap_lock:
            self._snap_seq += 1
            seq = self._snap_seq
        snap = {
            "window": obj["Window"],
            "ts_ms": obj["TimestampMs"],
            "seq": seq,
            "report": obj,
            "agents": {a: dict(v) for a, v in self._agents_view().items()},
            "cm_bytes": tables["cm_bytes"],
            "cm_pkts": tables["cm_pkts"],
            "heavy": heavy,
            "total_records": obj["Records"],
            "total_bytes": obj["Bytes"],
        }
        with self._snap_lock:
            self._snapshot = snap
        if self.alerts is not None:
            self.alerts.safe_evaluate(snap)
        m = self._metrics
        if m is not None:
            m.federation_active_agents.set(len(agents))
            m.sketch_window_reports_total.inc()
        if self._ckpt is not None:
            # the publish-commit marker, before the sink: a restore from an
            # older tensor checkpoint fast-forwards past this window id and
            # keeps the ledger it committed
            try:
                with self._lock:
                    meta = self._delivery_meta_locked()
                self._ckpt.save_publish_marker(obj["Window"], meta)
            except Exception as exc:
                log.error("publish marker write failed (a restart may "
                          "re-publish window %s): %s", obj["Window"], exc)
                if m is not None:
                    m.count_error("federation")
        if self._sink is not None:
            with wtrace.stage("report_sink"):
                self._sink(obj)
        # the cluster archive last, in its own try: the snapshot and the
        # sink committed, so a wedged archive disk loses only this merged
        # window's segment (counted) and stalls only the window thread
        if self.archive is not None:
            try:
                faultinject.fire("sketch.archive_write")
                self.archive.write_window(
                    {name: tables[name] for name, _ in fdelta.TABLE_SPEC},
                    window=int(obj["Window"]),
                    ts_ms=int(obj["TimestampMs"]))
            except Exception as exc:
                log.error("cluster archive write failed (window %s not "
                          "archived; report already published): %s",
                          obj["Window"], exc)
                if m is not None:
                    m.count_error("federation-archive")

    def _agents_view(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {a: {"frames": v["frames"], "window": v["window"],
                        "last_ms": v["last_ms"],
                        "staleness_s": round(now - v["last_mono"], 3),
                        "stale": (now - v["last_mono"])
                        > self._stale_after_s,
                        "epoch": self._ledger.get(a, {}).get("epoch", 0),
                        "window_seq": self._ledger.get(a, {})
                        .get("window_seq", 0),
                        "telemetry": v.get("telemetry")}
                    for a, v in self._agents.items()}

    def _update_fleet(self) -> None:
        """Rebuild and swap the published fleet snapshot (window thread,
        and `flush`)."""
        agents = self._agents_view()
        counts = {"agents": len(agents),
                  "stale": sum(1 for v in agents.values() if v["stale"]),
                  "overloaded": 0, "degraded": 0, "alerting": 0}
        for v in agents.values():
            conditions = (v.get("telemetry") or {}).get("conditions", ())
            if "OVERLOADED" in conditions:
                counts["overloaded"] += 1
            if "DEGRADED" in conditions:
                counts["degraded"] += 1
            if "ALERTING" in conditions:
                counts["alerting"] += 1
        with self._fleet_lock:
            self._fleet_seq += 1
            self._fleet = {"seq": self._fleet_seq,
                           "ts_ms": time.time_ns() // 1_000_000,
                           "window_s": self._window_s,
                           "stale_after_s": self._stale_after_s,
                           "counts": counts,
                           "agents": agents}

    def fleet(self) -> Optional[dict]:
        """The published fleet snapshot (None before the first rebuild)."""
        with self._fleet_lock:
            return self._fleet

    def _update_staleness(self) -> None:
        m = self._metrics
        if m is None:
            return
        for agent, info in self._agents_view().items():
            m.federation_agent_staleness_seconds.labels(agent).set(
                info["staleness_s"])

    def _evict_stale_agents(self) -> None:
        """Drop agents silent past `agent_ttl_s` (0 = never) from the
        agent view and the ledger, and delete their staleness series."""
        ttl = self._agent_ttl_s
        if not ttl:
            return
        now = time.monotonic()
        with self._lock:
            dead = [a for a, v in self._agents.items()
                    if now - v["last_mono"] > ttl]
            for a in dead:
                del self._agents[a]
                self._ledger.pop(a, None)
                self._window_agents.discard(a)
        m = self._metrics
        for a in dead:
            log.warning("evicting dark agent %r (no delta for > %.0fs)",
                        a, ttl)
            if m is not None:
                m.remove_labeled(m.federation_agent_staleness_seconds, a)
                m.federation_agent_evictions_total.inc()

    # --- query surface (host-side, never a device op) --------------------
    def snapshot(self) -> Optional[dict]:
        """The last closed window's published snapshot (None before the
        first publish)."""
        with self._snap_lock:
            return self._snapshot

    def status(self) -> dict:
        with self._lock:
            frames = self._frames_total
            window_agents = sorted(self._window_agents)
        snap = self.snapshot()
        out = {
            "frames_total": frames,
            "agents": self._agents_view(),
            "current_window_agents": window_agents,
            "last_published_window": None if snap is None
            else snap["window"],
            "window_s": self._window_s,
            "mesh": self.mesh is not None,
            "format_version": fdelta.DELTA_FORMAT_VERSION,
            "supported_versions": list(fdelta.SUPPORTED_VERSIONS),
            "agent_ttl_s": self._agent_ttl_s,
            "checkpointing": self._ckpt is not None,
        }
        if self.alerts is not None:
            out["alerts"] = self.alerts.summary()
        if self.archive is not None:
            out["archive"] = self.archive.stats()
        return out

    def query_frequency(self, src: str, dst: str, src_port: int = 0,
                        dst_port: int = 0, proto: int = 0) -> Optional[dict]:
        """CM point query with error bars against the last closed window's
        merged tables (the query core, host numpy only)."""
        snap = self.snapshot()
        if snap is None:
            return None
        from netobserv_tpu_torch.query import core as qcore
        return qcore.frequency_payload(snap, src, dst, src_port, dst_port,
                                       proto)

    # --- lifecycle -------------------------------------------------------
    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Close the current window now and publish synchronously."""
        with self._lock, self._on_device():
            self._close_window_locked()
        self._update_fleet()
        self._publish_queued(timeout_s)

    def close(self) -> None:
        """Stop the window thread, publish the last window (waiting at most
        10 s for the publish lock, which a hung checkpoint disk holds) and
        close the checkpointer."""
        self._closed.set()
        if self._timer is not None:
            self._timer.join(timeout=2.0)
        self.flush(timeout_s=10.0)
        if self._ckpt is not None:
            try:
                self._ckpt.close()
            except Exception as exc:
                log.error("checkpointer close failed: %s", exc)

    def kill(self) -> None:
        """Stop the window thread without the final flush, publish or
        checkpoint, as a crash would."""
        self._closed.set()
        if self._timer is not None:
            self._timer.join(timeout=2.0)
