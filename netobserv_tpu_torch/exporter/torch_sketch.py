"""The sketch exporter of the port, reduced to this slice.

Counterpart of `netobserv_tpu/exporter/tpu_sketch.py` (`TpuSketchExporter`
on one device). Flow records go in through one of three entry points, and
`roll` closes the window into a report dict (`exporter/report.report_to_json`,
with the previous roll's heavy-hitter index threaded so evicted keys are
named):

- `export_evicted` takes one map eviction (`datapath/fetcher.EvictedFlows`:
  flow events and their feature lanes) into a
  `sketch/staging.PendingEventBuffer`, which folds batch-aligned prefixes
  through the feed's staging ring and keeps each sub-batch tail for the
  next eviction, `flush` or `roll`;
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
batches builds no packer. On CUDA each fold runs as a CUDA graph
(`sketch/capture.py`) in one memory pool: the exporter's "fold_dense"
(captured at its first fold), the dense ring's "fold_dense_ring", the
compact ring's "fold_compact" and "fold_compact_dense", and one graph per
ladder entry, "fold_resident_lanes_x{k}", all captured by
`warm_superbatch_ladder` when the ring is made, before any fold: each
entry becomes selectable as its capture lands. A capture that fails
raises; nothing falls back to eager folds or to a smaller ladder.
`capture=False` folds eagerly, op by op, as the CPU always does, and every
ladder entry is selectable at once.

With `SketchConfig(tiered=TierSpec())` the state stays resident in tiered
form (`sketch/tiered.py`); folds, rolls and `state_tables` work the same,
and `counter_table_bytes` gives the resident bytes of the tier-covered
tables.

Not in this slice: overload control, the fold thread, federation,
archive, checkpoints, metrics and tracing.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from netobserv_tpu_torch import config
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.report import (
    heavy_identity_index, report_numpy, report_to_json,
)
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch import staging, tiered
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.utils.platform import pick_device

FEEDS = ("resident", "compact", "dense")


class TorchSketchExporter:
    """Folds flow records into one device-resident sketch state.

    `window_s` sets a window deadline: the first fold after it passes
    closes the window and returns the report (None otherwise).
    `decay_factor` / `reset_sketches` choose the roll mode as in
    `sketch.state.roll_window`. `folds` counts ingest dispatches (a
    superbatch of k batches is one), `records` the records handed to a
    fold, `rolls` the closed windows. `ring` is the feed's staging ring
    (module docstring; `resident_slots` slots a region, the packer
    `packer` names for the resident feed: "native", the default, or
    "python"), made at the feed's first use, and `pending` its
    `PendingEventBuffer`. On a CUDA device `capture` folds through CUDA
    graphs, listed in `captures`; the CPU folds eagerly."""

    def __init__(self, cfg: sk.SketchConfig = sk.SketchConfig(),
                 batch_size: int = 16384,
                 device: str | torch.device | None = None,
                 window_s: Optional[float] = None,
                 reset_sketches: bool = True,
                 decay_factor: Optional[float] = None,
                 sink: Optional[Callable[[dict], None]] = None,
                 packer: str = "native", capture: bool = True,
                 feed: str = "resident", pack_threads: int = 0,
                 superbatch=(1, 2, 4), resident_slots: int = 1 << 18):
        self.device = pick_device(device)
        cuda = self.device.type == "cuda"
        if packer not in ("native", "python"):
            raise ValueError(f"packer must be 'native' or 'python', not "
                             f"{packer!r}")
        if feed not in FEEDS:
            raise ValueError(f"feed must be one of {FEEDS}, not {feed!r}")
        self.cfg = cfg
        self.batch_size = batch_size
        self.window_s = window_s
        self.reset_sketches = reset_sketches
        self.decay_factor = decay_factor
        self.sink = sink
        self.feed = feed
        self.superbatch = config.parse_superbatch_ladder(superbatch)
        self.pack_threads = config.resolved_pack_threads(pack_threads)
        # pack lanes wanted: an auto count engages lanes only on a host of
        # at least 4 CPUs
        self._lane_threads = (self.pack_threads if pack_threads > 0
                              or (os.cpu_count() or 1) >= 4 else 1)
        self.resident_slots = resident_slots
        self.state = sk.init_state(cfg, self.device)
        words = batch_size * sk.DENSE_WORDS
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
                            if self._capture else None)
        self._prev_index: Optional[dict] = None
        self._deadline = self._next_deadline()
        self._closed = False
        self.folds = 0
        self.records = 0
        self.rolls = 0

    @property
    def captures(self) -> list[CapturedFold]:
        """The captured folds made so far: the dense entry's, and the
        ring's once it is made."""
        ring = self.ring.captures if self.ring is not None else []
        return [c for c in (self._fold_dense, *ring) if c is not None]

    def _next_deadline(self) -> Optional[float]:
        return (time.monotonic() + self.window_s
                if self.window_s is not None else None)

    def _maybe_roll(self) -> Optional[dict]:
        if self._deadline is not None and time.monotonic() >= self._deadline:
            return self.roll()
        return None

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("exporter is closed")

    def _ensure_ring(self) -> None:
        """Make the feed's ring and pending buffer at first use; the
        resident feed warms its ladder there."""
        if self.ring is not None:
            return
        kw = dict(device=self.device, enable_fanout=self.cfg.enable_fanout,
                  enable_asym=self.cfg.enable_asym, capture=self._capture,
                  graph_pool=self._pool, pack_threads=self.pack_threads)
        if self.feed == "resident":
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
            self.batch_size, getattr(ring, "superbatch_max", 1))
        self.ring = ring
        self.warm_superbatch_ladder()

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

    def export_evicted(self, evicted: EvictedFlows) -> Optional[dict]:
        """Take one eviction into the pending buffer, which folds its
        batch-aligned rows and keeps the sub-batch tail. Returns the window
        report if this call passed the window deadline, else None."""
        self._check_open()
        self._ensure_ring()
        self.pending.append(evicted, self._fold_events)
        return self._maybe_roll()

    def fold_events(self, events: np.ndarray, extra=None, dns=None,
                    drops=None, xlat=None, quic=None) -> Optional[dict]:
        """Fold raw flow events (`model/binfmt.FLOW_EVENT_DTYPE` rows, any
        count) and their optional feature lanes (`EXTRA_REC_DTYPE`,
        `DNS_REC_DTYPE`, `DROPS_REC_DTYPE`, `XLAT_REC_DTYPE`,
        `QUIC_REC_DTYPE`, row for row) as one eviction
        (`export_evicted`)."""
        return self.export_evicted(EvictedFlows(
            events, dns=dns, drops=drops, extra=extra, xlat=xlat, quic=quic))

    def _fold_events(self, events: np.ndarray, feats: dict) -> None:
        chunks = self.ring.chunks
        self.ring.fold(self.state, events, **feats)
        self.folds += self.ring.chunks - chunks
        self.records += len(events)

    def flush(self) -> None:
        """Fold the pending buffer's tail (a partial batch)."""
        self._check_open()
        if self.pending is not None:
            self.pending.flush_to(self._fold_events)

    def fold_dense(self, flat: np.ndarray) -> Optional[dict]:
        """Fold a flat uint32 dense feed (rows of 20 words, any row count;
        it folds in batches of `batch_size`). Returns the window report if
        this call passed the window deadline, else None."""
        self._check_open()
        flat = np.asarray(flat).reshape(-1).view(np.uint32)
        if flat.size % sk.DENSE_WORDS:
            raise ValueError(f"dense feed of {flat.size} words is not whole "
                             f"{sk.DENSE_WORDS}-word rows")
        step = self.batch_size * sk.DENSE_WORDS
        for lo in range(0, flat.size, step):
            self._fold_one(flat[lo:lo + step])
        self.records += flat.size // sk.DENSE_WORDS
        return self._maybe_roll()

    def _fold_one(self, chunk: np.ndarray) -> None:
        if self._copied is not None:
            self._copied.synchronize()  # the last copy out of _host is done
        n = chunk.size
        self._host_u32[:n] = chunk
        self._host_u32[n:] = 0  # zero rows are invalid (word 14 == 0)
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        if self._fold_dense is not None:
            self._fold_dense(self.state, self._dev)
        else:
            self._ingest_dense(self.state, self._dev)
        self.folds += 1

    def _ingest_dense(self, state, dev: torch.Tensor):
        return sk.ingest(state, sk.dense_to_arrays(dev),
                         enable_fanout=self.cfg.enable_fanout,
                         enable_asym=self.cfg.enable_asym)

    def state_tables(self) -> dict[str, np.ndarray]:
        """The current (pre-roll) mergeable tables, on the host."""
        return sk.state_tables(self.state)

    def counter_table_bytes(self) -> dict[str, int]:
        """Resident bytes of each tier-covered table (CM planes, HLL
        banks), read from the state's tensors."""
        return tiered.counter_table_bytes(self.state)

    def roll(self) -> dict:
        """Close the window: fold the pending buffer's tail, render the
        report, roll the state, pass the report to the sink and return
        it."""
        self.flush()
        _, report = sk.roll_window(self.state, self.cfg, self.reset_sketches,
                                   self.decay_factor)
        host = report_numpy(report)
        out = report_to_json(host, prev_heavy_index=self._prev_index)
        self._prev_index = heavy_identity_index(host)
        self.rolls += 1
        self._deadline = self._next_deadline()
        if self.sink is not None:
            self.sink(out)
        return out

    def close(self) -> None:
        """Wait for outstanding device work and drop the buffers, the
        ring's pinned buffers and the captured graphs included. Rows still
        pending are dropped with the window's state: `roll` first to keep
        them."""
        if self._closed:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._closed = True
        if self.ring is not None:
            self.ring.close()
        self.pending = None
        self._fold_dense = None
        self._host = self._host_u32 = self._dev = None
