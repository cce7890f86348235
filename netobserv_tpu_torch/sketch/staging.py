"""Host-to-device staging rings of the three feeds, and the pending-event
buffer in front of them.

Counterpart of `netobserv_tpu/sketch/staging.py` (`default_spill_cap`,
`pick_lanes`, `PendingEventBuffer`, `_SlotRing`, `DenseStagingRing`,
`ShardedResidentStagingRing` at one shard, `ResidentStagingRing`), on one
device. A small ring of pinned host buffers lets chunk i+1 be packed while
chunk i's copy to the device is in flight.

Slot protocol: each slot has a pinned host buffer (viewed as uint32 for the
packer); the slots share one device buffer. A chunk is copied into it (or
into its prefix) with `non_blocking=True` on the current stream, and a CUDA
event is recorded after the copy. Before a slot is packed again its event
is synchronized, so the packer never writes a pinned buffer that a copy
still reads. The device buffer needs no guard: each copy into it and the
fold that reads it run on one stream, in order, so a device buffer per slot
would overlap nothing, and one buffer lets one captured fold
(`sketch/capture.py`) serve every slot. On the CPU the copy is synchronous
and no event is kept.

- `DenseStagingRing` ships the dense feed (80 B a record), or with
  `spill_cap` the compact feed (40 B a v4 record) and, for a batch whose
  non-v4 rows pass the spill lane, the dense feed from a buffer of its own,
  synchronously (`dense_fallbacks`).
- `ShardedResidentStagingRing` ships the resident feed split into pack
  lanes, each with its own dictionary and device key table, packed in
  parallel threads, and folds k queued batches in one dispatch through its
  superbatch ladder. At one lane and the ladder (1,) it ships what
  `ResidentStagingRing` ships.
- `PendingEventBuffer` coalesces evictions into batch-aligned folds.

The reference's seams (`sketch/staging.py:108-170`, `:251-329`,
`:443-444`, `:650-680`): every ring and the pending buffer take an
optional `metrics` facade (`metrics/registry.Metrics`) and count
`sketch_direct_fold_rows_total`, `sketch_staging_stalls_total`,
`sketch_slot_wait_seconds`, `sketch_resident_continuations_total`,
`sketch_resident_dict_epochs_total`, `sketch_resident_spill_rows_total`,
`sketch_superbatch_folds_total{k}` and `sketch_dense_fallback_total`
where the reference does. Every ring's `fold` takes `trace=`, the
caller's trace (`utils/tracing`), and records its spans on it:
`staging_wait` (a slot wait that stalled), `pack` (dense and compact),
`resident_pack` and `ingest_dispatch`; with no trace given it samples one
of its own (`_fold_trace`) and finishes only that one. `_wait_slot` fires
the `sketch.staging_wait` fault point (`utils/faultinject`).

A ring's `fold` raises whatever its pack or dispatch raises: containment
is the exporter's (`exporter/torch_sketch.py`), as in the reference.

The slot-wait budget (reference `StagingWedged`, `_SlotRing`'s
`slot_wait_budget_s` and its bounded wait, `sketch/staging.py:33-50`,
`:250-329`): with `slot_wait_budget_s` set (the exporter sets it when an
overload controller exists), `_wait_slot` polls the slot's copy event
(`query()`, 2 ms apart) until the budget runs out, then records the wait
and raises `StagingWedged`, leaving the event in place, so a later fold
waits on it again. Every ring raises it at a chunk boundary before it
packs, so no dictionary slot is committed for the rows it drops
(reference `:402`, `:612`, `:889`); `StagingWedged.state` is the state the
ring was folding into, which the port updates in place, so it holds
exactly the chunks that dispatched before the wait tripped. The token a
slot waits on is its host-to-device copy event, which follows everything
queued on the stream before it; the reference's is the ingest that read
the slot (ROADMAP C5).

Not here: the sharded rings of a mesh (A6), and
`ShardedResidentStagingRing.fold_packed` with `ResidentPackSurface`,
which need the reference's fused drain pipeline (A7).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from netobserv_tpu_torch.datapath import flowpack
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.utils import faultinject, tracing
from netobserv_tpu_torch.utils.platform import pick_device


class StagingWedged(RuntimeError):
    """A fold waited past its ring's slot-wait budget: the device, or its
    copy stream, is wedged (reference `sketch/staging.py:33-50`). Raised
    only when `slot_wait_budget_s` is set; the exporter catches it, drops
    the rows not yet packed (counted, no dictionary epoch roll) and keeps
    the eviction feed's cadence. `state` is the state the ring was folding
    into: the port updates it in place, so it is the caller's own object,
    holding the chunks that dispatched before the trip."""

    state = None


def default_spill_cap(batch_size: int) -> int:
    """Spill-lane rows of the compact feed: 1/8 of the batch (a batch
    whose non-v4 rows pass it ships dense)."""
    return max(batch_size // 8, 64)


def pick_lanes(per_unit: int, want: int) -> int:
    """The largest lane count <= `want` that divides `per_unit` evenly
    (lane regions need one fixed shape)."""
    lanes = max(1, min(want, per_unit))
    while per_unit % lanes:
        lanes -= 1
    return lanes


def _pick_packer(packer: str, slot_cap: int):
    """(dictionary factory, pack function) of the packer `packer` names:
    "native" (`NativeKeyDict`, `pack_resident_native`) or "python"
    (`KeyDict`, `pack_resident`)."""
    if packer == "native":
        flowpack.native_lib()  # a packer that cannot be built raises here
        return (functools.partial(flowpack.NativeKeyDict, slot_cap),
                flowpack.pack_resident_native)
    if packer == "python":
        return (functools.partial(flowpack.KeyDict, slot_cap),
                flowpack.pack_resident)
    raise ValueError(f"packer must be 'native' or 'python', not {packer!r}")


def _bytes(a: np.ndarray) -> np.ndarray:
    """A contiguous record array as (rows, itemsize) uint8."""
    return a.view(np.uint8).reshape(len(a), a.dtype.itemsize)


def _set_rows(dst: np.ndarray, lo: int, src: np.ndarray) -> None:
    """dst[lo:lo + len(src)] = src, as one copy of bytes where both hold
    one record dtype contiguously (numpy copies overlapping rows through a
    temporary); a source of another dtype or layout converts field by
    field."""
    if src.dtype == dst.dtype and src.flags.c_contiguous:
        _bytes(dst)[lo:lo + len(src)] = _bytes(src)
    else:
        dst[lo:lo + len(src)] = src


def _zero_rows(a: np.ndarray, lo: int, hi: int) -> None:
    """a[lo:hi] = 0, as bytes."""
    _bytes(a)[lo:hi] = 0


class PendingEventBuffer:
    """A preallocated rolling buffer for queued evictions: each arriving row
    is copied once into fixed arrays, and the fold gets prefix views.

    `superbatch_max > 1` sizes the buffer for that many batches, so rows
    that arrive together (one large eviction, or queued ones delivered at
    once) fold as one k-batch prefix, which the lane ring dispatches as one
    superbatch. Small evictions fold as soon as a full batch is buffered;
    the sub-batch tail waits for the next eviction or `flush_to`.

    A feature lane is passed to the fold iff an eviction in the folded rows
    carried it, with zero rows for evictions that lacked it (`_live` keeps
    each lane's liveness, so an untouched lane costs nothing).

    Direct path: when the buffer is empty and an eviction's feature lanes
    are row for row with its events, its batch-aligned prefix folds from
    views of the eviction's own arrays, in capacity-sized chunks, and only
    the sub-batch tail is copied in (`direct_rows` counts the rows that
    skipped the copy). The fold must finish reading its views before it
    returns: every ring packs them into a pinned slot synchronously.

    A fold that raises drops only the rows it was given; the rows still
    buffered stay. Counterpart of the reference's `PendingEventBuffer`
    (`sketch/staging.py:66-238`); with `metrics` the direct rows also go
    to `sketch_direct_fold_rows_total`. Rows move as bytes
    (`_set_rows`): numpy's assignment of structured rows, field by field,
    is some 20x slower than the memcpy of the same bytes."""

    LANES = (("extra", binfmt.EXTRA_REC_DTYPE),
             ("dns", binfmt.DNS_REC_DTYPE),
             ("drops", binfmt.DROPS_REC_DTYPE),
             ("xlat", binfmt.XLAT_REC_DTYPE),
             ("quic", binfmt.QUIC_REC_DTYPE))

    def __init__(self, batch_size: int, superbatch_max: int = 1,
                 metrics=None):
        self.batch_size = batch_size
        self.capacity = batch_size * max(1, superbatch_max)
        self.n = 0
        self.events = np.zeros(self.capacity, binfmt.FLOW_EVENT_DTYPE)
        self._lanes = {name: np.zeros(self.capacity, dt)
                       for name, dt in self.LANES}
        self._live = {name: False for name, _ in self.LANES}
        self._metrics = metrics
        #: rows folded from views of an eviction's arrays (no copy)
        self.direct_rows = 0

    def __len__(self) -> int:
        return self.n

    def _lanes_aligned(self, evicted, n: int) -> bool:
        """Whether every present feature lane covers all n event rows (a
        short lane needs the buffer's zero rows: the copy path)."""
        for name, _ in self.LANES:
            col = getattr(evicted, name, None)
            if col is not None and len(col) and len(col) != n:
                return False
        return True

    def append(self, evicted, fold: Callable) -> None:
        """Take `evicted` (a `datapath/fetcher.EvictedFlows`): fold its
        batch-aligned prefix directly where the direct path's gate holds,
        copy the rest in, and fire `fold(events, feats)` with views of the
        buffer for every full batch buffered, as one batch-aligned prefix;
        the sub-batch tail stays buffered."""
        ev = evicted.events
        off = 0
        if self.n == 0 and len(ev) >= self.batch_size \
                and self._lanes_aligned(evicted, len(ev)):
            while len(ev) - off >= self.batch_size:
                take = min(len(ev) - off, self.capacity)
                take -= take % self.batch_size
                feats = {}
                for name, _ in self.LANES:
                    col = getattr(evicted, name, None)
                    feats[name] = (col[off:off + take]
                                   if col is not None and len(col) else None)
                try:
                    fold(ev[off:off + take], feats)
                except BaseException:
                    # a raising fold drops its chunk; the rest still
                    # buffers, and the dropped rows never count as direct
                    self._copy_in(evicted, off + take, fold)
                    raise
                off += take
                self.direct_rows += take
                if self._metrics is not None:
                    self._metrics.sketch_direct_fold_rows_total.inc(take)
            if off == len(ev):
                return
        self._copy_in(evicted, off, fold)

    def _copy_in(self, evicted, off: int, fold: Callable) -> None:
        """The copy path: buffer `evicted`'s rows from `off` on, folding
        whenever the buffer fills, then fold the batch-aligned prefix."""
        ev = evicted.events
        while off < len(ev):
            take = min(len(ev) - off, self.capacity - self.n)
            lo, hi = self.n, self.n + take
            _set_rows(self.events, lo, ev[off:off + take])
            for name, _ in self.LANES:
                col = getattr(evicted, name, None)
                lane = self._lanes[name]
                if col is not None and len(col):
                    if not self._live[name]:
                        _zero_rows(lane, 0, lo)  # earlier evictions lacked it
                        self._live[name] = True
                    c = col[off:off + take]
                    _set_rows(lane, lo, c)
                    _zero_rows(lane, lo + len(c), hi)  # a short lane's tail
                elif self._live[name]:
                    _zero_rows(lane, lo, hi)
            self.n += take
            off += take
            if self.n == self.capacity:
                self.flush_to(fold)
        full = self.n - self.n % self.batch_size
        if full:
            self._fold_prefix(fold, full)

    def flush_to(self, fold: Callable) -> None:
        """Fold whatever is buffered (a partial batch pads downstream) and
        empty the buffer; nothing when it is empty. The buffer is emptied
        before the fold, so a fold that raises leaves nothing to fold
        twice."""
        if not self.n:
            return
        n = self.n
        feats = {name: (self._lanes[name][:n] if self._live[name] else None)
                 for name, _ in self.LANES}
        self.n = 0
        for name, _ in self.LANES:
            self._live[name] = False
        fold(self.events[:n], feats)

    def _fold_prefix(self, fold: Callable, rows: int) -> None:
        """Fold the batch-aligned `rows` prefix, then slide the tail to the
        front; a fold that raises still drops the prefix and keeps the
        tail."""
        n = self.n
        feats = {name: (self._lanes[name][:rows] if self._live[name]
                        else None) for name, _ in self.LANES}
        try:
            fold(self.events[:rows], feats)
        finally:
            tail = n - rows
            if tail:
                _set_rows(self.events, 0, self.events[rows:n])
                for name, _ in self.LANES:
                    if self._live[name]:
                        lane = self._lanes[name]
                        _set_rows(lane, 0, lane[rows:n])
            else:
                for name, _ in self.LANES:
                    self._live[name] = False
            self.n = tail


class _SlotRing:
    """The slot protocol of the module docstring, shared by the rings."""

    #: recent slot-wait samples kept for `slot_wait_p95`
    WAIT_WINDOW = 64

    def _init_slots(self, n_slots: int, words: int,
                    device: torch.device, metrics) -> None:
        cuda = device.type == "cuda"
        self.device = device
        self._metrics = metrics
        self._host = [torch.zeros(words, dtype=torch.int32, pin_memory=cuda)
                      for _ in range(n_slots)]
        self._bufs = [h.numpy().view(np.uint32) for h in self._host]
        self._dev = torch.zeros(words, dtype=torch.int32, device=device)
        self._copied: list[Optional[torch.cuda.Event]] = [None] * n_slots
        self._slot = 0
        self.stalls = 0
        #: the longest one fold waits for a slot, in seconds (None: no
        #: bound); past it `_wait_slot` raises `StagingWedged`
        self.slot_wait_budget_s: Optional[float] = None
        self._waits = np.zeros(self.WAIT_WINDOW, np.float64)
        self._wait_i = 0
        self._wait_n = 0

    def _record_wait(self, seconds: float) -> None:
        self._waits[self._wait_i] = seconds
        self._wait_i = (self._wait_i + 1) % self.WAIT_WINDOW
        self._wait_n = min(self._wait_n + 1, self.WAIT_WINDOW)

    def slot_wait_p95(self) -> float:
        """p95 of the last WAIT_WINDOW slot waits (0.0 before any)."""
        if not self._wait_n:
            return 0.0
        return float(np.percentile(self._waits[:self._wait_n], 95))

    def _fold_trace(self, trace):
        """A fold's trace and whether the ring owns it: the caller's (it
        finishes it), else one sampled here, which the ring finishes
        (reference `_fold_trace`, `sketch/staging.py:280-288`)."""
        if trace is not None:
            return trace, False
        return tracing.start_trace("fold"), True

    def _wait_slot(self, trace=tracing.NULL_TRACE) -> int:
        """The next slot, once the copy out of its host buffer is done. A
        hang armed at the `sketch.staging_wait` fault point models a
        wedged copy stalling the feed here. With `slot_wait_budget_s` the
        wait polls the copy event and raises `StagingWedged` past the
        budget, the event left in place (reference `:290-329`)."""
        faultinject.fire("sketch.staging_wait")
        slot = self._slot
        ev = self._copied[slot]
        wait_s = 0.0
        if ev is not None and not ev.query():
            self.stalls += 1
            if self._metrics is not None:
                self._metrics.sketch_staging_stalls_total.inc()
            t0 = time.perf_counter()
            with trace.stage("staging_wait"):
                budget = self.slot_wait_budget_s
                if budget is None:
                    ev.synchronize()
                else:
                    deadline = t0 + budget
                    while not ev.query():
                        if time.perf_counter() >= deadline:
                            self._record_wait(time.perf_counter() - t0)
                            raise StagingWedged(
                                f"staging slot busy past the {budget:.2f}s "
                                "slot-wait budget (device or copy wedged)")
                        time.sleep(0.002)
            wait_s = time.perf_counter() - t0
            if self._metrics is not None:
                self._metrics.sketch_slot_wait_seconds.observe(wait_s)
        self._record_wait(wait_s)
        return slot

    def _ship(self, slot: int, words: Optional[int] = None) -> torch.Tensor:
        """Copy the slot's host buffer, or its first `words` words, to the
        device buffer (without blocking on CUDA) and return the device
        buffer, or its prefix view."""
        dev, host = self._dev, self._host[slot]
        if words is not None:
            dev, host = dev[:words], host[:words]
        dev.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            ev = self._copied[slot] or torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[slot] = ev
        return dev

    def _advance(self, slot: int) -> None:
        self._slot = (slot + 1) % len(self._bufs)

    def drain(self) -> None:
        """Block until every copy out of a host buffer is done."""
        for ev in self._copied:
            if ev is not None:
                ev.synchronize()

    def close(self) -> None:
        """Drain, then drop the pinned and device buffers."""
        self.drain()
        self._host = self._bufs = []
        self._dev = None
        self._copied = []


class ResidentStagingRing(_SlotRing):
    """Staging ring for the resident feed: 15.4 B per record at B = 16,384
    when a fold fits one chunk (251,920 B), against the dense feed's 80.
    The host keeps the key -> slot dictionary, the device the matching key
    table (`sketch.state.init_key_table`), which `fold` threads through
    `sketch.state.ingest_resident`.

    `packer` picks the dictionary and its packer: "native" (the default on
    every device: `flowpack.NativeKeyDict` with `pack_resident_native`) or
    "python" (`flowpack.KeyDict` with `pack_resident`, the layout oracle).
    A native packer that cannot be built or loaded raises; the ring never
    falls back to the Python one. On a CUDA device `capture` folds each
    chunk by replaying one CUDA graph (`sketch/capture.py`, "fold_resident",
    with its memory from `graph_pool` if given); the CPU folds eagerly.

    The packer packs until a lane fills and says how many rows it used; the
    ring ships that self-consistent prefix and continues from the stop row
    in the next slot, so the dictionary and the device table learn
    monotonically under cold-start key floods, with no fallback. A full
    dictionary starts a new epoch (reset) before the next chunk; stale
    device-table rows are harmless, because every live slot is redefined
    through the new-key lane before a hot row references it.

    Counters: `continuations` (chunks beyond one per `fold`), `dict_resets`
    (epochs), `spill_rows` (rows that rode the spill lane), `chunks`
    (regions shipped) and `pack_seconds` (host time in the packer)."""

    def __init__(self, batch_size: int,
                 caps: Optional[flowpack.ResidentCaps] = None,
                 slot_cap: int = 1 << 18, n_slots: int = 4,
                 device: str | torch.device | None = None,
                 enable_fanout: bool = True, enable_asym: bool = True,
                 packer: str = "native", capture: bool = True,
                 graph_pool=None, metrics=None):
        self.batch_size = batch_size
        self.caps = caps or flowpack.default_resident_caps(batch_size)
        self.enable_fanout = enable_fanout
        self.enable_asym = enable_asym
        dev = pick_device(device)
        make_dict, self._pack = _pick_packer(packer, slot_cap)
        self.kdict = make_dict()
        self.slot_cap = slot_cap
        self.key_table = sk.init_key_table(slot_cap, dev)
        #: the captured fold (`capture` on a CUDA device), else None
        self.captured = (CapturedFold("fold_resident", self._ingest,
                                      graph_pool)
                         if capture and dev.type == "cuda" else None)
        self.continuations = 0
        self.dict_resets = 0
        self.spill_rows = 0
        self.chunks = 0
        self.pack_seconds = 0.0
        self._init_slots(n_slots,
                         flowpack.resident_buf_len(batch_size, self.caps),
                         dev, metrics)

    def _ingest(self, state, key_table: torch.Tensor, flat: torch.Tensor):
        return sk.ingest_resident(state, key_table, flat, self.batch_size,
                                  self.caps, enable_fanout=self.enable_fanout,
                                  enable_asym=self.enable_asym)

    def fold(self, state, events: np.ndarray, extra=None, dns=None,
             drops=None, xlat=None, quic=None, trace=None):
        """Pack `events` (flow event rows, `model/binfmt.FLOW_EVENT_DTYPE`,
        with optional feature lanes row for row) into ring slots in one or
        more chunks, ship and ingest each, with spans on `trace`. Returns
        `state`, updated in place; the device work is not waited for."""
        feats = dict(extra=extra, dns=dns, drops=drops, xlat=xlat, quic=quic)
        n = len(events)
        if n == 0:
            return state
        m = self._metrics
        trace, owned = self._fold_trace(trace)
        try:
            start = 0
            while start < n:
                if self.kdict.count() >= self.slot_cap:
                    self.kdict.reset()
                    self.dict_resets += 1
                    if m is not None:
                        m.sketch_resident_dict_epochs_total.inc()
                try:
                    slot = self._wait_slot(trace)
                except StagingWedged as exc:
                    exc.state = state  # the chunks before it dispatched
                    raise
                t0 = time.perf_counter()
                with trace.stage("resident_pack"):
                    buf, consumed = self._pack(
                        events, batch_size=self.batch_size, kdict=self.kdict,
                        caps=self.caps, start=start, out=self._bufs[slot],
                        **feats)
                self.pack_seconds += time.perf_counter() - t0
                if consumed == 0:
                    raise RuntimeError("resident pack made no progress")
                self.spill_rows += int(buf[2])
                self.continuations += start > 0
                if m is not None:
                    if buf[2]:
                        m.sketch_resident_spill_rows_total.inc(int(buf[2]))
                    if start > 0:
                        m.sketch_resident_continuations_total.inc()
                start += consumed
                with trace.stage("ingest_dispatch"):
                    flat = self._ship(slot)
                    if self.captured is not None:
                        self.captured(state, self.key_table, flat)
                    else:
                        state = self._ingest(state, self.key_table, flat)
                self.chunks += 1
                self._advance(slot)
            return state
        finally:
            if owned:
                trace.finish()

    def close(self) -> None:
        """Drain, then drop the buffers and the captured fold."""
        super().close()
        self.captured = None


class DenseStagingRing(_SlotRing):
    """Staging ring of the dense feed, or with `spill_cap` of the compact
    feed.

    Dense: each slot holds one batch of DENSE_WORDS-word rows, packed by
    `flowpack.pack_dense_sharded` over `pack_threads` threads and folded
    by `sketch.state.ingest` after `dense_to_arrays`.

    Compact: each slot holds `flowpack.pack_compact`'s buffer (v4 rows of
    COMPACT_WORDS words and `spill_cap` dense rows), folded after
    `compact_to_arrays`. A batch whose non-v4 rows pass the spill lane
    ships dense from a pinned buffer and a device buffer of its own,
    synchronously: the fold is waited for before `fold` returns
    (`dense_fallbacks` counts those batches).

    On a CUDA device `capture` folds each slot by replaying one CUDA graph
    (`sketch/capture.py`): "fold_dense_ring" for the dense feed,
    "fold_compact" and "fold_compact_dense" (the fallback's) for the
    compact feed, with their memory from `graph_pool` if given; `warm`
    captures them before any fold (the exporter calls it when it makes the
    ring, so a capture that fails raises there), else each captures at its
    first fold. Counters:
    `chunks` (ingest dispatches), `dense_fallbacks`, `stalls`,
    `slot_wait_p95` and `pack_seconds` (host time in the packer).
    Counterpart of the reference's `DenseStagingRing`
    (`sketch/staging.py:349-453`), on one device."""

    def __init__(self, batch_size: int, spill_cap: Optional[int] = None,
                 n_slots: int = 4, device: str | torch.device | None = None,
                 enable_fanout: bool = True, enable_asym: bool = True,
                 pack_threads: int = 1, capture: bool = True,
                 graph_pool=None, metrics=None):
        dev = pick_device(device)
        flowpack.native_lib()  # a packer that cannot be built raises here
        self.batch_size = batch_size
        self.spill_cap = spill_cap
        self.pack_threads = pack_threads
        self.enable_fanout = enable_fanout
        self.enable_asym = enable_asym
        self._capture = capture and dev.type == "cuda"
        self._pool = graph_pool
        if spill_cap is None:
            words = batch_size * sk.DENSE_WORDS
            self._fold_fn, name = self._ingest_dense, "fold_dense_ring"
        else:
            words = flowpack.compact_buf_len(batch_size, spill_cap)
            self._fold_fn, name = self._ingest_compact, "fold_compact"
        #: the captured fold of the slots (`capture` on CUDA), else None
        self.captured = (CapturedFold(name, self._fold_fn, graph_pool)
                         if self._capture else None)
        #: the compact feed's dense fallback: pinned and device buffers
        #: and captured fold, made at the first fallback
        self._fb_host: Optional[torch.Tensor] = None
        self._fb_dev: Optional[torch.Tensor] = None
        self.captured_fallback: Optional[CapturedFold] = None
        self.dense_fallbacks = 0
        self.chunks = 0
        self.pack_seconds = 0.0
        self._init_slots(n_slots, words, dev, metrics)

    @property
    def captures(self) -> list[CapturedFold]:
        """The ring's captured folds so far (none on the CPU)."""
        return [c for c in (self.captured, self.captured_fallback)
                if c is not None]

    def _ingest_dense(self, state, flat: torch.Tensor):
        return sk.ingest(state, sk.dense_to_arrays(flat),
                         enable_fanout=self.enable_fanout,
                         enable_asym=self.enable_asym)

    def warm(self, state) -> None:
        """Capture the ring's graphs against `state` (on CUDA with
        `capture`: warm-up on clones and the capture, no fold): the
        slots', and the compact feed's dense fallback's with its
        buffers."""
        if not self._capture:
            return
        self.captured.prepare(state, self._dev)
        if self.spill_cap is not None:
            self._fallback_buffers()
            self.captured_fallback.prepare(state, self._fb_dev)

    def _fallback_buffers(self) -> None:
        """The dense fallback's pinned and device buffers and captured
        fold, made once."""
        if self._fb_host is not None:
            return
        cuda = self.device.type == "cuda"
        words = self.batch_size * sk.DENSE_WORDS
        self._fb_host = torch.zeros(words, dtype=torch.int32,
                                    pin_memory=cuda)
        self._fb_dev = torch.zeros(words, dtype=torch.int32,
                                   device=self.device)
        if self._capture:
            self.captured_fallback = CapturedFold(
                "fold_compact_dense", self._ingest_dense, self._pool)

    def _ingest_compact(self, state, flat: torch.Tensor):
        return sk.ingest_compact(state, flat, self.batch_size, self.spill_cap,
                                 enable_fanout=self.enable_fanout,
                                 enable_asym=self.enable_asym)

    def _dispatch(self, captured: Optional[CapturedFold], fn: Callable,
                  state, flat: torch.Tensor):
        if captured is not None:
            captured(state, flat)
        else:
            fn(state, flat)
        self.chunks += 1

    def fold(self, state, events: np.ndarray, extra=None, dns=None,
             drops=None, xlat=None, quic=None, trace=None):
        """Pack `events` (at most `batch_size` rows) into the next free
        slot, ship and ingest it, with spans on `trace`. Returns `state`,
        updated in place; the device work is not waited for, except on the
        dense fallback."""
        feats = dict(extra=extra, dns=dns, drops=drops, xlat=xlat, quic=quic)
        trace, owned = self._fold_trace(trace)
        try:
            try:
                slot = self._wait_slot(trace)
            except StagingWedged as exc:
                exc.state = state  # nothing dispatched
                raise
            t0 = time.perf_counter()
            with trace.stage("pack"):
                if self.spill_cap is not None:
                    buf = flowpack.pack_compact(
                        events, batch_size=self.batch_size,
                        spill_cap=self.spill_cap, out=self._bufs[slot],
                        **feats)
                else:
                    buf = flowpack.pack_dense_sharded(
                        events, batch_size=self.batch_size,
                        threads=self.pack_threads,
                        out=self._bufs[slot].reshape(self.batch_size,
                                                     sk.DENSE_WORDS),
                        **feats)
            self.pack_seconds += time.perf_counter() - t0
            if buf is None:
                return self._fold_dense_fallback(state, events, feats)
            with trace.stage("ingest_dispatch"):
                self._dispatch(self.captured, self._fold_fn, state,
                               self._ship(slot))
            self._advance(slot)
            return state
        finally:
            if owned:
                trace.finish()

    def _fold_dense_fallback(self, state, events: np.ndarray, feats: dict):
        """The compact feed's batch whose non-v4 rows pass the spill lane,
        shipped dense from the fallback's own buffers and waited for."""
        self.dense_fallbacks += 1
        if self._metrics is not None:
            self._metrics.sketch_dense_fallback_total.inc()
        self._fallback_buffers()
        t0 = time.perf_counter()
        flowpack.pack_dense_sharded(
            events, batch_size=self.batch_size, threads=self.pack_threads,
            out=self._fb_host.numpy().view(np.uint32).reshape(
                self.batch_size, sk.DENSE_WORDS), **feats)
        self.pack_seconds += time.perf_counter() - t0
        self._fb_dev.copy_(self._fb_host, non_blocking=True)
        self._dispatch(self.captured_fallback, self._ingest_dense, state,
                       self._fb_dev)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return state

    def close(self) -> None:
        """Drain, then drop the buffers and the captured folds."""
        super().close()
        self.captured = self.captured_fallback = None
        self._fb_host = self._fb_dev = None


class ShardedResidentStagingRing(_SlotRing):
    """Staging ring of the resident feed split into pack lanes, with the
    superbatch ladder, on one device (one shard). Counterpart of the
    reference's `ShardedResidentStagingRing` (`sketch/staging.py:456-682`)
    at `n_shards == 1`; more shards raise (ROADMAP A6, multi-GPU).

    Lanes: a batch splits into `lanes` contiguous row blocks, each packed
    by its own dictionary into its own resident region (caps for
    batch_size / lanes rows); `pack_threads > 1` packs the regions in a
    thread pool (`flowpack._pack_submit`: the native pack releases the GIL,
    so the regions pack at once). Each region has its own device key table,
    a row of `key_tables` (`sketch.state.init_key_tables`); one ingest
    folds all of a chunk's regions (`sketch.state.ingest_resident_lanes`).

    Ladder (`ladder=(1, 2, 4)`): a fold of k queued batches' rows (the
    exporter's `PendingEventBuffer` coalesces up to `superbatch_max`) packs
    into k * lanes regions and ships and folds as one dispatch of ladder
    entry k, the largest selectable entry whose k batches the rows fill.
    Each entry has its own fixed shapes; all share one device buffer and
    one key-table array sized for the largest, and region i of any chunk
    packs with dictionary `(i // kl) * kmax_l + (i % kl)` (kl = k * lanes,
    kmax_l = superbatch_max * lanes), so a region's dictionary and its
    device table row stay paired whatever k. With `lazy_ladder` only
    entry 1 is selectable until `mark_warm` names the others (the
    exporter warms them first, so no live fold captures).

    On a CUDA device `capture` folds each entry by replaying its own CUDA
    graph (`sketch/capture.py`, "fold_resident_lanes_x{k}", the reference's
    "ingest_resident_lanes_x{k}"), bound to the prefix view of the device
    buffer that entry ships. The packer, the continuation chunks (a region
    whose lane fills continues in the next slot; an exhausted region of a
    continuation chunk ships empty, `flowpack.zero_resident_region`) and
    the dictionary epochs are `ResidentStagingRing`'s, per region.

    Counters: `continuations`, `dict_resets`, `spill_rows`,
    `superbatch_folds` (dispatches by k), `stalls`, `slot_wait_p95`, and
    `chunks` (ingest dispatches) and `pack_seconds` (host wall time of the
    packs)."""

    def __init__(self, batch_size: int, n_shards: int = 1,
                 caps: Optional[flowpack.ResidentCaps] = None,
                 slot_cap: int = 1 << 18, n_slots: int = 4,
                 device: str | torch.device | None = None,
                 enable_fanout: bool = True, enable_asym: bool = True,
                 packer: str = "native", capture: bool = True,
                 graph_pool=None, pack_threads: int = 1, lanes: int = 1,
                 ladder: tuple = (1,), lazy_ladder: bool = False,
                 metrics=None):
        if n_shards != 1:
            raise NotImplementedError(
                "a resident ring over several shards needs the mesh, which "
                "the port does not have yet (ROADMAP A6, multi-GPU)")
        self.ladder = tuple(sorted({int(k) for k in ladder}))
        if not self.ladder or self.ladder[0] != 1:
            raise ValueError("superbatch ladder must include 1")
        if batch_size % lanes:
            raise ValueError("batch_size must divide evenly over lanes")
        dev = pick_device(device)
        make_dict, self._pack = _pick_packer(packer, slot_cap)
        self.superbatch_max = self.ladder[-1]
        self._available = {1} if lazy_ladder else set(self.ladder)
        self.batch_size = batch_size
        self.n_shards = n_shards
        self.lanes = lanes
        #: regions of one batch (a k-superbatch packs k * n_regions)
        self.n_regions = n_shards * lanes
        self.batch_per_region = batch_size // self.n_regions
        self.caps = caps or flowpack.default_resident_caps(
            self.batch_per_region)
        self.slot_cap = slot_cap
        self.pack_threads = pack_threads
        self.enable_fanout = enable_fanout
        self.enable_asym = enable_asym
        self.kdicts = [make_dict()
                       for _ in range(self.n_regions * self.superbatch_max)]
        self.key_tables = sk.init_key_tables(
            self.superbatch_max * self.n_regions, slot_cap, dev)
        self._region_words = flowpack.resident_buf_len(self.batch_per_region,
                                                       self.caps)
        #: the captured fold of each ladder entry (`capture` on a CUDA
        #: device), else None
        self.captured = ({k: CapturedFold(f"fold_resident_lanes_x{k}",
                                          functools.partial(self._ingest, k),
                                          graph_pool)
                          for k in self.ladder}
                         if capture and dev.type == "cuda" else None)
        self.continuations = 0
        self.dict_resets = 0
        self.spill_rows = 0
        self.superbatch_folds: dict[int, int] = {}
        self.chunks = 0
        self.pack_seconds = 0.0
        self._init_slots(n_slots, self.superbatch_max * self.n_regions
                         * self._region_words, dev, metrics)

    @property
    def captures(self) -> list[CapturedFold]:
        """The ladder's captured folds (none on the CPU)."""
        return list(self.captured.values()) if self.captured else []

    def _ingest(self, k: int, state, key_tables: torch.Tensor,
                flat: torch.Tensor):
        return sk.ingest_resident_lanes(
            state, key_tables, flat, self.batch_per_region, self.caps,
            k * self.n_regions, enable_fanout=self.enable_fanout,
            enable_asym=self.enable_asym)

    def _dispatch(self, k: int, state, flat: torch.Tensor) -> None:
        """Fold one shipped k-chunk through ladder entry k: its captured
        graph, or eagerly."""
        if self.captured is not None:
            self.captured[k](state, self.key_tables, flat)
        else:
            self._ingest(k, state, self.key_tables, flat)

    def _ship_words(self, k: int) -> int:
        return k * self.n_regions * self._region_words

    def mark_warm(self, *ks: int) -> None:
        """Make ladder entries selectable."""
        self._available.update(int(k) for k in ks)

    def warm(self, state, k: int) -> None:
        """Capture ladder entry k against `state` (on a CUDA device with
        `capture`: warm-up on clones and the capture, no fold), then make
        it selectable."""
        if self.captured is not None:
            self.captured[k].prepare(state, self.key_tables,
                                     self._dev[:self._ship_words(k)])
        self.mark_warm(k)

    def fold(self, state, events: np.ndarray, extra=None, dns=None,
             drops=None, xlat=None, quic=None, trace=None):
        """Pack `events` (any count; with optional feature lanes row for
        row) split over the regions, in one or more chunks, into ring
        slots; ship and ingest each, with spans on `trace`. Rows past one
        batch dispatch through the largest fitting ladder entries. Returns
        `state`, updated in place; the device work is not waited for."""
        n = len(events)
        if n == 0:
            return state
        feats = dict(extra=extra, dns=dns, drops=drops, xlat=xlat, quic=quic)
        trace, owned = self._fold_trace(trace)
        try:
            start = 0
            while start < n:
                remaining = n - start
                k = max((x for x in self.ladder if x in self._available
                         and x * self.batch_size <= remaining), default=1)
                take = min(remaining, k * self.batch_size)
                chunk_feats = {
                    name: (v[start:start + take]
                           if v is not None and len(v) else None)
                    for name, v in feats.items()}
                self._fold_chunk(state, events[start:start + take],
                                 chunk_feats, k, trace)
                start += take
            return state
        finally:
            if owned:
                trace.finish()

    def _fold_chunk(self, state, events: np.ndarray, feats: dict,
                    k: int, trace) -> None:
        """Pack and dispatch one k-superbatch chunk (<= k * batch_size
        rows) through ladder entry k, in as many slots as its regions
        need."""
        n = len(events)
        nr = self.n_shards * k * self.lanes
        kl = k * self.lanes
        kmax_l = self.superbatch_max * self.lanes
        rw = self._region_words
        bounds = [n * i // nr for i in range(nr + 1)]
        shard_ev = [events[bounds[i]:bounds[i + 1]] for i in range(nr)]
        shard_feats = [
            {name: (v[bounds[i]:bounds[i + 1]] if v is not None and len(v)
                    else None) for name, v in feats.items()}
            for i in range(nr)]
        starts = [0] * nr
        first = True
        m = self._metrics
        while any(starts[i] < len(shard_ev[i]) for i in range(nr)):
            try:
                slot = self._wait_slot(trace)
            except StagingWedged as exc:
                exc.state = state  # the chunks before it dispatched
                raise
            buf = self._bufs[slot]

            def pack_region(i):
                # touches only region i's dictionary, buffer region and
                # start, and returns its counters, so threads never race
                region = buf[i * rw:(i + 1) * rw]
                if starts[i] >= len(shard_ev[i]):
                    # an exhausted region of a continuation chunk ships
                    # empty, and its dictionary's epoch stays
                    flowpack.zero_resident_region(
                        region, self.batch_per_region, self.caps)
                    return 0, 0
                kd = self.kdicts[(i // kl) * kmax_l + (i % kl)]
                resets = 0
                if kd.count() >= self.slot_cap:
                    kd.reset()
                    resets = 1
                _, consumed = self._pack(
                    shard_ev[i], batch_size=self.batch_per_region, kdict=kd,
                    caps=self.caps, start=starts[i], out=region,
                    **shard_feats[i])
                if consumed == 0:
                    raise RuntimeError("resident pack made no progress")
                starts[i] += consumed
                return int(region[2]), resets

            t0 = time.perf_counter()
            with trace.stage("resident_pack"):
                if self.pack_threads > 1 and nr > 1:
                    outs = [f.result() for f in flowpack._pack_submit(
                        min(self.pack_threads, nr),
                        [functools.partial(pack_region, i)
                         for i in range(nr)])]
                else:
                    outs = [pack_region(i) for i in range(nr)]
            self.pack_seconds += time.perf_counter() - t0
            spills = sum(o[0] for o in outs)
            resets = sum(o[1] for o in outs)
            self.spill_rows += spills
            self.dict_resets += resets
            self.superbatch_folds[k] = self.superbatch_folds.get(k, 0) + 1
            self.continuations += not first
            if m is not None:
                if spills:
                    m.sketch_resident_spill_rows_total.inc(spills)
                if resets:
                    m.sketch_resident_dict_epochs_total.inc(resets)
                if not first:
                    m.sketch_resident_continuations_total.inc()
                m.sketch_superbatch_folds_total.labels(str(k)).inc()
            first = False
            with trace.stage("ingest_dispatch"):
                self._dispatch(k, state, self._ship(slot,
                                                    self._ship_words(k)))
            self.chunks += 1
            self._advance(slot)

    def close(self) -> None:
        """Drain, then drop the buffers and the captured folds."""
        super().close()
        self.captured = None
