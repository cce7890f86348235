"""Tenant planes: N independent sketch states on one device, stacked on a
leading axis, with a host router in front of them.

Counterpart of `netobserv_tpu/sketch/tenancy.py` (`DENSE_WORDS`,
`init_stacked_state` `:58`, `split_tenants` `:68`, `TenantStack` `:78`).
Many independent observation domains (namespaces, customers, VPCs) share
one card: each tenant's state is a slice of one stacked state, and one
dispatch folds every tenant's evicted rows.

Routing is the reference's, on the host. Evicted rows pack once to dense
rows (`datapath/flowpack.pack_dense`); each row's owner is
`ops/hashing.tenant_of_np` of its key words; rows fill per-tenant
(B, DENSE_WORDS) buffers in arrival order. When any tenant's buffer fills,
every tenant ships its prefix, zero-padded, as one (N, B * DENSE_WORDS)
slot: an all-zero row is invalid, the fold's identity. `flush` ships the
partial buffers (the window's close calls it before the roll).

The device side differs from the reference's, which folds the stack with
one vmapped executable. PyTorch has no vmap over the port's ctypes
kernels, so the stacked fold runs the port's own single-tenant ingest
(`sketch/state.ingest`) on each tenant's view (`tenant_view`), t = 0..N-1,
inside one CUDA graph per tenant count (`sketch/capture.CapturedFold`,
"tenant_ingest", watched with `tenants=N`). A stacked dispatch is one
host-to-device copy of the slot and one replay; it launches each kernel
of the fold N times. Each tenant's fold is the single-tenant fold of the
same (B, DENSE_WORDS) rows into the same tensors, so a tenant's tables are
bit for bit those of a single-tenant pipeline fed its routed rows on the
same schedule. The roll (`roll`) runs `roll_window` per tenant view, after
one snapshot of every tenant's pre-roll tables, and stacks the reports.

A view `x[t]` of a contiguous stacked tensor is contiguous and starts t
times the leaf's bytes past the stack's base, which every kernel takes:
each leaf a kernel reads is of a 4-byte type, but for the tier planes'
uint8 base (d x w bytes a tenant: kernel 6 moves it in 32-bit words, and w
is a multiple of its tile) and the 6-bit packed HLL banks (kernel 7 reads
them byte by byte). A scalar of the state is (N,) in the stack and 0-d in
a view.

The slot protocol is `sketch/staging._SlotRing`'s: `fold` and `fold_rows`
raise `StagingWedged` past the slot-wait budget with `state`, the caller's
own stacked state (the port folds in place), holding the dispatches made
before the wait tripped (ROADMAP C5). `TenantStack` has the rings' fold
surface (`fold`, `slot_wait_p95`, `chunks`, `captures`, `close`), so the
exporter's eviction path, the pending buffer and overload control take it
unchanged (`exporter/torch_sketch.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from netobserv_tpu_torch.datapath import flowpack
from netobserv_tpu_torch.model.columnar import KEY_WORDS
from netobserv_tpu_torch.ops import hashing
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.sketch.staging import StagingWedged, _SlotRing
from netobserv_tpu_torch.utils import tracing
from netobserv_tpu_torch.utils.platform import pick_device

DENSE_WORDS = sk.DENSE_WORDS
#: the tables a query snapshot needs (the whole `table_tensors` set goes
#: to delta frames and the archive)
CM_TABLES = ("cm_bytes", "cm_pkts")


def _map(fn, x):
    """fn of every tensor of a state, report or table tree (nested tuples,
    named or not, and dicts); other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, tuple):
        return tuple(_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return x


def _stack(trees: list):
    """The trees' tensors stacked leaf by leaf on a new leading axis (a
    copy); other leaves from the first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(v)) for v in zip(*trees)))
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return first


def init_stacked_state(cfg: sk.SketchConfig, n_tenants: int,
                       device: str | torch.device | None = None):
    """N fresh tenant states stacked on a leading axis, on `device` (the
    card unless the caller names the CPU, `pick_device`): every tensor of
    the `SketchState`, or of a `TieredState`, gains dim 0 = N."""
    if n_tenants < 1:
        raise ValueError("a tenant stack needs n_tenants >= 1")
    base = sk.init_state(cfg, pick_device(device))
    return _map(lambda x: torch.stack([x] * n_tenants).contiguous(), base)


def tenant_view(stacked, t: int):
    """Tenant t's state as views into the stack: a fold or roll of it in
    place lands in the stack."""
    return _map(lambda x: x[t], stacked)


def split_tenants(tree, n_tenants: int) -> list:
    """A stacked tree (a roll's report or tables) as N per-tenant host
    trees: one device-to-host copy per leaf (uint32 lanes back from int64,
    as `exporter/report.report_numpy` and `state_tables` give them), then
    a view per tenant (`x[t, ...]`: a scalar stays a 0-d array)."""
    def host(x):
        arr = x.detach().to("cpu", copy=True).numpy()
        return arr.astype(np.uint32) if arr.dtype == np.int64 else arr

    flat = _map(host, tree)
    return [_host_view(flat, t) for t in range(n_tenants)]


def _host_view(x, t: int):
    if isinstance(x, np.ndarray):
        return x[t, ...]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host_view(v, t) for v in x))
    if isinstance(x, dict):
        return {k: _host_view(v, t) for k, v in x.items()}
    return x


def _tenant_tables(view, keys: Optional[tuple] = None) -> dict:
    """The pre-roll mergeable tables of one (tenant's) state on its device
    (`sketch/state.table_tensors`, all of them or `keys`); a tiered state
    gives its decoded wide tables, the CM planes alone when `keys` asks
    for no more."""
    if isinstance(view, tiered.TieredState):
        if keys is not None and set(keys) <= set(CM_TABLES):
            t, spec = view.tables, view.spec
            cm = {"cm_bytes": tiered.decode_plane(t.cm_bytes, spec,
                                                  spec.bytes_unit),
                  "cm_pkts": tiered.decode_plane(t.cm_pkts, spec, 1)}
            return {k: cm[k] for k in keys}
        view = tiered.decode_state(view)
    tt = sk.table_tensors(view)
    return {k: tt[k] for k in (keys or tt)}


class TenantStack(_SlotRing):
    """The tenant plane: host router, per-tenant fill buffers, the stacked
    fold and the stacked roll (module docstring).

    `fold(state, events, extra=, dns=, drops=, xlat=, quic=, trace=)`
    routes flow events, `fold_rows` pre-packed dense rows, and `flush`
    ships partial buffers; each returns `state`, folded in place. On a
    CUDA device `capture` folds each slot by replaying one CUDA graph
    ("tenant_ingest", with its memory from `graph_pool` if given), which
    `warm` captures before any fold; the CPU folds eagerly. Counters:
    `folds` (stacked dispatches, also `chunks`), `routed_rows`, `stalls`
    and `slot_wait_p95`; with `metrics`, `sketch_tenant_folds_total` and
    `sketch_tenants_active`."""

    def __init__(self, n_tenants: int, cfg: sk.SketchConfig,
                 batch_size: int, metrics=None, n_slots: int = 4,
                 reset_sketches: bool = True,
                 decay_factor: Optional[float] = None,
                 device: str | torch.device | None = None,
                 capture: bool = True, graph_pool=None):
        if n_tenants < 1:
            raise ValueError("TenantStack needs n_tenants >= 1")
        dev = pick_device(device)
        flowpack.native_lib()  # a packer that cannot be built raises here
        self.n_tenants = n_tenants
        self.batch_size = batch_size
        self.cfg = cfg
        self.reset_sketches = reset_sketches
        self.decay_factor = decay_factor
        self.folds = 0          #: stacked ingest dispatches
        self.routed_rows = 0    #: rows routed to tenant buffers
        # per-tenant fill buffers: rows wait here in arrival order until
        # any tenant's buffer fills
        self._fillbuf = np.zeros((n_tenants, batch_size, DENSE_WORDS),
                                 np.uint32)
        self._fill = [0] * n_tenants
        self._init_slots(n_slots, n_tenants * batch_size * DENSE_WORDS, dev,
                         metrics)
        #: the captured stacked fold (`capture` on CUDA), else None
        self.captured = (CapturedFold("tenant_ingest", self._ingest,
                                      graph_pool, tenants=n_tenants)
                         if capture and dev.type == "cuda" else None)
        if metrics is not None:
            metrics.sketch_tenants_active.set(n_tenants)

    @property
    def chunks(self) -> int:
        """Stacked dispatches: the rings' dispatch count."""
        return self.folds

    @property
    def captures(self) -> list[CapturedFold]:
        """The stack's captured fold (none on the CPU)."""
        return [self.captured] if self.captured is not None else []

    def _ingest(self, state, dev: torch.Tensor) -> None:
        """Fold the shipped slot: tenant t's B rows into tenant t's view,
        t = 0..N-1, each the single-tenant ingest."""
        flat = dev.view(self.n_tenants, self.batch_size * DENSE_WORDS)
        for t in range(self.n_tenants):
            sk.ingest(tenant_view(state, t), sk.dense_to_arrays(flat[t]),
                      enable_fanout=self.cfg.enable_fanout,
                      enable_asym=self.cfg.enable_asym)

    def warm(self, state) -> None:
        """Capture the stacked fold against `state` (on CUDA with
        `capture`: warm-up on clones and the capture, no fold)."""
        if self.captured is not None:
            self.captured.prepare(state, self._dev)

    # -- host router ------------------------------------------------------
    def route(self, events, extra=None, dns=None, drops=None, xlat=None,
              quic=None) -> tuple[np.ndarray, np.ndarray]:
        """Pack `events` once to dense rows and derive each row's tenant:
        (rows (M, DENSE_WORDS) uint32, owners int32[M])."""
        rows = flowpack.pack_dense(events, batch_size=max(len(events), 1),
                                   extra=extra, dns=dns, drops=drops,
                                   xlat=xlat, quic=quic)
        owners = hashing.tenant_of_np(rows[:, :KEY_WORDS], self.n_tenants)
        return rows, owners

    def fold(self, state, events, extra=None, dns=None, drops=None,
             xlat=None, quic=None, trace=None):
        """Route `events` to the tenant buffers; each time a tenant's
        buffer fills, ship one stacked fold of every tenant's pending rows
        (not waited for). Returns `state`, folded in place."""
        if len(events) == 0:
            return state
        trace, owned = self._fold_trace(trace)
        try:
            with trace.stage("tenant_route"):
                rows, owners = self.route(events, extra=extra, dns=dns,
                                          drops=drops, xlat=xlat, quic=quic)
            return self._fold_routed(state, rows, owners, trace)
        finally:
            if owned:
                trace.finish()

    def fold_rows(self, state, rows: np.ndarray, trace=None):
        """Fold pre-packed dense rows ((M, DENSE_WORDS) uint32), routed and
        dispatched as `fold` does."""
        if len(rows) == 0:
            return state
        trace, owned = self._fold_trace(trace)
        try:
            owners = hashing.tenant_of_np(rows[:, :KEY_WORDS],
                                          self.n_tenants)
            return self._fold_routed(state, rows, owners, trace)
        finally:
            if owned:
                trace.finish()

    def _fold_routed(self, state, rows, owners, trace):
        self.routed_rows += len(rows)
        try:
            for t in range(self.n_tenants):
                sel = rows[owners == t]
                off = 0
                while off < len(sel):
                    take = min(len(sel) - off,
                               self.batch_size - self._fill[t])
                    lo = self._fill[t]
                    self._fillbuf[t, lo:lo + take] = sel[off:off + take]
                    self._fill[t] += take
                    off += take
                    if self._fill[t] == self.batch_size:
                        state = self._dispatch(state, trace)
        except StagingWedged as exc:
            # the dispatches before the trip folded into `state` in place:
            # it is the caller's own object
            exc.state = state
            raise
        return state

    def flush(self, state, trace=None):
        """Ship the partially filled tenant buffers as one stacked fold
        (nothing when every buffer is empty)."""
        if not any(self._fill):
            return state
        try:
            return self._dispatch(state, trace or tracing.NULL_TRACE)
        except StagingWedged as exc:
            exc.state = state  # nothing dispatched
            raise

    def _dispatch(self, state, trace):
        """One stacked fold: every tenant's fill prefix into the next slot,
        zero-padded, shipped and folded; the fill buffers empty."""
        slot = self._wait_slot(trace)
        buf = self._bufs[slot].reshape(self.n_tenants,
                                       self.batch_size * DENSE_WORDS)
        for t in range(self.n_tenants):
            f = self._fill[t] * DENSE_WORDS
            if f:
                buf[t, :f] = self._fillbuf[t].reshape(-1)[:f]
            buf[t, f:] = 0
            self._fill[t] = 0
        with trace.stage("ingest_dispatch"):
            dev = self._ship(slot)
            if self.captured is not None:
                self.captured(state, dev)
            else:
                self._ingest(state, dev)
        self._advance(slot)
        self.folds += 1
        if self._metrics is not None:
            self._metrics.sketch_tenant_folds_total.inc()
        return state

    # -- roll / teardown --------------------------------------------------
    def roll(self, state, table_keys: Optional[tuple] = None):
        """Close every tenant's window of `state` in place: (state, the
        stacked report, the stacked pre-roll tables, all of them or
        `table_keys`), on the device. Every tenant's tables are copied
        before the first tenant rolls."""
        tables = _stack([_tenant_tables(tenant_view(state, t), table_keys)
                         for t in range(self.n_tenants)])
        reports = [sk.roll_window(tenant_view(state, t), self.cfg,
                                  self.reset_sketches, self.decay_factor)[1]
                   for t in range(self.n_tenants)]
        return state, _stack(reports), tables

    def close(self) -> None:
        """Drain, drop the buffers and the captured fold, and evict every
        per-tenant series, zeroing the active-tenants gauge."""
        super().close()
        self.captured = None
        m = self._metrics
        if m is None:
            return
        for t in range(self.n_tenants):
            m.remove_labeled(m.sketch_tenant_window_records, str(t))
        m.sketch_tenants_active.set(0)
