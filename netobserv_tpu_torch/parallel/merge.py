"""Sharded sketch ingest and the window merge across shards.

Counterpart of `netobserv_tpu/parallel/merge.py` (`init_dist_state`,
`put_replicated`, `shard_batch`, `make_sharded_ingest_fn`,
`init_resident_tables`, `make_sharded_ingest_resident_fn`, `shard_dense`,
`shard_dense_per_device`, `merge_states`, `make_fold_delta_fn`,
`make_merge_fn`), in one process over a grid of `torch.device`s
(`parallel/mesh.Mesh`).

**The distributed state.** A `DistState` is a grid of per-shard
`SketchState`s, `shards[d][s]`, each on its mesh device. Where the
reference lays one pytree out with a leading data axis (`_state_specs`,
`:41-67`), `dist_tables` gives that layout back as numpy, leaf for leaf:

- every leaf `[n_data, ...]`, read from sketch shard 0 (the sketch
  replicas of a data shard fold the same rows, so they hold the same
  values; a restore writes every replica);
- the Count-Min planes `[n_data, depth, width]`, the local widths of the
  sketch shards side by side;
- the slot table `[n_data, n_sketch, ...]`: owner sharding gives each
  sketch shard a table of its own keys.

**Ingest** makes no cross-device call: each shard folds its rows into its
own partial (`sketch/state.ingest` with `sketch_shard` on a width-sharded
mesh, so kernel 5 folds the owned keys). `shard_batch`, `shard_dense` and
`put_replicated` copy each shard's slice from the host to its device, once
a device for the sketch replicas of one data shard. A sharded value is a
grid of the same shape as the state's.

**The roll** (`make_merge_fn`) is the one cross-device step. The partials
merge on the mesh's first device (`merge_states`): sums over the data
shards, in shard order, where the reference psums; maxima for the HLL
registers; the EWMA baselines are replicated, so only the rates sum. The
slot tables stack in the order the reference's two gathers give, data
within sketch (`stacked[s * n_data + d]`), since `topk.merge_slot_tables`
breaks ties by the lower stacked index, and re-score against the merged
Count-Min (the sum of the sketch shards' owner-masked queries on a
width-sharded mesh). The report is the merged state's roll
(`sketch/state.roll_window`). Each shard then rolls its own partial:
reset zeroes it but for its slot table, which persists through the roll
(`slot_roll(0.0)`, counts into prev_counts); decay scales it; keep keeps
it. The rolled EWMA baselines, their window counts and the window counter
are copied back into every shard.

`make_fold_delta_fn` (the federation aggregator's mesh fold) merges one
agent's delta tables into the data shard that owns the agent; the
reference's `where(mine, merged, s)` over every shard gives the same
state. It and `make_merge_fn(with_tables=True)` refuse a width-sharded
mesh with the reference's messages.

**Across processes** (a `Mesh` of several ranks, `parallel/distributed.
py`; reference `:83-106`, `:270-300`): every rank holds the same global
batch and places only its own rows; a `DistState` and every placed grid
hold None in the cells of other ranks, and the ingests fold the
addressable shards, with no cross-process call. The roll first merges this
rank's shards, as above, then completes the merge across ranks in three
collectives: one sum of the packed float leaves (the Count-Min planes,
each sketch column's among them, the histograms, the rates and the
scalars; a rank that holds no cell of a leaf adds zeros), one maximum of
the packed HLL registers, and one all-gather of the slot tables (each
packed as int64 rows, float bits kept), stacked in the single-process
order, so ties break as the reference's do. Every rank then holds the
same merged state and rolls it to the same report, as the reference's
replicated `out_specs P()` gives every process. Sums across ranks add in
another order than one process does: exact for integer masses below
2^24, within the add-order bound otherwise. `dist_tables` gathers the
whole layout on every rank; `make_fold_delta_fn` folds on the rank that
holds the owner shard. Once the group is initialised, every mesh spans it
(`parallel/mesh.make_mesh`), so functions given only a `DistState` read
the process count from `parallel/distributed`.

Every function runs on the state's devices as they are: a grid that
repeats one device runs the same steps there, and the CPU's grid runs the
kernels' plain versions.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from netobserv_tpu_torch.ops import countmin, topk
from netobserv_tpu_torch.parallel import distributed
from netobserv_tpu_torch.parallel.mesh import Mesh
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.utils import retrace

#: the port's dtype of each leaf -> the JAX dtype of `dist_tables`
_JAX_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
               torch.bool: np.bool_, torch.int64: np.uint32}


class DistState(NamedTuple):
    """Per-shard partial states: `shards[d][s]` is data shard d, sketch
    shard s, or None where another rank holds it (tuples, so
    `sketch/capture` and `copy_state_` walk it as any nested state)."""

    shards: tuple

    @property
    def n_data(self) -> int:
        return len(self.shards)

    @property
    def n_sketch(self) -> int:
        return len(self.shards[0])

    @property
    def window(self) -> torch.Tensor:
        """The window counter (every shard holds the same)."""
        return self.flat()[0].window

    def flat(self) -> list[sk.SketchState]:
        """Every shard's state this rank holds, data-major."""
        return [s for row in self.shards for s in row if s is not None]


def local_config(cfg: sk.SketchConfig, n_sketch: int) -> sk.SketchConfig:
    """One shard's geometry: the Count-Min width split over the sketch
    axis. A tiered config and a width the axis does not divide raise."""
    if cfg.tiered is not None:
        raise NotImplementedError(
            "SKETCH_TIERED has no owner-sharded form yet — tiered counter "
            "planes are single-device (config.validate blocks "
            "SKETCH_MESH_SHAPE with SKETCH_TIERED)")
    if cfg.cm_width % n_sketch:
        raise ValueError(f"cm_width {cfg.cm_width} does not split over a "
                         f"sketch axis of {n_sketch}")
    return cfg._replace(cm_width=cfg.cm_width // n_sketch)


def init_dist_state(cfg: sk.SketchConfig, mesh: Mesh) -> DistState:
    """Per-shard partial states, zeros, one on each of this rank's mesh
    devices (None in other ranks' cells). A rank that holds no cell of
    the mesh raises."""
    local = local_config(cfg, mesh.sketch)
    if not mesh.addressable():
        raise ValueError(
            f"rank {mesh.rank} holds no cell of the {mesh.data}x"
            f"{mesh.sketch} mesh: give every rank at least one device of "
            "it")
    return DistState(tuple(
        tuple(sk.init_state(local, dev) if mesh.is_local(d, s) else None
              for s, dev in enumerate(row))
        for d, row in enumerate(mesh.devices)))


def _sketch_shard(s: int, n_sketch: int) -> Optional[tuple[int, int]]:
    return (s, n_sketch) if n_sketch > 1 else None


# ---------------------------------------------------------------------------
# the reference's leading-axis layout
# ---------------------------------------------------------------------------

def dist_layout(dist: DistState, reading: bool = False) -> list[tuple]:
    """Each leaf of the reference's layout as (dotted path, shape, port
    dtype, parts); a part is (index into the leaf, the shard tensors that
    hold it), one a part this rank holds. Writing writes all of them (the
    sketch replicas of a data shard); with `reading` a replicated leaf's
    part is sketch shard 0's alone, which the reader takes (the replicas
    fold the same rows, but the heavy-eviction count follows each one's
    own slot table)."""
    nd, ns = dist.n_data, dist.n_sketch
    sh = dist.shards

    def leaves(p, cells):
        return [carry.get_leaf(sh[d][s], p) for d, s in cells
                if sh[d][s] is not None]
    out = []
    for p in carry.field_paths():
        first = carry.get_leaf(dist.flat()[0], p)
        if p.startswith("cm_"):
            w = first.shape[1]
            shape = (nd, first.shape[0], w * ns)
            parts = [((d, slice(None), slice(s * w, (s + 1) * w)),
                      leaves(p, [(d, s)]))
                     for d in range(nd) for s in range(ns)]
        elif p.startswith("heavy."):
            shape = (nd, ns, *first.shape)
            parts = [((d, s), leaves(p, [(d, s)]))
                     for d in range(nd) for s in range(ns)]
        else:
            shape = (nd, *first.shape)
            parts = [((d,), leaves(p, [(d, s) for s in range(
                1 if reading else ns)])) for d in range(nd)]
        out.append((p, shape, first.dtype, [x for x in parts if x[1]]))
    return out


def dist_tables(dist: DistState) -> dict[str, np.ndarray]:
    """The reference's `DistState` layout as host numpy, by dotted path
    (the paths and dtypes of `sketch/carry`; uint32 lanes as uint32);
    across processes every rank's parts, gathered on every rank (a
    collective)."""
    layout = dist_layout(dist, reading=True)
    mine = [[(idx, ts[0].detach().cpu().numpy()) for idx, ts in parts]
            for _, _, _, parts in layout]
    every = distributed.all_gather_object(mine)
    out = {}
    for i, (p, shape, dtype, _) in enumerate(layout):
        arr = np.zeros(shape, _JAX_DTYPES[dtype])
        for rank_parts in every:
            for idx, part in rank_parts[i]:
                arr[idx] = part
        out[p] = arr
    return out


# ---------------------------------------------------------------------------
# placement: one slice copy a shard, host to its device
# ---------------------------------------------------------------------------

def _per_device(mesh: Mesh, make: Callable) -> tuple:
    """A grid of `make(d, device)`, made once per (data shard, device) of
    this rank's cells (None in other ranks'): sketch replicas of one data
    shard on one device share it."""
    made: dict = {}
    grid = []
    for d, row in enumerate(mesh.devices):
        for s, dev in enumerate(row):
            if mesh.is_local(d, s) and (d, dev) not in made:
                made[(d, dev)] = make(d, dev)
        grid.append(tuple(made[(d, dev)] if mesh.is_local(d, s) else None
                          for s, dev in enumerate(row)))
    return tuple(grid)


def _row_slice(n: int, n_data: int, d: int) -> slice:
    if n % n_data:
        raise ValueError(f"{n} rows do not split evenly over {n_data} "
                         "data shards")
    per = n // n_data
    return slice(d * per, (d + 1) * per)


def shard_batch(mesh: Mesh, arrays: dict[str, np.ndarray]) -> tuple:
    """A host columnar batch (leading dim divisible by n_data) as a grid
    of per-shard device batches (`sketch/state.batch_to_device` of the
    data shard's rows), the same rows for every sketch shard; across
    processes every rank gives the same global batch and places only its
    own shards' rows."""
    n = len(arrays["valid"])
    return _per_device(mesh, lambda d, dev: sk.batch_to_device(
        {k: np.asarray(v)[_row_slice(n, mesh.data, d)]
         for k, v in arrays.items()}, dev))


def shard_dense(mesh: Mesh, dense: np.ndarray) -> tuple:
    """A dense feed batch ((B, 20) rows or the flat (B*20,) form) as a
    grid of each data shard's rows, int32 words on its device; across
    processes this rank's shards only."""
    flat = np.ascontiguousarray(dense).reshape(-1).view(np.int32)
    rows = flat.size // sk.DENSE_WORDS
    return _per_device(mesh, lambda d, dev: torch.from_numpy(
        flat.reshape(rows, sk.DENSE_WORDS)[_row_slice(rows, mesh.data, d)]
        .reshape(-1).copy()).to(dev))


def shard_dense_per_device(mesh: Mesh, flat: np.ndarray) -> tuple:
    """Any flat 1-D host buffer split evenly over the data shards, one
    host-to-device copy a shard (reference `:273-300`: every rank holds
    the whole buffer at its global positions and places only its own
    slices). On a dense batch it is `shard_dense`; the resident feed's
    regions ship this way too."""
    flat = np.ascontiguousarray(flat).reshape(-1).view(np.int32)
    return _per_device(mesh, lambda d, dev: torch.from_numpy(
        flat[_row_slice(flat.size, mesh.data, d)].copy()).to(dev))


def put_replicated(mesh: Mesh, arr) -> tuple:
    """A host array (or a torch tensor) copied to every mesh device of
    this rank, once a device, as a grid (None in other ranks' cells)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    by_dev = {dev: t.to(dev) for dev in mesh.distinct()}
    return tuple(tuple(by_dev[dev] if mesh.is_local(d, s) else None
                       for s, dev in enumerate(row))
                 for d, row in enumerate(mesh.devices))


# ---------------------------------------------------------------------------
# sharded ingest (no cross-device calls)
# ---------------------------------------------------------------------------

def make_sharded_ingest_fn(mesh: Mesh, cfg: sk.SketchConfig,
                           dense: bool = False,
                           with_token: bool = False) -> Callable:
    """`(dist, batch) -> dist`, watched: every shard folds its slice of
    `batch` (a grid from `shard_batch`, or with `dense` one from
    `shard_dense`, unpacked on its device). `with_token` (dense only)
    returns `(dist, token)`, each shard's first word: the slot guard's
    counterpart (`sketch/staging` guards its slots with copy events)."""
    if with_token and not dense:
        raise ValueError("with_token requires dense=True")
    nsk = mesh.sketch

    def step(dist: DistState, batch: tuple):
        for d, row in enumerate(dist.shards):
            for s, state in enumerate(row):
                if state is None:
                    continue  # another rank's shard
                arrays = (sk.dense_to_arrays(batch[d][s]) if dense
                          else batch[d][s])
                sk.ingest(state, arrays,
                          sketch_shard=_sketch_shard(s, nsk),
                          enable_fanout=cfg.enable_fanout,
                          enable_asym=cfg.enable_asym)
        if with_token:
            return dist, tuple(tuple(None if b is None else b[:1]
                                     for b in row) for row in batch)
        return dist

    return retrace.watch(step, "sharded_ingest_dense" if dense
                         else "sharded_ingest")


def init_resident_tables(mesh: Mesh, slot_cap: int,
                         lanes: int = 1) -> tuple:
    """Per-data-shard key tables of the sharded resident feed: a grid of
    (lanes, slot_cap + 1, KEY_WORDS) int32 tables (`sketch/state.
    init_key_tables`), one a (data shard, device), shared by the sketch
    replicas on one device: they apply the same new-key lanes, so the
    second write of a slot writes what the first did."""
    return _per_device(mesh, lambda d, dev: sk.init_key_tables(
        lanes, slot_cap, dev))


def make_sharded_ingest_resident_fn(mesh: Mesh, cfg: sk.SketchConfig,
                                    batch_per_lane: int, caps,
                                    lanes: int = 1,
                                    watch_name: str =
                                    "sharded_ingest_resident") -> Callable:
    """`(dist, key_tables, flat) -> (dist, key_tables, token)`, watched:
    the resident feed over the mesh. `flat` is a grid of each data
    shard's `lanes` concatenated regions (`flowpack.resident_buf_len(
    batch_per_lane, caps)` words each) on its device; `key_tables` a grid
    from `init_resident_tables` (it may hold more rows than `lanes`: the
    ladder's entries share it). The token is each shard's first word."""

    nsk = mesh.sketch

    def step(dist: DistState, tables: tuple, flat: tuple):
        for d, row in enumerate(dist.shards):
            for s, state in enumerate(row):
                if state is None:
                    continue  # another rank's shard
                sk.ingest_resident_lanes(
                    state, tables[d][s], flat[d][s], batch_per_lane, caps,
                    lanes, enable_fanout=cfg.enable_fanout,
                    enable_asym=cfg.enable_asym,
                    sketch_shard=_sketch_shard(s, nsk))
        return dist, tables, tuple(tuple(None if f is None else f[:1]
                                         for f in row) for row in flat)

    return retrace.watch(step, watch_name)


# ---------------------------------------------------------------------------
# window roll: merge the partials, report, roll every shard
# ---------------------------------------------------------------------------

def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return type(x)(*(_zeros_like(v) for v in x))


def _sum_into(dst: torch.Tensor, srcs: list) -> None:
    """`dst` = the sum of `srcs` in order (zeros for none: a rank that
    holds no cell of a leaf adds zeros across ranks)."""
    if not srcs:
        dst.zero_()
        return
    dst.copy_(srcs[0])
    for t in srcs[1:]:
        dst.add_(t.to(dst.device))


def _max_into(dst: torch.Tensor, srcs: list) -> None:
    """`dst` = the element-wise maximum of `srcs` (zeros for none: HLL
    registers are >= 0)."""
    if not srcs:
        dst.zero_()
        return
    dst.copy_(srcs[0])
    for t in srcs[1:]:
        torch.maximum(dst, t.to(dst.device), out=dst)


#: the float leaves a merge sums, besides the Count-Min planes (the EWMA
#: baselines are replicated; only the window rates are partials)
_SUM_LEAVES = ("hist_rtt.counts", "hist_dns.counts", "ddos.rate",
               "syn.rate", "drops_ewma.rate", "synack", "drop_causes",
               "dscp_bytes", "conv_fwd", "conv_rev", *sk._SCALARS)
_MAX_LEAVES = ("hll_src.regs", "hll_per_dst.regs", "hll_per_src.regs")


def _reduce_packed(tensors: list, op: Callable) -> int:
    """One collective `op` over `tensors` packed into one flat buffer,
    copied back in place; returns the buffer's bytes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))
    return flat.numel() * flat.element_size()


def _pack_table(table: topk.SlotTable) -> torch.Tensor:
    """A slot table as int64 rows [k, cols], float leaves by their bits."""
    cols = []
    for t in table:
        t = t.reshape(t.shape[0], -1)
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        cols.append(t.to(torch.int64))
    return torch.cat(cols, dim=1)


def _unpack_table(x: torch.Tensor, like: topk.SlotTable) -> topk.SlotTable:
    """`_pack_table`'s inverse, with `like`'s shapes and dtypes."""
    out, c = [], 0
    for t in like:
        w = t[0].numel() if t.dim() > 1 else 1
        col = x[:, c:c + w].reshape(t.shape)
        c += w
        if t.dtype == torch.float32:
            col = col.to(torch.int32).view(torch.float32)
        else:
            col = col.to(t.dtype)
        out.append(col)
    return topk.SlotTable(*out)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def merge_states(dist: DistState, out: Optional[sk.SketchState] = None,
                 cms: Optional[list] = None, mesh: Optional[Mesh] = None,
                 stats: Optional[dict] = None) -> sk.SketchState:
    """Merge the partials into one state on this rank's first shard's
    device (module docstring), into `out` if given (a zero state of one
    shard's shape, made once by the caller), and return it. `cms` (the
    sketch shards' merged byte planes, made once) holds the owner-sharded
    sums the slot tables re-score against on a width-sharded mesh. Across
    processes `mesh` is required (which rank holds which slot table), and
    every rank must call this in the same order. `stats`, when given,
    takes the step times in ms (`local_ms`, `cross_ms`, `select_ms`; the
    device synchronised around each) and the collectives' bytes
    (`reduce_bytes`, `gather_bytes`)."""
    rows = dist.shards
    nd, nsk = dist.n_data, dist.n_sketch
    world = distributed.process_count()
    if world > 1 and mesh is None:
        raise ValueError("a merge across processes needs its mesh")
    first = dist.flat()[0]
    if out is None:
        out = _zeros_like(first)
    dev = out.window.device
    if stats is not None:
        _sync(dev)
        t0 = time.perf_counter()
    # each data shard's sketch shard 0 holds its non-CM leaves (the sketch
    # replicas of a data shard fold the same rows)
    col = [row[0] for row in rows if row[0] is not None]

    def over(path):
        return [carry.get_leaf(s, path) for s in col]

    _sum_into(out.cm_bytes.counts, over("cm_bytes.counts"))
    _sum_into(out.cm_pkts.counts, over("cm_pkts.counts"))
    planes = [out.cm_bytes]
    if nsk > 1:
        if cms is None:
            cms = [countmin.CountMin(torch.zeros_like(out.cm_bytes.counts))
                   for _ in range(nsk - 1)]
        for s in range(1, nsk):
            _sum_into(cms[s - 1].counts, [row[s].cm_bytes.counts
                                          for row in rows
                                          if row[s] is not None])
            planes.append(cms[s - 1])
    for path in _MAX_LEAVES:
        _max_into(carry.get_leaf(out, path), over(path))
    for path in _SUM_LEAVES:
        _sum_into(carry.get_leaf(out, path), over(path))
    for name in ("ddos", "syn", "drops_ewma"):
        e, src = getattr(out, name), getattr(first, name)
        e.mean.copy_(src.mean)
        e.var.copy_(src.var)
        e.windows.copy_(src.windows)
    out.window.copy_(first.window)
    order = [(d, s) for s in range(nsk) for d in range(nd)]
    tables = {(d, s): rows[d][s].heavy for d, s in order
              if rows[d][s] is not None}
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
        stats["local_ms"] = (t1 - t0) * 1e3
    if world > 1:
        sums = [out.cm_bytes.counts, out.cm_pkts.counts,
                *(c.counts for c in cms or []),
                *(carry.get_leaf(out, p) for p in _SUM_LEAVES)]
        red = _reduce_packed(sums, distributed.all_reduce_sum_)
        red += _reduce_packed([carry.get_leaf(out, p) for p in _MAX_LEAVES],
                              distributed.all_reduce_max_)
        tables, gathered = _gather_tables(mesh, tables, first.heavy, dev)
        if stats is not None:
            _sync(dev)
            t2 = time.perf_counter()
            stats.update(cross_ms=(t2 - t1) * 1e3, reduce_bytes=red,
                         gather_bytes=gathered)
            t1 = t2
    elif stats is not None:
        stats.update(cross_ms=0.0, reduce_bytes=0, gather_bytes=0)
    qfn = None
    if nsk > 1:
        qfn = lambda a, b: countmin.query_sharded(planes, a, b)  # noqa: E731
    stacked = topk.SlotTable(*(
        torch.cat([tables[c][i].to(dev) for c in order])
        for i in range(len(topk.SlotTable._fields))))
    merged = topk.merge_slot_tables(stacked, out.cm_bytes, first.heavy.k,
                                    query_fn=qfn)
    for t, m in zip(out.heavy, merged):
        t.copy_(m)
    if stats is not None:
        _sync(dev)
        stats["select_ms"] = (time.perf_counter() - t1) * 1e3
    return out


def _gather_tables(mesh: Mesh, tables: dict, like: topk.SlotTable,
                   dev: torch.device) -> tuple[dict, int]:
    """Every cell's slot table on every rank: each rank's cells packed in
    grid order (padded to the most any rank holds) and all-gathered in
    rank order. Returns (cell -> table, bytes gathered)."""
    cells = [(d, s) for d in range(mesh.data) for s in range(mesh.sketch)]
    by_rank = [[c for c in cells if mesh.ranks[c[0]][c[1]] == r]
               for r in range(mesh.world)]
    most = max(len(c) for c in by_rank)
    mine = [_pack_table(tables[c]).to(dev) for c in by_rank[mesh.rank]]
    pad = torch.zeros((most - len(mine), *mine[0].shape), dtype=torch.int64,
                      device=dev)
    packed = torch.cat([torch.stack(mine), pad])
    every = distributed.all_gather(packed)
    out = {}
    for r, rank_cells in enumerate(by_rank):
        for i, c in enumerate(rank_cells):
            out[c] = tables[c] if r == mesh.rank else _unpack_table(
                every[r][i], like)
    return out, packed.numel() * packed.element_size() * mesh.world


def make_fold_delta_fn(mesh: Mesh, cfg: sk.SketchConfig) -> Callable:
    """`(dist, tables, owner) -> dist`, watched: the federation
    aggregator's mesh fold. One agent's delta tables (`federation.delta.
    TABLE_SPEC` names on the owner's device, or a grid of them from
    `put_replicated`) merge into data shard `owner` (an int, a stable hash
    of the agent id: one agent's deltas always land in one shard's
    partial). No other shard changes, as in the reference's masked merge
    over every shard; across processes only the rank that holds the
    owner shard folds. A width-sharded mesh raises: its Count-Min shards
    re-hash keys into their local width, so a whole-width delta table has
    no decomposition into them."""
    from netobserv_tpu_torch.federation import statemerge

    nsk = mesh.sketch
    if nsk > 1:
        raise ValueError(
            "federation fold requires a data-axis-only mesh (Nx1): "
            "owner-sharded CM shards re-hash keys into their local width, "
            f"so a whole-width delta table cannot merge into a {nsk}-way "
            "width-sharded aggregate")

    def fold(dist: DistState, tables, owner: int):
        shard = dist.shards[int(owner)][0]
        if shard is None:
            return dist  # another rank holds the owner shard
        t = tables[owner][0] if isinstance(tables, tuple) else tables
        statemerge.merge_tables(shard, t)
        return dist

    return retrace.watch(fold, "federation_fold_delta")


class MergeFn:
    """The roll of `make_merge_fn`: `fn(dist)` closes the window of every
    shard in place and returns `(dist, report)`, with `with_tables`
    `(dist, report, tables)`: `tables` the merged pre-roll
    `sketch/state.state_tables` on the host (with `cm_only` the host CM
    planes alone, `state.host_cm_planes`). The report lives on the first
    shard's device. The merge's state is made once and reused. Across
    processes the call is a collective: every rank rolls in the same
    order and gets the same report. `stats`, when set to a dict, takes
    each roll's `merge_states` stats (the smoke's split of the roll)."""

    def __init__(self, mesh: Mesh, cfg: sk.SketchConfig,
                 reset_sketches: bool, decay_factor: Optional[float],
                 with_tables: bool):
        self.cfg = cfg
        self.reset_sketches = reset_sketches
        self.decay_factor = decay_factor
        self.with_tables = with_tables
        self._merged = sk.init_state(local_config(cfg, mesh.sketch),
                                     mesh.first)
        self._cms = [countmin.CountMin(torch.zeros_like(
            self._merged.cm_bytes.counts)) for _ in range(mesh.sketch - 1)]
        self.mesh = mesh
        self.stats: Optional[dict] = None
        self._call = retrace.watch(self._roll, "sharded_merge")

    def __call__(self, dist: DistState, cm_only: bool = False):
        return self._call(dist, cm_only)

    def _roll(self, dist: DistState, cm_only: bool):
        merged = merge_states(dist, self._merged, self._cms, self.mesh,
                              self.stats)
        tables = None
        if self.with_tables:
            tables = (sk.host_cm_planes(merged) if cm_only
                      else sk.state_tables(merged))
        _, report = sk.roll_window(merged, self.cfg, self.reset_sketches,
                                   self.decay_factor)
        for state in dist.flat():
            sk.roll_tables_(state, self.reset_sketches, self.decay_factor)
            for name in ("ddos", "syn", "drops_ewma"):
                e, m = getattr(state, name), getattr(merged, name)
                e.mean.copy_(m.mean)
                e.var.copy_(m.var)
                e.windows.copy_(m.windows)
                e.rate.zero_()
            state.window.copy_(merged.window)
        if self.with_tables:
            return dist, report, tables
        return dist, report


def make_merge_fn(mesh: Mesh, cfg: sk.SketchConfig,
                  reset_sketches: bool = True,
                  decay_factor: Optional[float] = None,
                  with_tables: bool = False) -> MergeFn:
    """The window roll over the mesh (`MergeFn`): the merged report, and
    every shard rolled for the next window with the EWMA baselines rolled
    on the merged rates. `with_tables` also returns the merged pre-roll
    tables: data-axis-only meshes only, since width-sharded Count-Min
    planes have no whole-width form."""
    if with_tables and mesh.sketch > 1:
        raise ValueError("with_tables requires a data-axis-only mesh (Nx1) "
                         "— width-sharded CM planes have no replicated "
                         "whole-width snapshot")
    return MergeFn(mesh, cfg, reset_sketches, decay_factor, with_tables)

