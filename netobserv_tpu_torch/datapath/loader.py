"""The drain chain: from a drained kernel map to the exporter's eviction.

Counterpart of the drain half of `netobserv_tpu/datapath/loader.py`
(`:85-465`), kept as a copy so the port imports nothing of the JAX
package: `_hash_keys_u64`, `_join_keys`, `_drain_map_arrays` and
`decode_eviction` (the Python chain: per-CPU merges, the key join, the
one copy into an `EvictedFlows`), `PackedEviction`, `NativeEvictPipeline`
(the fused drain's gate) and `resolve_drain_lanes`. The kernel fetchers
that own real maps (`BpfmanFetcher`, `MinimalKernelFetcher`,
`LibbpfKernelFetcher`) and their drain lanes come with ROADMAP A8.4; until
then the gate runs over any fetcher of their duck type (`_agg`, and
`_features` of attr -> (map, record dtype), each map with `fd`, `n_cpus`,
`max_entries`, `_no_batch_ops` and `_pad_vs`), as the tests and
`chip_smoke.py` drive it with injected maps (fd < 0).

The merges, the event compose and the fused pipeline are the port's
native library (`datapath/flowpack.py`, `csrc/flowpack.cc`); a library
that cannot be built raises, and nothing falls back to the numpy forms
(`model/accumulate.COLUMNAR_MERGES`, `model/binfmt.events_from_keys_stats`),
which stay the tests' plain twins.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from netobserv_tpu_torch.datapath import flowpack
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.utils import tracing

log = logging.getLogger("netobserv_tpu_torch.datapath.loader")

_U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
_KEY_SIZE = binfmt.FLOW_KEY_DTYPE.itemsize
_KEY_WORDS64 = _KEY_SIZE // 8


def _hash_keys_u64(keys_u8: np.ndarray) -> np.ndarray:
    """(n, 40) u8 keys -> (n,) u64 mixing hash, the join's sort key
    (reference `loader.py:85-99`): a u64 sort is about ten times a void
    sort at 100k keys, and `_join_keys` falls back to the exact
    lexicographic order when two distinct keys of one drain collide."""
    w = np.ascontiguousarray(keys_u8).view(np.uint64)  # (n, 5)
    h = w[:, 0].copy()
    c1 = np.uint64(0x9E3779B97F4A7C15)
    c2 = np.uint64(0xC2B2AE3D27D4EB4F)
    for i in range(1, _KEY_WORDS64):
        h = (h ^ (w[:, i] * c2)) * c1
        h ^= h >> np.uint64(29)
    return h


def _join_keys(agg_u8: np.ndarray, blocks: list[np.ndarray]
               ) -> tuple[list[np.ndarray], list[np.ndarray], np.ndarray]:
    """The key join of a drain (reference `:102-163`): one sort over [agg
    keys | every feature block], grouped by key, with the last agg index
    of each group filled forward.

    Returns (scatter_idx_per_block, orphan_mask_per_block,
    appended_keys): each feature row's event row, the agg row (the last,
    for a key the agg drain holds twice) or len(agg) + the appended row
    of a key absent from the agg drain; appended_keys are those orphan
    keys, one event row each, in sorted-group order."""
    n = len(agg_u8)
    allk = np.concatenate([agg_u8] + blocks)
    total = len(allk)
    w = allk.view(np.uint64)                       # (total, 5)
    h = _hash_keys_u64(allk)
    order = np.argsort(h, kind="stable")
    ws = w[order]
    newk = np.empty(total, bool)
    newk[0] = True
    newk[1:] = (ws[1:] != ws[:-1]).any(axis=1)
    hs = h[order]
    n_hash_groups = 1 + int((hs[1:] != hs[:-1]).sum())
    if int(newk.sum()) != n_hash_groups:
        # two distinct keys of this drain share a hash: the hash order may
        # interleave equal keys, so take the exact lexicographic order
        order = np.lexsort(tuple(w[:, i]
                                 for i in range(_KEY_WORDS64 - 1, -1, -1)))
        ws = w[order]
        newk[0] = True
        newk[1:] = (ws[1:] != ws[:-1]).any(axis=1)
    g = np.cumsum(newk) - 1
    # the last agg index, filled forward within each group: each group in
    # a value range of its own, so the running max never crosses groups
    val = np.where(order < n, order, -1).astype(np.int64)
    span = np.int64(n + 1)
    fill = np.maximum.accumulate(g * span + val + 1) - g * span - 1
    match = np.empty(total, np.int64)
    match[order] = fill
    g_orig = np.empty(total, np.int64)
    g_orig[order] = g
    feat_match = match[n:]
    feat_g = g_orig[n:]
    orphan = feat_match < 0
    if orphan.any():
        uniq_g = np.unique(feat_g[orphan])
        group_start = np.nonzero(newk)[0]
        appended_keys = np.ascontiguousarray(
            ws[group_start[uniq_g]]).view(np.uint8).reshape(-1, _KEY_SIZE)
        feat_match = feat_match.copy()
        feat_match[orphan] = n + np.searchsorted(uniq_g, feat_g[orphan])
    else:
        appended_keys = np.empty((0, _KEY_SIZE), np.uint8)
    idx_blocks, orphan_blocks = [], []
    off = 0
    for b in blocks:
        idx_blocks.append(feat_match[off:off + len(b)])
        orphan_blocks.append(orphan[off:off + len(b)])
        off += len(b)
    return idx_blocks, orphan_blocks, appended_keys


def _drain_map_arrays(bmap, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Drain one map -> (keys (n, key_size) u8, values (n, n_cpus) of
    `dtype`) (reference `:166-194`): from the map's batched drain
    (`drain_batched_arrays`, which may alias the map's buffers;
    `decode_eviction` copies once), its kernel-padded value stride
    (`_pad_vs`) stripped, else from its per-key `drain()` pairs."""
    res = bmap.drain_batched_arrays()
    if res is not None:
        keys_u8, vals_u8 = res
        n = len(keys_u8)
        pad = bmap._pad_vs
        if pad == dtype.itemsize:
            vals = vals_u8.view(dtype)          # (n, n_cpus), no copy
        else:
            vals = np.ascontiguousarray(
                vals_u8.reshape(n, bmap.n_cpus, pad)[:, :, :dtype.itemsize]
            ).view(dtype)[..., 0]
        return keys_u8, vals
    pairs = bmap.drain()
    n = len(pairs)
    if not n:
        return (np.empty((0, bmap.key_size), np.uint8),
                np.empty((0, bmap.n_cpus), dtype))
    keys_u8 = np.frombuffer(b"".join(k for k, _ in pairs),
                            np.uint8).reshape(n, bmap.key_size)
    vals = np.frombuffer(b"".join(v for _, v in pairs),
                         dtype=dtype).reshape(n, bmap.n_cpus)
    return keys_u8, vals


def decode_eviction(agg_keys: np.ndarray, agg_vals: np.ndarray,
                    drained: dict[str, tuple[np.ndarray, np.ndarray]],
                    trace=None, merged: Optional[dict] = None,
                    merge_threads: int = 1) -> EvictedFlows:
    """The Python chain of a drain (reference `:197-281`): merge each
    feature map's per-CPU partials, join the keys, and build the
    eviction. agg_keys (n, 40) u8 and agg_vals (n, 1) FLOW_STATS (the
    aggregation map is not per-CPU); `drained` maps an attr to (keys
    (m, 40) u8, partials (m, n_cpus)). Every output array is allocated
    here (the one copy).

    `merged` (attr -> (m,) merged records) skips the merges, whose
    partials are then unused; `merge_threads` splits each map's merge
    (`flowpack.merge_percpu_batch`). A feature row whose key the
    aggregation drain lacks becomes an appended event, one a unique key,
    shared by every feature that saw it, with the min and max seen times
    across them (`decode_stats["fallback_rows"]`)."""
    trace = trace if trace is not None else tracing.NULL_TRACE
    t0 = time.perf_counter()
    if merged is None:
        with trace.stage("merge_percpu"):
            merged = {attr: flowpack.merge_percpu_batch(
                attr, vals, threads=merge_threads)
                for attr, (_keys, vals) in drained.items()}
    t1 = time.perf_counter()
    with trace.stage("align"):
        n_agg = len(agg_keys)
        attrs = [a for a, (k, _v) in drained.items() if len(k)]
        if attrs:
            idx_blocks, orphan_blocks, appended_keys = _join_keys(
                np.ascontiguousarray(agg_keys),
                [np.ascontiguousarray(drained[a][0]) for a in attrs])
            joins = {a: (idx_blocks[i], orphan_blocks[i])
                     for i, a in enumerate(attrs)}
        else:
            joins, appended_keys = {}, np.empty((0, _KEY_SIZE), np.uint8)
        n = n_agg + len(appended_keys)
        events = flowpack.events_from_keys_stats(
            agg_keys if n_agg else np.empty((0, _KEY_SIZE), np.uint8),
            agg_vals[:, 0] if n_agg else np.empty(0, binfmt.FLOW_STATS_DTYPE),
            n_total=n)
        n_app = len(appended_keys)
        if n_app:
            events["key"][n_agg:] = appended_keys.view(
                binfmt.FLOW_KEY_DTYPE).reshape(-1)
        first_acc = np.full(n_app, _U64_MAX, np.uint64)
        last_acc = np.zeros(n_app, np.uint64)
        features: dict[str, Optional[np.ndarray]] = {}
        for attr in drained:
            recs = merged[attr]
            if n == 0 or not len(recs):
                features[attr] = None
                continue
            idx, orphan = joins[attr]
            if orphan.any():
                oi = idx[orphan] - n_agg
                of = recs["first_seen_ns"][orphan]
                np.minimum.at(first_acc, oi,
                              np.where(of == 0, _U64_MAX, of))
                np.maximum.at(last_acc, oi, recs["last_seen_ns"][orphan])
            out = np.zeros(n, recs.dtype)
            out[idx] = recs  # a key in two drain chunks: the last wins
            features[attr] = out
        if n_app:
            s = events["stats"]
            s["first_seen_ns"][n_agg:] = np.where(
                first_acc == _U64_MAX, np.uint64(0), first_acc)
            s["last_seen_ns"][n_agg:] = last_acc
    evicted = EvictedFlows(events, **features)
    evicted.decode_stats = {"merge_s": t1 - t0,
                            "align_s": time.perf_counter() - t1,
                            "fallback_rows": n_app}
    return evicted


class PackedEviction:
    """Resident regions packed at drain time with the exporter ring's own
    dictionaries, riding an `EvictedFlows` as `packed` (reference
    `:284-308`). `arena` belongs to this object until `free()`; `chunks`
    is the pack plan (`flowpack.PipeChunk`); `epoch` is the pack
    surface's at pack time: the exporter ships the arena only while the
    surface's epoch is the same, else frees it and folds the eviction's
    rows (`sketch/staging.ResidentPackSurface`)."""

    __slots__ = ("arena", "chunks", "epoch", "spill_rows", "dict_resets",
                 "segs", "_res")

    def __init__(self, res: flowpack.PipeResult, epoch: int):
        self.arena = res.arena
        self.chunks = res.chunks
        self.epoch = epoch
        self.spill_rows = res.spill_rows
        self.dict_resets = res.dict_resets
        self.segs = res.segs
        self._res = res

    def free(self) -> None:
        self._res.free()
        self.arena = None


class NativeEvictPipeline:
    """The fused drain's gate (EVICT_NATIVE_PIPELINE; reference
    `:311-446`): a drain's whole host chain as one native call
    (`flowpack.NativePipe.drain`, no GIL held), with a bound pack surface
    the resident pack too. Its output is the Python chain's, byte for
    byte.

    The first drain returns None, so the caller runs the Python chain
    (`decode_eviction`), which probes the kernel's batch map operations.
    The pipe is built at the second. It is disabled for the process, and
    every later drain returns None, when a map lacks batch operations
    (`_no_batch_ops`), a map's capacity is unknown, a feature map's value
    stride is kernel-padded, there are no feature maps, the library
    rejects the configuration, or a fused drain reports a batch error (that
    drain's rows are still returned) or fails. A library that cannot be
    built or loaded raises."""

    def __init__(self, fetcher, lanes: int):
        self._fetcher = fetcher
        self._lanes = max(1, lanes)
        self._pipe: Optional[flowpack.NativePipe] = None
        self._surface = None
        self._drains = 0
        self.disabled = False

    def bind_pack_surface(self, surface) -> None:
        """Attach the exporter ring's `ResidentPackSurface`: fused drains
        then pack its regions too."""
        self._surface = surface

    def _disable(self, why: str) -> None:
        self.disabled = True
        log.warning("native evict pipeline disabled: %s (the Python chain "
                    "carries on)", why)

    def _build(self) -> bool:
        f = self._fetcher
        flowpack.native_lib()  # raises when the library cannot load
        if not f._features:
            self._disable("no feature maps")
            return False
        maps = [(f._agg.fd, "stats", binfmt.FLOW_STATS_DTYPE.itemsize, 1,
                 int(getattr(f._agg, "max_entries", 0) or 0))]
        for attr, (fmap, dtype) in f._features.items():
            maps.append((fmap.fd, attr, dtype.itemsize, fmap.n_cpus,
                         int(getattr(fmap, "max_entries", 0) or 0)))
        for bmap in [f._agg] + [fm for fm, _dt in f._features.values()]:
            if getattr(bmap, "_no_batch_ops", True):
                self._disable("kernel lacks batch map ops")
                return False
        if any(m[4] <= 0 for m in maps):
            self._disable("unknown map capacity")
            return False
        for attr, (fmap, dtype) in f._features.items():
            if fmap._pad_vs != dtype.itemsize:
                self._disable(f"{attr} value stride is kernel-padded")
                return False
        try:
            self._pipe = flowpack.NativePipe(maps, lanes=self._lanes)
        except ValueError as exc:
            self._disable(str(exc))
            return False
        log.info("native evict pipeline engaged: %d maps, %d lanes%s",
                 len(maps), self._lanes,
                 ", pack surface bound" if self._surface else "")
        return True

    def drain(self, trace, t0: float) -> Optional[EvictedFlows]:
        """One fused drain, or None: not engaged (the caller runs the
        Python chain, which also probes the batch operations at drain 1)."""
        if self.disabled:
            return None
        self._drains += 1
        if self._drains == 1:
            return None
        if self._pipe is None and not self._build():
            return None
        surface = self._surface
        epoch = 0
        try:
            with trace.stage("decode"):
                if surface is not None:
                    # the surface lock spans the spec and the native call:
                    # the ladder and the dictionaries must not move, and a
                    # raw fold's invalidation waits for the pack
                    with surface.lock:
                        res = self._pipe.drain(pack=surface.pack_spec())
                        epoch = surface.epoch
                        if res.arena is not None and res.chunks:
                            surface.outstanding += 1
                else:
                    res = self._pipe.drain()
        except RuntimeError as exc:
            self._disable(str(exc))
            return None
        if res.batch_err_mask:
            # a map's batched drain failed part way: its banked rounds are
            # in this result (and deleted from the map), so take them, and
            # leave later drains to the Python chain
            self._disable(f"batch drain error mask {res.batch_err_mask:#x}")
        events = (res.events.copy() if res.events is not None
                  else np.zeros(0, binfmt.FLOW_EVENT_DTYPE))
        feats = {kind: (a.copy() if a is not None else None)
                 for kind, a in res.aligned.items()}
        evicted = EvictedFlows(events, **feats)
        evicted.decode_stats = {
            "merge_s": res.merge_s,      # summed over the lanes
            "align_s": res.join_s,
            "fallback_rows": res.n_orphans,
            "decode_s": res.drain_s + res.merge_s + res.join_s,
            "drain_lanes": self._lanes,
            "seconds": time.perf_counter() - t0,
            "native_path": "fused",
            "native": {"drain_s": res.drain_s, "merge_s": res.merge_s,
                       "join_s": res.join_s, "pack_s": res.pack_s},
        }
        if res.arena is not None and res.chunks:
            evicted.packed = PackedEviction(res, epoch)
        return evicted

    def close(self) -> None:
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None


#: ceiling of an explicit EVICT_DRAIN_LANES
_MAX_DRAIN_LANES = 16


def resolve_drain_lanes(requested: int, n_feature_maps: int) -> int:
    """EVICT_DRAIN_LANES (reference `:449-463`): 0 means one lane a
    feature map, at most the host's CPUs; 1 (or no feature map) the
    sequential drain; an explicit N > 1 up to `_MAX_DRAIN_LANES`, which
    may pass the map count (the surplus splits each map's merge)."""
    if requested == 1 or n_feature_maps == 0:
        return 1
    if requested <= 0:
        return max(1, min(n_feature_maps, os.cpu_count() or 1))
    return min(requested, _MAX_DRAIN_LANES)
