"""The kernel datapath's fetchers and their drain chain: from a kernel map
to the exporter's eviction.

Counterpart of `netobserv_tpu/datapath/loader.py` (`:60-72`, `:85-1279`),
kept as a copy so the port imports nothing of the JAX package:

- the drain chain: `_hash_keys_u64`, `_join_keys`, `_drain_map_arrays` and
  `decode_eviction` (the Python chain: per-CPU merges, the key join, the
  one copy into an `EvictedFlows`), `PackedEviction`,
  `NativeEvictPipeline` (the fused drain's gate) and `resolve_drain_lanes`;
- `BpfmanFetcher` (EBPF_PROGRAM_MANAGER_MODE): an external manager owns the
  programs and pins the maps on bpffs, and the fetcher drains them through
  `datapath/syscall_bpf`, with drain lanes and the fused gate;
- `MinimalKernelFetcher`: the self-managed datapath of the hand-assembled
  programs (`datapath/asm_flowpath`, `asm_probes`, `asm_ssl`), its maps
  created and its programs loaded through the kernel verifier and attached
  by TCX or tc (`_SelfManagedAttach`), with the flow-filter tries;
- `LibbpfKernelFetcher` (`:1387-1762`): the clang-built object
  `_OBJ_PATH` (`datapath/bpf_build.py` makes it; nothing here compiles)
  opened, resized, patched and loaded through `datapath/libbpf`, with its
  probes object's fentry -> kprobe -> none ladder; and `KernelFetcher`
  with `_load_clang_or_fallback` (`:38-56`, `:1850-1876`), the ladder
  from that object to `MinimalKernelFetcher`. Its pins take a prefix of
  their own, as `MinimalKernelFetcher`'s do.

The merges, the event compose and the fused pipeline are the port's
native library (`datapath/flowpack.py`, `csrc/flowpack.cc`); a library
that cannot be built raises, and nothing falls back to the numpy forms
(`model/accumulate.COLUMNAR_MERGES`, `model/binfmt.events_from_keys_stats`),
which stay the tests' plain twins. The gate also runs over any fetcher of
`BpfmanFetcher`'s duck type (`_agg`, and `_features` of attr -> (map,
record dtype), each map with `fd`, `n_cpus`, `max_entries`,
`_no_batch_ops` and `_pad_vs`), as tests drive it with injected maps.

The packet fetchers of PCA (`:1282-1385`, `:1764-1848`):
`MinimalPacketFetcher` over the hand-assembled capture program
(`datapath/asm_pca.py`), `LibbpfPacketFetcher` over the clang object, and
`load_packet_fetcher`, their ladder through `_load_clang_or_fallback`.
Every pin of the port's fetchers is `<prefix><pid>_<program>` under a
prefix of the port's own.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from netobserv_tpu_torch.config import AgentConfig
from netobserv_tpu_torch.datapath import bpf_build, flowpack, syscall_bpf
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.flow import GlobalCounter
from netobserv_tpu_torch.utils import tracing

log = logging.getLogger("netobserv_tpu_torch.datapath.loader")

_U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

_OBJ_PATH = os.path.join(bpf_build.BUILD_DIR, bpf_build.OBJ_NAME)

# (map name, value dtype, EvictedFlows attr) — ALL per-CPU feature maps the
# fetcher drains at eviction (reference merges every enabled feature map,
# pkg/tracer/tracer.go:1057-1110, incl. quic_flows at :1098-1110). The attr
# doubles as the flowpack merge kind.
_FEATURE_MAPS = [
    ("flows_extra", binfmt.EXTRA_REC_DTYPE, "extra"),
    ("flows_dns", binfmt.DNS_REC_DTYPE, "dns"),
    ("flows_drops", binfmt.DROPS_REC_DTYPE, "drops"),
    ("flows_nevents", binfmt.NEVENTS_REC_DTYPE, "nevents"),
    ("flows_xlat", binfmt.XLAT_REC_DTYPE, "xlat"),
    ("flows_quic", binfmt.QUIC_REC_DTYPE, "quic"),
]



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


class BpfmanFetcher:
    """FlowFetcher over maps pinned by an external manager (bpfman mode).

    Eviction runs the columnar plane (decode_eviction); with more than one
    DRAIN LANE (EVICT_DRAIN_LANES) the per-feature-map drain→per-CPU-merge
    pairs run on a worker pool — one batched bpf(2) syscall stream per lane
    — while the calling thread drains the aggregation map, and the
    vectorized `_join_keys` alignment stays the single join point. The
    zero-copy drain-view lifetime rule holds PER LANE: a lane's views alias
    only its own map's cached batch buffers, each map is owned by exactly
    one lane per drain, and every view is copied out at the EvictedFlows
    boundary before lookup_and_delete returns (pinned by
    tests/test_evict_parallel.py + the bpffs aliasing suite). Drains
    serialize (MapTracer's eviction lock), so a lane's buffers are never
    redrained while its views are still being aligned.

    Reference: `netobserv_tpu/datapath/loader.py:466`."""

    needs_iface_discovery = False  # program lifecycle is externally managed
    # class-level default so partially-constructed fetchers (subclasses
    # mid-__init__, test stubs) read an absent gate, never AttributeError
    _native_gate: Optional["NativeEvictPipeline"] = None

    def __init__(self, bpf_fs_path: str, drain_lanes: int = 0,
                 native_pipeline: bool = False):
        """Reference: `netobserv_tpu/datapath/loader.py:487`."""
        self._n_cpus = syscall_bpf.n_possible_cpus()
        self._base = bpf_fs_path

        def openmap(name, value_size, per_cpu):
            return syscall_bpf.BpfMap.open_pinned(
                os.path.join(bpf_fs_path, name),
                key_size=binfmt.FLOW_KEY_DTYPE.itemsize,
                value_size=value_size,
                n_cpus=self._n_cpus if per_cpu else 1)

        self._agg = openmap("aggregated_flows",
                            binfmt.FLOW_STATS_DTYPE.itemsize, False)
        self._features = {}
        for name, dtype, attr in _FEATURE_MAPS:
            try:
                self._features[attr] = (openmap(name, dtype.itemsize, True),
                                        dtype)
            except OSError:
                log.debug("pinned map %s absent (feature disabled)", name)
        try:
            self._counters = syscall_bpf.BpfMap.open_pinned(
                os.path.join(bpf_fs_path, "global_counters"), key_size=4,
                value_size=8, n_cpus=self._n_cpus)
        except OSError:
            self._counters = None
        # map-full fallback ring buffer (consumed via mmap when pinned)
        self._ringbuf = None
        try:
            rb_map = syscall_bpf.BpfMap.open_pinned(
                os.path.join(bpf_fs_path, "direct_flows"), key_size=0,
                value_size=0)
            self._ringbuf = syscall_bpf.RingBufReader(rb_map)
        except (OSError, ValueError):
            log.debug("pinned direct_flows ringbuf absent; fallback disabled")
        # OpenSSL-uprobe plaintext events (consumed via mmap when pinned)
        self._ssl_rb = None
        try:
            ssl_map = syscall_bpf.BpfMap.open_pinned(
                os.path.join(bpf_fs_path, "ssl_events"), key_size=0,
                value_size=0)
            self._ssl_rb = syscall_bpf.RingBufReader(ssl_map)
        except (OSError, ValueError):
            log.debug("pinned ssl_events ringbuf absent")
        self._init_drain_lanes(drain_lanes)
        if native_pipeline and self._features:
            self._native_gate = NativeEvictPipeline(self, self._drain_lanes)

    def _init_drain_lanes(self, drain_lanes: int) -> None:
        """Provision the drain-lane pool (shared by the subclassed
        self-managed fetchers, which call this after their own map setup).
        Sequential resolution (1 lane) keeps the pool unbuilt — the
        parallel path is then one is-None check.

        Reference: `netobserv_tpu/datapath/loader.py:536`."""
        self._drain_lanes = resolve_drain_lanes(drain_lanes,
                                                len(self._features))
        self._drain_pool = None
        # EVICT_NATIVE_PIPELINE gate (bpfman mode only; unset = one
        # is-None check on the drain path)
        self._native_gate: Optional[NativeEvictPipeline] = None
        if self._drain_lanes > 1:
            from concurrent.futures import ThreadPoolExecutor
            # the pool never needs more workers than maps — lanes beyond
            # the map count become per-map merge row-shards instead
            # (_lookup_and_delete_lanes mthreads)
            self._drain_pool = ThreadPoolExecutor(
                max_workers=min(self._drain_lanes, len(self._features)),
                thread_name_prefix="evict-drain")
            log.info("eviction drain lanes: %d (feature maps: %d)",
                     self._drain_lanes, len(self._features))

    @classmethod
    def load(cls, cfg: AgentConfig) -> "BpfmanFetcher":
        """Reference: `netobserv_tpu/datapath/loader.py:559`."""
        return cls(cfg.bpfman_bpf_fs_path,
                   drain_lanes=cfg.evict_drain_lanes,
                   native_pipeline=cfg.evict_native_pipeline)

    def bind_pack_surface(self, surface) -> None:
        """Exporter hook: with EVICT_NATIVE_PIPELINE engaged, fused drains
        also pack resident regions with the exporter ring's dictionaries
        (staging.ResidentPackSurface). No-op when the gate is off.

        Reference: `netobserv_tpu/datapath/loader.py:564`."""
        if self._native_gate is not None:
            self._native_gate.bind_pack_surface(surface)

    def map_capacity(self) -> int:
        """max_entries of the kernel aggregation map — the denominator of
        the map-pressure watermark. In bpfman mode the external manager
        sized the map, so the agent reads the REAL capacity instead of
        trusting its own CACHE_MAX_FLOWS; 0 when unknown.

        Reference: `netobserv_tpu/datapath/loader.py:571`."""
        if self._agg is None:
            return 0
        return int(getattr(self._agg, "max_entries", 0) or 0)

    def lookup_and_delete(self) -> EvictedFlows:
        """Reference: `netobserv_tpu/datapath/loader.py:580`."""
        # columnar eviction plane: whole-array drain decode -> one batched
        # per-CPU merge per feature map -> vectorized key alignment. Child
        # spans ride the batch trace map_tracer bound for this drain (per
        # drain, never per record; unsampled drains get the null trace).
        trace = tracing.active_trace()
        t0 = time.perf_counter()
        if self._native_gate is not None:
            evicted = self._native_gate.drain(trace, t0)
            if evicted is not None:
                return evicted
            # probe drain or disqualified: island chain carries this one
        if self._drain_pool is not None and self._features:
            evicted = self._lookup_and_delete_lanes(trace, t0)
            if self._native_gate is not None:
                evicted.decode_stats["native_path"] = "chain"
            return evicted
        with trace.stage("decode"):
            agg_keys, agg_vals = _drain_map_arrays(
                self._agg, binfmt.FLOW_STATS_DTYPE)
            drained = {attr: _drain_map_arrays(fmap, dtype)
                       for attr, (fmap, dtype) in self._features.items()}
        t1 = time.perf_counter()
        evicted = decode_eviction(agg_keys, agg_vals, drained, trace=trace)
        evicted.decode_stats["decode_s"] = t1 - t0
        evicted.decode_stats["drain_lanes"] = 1
        evicted.decode_stats["seconds"] = time.perf_counter() - t0
        if self._native_gate is not None:
            evicted.decode_stats["native_path"] = "chain"
        return evicted

    def _lookup_and_delete_lanes(self, trace, t0: float) -> EvictedFlows:
        """Parallel drain lanes: each worker owns one feature map for this
        drain — batched drain syscalls + the native per-CPU merge, both of
        which release the GIL, run concurrently across maps while the
        calling thread drains the (largest) aggregation map. Merged records
        are fresh arrays; only the key views still alias lane buffers, and
        `decode_eviction` copies them out before returning (the per-lane
        zero-copy lifetime rule — class docstring).

        Reference: `netobserv_tpu/datapath/loader.py:611`."""
        # maps with fewer lanes than workers row-shard their native merge
        mthreads = max(1, self._drain_lanes // max(1, len(self._features)))

        def lane(attr, fmap, dtype):
            ks, vals = _drain_map_arrays(fmap, dtype)
            tm = time.perf_counter()
            recs = flowpack.merge_percpu_batch(attr, vals,
                                               threads=mthreads)
            return attr, ks, recs, time.perf_counter() - tm

        with trace.stage("decode"):
            futs = [self._drain_pool.submit(lane, attr, fmap, dtype)
                    for attr, (fmap, dtype) in self._features.items()]
            agg_keys, agg_vals = _drain_map_arrays(
                self._agg, binfmt.FLOW_STATS_DTYPE)
            lanes = [f.result() for f in futs]
        t1 = time.perf_counter()
        # vals half None: the per-CPU partials were consumed in-lane —
        # decode_eviction's merged= contract (never smuggle merged
        # records into the partials slot)
        drained = {attr: (ks, None) for attr, ks, _recs, _dt in lanes}
        evicted = decode_eviction(
            agg_keys, agg_vals, drained, trace=trace,
            merged={attr: recs for attr, _ks, recs, _dt in lanes})
        # merge ran inside the lanes: report the summed lane CPU (the
        # overlap evidence — decode_s is the whole section's WALL)
        evicted.decode_stats["merge_s"] = sum(dt for *_x, dt in lanes)
        evicted.decode_stats["decode_s"] = t1 - t0
        evicted.decode_stats["drain_lanes"] = self._drain_lanes
        evicted.decode_stats["seconds"] = time.perf_counter() - t0
        return evicted

    def read_ringbuf(self, timeout_s: float) -> Optional[bytes]:
        """Consume the map-full fallback ring buffer (mmap reader) — the
        reference's bpfman branch also runs the ringbuf reader over the
        pinned map.

        Reference: `netobserv_tpu/datapath/loader.py:651`."""
        if self._ringbuf is None:
            time.sleep(timeout_s)
            return None
        return self._ringbuf.read(timeout_s)

    def read_ssl(self, timeout_s: float) -> Optional[bytes]:
        """Reference: `netobserv_tpu/datapath/loader.py:660`."""
        if self._ssl_rb is None:
            time.sleep(timeout_s)
            return None
        return self._ssl_rb.read(timeout_s)

    def read_global_counters(self) -> dict[GlobalCounter, int]:
        """Reference: `netobserv_tpu/datapath/loader.py:666`."""
        out: dict[GlobalCounter, int] = {}
        if self._counters is None:
            return out
        import struct as _struct
        for ctr in GlobalCounter:
            if ctr is GlobalCounter.MAX:
                continue
            key = _struct.pack("=I", ctr.value)
            raw = self._counters.lookup(key)
            if raw is None:
                continue
            total = sum(_struct.unpack_from("=Q", raw, off)[0]
                        for off in range(0, len(raw), 8))
            if total:
                out[ctr] = total
                # reset by writing zeros
                self._counters.update(key, b"\x00" * len(raw))
        return out

    def program_filters(self, rules) -> int:
        """Compile FLOW_FILTER_RULES into the pinned LPM tries (reference:
        Filter.ProgramFilter). Returns the number of rules written; 0 when
        the filter maps aren't pinned.

        Reference: `netobserv_tpu/datapath/loader.py:686`."""
        from netobserv_tpu_torch.datapath import filter_compile

        compiled = filter_compile.compile_filters(rules)
        rules_map = peers_map = None
        try:
            try:
                rules_map = syscall_bpf.BpfMap.open_pinned(
                    os.path.join(self._base, "filter_rules"),
                    key_size=filter_compile.FILTER_KEY_SIZE,
                    value_size=filter_compile.FILTER_RULE_SIZE)
                peers_map = syscall_bpf.BpfMap.open_pinned(
                    os.path.join(self._base, "filter_peers"),
                    key_size=filter_compile.FILTER_KEY_SIZE, value_size=1)
            except OSError:
                log.warning("filter maps not pinned; FLOW_FILTER_RULES ignored")
                return 0
            if (rules_map.max_entries
                    and len(compiled.rules) > rules_map.max_entries):
                raise ValueError(
                    f"{len(compiled.rules)} filter rules exceed the pinned "
                    f"trie capacity {rules_map.max_entries}")
            for key, value in compiled.rules:
                rules_map.update(key, value)
            for key, value in compiled.peers:
                peers_map.update(key, value)
        finally:
            if rules_map is not None:
                rules_map.close()
            if peers_map is not None:
                peers_map.close()
        # NOTE: matching only takes effect if the external manager loaded the
        # datapath with cfg_enable_flow_filtering=1 (a load-time constant this
        # process cannot flip)
        log.info("wrote %d filter rules (+%d peer CIDRs); effective only if "
                 "the datapath was loaded with filtering enabled",
                 len(compiled.rules), len(compiled.peers))
        return len(compiled.rules)

    # no_dns_corr_key layout (bpf/maps.h); value = u64 query timestamp (mono)
    DNS_CORR_KEY_SIZE = 40

    def purge_stale(self, older_than_s: float) -> int:
        """Drop unanswered DNS/RTT correlations older than the deadline
        (reference: DeleteMapsStaleEntries, `tracer.go:1188-1216`). Lazily
        opens the pinned correlation maps; returns the purge count.

        Reference: `netobserv_tpu/datapath/loader.py:731`."""
        for attr, pin in (("_dns_inflight", "dns_inflight"),
                          ("_rtt_inflight", "rtt_inflight")):
            if not hasattr(self, attr):
                try:
                    setattr(self, attr, syscall_bpf.BpfMap.open_pinned(
                        os.path.join(self._base, pin),
                        key_size=self.DNS_CORR_KEY_SIZE, value_size=8))
                except (OSError, ValueError):
                    setattr(self, attr, None)
        import struct as _struct

        deadline = time.clock_gettime_ns(time.CLOCK_MONOTONIC) - int(
            older_than_s * 1e9)
        purged = 0
        # both correlation maps hold a u64 monotonic stamp per 40-byte key
        for corr in (self._dns_inflight, self._rtt_inflight):
            if corr is None:
                continue
            for key in corr.keys():
                raw = corr.lookup(key)
                if raw is None:
                    continue
                (sent_ns,) = _struct.unpack_from("=Q", raw, 0)
                if sent_ns < deadline:
                    if corr.delete(key):
                        purged += 1
        if purged:
            log.debug("purged %d stale correlations (dns/rtt)", purged)
        return purged

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:765`."""
        pass  # programs are attached by the external manager

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:769`."""
        pass

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:773`."""
        if getattr(self, "_drain_pool", None) is not None:
            self._drain_pool.shutdown(wait=True)
            self._drain_pool = None
        if getattr(self, "_native_gate", None) is not None:
            self._native_gate.close()
            self._native_gate = None
        self._agg.close()
        for fmap, _ in self._features.values():
            fmap.close()
        if self._counters is not None:
            self._counters.close()
        if self._ringbuf is not None:
            self._ringbuf.close()
        if self._ssl_rb is not None:
            self._ssl_rb.close()
        for attr in ("_dns_inflight", "_rtt_inflight"):
            corr = getattr(self, attr, None)
            if corr is not None:
                corr.close()


BPF_MAP_TYPE_LPM_TRIE = 11
BPF_F_NO_PREALLOC = 1


def _create_filter_tries():
    """(filter_rules, filter_peers) LPM tries — shared by the flow and PCA
    self-managed fetchers.

    Reference: `netobserv_tpu/datapath/loader.py:799`."""
    from netobserv_tpu_torch.datapath import filter_compile

    rules = syscall_bpf.BpfMap.create(
        BPF_MAP_TYPE_LPM_TRIE, filter_compile.FILTER_KEY_SIZE,
        filter_compile.FILTER_RULE_SIZE, filter_compile.MAX_FILTER_RULES,
        b"filter_rules", flags=BPF_F_NO_PREALLOC)
    peers = syscall_bpf.BpfMap.create(
        BPF_MAP_TYPE_LPM_TRIE, filter_compile.FILTER_KEY_SIZE, 1,
        filter_compile.MAX_FILTER_RULES, b"filter_peers",
        flags=BPF_F_NO_PREALLOC)
    return rules, peers


def _program_filter_tries(rules_map, peers_map, rules) -> int:
    """Compile FLOW_FILTER_RULES into live LPM tries; returns rules written.

    Reference: `netobserv_tpu/datapath/loader.py:815`."""
    from netobserv_tpu_torch.datapath import filter_compile

    compiled = filter_compile.compile_filters(rules)
    for key, value in compiled.rules:
        rules_map.update(key, value)
    for key, value in compiled.peers:
        peers_map.update(key, value)
    return len(compiled.rules)


def _pin_owner_alive(suffix: str) -> bool:
    """Whether the process named by a pin's `<pid>_<program>` suffix still
    runs. A suffix with no pid is no pin of the port's, and is swept."""
    pid, sep, _name = suffix.partition("_")
    if not sep or not pid.isdigit() or int(pid) <= 0:
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # alive, owned by another user
    return True


class _SelfManagedAttach:
    """TC/TCX attach lifecycle shared by the self-managed fetchers (flow +
    PCA): per-direction pinned programs, tcx/tc/any mode dispatch, netns
    entry, stale legacy cleanup, and full detach on close. Users provide
    `self._prog_fds`/`self._pins` (direction -> fd / pin path) and
    `self._mode`; `self._attached` maps (netns, if_index) -> (name, dir ->
    Attachment).

    Reference: `netobserv_tpu/datapath/loader.py:827`."""

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None:
        """Attach inside `netns` when named: the calling thread enters the
        namespace for the attach syscalls (ifindex resolves there; TCX links
        and tc subprocesses bind to it) and restores itself after (reference:
        interfaces_listener.go:272-298 netns-scoped attach).

        Reference: `netobserv_tpu/datapath/loader.py:835`."""
        from netobserv_tpu_torch.datapath import tc_attach
        from netobserv_tpu_torch.ifaces.netns import netns_context

        wanted = (["ingress", "egress"] if direction == "both"
                  else [direction])
        name, done = self._attached.setdefault(
            (netns, if_index), (if_name, {}))

        def stale_cleanup():
            # first legacy attach on this interface: drop stale clsact state
            # from prior runs (reference removeTCFilters, tracer.go:542-566);
            # never run when TCX succeeded — it would destroy third-party
            # clsact filters for nothing
            if not any(a.kind == "tc" for a in done.values()):
                tc_attach.remove_clsact(if_name)

        with netns_context(netns):
            for d in wanted:
                if d in done:
                    continue  # idempotent across listener retries
                done[d] = tc_attach.attach_mode(
                    self._prog_fds[d], self._pins[d], if_name, if_index, d,
                    mode=self._mode, pre_legacy=stale_cleanup)

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:865`."""
        from netobserv_tpu_torch.ifaces.netns import netns_context

        entry = self._attached.pop((netns, if_index), None)
        if entry is None:
            return
        name, done = entry
        # TCX link closes are namespace-agnostic (fd-bound); legacy tc CLI
        # detaches must run inside the namespace. Enter it separately so a
        # failed entry/exit never re-runs detach on already-closed link fds.
        ctx = netns_context(netns)
        entered = True
        try:
            ctx.__enter__()
        except OSError as exc:
            entered = False
            log.debug("cannot enter netns %r to detach %s (%s); tc filters "
                      "die with the namespace", netns, name, exc)
        try:
            for d, att in done.items():
                if att.kind == "tc" and not entered:
                    continue  # tc CLI would hit the wrong namespace
                try:
                    att.detach()
                except Exception as exc:
                    log.debug("detach %s %s failed: %s", name, d, exc)
        finally:
            if entered:
                try:
                    ctx.__exit__(None, None, None)
                except OSError as exc:  # pragma: no cover - setns restore
                    log.warning("failed to restore netns after detach: %s",
                                exc)

    def _sweep_stale_pins(self) -> None:
        """Unpin leftovers from crashed runs (their TC filters die with the
        clsact qdisc, which attach() resets per interface; TCX links die with
        their fds at process exit — only the pins linger).

        Reference: `netobserv_tpu/datapath/loader.py:900`, which unlinks
        every pin under its prefix. Here a pin is named
        `<prefix><pid>_<program>`, and one whose process still lives is
        kept: another agent or test of the port may be using it."""
        import glob

        for path in glob.glob(self._PIN_PREFIX + "*"):
            if _pin_owner_alive(path[len(self._PIN_PREFIX):]):
                continue
            try:
                os.unlink(path)
                log.info("removed stale program pin %s", path)
            except OSError:
                pass

    def _init_empty_maps(self) -> None:
        """The inherited eviction path expects these BpfmanFetcher fields;
        everything close() touches is initialized here so a failed
        _provision can clean up safely.

        Reference: `netobserv_tpu/datapath/loader.py:913`."""
        self._n_cpus = syscall_bpf.n_possible_cpus()
        self._base = ""
        self._features = {}
        self._drain_pool = None
        self._drain_lanes = 1
        self._agg = None
        self._prog_fds = {}
        self._pins = {}
        self._attached = {}
        self._counters = None
        self._ringbuf = None
        self._ssl_rb = None
        self._ssl_map = None
        self._ssl_uprobe = None
        self._kprobes = []
        self._gate_map = None
        self._dns_inflight = None
        self._rtt_inflight = None
        self._rb_map = None
        self._filter_rules = None
        self._filter_peers = None

    def _teardown_attachments(self) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:939`."""
        from netobserv_tpu_torch.datapath import tc_attach
        from netobserv_tpu_torch.ifaces.netns import netns_context

        for key in list(self._attached):
            netns, if_index = key
            name, dirs = self._attached[key]
            legacy = any(att.kind == "tc" for att in dirs.values())
            try:
                self.detach(if_index, name, netns=netns)
                if legacy:
                    with netns_context(netns):
                        tc_attach.remove_clsact(name)
            except Exception as exc:
                log.debug("cleanup of %s failed: %s", name, exc)
        for fd in set(self._prog_fds.values()):
            try:
                os.close(fd)
            except OSError:
                pass
        for pin in set(self._pins.values()):
            if os.path.exists(pin):
                os.unlink(pin)


class MinimalKernelFetcher(_SelfManagedAttach, BpfmanFetcher):
    """Self-managed kernel datapath from the hand-assembled flow program
    (datapath/asm_flowpath.py): creates the maps, loads one program per
    direction through the live verifier, attaches/detaches interfaces via
    TCX/TC, and evicts with the same syscall drain as bpfman mode.

    Feature coverage (each gated on config, like the C datapath's
    loader-rewritten constants): IPv4+IPv6 TCP/UDP/ICMP flows with MACs/DSCP/
    TCP flags, first-seen-interface dedup, 1/N sampling, DNS latency tracking
    (dns_inflight correlation + per-CPU flows_dns feature map), map-full
    fallback into the direct_flows ring buffer, and global health counters.
    Remaining clang-object-only features: in-kernel flow filter, TLS/QUIC
    inline trackers, RTT/drops/network-events probes (reference:
    pkg/tracer/tracer.go:92-273 loads the CO-RE object instead).

    Reference: `netobserv_tpu/datapath/loader.py:964`."""

    needs_iface_discovery = True
    # a prefix of its own, which the reference's stale-pin sweep
    # ("netobserv_minflow_*") does not match, nor this one the reference's:
    # the two agents' fetchers may run side by side on one host
    _PIN_PREFIX = "/sys/fs/bpf/netobserv_torch_minflow_"

    BPF_MAP_TYPE_HASH = 1
    BPF_MAP_TYPE_LPM_TRIE = 11
    BPF_MAP_TYPE_PERCPU_HASH = 5
    BPF_MAP_TYPE_PERCPU_ARRAY = 6
    BPF_MAP_TYPE_RINGBUF = 27
    BPF_F_NO_PREALLOC = 1

    def __init__(self, cache_max_flows: int = 5000,
                 attach_mode: str = "tcx", sampling: int = 0,
                 enable_dns: bool = False, dns_port: int = 53,
                 enable_rtt: bool = False, enable_pkt_drops: bool = False,
                 enable_filters: bool = False, quic_mode: int = 0,
                 has_filter_sampling: bool = False,
                 enable_tls: bool = False,
                 enable_openssl: bool = False, libssl_path: str = "",
                 enable_ringbuf_fallback: bool = True,
                 ringbuf_bytes: int = 1 << 17,
                 drain_lanes: int = 0,
                 native_pipeline: bool = False,
                 # maps.h DEF_RINGBUF(ssl_events, 1<<27): 16KB * 1000/s * 5s
                 ssl_ring_bytes: int = 1 << 27):
        """Reference: `netobserv_tpu/datapath/loader.py:989`."""
        self._init_empty_maps()
        self._sweep_stale_pins()
        self._mode = attach_mode
        try:
            self._has_filter_sampling = (has_filter_sampling
                                         and enable_filters)
            self._provision(
                cache_max_flows, sampling, enable_dns, dns_port, enable_rtt,
                enable_pkt_drops, enable_filters, quic_mode, enable_tls,
                enable_openssl, libssl_path, enable_ringbuf_fallback,
                ringbuf_bytes, ssl_ring_bytes)
            self._init_drain_lanes(drain_lanes)
            if native_pipeline and self._features:
                self._native_gate = NativeEvictPipeline(self,
                                                        self._drain_lanes)
        except Exception:
            # a half-provisioned fetcher must not leak map/prog fds (a
            # supervisor retrying construction would exhaust fds)
            self.close()
            raise

    def _provision(self, cache_max_flows, sampling, enable_dns, dns_port,
                   enable_rtt, enable_pkt_drops, enable_filters, quic_mode,
                   enable_tls, enable_openssl, libssl_path,
                   enable_ringbuf_fallback, ringbuf_bytes, ssl_ring_bytes):
        """Reference: `netobserv_tpu/datapath/loader.py:1024`."""
        from netobserv_tpu_torch.datapath import asm_flowpath
        from netobserv_tpu_torch.model.flow import GlobalCounter

        log.info("assembler datapath features: dns=%s rtt=%s drops=%s "
                 "filters=%s quic=%d tls=%s openssl=%s sampling=%d "
                 "filter_sampling=%s", enable_dns, enable_rtt,
                 enable_pkt_drops, enable_filters, quic_mode, enable_tls,
                 enable_openssl, sampling, self._has_filter_sampling)
        self._agg = syscall_bpf.BpfMap.create(
            self.BPF_MAP_TYPE_HASH, binfmt.FLOW_KEY_DTYPE.itemsize,
            binfmt.FLOW_STATS_DTYPE.itemsize, cache_max_flows, b"agg_flows")
        self._counters = syscall_bpf.BpfMap.create(
            self.BPF_MAP_TYPE_PERCPU_ARRAY, 4, 8, int(GlobalCounter.MAX),
            b"global_counters")
        dns_q_fd = dns_rec_fd = None
        if enable_dns:
            self._dns_inflight = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_HASH, self.DNS_CORR_KEY_SIZE, 8,
                max(cache_max_flows, 1024), b"dns_inflight")
            dns_rec = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_PERCPU_HASH, binfmt.FLOW_KEY_DTYPE.itemsize,
                binfmt.DNS_REC_DTYPE.itemsize, cache_max_flows, b"flows_dns")
            self._features["dns"] = (dns_rec, binfmt.DNS_REC_DTYPE)
            dns_q_fd, dns_rec_fd = self._dns_inflight.fd, dns_rec.fd
        rtt_q_fd = rtt_rec_fd = None
        if enable_rtt:
            self._rtt_inflight = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_HASH, self.DNS_CORR_KEY_SIZE, 8,
                max(cache_max_flows, 1024), b"rtt_inflight")
            extra_rec = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_PERCPU_HASH, binfmt.FLOW_KEY_DTYPE.itemsize,
                binfmt.EXTRA_REC_DTYPE.itemsize, cache_max_flows,
                b"flows_extra")
            self._features["extra"] = (extra_rec, binfmt.EXTRA_REC_DTYPE)
            rtt_q_fd, rtt_rec_fd = self._rtt_inflight.fd, extra_rec.fd
        # per-CPU sampling gate: only needed when sampling can skip packets
        # AND a kprobe consumes the decision (reference do_sampling pattern)
        self._gate_map = None
        want_probes = enable_rtt or enable_pkt_drops
        if (sampling > 1 or self._has_filter_sampling) and want_probes:
            self._gate_map = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_PERCPU_ARRAY, 4, 1, 1, b"sampling_gate")
        gate_fd = self._gate_map.fd if self._gate_map else None
        if enable_rtt:
            # smoothed-RTT tracepoint (tcp/tcp_probe) alongside the TC
            # handshake RTT: both max-merge into flows_extra (handle_rtt).
            # Best-effort: a locked-down tracefs must not take down the
            # still-functional handshake-RTT path.
            from netobserv_tpu_torch.datapath import asm_probes, uprobe

            try:
                self._attach_tracepoint(
                    asm_probes.build_rtt_tracepoint_program(
                        uprobe.tracepoint_fields("tcp", "tcp_probe"),
                        self._features["extra"][0].fd, gate_fd),
                    "tcp", "tcp_probe", b"rtt_srtt")
                log.info("smoothed-RTT tracepoint attached (tcp/tcp_probe)")
            except (OSError, RuntimeError, KeyError) as exc:
                log.warning("smoothed-RTT tracepoint unavailable (%s); "
                            "handshake RTT only", exc)
        if enable_pkt_drops:
            from netobserv_tpu_torch.datapath import asm_probes, btf, uprobe

            if not btf.available():
                raise RuntimeError("ENABLE_PKT_DROPS needs "
                                   "/sys/kernel/btf/vmlinux to walk the "
                                   "dropped skb's headers")
            drops_rec = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_PERCPU_HASH,
                binfmt.FLOW_KEY_DTYPE.itemsize,
                binfmt.DROPS_REC_DTYPE.itemsize, cache_max_flows,
                b"flows_drops")
            self._features["drops"] = (drops_rec, binfmt.DROPS_REC_DTYPE)
            self._attach_tracepoint(
                asm_probes.build_drops_program(
                    btf.kernel_btf(), drops_rec.fd,
                    uprobe.tracepoint_fields("skb", "kfree_skb"),
                    sampling_gate_fd=gate_fd),
                "skb", "kfree_skb", b"pkt_drops")
            log.info("packet-drop tracepoint attached (skb/kfree_skb, "
                     "BTF-resolved skb offsets)")
        quic_fd = None
        if quic_mode:
            quic_rec = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_PERCPU_HASH, binfmt.FLOW_KEY_DTYPE.itemsize,
                binfmt.QUIC_REC_DTYPE.itemsize, cache_max_flows,
                b"flows_quic")
            self._features["quic"] = (quic_rec, binfmt.QUIC_REC_DTYPE)
            quic_fd = quic_rec.fd
        flt_rules_fd = flt_peers_fd = None
        if enable_filters:
            self._filter_rules, self._filter_peers = _create_filter_tries()
            flt_rules_fd = self._filter_rules.fd
            flt_peers_fd = self._filter_peers.fd
        rb_fd = None
        if enable_ringbuf_fallback:
            self._rb_map = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_RINGBUF, 0, 0, ringbuf_bytes,
                b"direct_flows")
            self._ringbuf = syscall_bpf.RingBufReader(self._rb_map)
            rb_fd = self._rb_map.fd
        if enable_openssl:
            from netobserv_tpu_torch.datapath import asm_ssl, uprobe

            path, sym_off = uprobe.resolve_ssl_library(libssl_path)
            self._ssl_map = syscall_bpf.BpfMap.create(
                self.BPF_MAP_TYPE_RINGBUF, 0, 0, ssl_ring_bytes,
                b"ssl_events")
            ssl_prog = syscall_bpf.prog_load(
                asm_ssl.build_ssl_write_program(self._ssl_map.fd),
                prog_type=syscall_bpf.BPF_PROG_TYPE_KPROBE,
                name=b"ssl_write")
            try:
                self._ssl_uprobe = uprobe.UprobeAttachment(
                    ssl_prog, path, sym_off)
            finally:
                os.close(ssl_prog)  # the perf event holds its own reference
            self._ssl_rb = syscall_bpf.RingBufReader(self._ssl_map)
            log.info("OpenSSL plaintext tracer attached: uprobe on %s", path)
        # one program instance per direction so direction_first is correct
        self._prog_fds: dict[str, int] = {}
        self._pins: dict[str, str] = {}
        for name, code in (("ingress", 0), ("egress", 1)):
            fd = syscall_bpf.prog_load(
                asm_flowpath.build_flow_program(
                    self._agg.fd, direction=code, sampling=sampling,
                    ringbuf_fd=rb_fd, counters_fd=self._counters.fd,
                    dns_inflight_fd=dns_q_fd, flows_dns_fd=dns_rec_fd,
                    dns_port=dns_port, rtt_inflight_fd=rtt_q_fd,
                    flows_extra_fd=rtt_rec_fd,
                    filter_rules_fd=flt_rules_fd,
                    filter_peers_fd=flt_peers_fd,
                    flows_quic_fd=quic_fd, quic_mode=quic_mode,
                    enable_tls=enable_tls, sampling_gate_fd=gate_fd,
                    has_filter_sampling=self._has_filter_sampling))
            pin = f"{self._PIN_PREFIX}{os.getpid()}_{name}"
            if os.path.exists(pin):
                os.unlink(pin)
            syscall_bpf.obj_pin(fd, pin)
            self._prog_fds[name] = fd
            self._pins[name] = pin
        # (netns, if_index) -> (if_name, direction -> live Attachment)
        self._attached: dict[tuple[str, int], tuple[str, dict]] = {}

    _UNSUPPORTED_FEATURES = (
        ("enable_network_events_monitoring", "network events (psample)"),
        ("enable_pkt_translation", "packet translation (nf_nat)"),
        ("enable_ipsec_tracking", "IPsec (xfrm)"),
    )

    @classmethod
    def load(cls, cfg: AgentConfig) -> "MinimalKernelFetcher":
        """Reference: `netobserv_tpu/datapath/loader.py:1179`."""
        import shutil

        if os.geteuid() != 0:
            raise RuntimeError("kernel datapath requires root/CAP_BPF")
        if cfg.tc_attach_mode != "tcx" and shutil.which("tc") is None:
            raise RuntimeError("tc (iproute2) not found; cannot attach")
        wanted = [label for attr, label in cls._UNSUPPORTED_FEATURES
                  if getattr(cfg, attr)]
        if wanted:
            log.warning("enabled features need kprobe/fentry hooks the "
                        "assembler datapath cannot provide: %s — they will "
                        "produce no data (build the clang probes object or "
                        "use bpfman mode)", ", ".join(wanted))
        has_filter_sampling = bool(cfg.flow_filter_rules) and any(
            getattr(r, "sample", 0) for r in cfg.parsed_filter_rules())
        return cls(cache_max_flows=cfg.cache_max_flows,
                   attach_mode=cfg.tc_attach_mode, sampling=cfg.sampling,
                   enable_dns=cfg.enable_dns_tracking,
                   dns_port=cfg.dns_tracking_port,
                   enable_rtt=cfg.enable_rtt,
                   enable_pkt_drops=cfg.enable_pkt_drops,
                   enable_filters=bool(cfg.flow_filter_rules),
                   has_filter_sampling=has_filter_sampling,
                   quic_mode=cfg.quic_tracking_mode,
                   enable_tls=cfg.enable_tls_tracking,
                   enable_openssl=cfg.enable_openssl_tracking,
                   libssl_path=cfg.openssl_path,
                   enable_ringbuf_fallback=cfg.enable_flows_ringbuf_fallback,
                   drain_lanes=cfg.evict_drain_lanes,
                   native_pipeline=cfg.evict_native_pipeline)

    def _attach_tracepoint(self, prog_bytes: bytes, category: str,
                           name: str, prog_name: bytes) -> None:
        """Load a tracepoint program and bind it to its perf event; the
        live attachment owns the program (the prog fd is dropped).

        Reference: `netobserv_tpu/datapath/loader.py:1211`."""
        from netobserv_tpu_torch.datapath import uprobe

        prog = syscall_bpf.prog_load(
            prog_bytes, prog_type=syscall_bpf.BPF_PROG_TYPE_TRACEPOINT,
            name=prog_name)
        try:
            self._kprobes.append(
                uprobe.TracepointAttachment(prog, category, name))
        finally:
            os.close(prog)

    def program_filters(self, rules) -> int:
        """Compile FLOW_FILTER_RULES into this fetcher's own LPM tries (the
        bpfman override programs pinned tries instead). The kernel-side gate
        is active because the programs were built with the trie fds wired.

        Reference: `netobserv_tpu/datapath/loader.py:1226`."""
        from netobserv_tpu_torch.datapath import filter_compile

        if self._filter_rules is None:
            if rules:
                log.warning("filter maps not provisioned (enable_filters "
                            "was off at load); FLOW_FILTER_RULES ignored")
            return 0
        if (any(getattr(r, "sample", 0) for r in rules)
                and not getattr(self, "_has_filter_sampling", False)):
            log.warning("rules carry sample overrides but the programs were "
                        "built without has_filter_sampling; overrides will "
                        "not take effect (reload with the flag)")
        n = _program_filter_tries(self._filter_rules, self._filter_peers,
                                  rules)
        log.info("programmed %d filter rules into the kernel gate", n)
        return n

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1247`."""
        if getattr(self, "_drain_pool", None) is not None:
            self._drain_pool.shutdown(wait=True)
            self._drain_pool = None
        self._teardown_attachments()
        if self._agg is not None:
            self._agg.close()
        if self._counters is not None:
            self._counters.close()
        if self._ringbuf is not None:
            self._ringbuf.close()
        if self._rb_map is not None:
            self._rb_map.close()
        if self._dns_inflight is not None:
            self._dns_inflight.close()
        if self._rtt_inflight is not None:
            self._rtt_inflight.close()
        if self._filter_rules is not None:
            self._filter_rules.close()
        if self._filter_peers is not None:
            self._filter_peers.close()
        if self._ssl_uprobe is not None:
            self._ssl_uprobe.close()
        if self._ssl_rb is not None:
            self._ssl_rb.close()
        if self._ssl_map is not None:
            self._ssl_map.close()
        for kp in self._kprobes:
            kp.close()
        if self._gate_map is not None:
            self._gate_map.close()
        for fmap, _dtype in self._features.values():
            fmap.close()

class MinimalPacketFetcher(_SelfManagedAttach):
    """Self-managed PCA datapath from the hand-assembled capture program
    (datapath/asm_pca.py): creates the packet_records ring buffer, loads the
    program through the live verifier, attaches via TCX/tc, and serves raw
    `no_packet_event` records to PerfTracer through the mmap ring reader —
    the compiler-free analog of the reference's PCA fetcher
    (pkg/tracer/tracer.go:1552-2076).

    Reference: `netobserv_tpu/datapath/loader.py:1282`. Its pins take the
    port's own prefix, each named `<prefix><pid>_<program>` (the one
    program without filters `_pca`), so the stale-pin sweep keeps a live
    process's pins and neither package's sweep removes the other's."""

    needs_iface_discovery = True
    _PIN_PREFIX = "/sys/fs/bpf/netobserv_torch_minpca_"

    def __init__(self, ring_bytes: int = 1 << 21, attach_mode: str = "tcx",
                 sampling: int = 0, enable_filters: bool = False):
        self._mode = attach_mode
        self._sweep_stale_pins()
        self._filter_rules = self._filter_peers = None
        self._rb_map = None
        self._reader = None
        self._prog_fds = {}
        self._pins = {}
        self._attached: dict[tuple[str, int], tuple[str, dict]] = {}
        try:
            self._provision(ring_bytes, sampling, enable_filters)
        except Exception:
            self.close()  # a half-provisioned fetcher must not leak fds
            raise

    def _provision(self, ring_bytes, sampling, enable_filters) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1309`."""
        from netobserv_tpu_torch.datapath import asm_pca

        BPF_MAP_TYPE_RINGBUF = 27
        flt_rules_fd = flt_peers_fd = None
        if enable_filters:
            self._filter_rules, self._filter_peers = _create_filter_tries()
            flt_rules_fd = self._filter_rules.fd
            flt_peers_fd = self._filter_peers.fd
        self._rb_map = syscall_bpf.BpfMap.create(
            BPF_MAP_TYPE_RINGBUF, 0, 0, ring_bytes, b"pkt_records")
        if enable_filters:
            # filters evaluate a direction predicate, so each hook needs its
            # own program instance (like the flow datapath)
            programs = [(name, asm_pca.build_pca_program(
                self._rb_map.fd, sampling=sampling, direction=code,
                filter_rules_fd=flt_rules_fd, filter_peers_fd=flt_peers_fd))
                for name, code in (("ingress", 0), ("egress", 1))]
        else:
            # one program serves both hooks (the record carries no direction)
            programs = [("pca", asm_pca.build_pca_program(
                self._rb_map.fd, sampling=sampling))]
        for name, prog in programs:
            fd = syscall_bpf.prog_load(prog, name=b"netobserv_pca")
            pin = f"{self._PIN_PREFIX}{os.getpid()}_{name}"
            if os.path.exists(pin):
                os.unlink(pin)
            syscall_bpf.obj_pin(fd, pin)
            hooks = ("ingress", "egress") if name == "pca" else (name,)
            for hook in hooks:
                self._prog_fds[hook] = fd
                self._pins[hook] = pin
        self._reader = syscall_bpf.RingBufReader(self._rb_map)

    @classmethod
    def load(cls, cfg: AgentConfig) -> "MinimalPacketFetcher":
        """Reference: `netobserv_tpu/datapath/loader.py:1350`."""
        import shutil

        if os.geteuid() != 0:
            raise RuntimeError("kernel datapath requires root/CAP_BPF")
        if cfg.tc_attach_mode != "tcx" and shutil.which("tc") is None:
            raise RuntimeError("tc (iproute2) not found; cannot attach")
        return cls(attach_mode=cfg.tc_attach_mode, sampling=cfg.sampling,
                   enable_filters=bool(cfg.flow_filter_rules))

    def program_filters(self, rules) -> int:
        """Same kernel-gate programming as the flow fetcher: captured
        packets are the ones an Accept rule matches (pca.h parity).

        Reference: `netobserv_tpu/datapath/loader.py:1360`."""
        if self._filter_rules is None:
            if rules:
                log.warning("PCA filter maps not provisioned; "
                            "FLOW_FILTER_RULES ignored")
            return 0
        return _program_filter_tries(self._filter_rules, self._filter_peers,
                                     rules)

    def read_packet(self, timeout_s: float):
        return self._reader.read(timeout_s)

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1374`."""
        self._teardown_attachments()
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        for bm in (self._rb_map, self._filter_rules, self._filter_peers):
            if bm is not None:
                bm.close()
        self._rb_map = self._filter_rules = self._filter_peers = None



def _libbpf_open_and_load(obj_path: str, resize: dict, knobs: dict,
                          entry_names: dict):
    """Shared clang-object lifecycle (both fetcher twins): open, pinning
    strip, map resize, volatile-const patch (ELF-symtab offsets), entry-
    point check, prune everything but the selected entries, verifier load.
    Returns the loaded BpfObject.

    Reference: `netobserv_tpu/datapath/loader.py:1387`."""
    from netobserv_tpu_torch.datapath import libbpf as lb

    obj = lb.BpfObject(obj_path)
    try:
        for m in obj.maps():
            m.disable_pinning()
            want = resize.get(m.name)
            if want:
                m.set_max_entries(want)
        syms = lb.rodata_symbols(obj_path)
        patches = {}
        for name, val in knobs.items():
            if name in syms:
                off, size = syms[name]
                patches[off] = (size, int(val))
            else:
                log.debug("const %s absent in %s", name, obj_path)
        if patches:
            obj.patch_rodata(patches)
        for pname in entry_names.values():
            if obj.program(pname) is None:
                raise RuntimeError(f"object lacks program {pname}")
        wanted = set(entry_names.values())
        for p in obj.programs():
            if p.name not in wanted:
                p.set_autoload(False)
            else:
                # force SCHED_CLS on EVERY entry: this tree's "tc_*"
                # sections are custom, and "tcx/..." sec_defs only exist in
                # libbpf >= 1.3 (v1.1 leaves them UNSPEC and load fails);
                # plain SCHED_CLS attaches through both the TCX link and
                # legacy tc paths, exactly like the assembler programs
                p.set_type(3)
        obj.load()
        return obj
    except Exception:
        obj.close()
        raise


def _libbpf_default_resize(cache: int) -> dict:
    """Every oversized map in maps.h must shrink BEFORE load — libbpf
    creates ALL object maps regardless of program autoload, and the
    declared 1<<24-entry preallocated per-CPU hashes would ENOMEM.

    Reference: `netobserv_tpu/datapath/loader.py:1433`."""
    return {"aggregated_flows": cache, "flows_dns": cache,
            "flows_drops": cache, "flows_nevents": cache,
            "flows_xlat": cache, "flows_extra": cache,
            "flows_quic": cache, "dns_inflight": max(cache, 1024),
            "direct_flows": 1 << 17, "ssl_events": 1 << 20,
            "packet_records": 1 << 17}


def _libbpf_pin_entries(obj, entry_names: dict, prefix: str):
    """(prog_fds, pins): dup per-direction entry fds and pin them (the
    legacy tc attach path needs a pinned program path).

    Reference: `netobserv_tpu/datapath/loader.py:1445`."""
    prog_fds, pins = {}, {}
    for d, pname in entry_names.items():
        fd = os.dup(obj.program(pname).fd)
        pin = f"{prefix}{os.getpid()}_{d}"
        if os.path.exists(pin):
            os.unlink(pin)
        syscall_bpf.obj_pin(fd, pin)
        prog_fds[d] = fd
        pins[d] = pin
    return prog_fds, pins


def _libbpf_release(self) -> None:
    """Shared teardown for the libbpf fetchers' fds/pins/object.

    Reference: `netobserv_tpu/datapath/loader.py:1460`."""
    for fd in self._prog_fds.values():
        try:
            os.close(fd)
        except OSError:
            pass
    self._prog_fds = {}
    for pin in self._pins.values():
        try:
            os.unlink(pin)
        except OSError:
            pass
    self._pins = {}
    if self._obj is not None:
        self._obj.close()
        self._obj = None


class LibbpfKernelFetcher(_SelfManagedAttach, BpfmanFetcher):
    """Full C datapath: loads the clang-built CO-RE object (flowpath.c —
    every inline tracker; `datapath/bpf_build.py`) through the system
    libbpf, with the reference's load lifecycle (`pkg/tracer/tracer.go:
    92-273`): map resize per config, pinning strip, `volatile const`
    rewrite from the parsed env config, capability-based program pruning,
    verifier load, per-direction TCX/TC attach, and the shared per-CPU
    drain at eviction.

    Reference: `netobserv_tpu/datapath/loader.py:1479`."""

    needs_iface_discovery = True
    # a prefix of its own, which the reference's stale-pin sweep
    # ("netobserv_cobj_*") does not match, nor this one the reference's:
    # the two agents' fetchers may run side by side on one host
    _PIN_PREFIX = "/sys/fs/bpf/netobserv_torch_cobj_"

    def __init__(self, cfg: AgentConfig, obj_path: str = _OBJ_PATH):
        """Reference: `netobserv_tpu/datapath/loader.py:1494`."""
        self._init_empty_maps()
        self._sweep_stale_pins()
        self._mode = cfg.tc_attach_mode
        self._obj = None
        try:
            self._provision_object(cfg, obj_path)
            self._init_drain_lanes(cfg.evict_drain_lanes)
            if cfg.evict_native_pipeline and self._features:
                self._native_gate = NativeEvictPipeline(self,
                                                        self._drain_lanes)
        except Exception:
            self.close()
            raise

    def _provision_object(self, cfg: AgentConfig, obj_path: str) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1509`."""
        use_tcx = self._mode != "tc"
        entry_names = {"ingress": ("tcx_ingress_flow" if use_tcx
                                   else "tc_ingress_flow"),
                       "egress": ("tcx_egress_flow" if use_tcx
                                  else "tc_egress_flow")}
        knobs = {
            "cfg_sampling": cfg.sampling,
            "cfg_trace_messages": int(cfg.log_level.lower() in
                                      ("debug", "trace")),
            "cfg_enable_rtt": int(cfg.enable_rtt),
            "cfg_enable_dns_tracking": int(cfg.enable_dns_tracking),
            "cfg_dns_port": cfg.dns_tracking_port,
            "cfg_enable_pkt_drops": int(cfg.enable_pkt_drops),
            "cfg_enable_flow_filtering": int(bool(cfg.flow_filter_rules)),
            "cfg_enable_tls_tracking": int(cfg.enable_tls_tracking),
            "cfg_quic_mode": cfg.quic_tracking_mode,
            "cfg_enable_ringbuf_fallback":
                int(cfg.enable_flows_ringbuf_fallback),
            "cfg_enable_ipsec": int(cfg.enable_ipsec_tracking),
            "cfg_enable_network_events":
                int(cfg.enable_network_events_monitoring),
            "cfg_network_events_group_id":
                cfg.network_events_monitoring_group_id,
            "cfg_enable_pkt_translation": int(cfg.enable_pkt_translation),
        }
        if cfg.flow_filter_rules:
            # per-rule sampling moves the 1/N gate after the filter
            # (config.h:52, flowpath.c:155-180)
            knobs["cfg_has_sampling"] = int(any(
                getattr(r, "sample", 0) for r in cfg.parsed_filter_rules()))
        obj = _libbpf_open_and_load(
            obj_path, _libbpf_default_resize(cfg.cache_max_flows), knobs,
            entry_names)
        self._obj = obj
        # layout contract: the object's maps must match the binfmt dtypes
        # byte-for-byte or the drain would mis-decode (records.h <-> binfmt)
        agg_h = obj.map("aggregated_flows")
        if agg_h is None:
            raise RuntimeError("object lacks aggregated_flows")
        if (agg_h.key_size != binfmt.FLOW_KEY_DTYPE.itemsize
                or agg_h.value_size != binfmt.FLOW_STATS_DTYPE.itemsize):
            raise RuntimeError(
                f"object layout mismatch: aggregated_flows "
                f"{agg_h.key_size}/{agg_h.value_size} != binfmt "
                f"{binfmt.FLOW_KEY_DTYPE.itemsize}/"
                f"{binfmt.FLOW_STATS_DTYPE.itemsize} — rebuild the object "
                "against this tree's records.h")
        for name, dtype, _attr in _FEATURE_MAPS:
            h = obj.map(name)
            if h is not None and h.value_size != dtype.itemsize:
                raise RuntimeError(
                    f"object layout mismatch: {name} value {h.value_size} "
                    f"!= {dtype.itemsize}")

        def wrap(name: str, n_cpus: int = 1):
            h = obj.map(name)
            if h is None:
                return None
            return syscall_bpf.BpfMap(
                os.dup(h.fd), h.key_size, h.value_size, h.max_entries,
                n_cpus=n_cpus,
                percpu=h.type in syscall_bpf.PERCPU_MAP_TYPES)

        ncpu = self._n_cpus
        self._agg = wrap("aggregated_flows")
        self._counters = wrap("global_counters", ncpu)
        for name, dtype, attr in _FEATURE_MAPS:
            bm = wrap(name, ncpu)
            if bm is not None:
                self._features[attr] = (bm, dtype)
        self._dns_inflight = wrap("dns_inflight")
        self._filter_rules = wrap("filter_rules")
        self._filter_peers = wrap("filter_peers")
        if cfg.enable_flows_ringbuf_fallback:
            self._rb_map = wrap("direct_flows")
            if self._rb_map is not None:
                self._ringbuf = syscall_bpf.RingBufReader(self._rb_map)
        self._prog_fds, self._pins = _libbpf_pin_entries(
            obj, entry_names, self._PIN_PREFIX)
        self._probe_links = []
        self._probes_obj = None
        probes_path = os.path.join(os.path.dirname(obj_path),
                                   "flowpath_probes.bpf.o")
        if os.path.exists(probes_path):
            try:
                self._load_probes(cfg, probes_path, knobs)
            except Exception as exc:
                log.warning("probes object %s unusable (%s); probe-based "
                            "features degrade to the inline trackers",
                            probes_path, exc)

    @staticmethod
    def _probe_wanted(cfg, section: str, rtt_tier: str,
                      have_kprobes: bool, have_tracepoints: bool) -> bool:
        """SEC-prefix -> (config gate, capability) for the aux hook
        programs (the reference's attach ladder, tracer.go:184-273).
        `rtt_tier` selects the RTT hook flavour: "fentry" -> "kprobe"
        (trampoline unusable) -> "none" (both RTT twins rejected; every
        other wanted probe still loads).

        Reference: `netobserv_tpu/datapath/loader.py:1608`."""
        if section.startswith("tracepoint/skb/kfree_skb"):
            return cfg.enable_pkt_drops and have_tracepoints
        if section.startswith("fentry/tcp_rcv"):
            return cfg.enable_rtt and rtt_tier == "fentry"
        if section.startswith("kprobe/tcp_rcv"):
            # kprobe fallback only when fentry is off the table
            return cfg.enable_rtt and have_kprobes and rtt_tier == "kprobe"
        if section.startswith("kprobe/psample"):
            return cfg.enable_network_events_monitoring and have_kprobes
        if section.startswith("kprobe/nf_nat"):
            return cfg.enable_pkt_translation and have_kprobes
        if section.startswith(("kprobe/xfrm", "kretprobe/xfrm")):
            return cfg.enable_ipsec_tracking and have_kprobes
        return False                            # uprobe/...: asm path owns it

    def _load_probes(self, cfg, probes_path: str, knobs: dict) -> None:
        """Load the aux-hook object, sharing the flow object's maps
        (bpf_map__reuse_fd) so probe records land in the maps the drain
        reads. fentry needs trampoline support libbpf only reveals at load
        — ladder: try with fentry, retry without (reference fentry->kprobe
        fallback, tracer.go:203-222).

        Reference: `netobserv_tpu/datapath/loader.py:1625`."""
        from netobserv_tpu_torch.datapath import libbpf as lb

        have_tracepoints = any(os.path.isdir(p) for p in (
            "/sys/kernel/tracing/events",
            "/sys/kernel/debug/tracing/events"))
        have_kprobes = (os.path.isdir("/sys/bus/event_source/devices/kprobe")
                        or any(os.path.exists(p) for p in (
                            "/sys/kernel/tracing/kprobe_events",
                            "/sys/kernel/debug/tracing/kprobe_events")))
        syms = lb.rodata_symbols(probes_path)
        last_exc: Exception | None = None
        rtt_ladder = ["fentry"]
        if have_kprobes:
            rtt_ladder.append("kprobe")
        rtt_ladder.append("none")
        for rtt_tier in rtt_ladder:
            pobj = lb.BpfObject(probes_path)
            try:
                wanted_any = False
                for p in pobj.programs():
                    want = self._probe_wanted(cfg, p.section, rtt_tier,
                                              have_kprobes, have_tracepoints)
                    if not want:
                        p.set_autoload(False)
                    wanted_any = wanted_any or want
                if not wanted_any:
                    pobj.close()
                    log.info("no probe hooks wanted/attachable on this "
                             "kernel; skipping %s", probes_path)
                    return
                resize = _libbpf_default_resize(cfg.cache_max_flows)
                for m in pobj.maps():
                    m.disable_pinning()
                    # internal maps are named '<8-char-obj-prefix>.rodata'
                    # etc. — never share those: the probes object needs its
                    # OWN patched consts, not the flow object's image
                    if "." in m.name:
                        continue
                    shared = self._obj.map(m.name)
                    if shared is not None:
                        m.reuse_fd(shared.fd)
                    elif m.name in resize:
                        # unshared probes-only maps get the same pre-load
                        # shrink the flow object does: libbpf creates every
                        # object map at its declared size regardless of
                        # program autoload, and maps.h declares 1<<24-scale
                        m.set_max_entries(resize[m.name])
                patches = {}
                for name, val in knobs.items():
                    if name in syms:
                        off, size = syms[name]
                        patches[off] = (size, int(val))
                if patches:
                    pobj.patch_rodata(patches)
                pobj.load()
                links = []
                fentry_attach_failed = False
                # fentry first: if its trampoline is rejected at ATTACH we
                # rerun the whole ladder, so don't attach anything else
                # before that verdict is in
                progs = sorted((p for p in pobj.programs() if p.autoload),
                               key=lambda p:
                               not p.section.startswith("fentry/"))
                for p in progs:
                    try:
                        links.append(p.attach())
                        log.info("probe attached: %s", p.section)
                    except OSError as exc:
                        if (rtt_tier == "fentry"
                                and p.section.startswith("fentry/")):
                            # some kernels accept the fentry program at load
                            # but reject the trampoline at ATTACH; the
                            # reference falls back to the kprobe twin there
                            # too (tracer.go:203-222), so rerun the ladder
                            fentry_attach_failed = True
                            log.warning(
                                "fentry probe %s attach failed (%s); %s",
                                p.section, exc,
                                "retrying with the kprobe fallback"
                                if have_kprobes else
                                "no kprobe support here — RTT probe dropped")
                            break
                        log.warning("probe %s attach failed: %s",
                                    p.section, exc)
                if fentry_attach_failed:
                    for link in links:
                        link.destroy()
                    pobj.close()
                    continue
                self._probes_obj = pobj
                self._probe_links = links
                return
            except OSError as exc:
                pobj.close()
                last_exc = exc
                if rtt_tier != "none":
                    log.debug("probes load at RTT tier %r failed (%s); "
                              "laddering down", rtt_tier, exc)
        raise last_exc if last_exc else RuntimeError("probes load failed")

    def program_filters(self, rules) -> int:
        """Reference: `netobserv_tpu/datapath/loader.py:1731`."""
        if self._filter_rules is None:
            if rules:
                log.warning("object has no filter maps; rules ignored")
            return 0
        return _program_filter_tries(self._filter_rules, self._filter_peers,
                                     rules)

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1739`."""
        if getattr(self, "_drain_pool", None) is not None:
            self._drain_pool.shutdown(wait=True)
            self._drain_pool = None
        self._teardown_attachments()
        for link in getattr(self, "_probe_links", []):
            link.destroy()
        self._probe_links = []
        pobj = getattr(self, "_probes_obj", None)
        if pobj is not None:
            pobj.close()
            self._probes_obj = None
        if self._ringbuf is not None:
            self._ringbuf.close()
            self._ringbuf = None
        for bm in [self._agg, self._counters, self._dns_inflight,
                   self._filter_rules, self._filter_peers, self._rb_map]:
            if bm is not None:
                bm.close()
        for bm, _dtype in self._features.values():
            bm.close()
        self._features = {}
        _libbpf_release(self)


class KernelFetcher:
    """Self-managed kernel datapath entry point (reference analog:
    `pkg/tracer/tracer.go:92-273` NewFlowFetcher).

    Where the clang-built object (`datapath/bpf_build.py`) is present and
    libbpf is available, loads the full C datapath through
    `LibbpfKernelFetcher`. Otherwise provisions the hand-assembled
    datapath (`MinimalKernelFetcher`), which needs no compiler or libbpf.

    Reference: `netobserv_tpu/datapath/loader.py:38`."""

    needs_iface_discovery = True  # the agent starts an InterfaceListener

    @classmethod
    def load(cls, cfg: AgentConfig):
        return _load_clang_or_fallback(
            cfg, lambda c: LibbpfKernelFetcher(c, _OBJ_PATH),
            MinimalKernelFetcher.load, "datapath")

class LibbpfPacketFetcher(_SelfManagedAttach):
    """PCA twin of LibbpfKernelFetcher (reference PacketFetcher,
    tracer.go:1552-2076): loads the CI-built object with cfg_enable_pca
    patched on, autoloads only the PCA entry points, and serves raw
    packet_records to the packets agent through the mmap ring reader.

    Reference: `netobserv_tpu/datapath/loader.py:1764`; its pins take the
    port's own prefix."""

    needs_iface_discovery = True
    _PIN_PREFIX = "/sys/fs/bpf/netobserv_torch_cpca_"

    def __init__(self, cfg: AgentConfig, obj_path: str = _OBJ_PATH,
                 ring_bytes: int = 1 << 21):
        self._mode = cfg.tc_attach_mode
        self._sweep_stale_pins()
        self._filter_rules = self._filter_peers = None
        self._rb_map = None
        self._reader = None
        self._obj = None
        self._prog_fds = {}
        self._pins = {}
        self._attached = {}
        try:
            self._provision_object(cfg, obj_path, ring_bytes)
        except Exception:
            self.close()
            raise

    def _provision_object(self, cfg, obj_path, ring_bytes) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1790`."""
        use_tcx = self._mode != "tc"
        entry_names = {"ingress": ("tcx_pca_ingress" if use_tcx
                                   else "tc_pca_ingress"),
                       "egress": ("tcx_pca_egress" if use_tcx
                                  else "tc_pca_egress")}
        # the flow maps still get created at load (libbpf creates every
        # object map regardless of autoload) — shrink them all
        resize = _libbpf_default_resize(cache=512)
        resize["packet_records"] = ring_bytes
        knobs = {"cfg_enable_pca": 1, "cfg_sampling": cfg.sampling,
                 "cfg_enable_flow_filtering":
                     int(bool(cfg.flow_filter_rules))}
        obj = _libbpf_open_and_load(obj_path, resize, knobs, entry_names)
        self._obj = obj
        rb = obj.map("packet_records")
        if rb is None:
            raise RuntimeError("object lacks packet_records")
        self._rb_map = syscall_bpf.BpfMap(os.dup(rb.fd), 0, 0)
        self._reader = syscall_bpf.RingBufReader(self._rb_map)
        fr, fp = obj.map("filter_rules"), obj.map("filter_peers")
        if fr is not None and fp is not None:
            self._filter_rules = syscall_bpf.BpfMap(
                os.dup(fr.fd), fr.key_size, fr.value_size)
            self._filter_peers = syscall_bpf.BpfMap(
                os.dup(fp.fd), fp.key_size, fp.value_size)
        self._prog_fds, self._pins = _libbpf_pin_entries(
            obj, entry_names, self._PIN_PREFIX)

    def program_filters(self, rules) -> int:
        """Reference: `netobserv_tpu/datapath/loader.py:1819`."""
        if self._filter_rules is None:
            if rules:
                log.warning("object has no filter maps; rules ignored")
            return 0
        return _program_filter_tries(self._filter_rules, self._filter_peers,
                                     rules)

    def read_packet(self, timeout_s: float):
        return self._reader.read(timeout_s)

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/loader.py:1830`."""
        self._teardown_attachments()
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        for bm in (self._rb_map, self._filter_rules, self._filter_peers):
            if bm is not None:
                bm.close()
        self._rb_map = self._filter_rules = self._filter_peers = None
        _libbpf_release(self)


def load_packet_fetcher(cfg: AgentConfig):
    """PCA fetcher dispatch, mirroring KernelFetcher.load: the CI-built
    clang object when present+loadable, else the assembler PCA program.

    Reference: `netobserv_tpu/datapath/loader.py:1842`."""
    return _load_clang_or_fallback(
        cfg, lambda c: LibbpfPacketFetcher(c, _OBJ_PATH),
        MinimalPacketFetcher.load, "PCA datapath")



def _load_clang_or_fallback(cfg: AgentConfig, clang_ctor, fallback,
                            noun: str):
    """Shared dispatch ladder: clang object via libbpf when present and
    loadable, else the assembler implementation, with one log line per
    branch so a degraded start is always explained.

    Reference: `netobserv_tpu/datapath/loader.py:1850`."""
    if os.geteuid() != 0:
        raise RuntimeError("kernel datapath requires root/CAP_BPF")
    if os.path.exists(_OBJ_PATH):
        from netobserv_tpu_torch.datapath import libbpf as lb

        if lb.available():
            try:
                fetcher = clang_ctor(cfg)
                log.info("loaded the clang-built %s %s via libbpf",
                         noun, _OBJ_PATH)
                return fetcher
            except Exception as exc:
                log.warning("clang %s failed to load (%s); falling back "
                            "to the assembler implementation", noun, exc)
        else:
            log.warning("clang object %s present but libbpf is not "
                        "available; using the assembler %s",
                        _OBJ_PATH, noun)
    else:
        log.info("no clang-built BPF object (%s); using the assembler %s",
                 _OBJ_PATH, noun)
    return fallback(cfg)
