"""The port's fused drain pipeline (netobserv_tpu_torch/datapath/flowpack.py
`NativePipe`, csrc/flowpack.cc `fp_drain_to_resident`), its gate
(datapath/loader.py `NativeEvictPipeline`) and the ring's side of it
(sketch/staging.py `ResidentPackSurface`), on the CPU, as the reference's
`tests/test_native_pipeline.py` holds the reference's.

- Fuzzed drains (random map subsets, per-CPU widths, lanes, orphan rows
  and empty maps) give the events and aligned features of the port's
  Python chain (`decode_eviction`) and of the reference's `NativePipe`,
  byte for byte, and its orphan count; an engineered 64-bit key-hash
  collision takes the lexicographic join on every side.
- The pack stage over three geometries (a multi-k ladder over two lanes,
  four data shards whose last regions run out inside continuation
  segments, and a slot_cap of 4 that resets the dictionaries) gives the
  reference's arena and chunk table, and the regions the port's own
  `ShardedResidentStagingRing` ships when it folds the same rows with a
  second set of dictionaries (its slot buffers zeroed before each use, as
  a fresh ring's are, so that an exhausted region's unread words compare
  too), chunk by chunk: rows, k, segments, spill rows and resets.
- The gate's rules over stub maps (fd < 0): the first drain runs the
  Python chain, the second is fused, with the native stage split in its
  `decode_stats`; no batch operations, an unknown capacity or a padded
  value stride disable it for good.
- `ResidentPackSurface`: a raw fold rolls the epoch and resets the ring's
  dictionaries only while an arena is outstanding; `note_external_reset`
  rolls the epoch and leaves the dictionaries.
- A library built with another ABI number raises at load, in the port's
  loader and in the gate; nothing falls back.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.datapath import loader as tloader
from netobserv_tpu_torch.model import binfmt as tbin
from netobserv_tpu_torch.ops.kernels import _build
from netobserv_tpu_torch.parallel import MeshSpec, make_mesh
from netobserv_tpu_torch.parallel import merge as pmerge
from netobserv_tpu_torch.sketch import staging
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import tracing
from tests.test_native_pipeline import _fill, _synth_map
from tests.test_torch_evict_chain import colliding_keys

FEATURES = ["extra", "dns", "drops", "nevents", "xlat", "quic"]
#: a small sketch geometry: the pack tests' folds only drive the ring
SMALL = dict(cm_depth=2, cm_width=1 << 10, hll_precision=6,
             perdst_buckets=32, perdst_precision=4, persrc_buckets=32,
             persrc_precision=4, topk=16, hist_buckets=64, ewma_buckets=32)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    if not jfp.build_native():
        pytest.skip("no g++ to build the reference's libflowpack")
    return tfp.native_lib()


def _pipes(maps: list, data: list, lanes: int) -> tuple:
    """The port's and the reference's pipe over the same injected maps."""
    pipes = (tfp.NativePipe(maps, lanes=lanes),
             jfp.NativePipe(maps, lanes=lanes))
    for pipe in pipes:
        for i, (k, v) in enumerate(data):
            pipe.set_drained(i, k, v)
    return pipes


def _assert_drain(res, jres, ev, drained, where=""):
    assert res.n_events == jres.n_events == len(ev.events), where
    assert res.events.tobytes() == jres.events.tobytes() == \
        ev.events.tobytes(), where
    for kind in drained:
        a, j, b = res.aligned[kind], jres.aligned[kind], getattr(ev, kind)
        assert (a is None) == (j is None) == (b is None), (where, kind)
        if b is not None:
            assert a.tobytes() == j.tobytes() == b.tobytes(), (where, kind)
    assert res.n_orphans == jres.n_orphans == \
        ev.decode_stats["fallback_rows"], where
    assert res.map_rows == jres.map_rows
    assert res.lex_fallback == jres.lex_fallback


@pytest.mark.parametrize("seed", range(4))
def test_fuzzed_drains_equal_the_python_chain_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    for trial in range(4):
        n_pool = int(rng.integers(5, 600))
        pool = rng.integers(0, 256, size=(n_pool, 40), dtype=np.uint8)
        specs = [("stats", tbin.FLOW_STATS_DTYPE, 1,
                  int(rng.integers(0, n_pool + 1)))]
        for kind in FEATURES:
            if rng.random() < 0.8:
                specs.append((kind, tfp.PIPE_DTYPES[kind],
                              int(rng.integers(1, 9)),
                              int(rng.integers(0, n_pool + 1))))
        maps, data = [], []
        for kind, dt, ncpu, n in specs:
            data.append(_synth_map(n, dt, ncpu, pool, rng))
            maps.append((-1, kind, dt.itemsize, ncpu, max(n_pool, 1)))
        pipe, jpipe = _pipes(maps, data, int(rng.integers(1, 5)))
        try:
            res, jres = pipe.drain(), jpipe.drain()
            drained = {kind: data[i] for i, (kind, *_r) in
                       enumerate(specs) if i}
            ev = tloader.decode_eviction(data[0][0], data[0][1], drained)
            _assert_drain(res, jres, ev, drained, f"seed {seed} {trial}")
            assert res.arena is None and res.chunks == []
        finally:
            pipe.close()
            jpipe.close()


def test_a_hash_collision_takes_the_lexicographic_join_everywhere():
    rng = np.random.default_rng(12)
    key_a, key_b = colliding_keys(11)
    filler = rng.integers(0, 256, size=(30, 40), dtype=np.uint8)
    agg = np.ascontiguousarray(np.vstack([key_a[None], key_b[None], filler]))
    agg_vals = _fill(np.zeros((len(agg), 1), tbin.FLOW_STATS_DTYPE), rng)
    ex = np.ascontiguousarray(np.vstack([key_b[None], key_a[None],
                                         filler[:5]]))
    orphan = rng.integers(0, 256, size=(2, 40), dtype=np.uint8)
    ex = np.vstack([ex, orphan])
    ex_vals = _fill(np.zeros((len(ex), 4), tbin.EXTRA_REC_DTYPE), rng)
    maps = [(-1, "stats", tbin.FLOW_STATS_DTYPE.itemsize, 1, 64),
            (-1, "extra", tbin.EXTRA_REC_DTYPE.itemsize, 4, 64)]
    pipe, jpipe = _pipes(maps, [(agg, agg_vals), (ex, ex_vals)], 2)
    try:
        res, jres = pipe.drain(), jpipe.drain()
        assert res.lex_fallback == 1
        drained = {"extra": (ex, ex_vals)}
        ev = tloader.decode_eviction(agg, agg_vals, drained)
        _assert_drain(res, jres, ev, drained)
        assert res.n_orphans == 2
    finally:
        pipe.close()
        jpipe.close()


class _Recorder:
    """Wraps a ring so every slot starts zeroed and every shipped image,
    and each `_fold_chunk`'s (rows, k, images, spills, resets), is kept."""

    def __init__(self, ring):
        self.images, self.chunks = [], []
        wait, ship, chunk = ring._wait_slot, ring._ship, ring._fold_chunk

        def wait_slot(trace=tracing.NULL_TRACE):
            slot = wait(trace)
            ring._bufs[slot][:] = 0
            return slot

        def ship_slot(slot, words=None):
            self.images.append(ring._bufs[slot][:words].copy())
            return ship(slot, words)

        def fold_chunk(state, events, feats, k, trace):
            before = (len(self.images), ring.spill_rows, ring.dict_resets)
            chunk(state, events, feats, k, trace)
            self.chunks.append((len(events), k,
                                len(self.images) - before[0],
                                ring.spill_rows - before[1],
                                ring.dict_resets - before[2]))

        ring._wait_slot, ring._ship = wait_slot, ship_slot
        ring._fold_chunk = fold_chunk


def _ring(batch, shards, lanes, ladder, slot_cap, caps):
    mesh = (make_mesh(MeshSpec.parse(f"{shards}x1", 0), ["cpu"] * shards)
            if shards > 1 else None)
    ring = staging.ShardedResidentStagingRing(
        batch, shards, caps=caps, slot_cap=slot_cap, device="cpu",
        capture=False, lanes=lanes, ladder=ladder, mesh=mesh)
    cfg = ts.SketchConfig(**SMALL)
    state = (pmerge.init_dist_state(cfg, mesh) if mesh is not None
             else ts.init_state(cfg, "cpu"))
    return ring, state


@pytest.mark.parametrize(
    "seed,n_pool,batch,shards,lanes,ladder,slot_cap",
    [(7, 700, 64, 1, 2, (1, 2, 4), 1 << 10),
     (10, 900, 128, 4, 1, (1, 2), 1 << 10),
     (9, 60, 16, 1, 1, (1,), 4)],
    ids=["ladder-1-2-4-two-lanes", "four-shards-exhausted", "slot-cap-4"])
def test_the_pack_equals_the_reference_and_the_rings_own_pack(
        seed, n_pool, batch, shards, lanes, ladder, slot_cap):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, size=(n_pool, 40), dtype=np.uint8)
    specs = [("stats", tbin.FLOW_STATS_DTYPE, 1, n_pool * 3 // 4),
             ("extra", tbin.EXTRA_REC_DTYPE, 4, n_pool // 2),
             ("dns", tbin.DNS_REC_DTYPE, 2, n_pool // 5),
             ("drops", tbin.DROPS_REC_DTYPE, 3, n_pool // 6)]
    maps, data = [], []
    for kind, dt, ncpu, n in specs:
        data.append(_synth_map(n, dt, ncpu, pool, rng))
        maps.append((-1, kind, dt.itemsize, ncpu, n_pool))
    bpr = batch // (shards * lanes)
    caps = tfp.ResidentCaps(dns=8, drop=8, nk=max(bpr // 4, 2), spill=2)
    ring, _ = _ring(batch, shards, lanes, ladder, slot_cap, caps)
    twin, state = _ring(batch, shards, lanes, ladder, slot_cap, caps)
    surface = staging.ResidentPackSurface(ring)
    spec = surface.pack_spec()
    jdicts = [jfp.KeyDict(slot_cap) for _ in ring.kdicts]
    jspec = dict(spec, ladder=[
        (k, [jdicts[ring.kdicts.index(d)]._live_handle()
             for d in _dicts_of(ring, k)]) for k, _h in spec["ladder"]])
    pipe, jpipe = _pipes(maps, data, 2)
    try:
        res = pipe.drain(pack=spec)
        jres = jpipe.drain(pack=jspec)
        drained = {kind: data[i] for i, (kind, *_r) in enumerate(specs)
                   if i}
        ev = tloader.decode_eviction(data[0][0], data[0][1], drained)
        _assert_drain(res, jres, ev, drained)
        assert res.packed_rows == len(ev.events)
        plan = [(c.row_start, c.rows, c.k, c.n_segs, c.spills, c.resets)
                for c in res.chunks]
        assert plan == [(c.row_start, c.rows, c.k, c.n_segs, c.spills,
                         c.resets) for c in jres.chunks]
        assert res.arena.tobytes() == jres.arena.tobytes()
        rec = _Recorder(twin)
        twin.fold(state, ev.events, extra=ev.extra, dns=ev.dns,
                  drops=ev.drops)
        assert [(rows, k, segs, spills, resets)
                for _s, rows, k, segs, spills, resets in plan] == rec.chunks
        assert res.arena.tobytes() == np.concatenate(rec.images).tobytes()
        assert (res.spill_rows, res.dict_resets, res.segs) == (
            twin.spill_rows, twin.dict_resets, len(rec.images))
        assert res.segs > len(plan)  # continuation segments ran
        if slot_cap == 4:
            assert res.dict_resets > 0
        if shards == 4:
            # the last regions ran out inside a continuation segment
            rw = twin._region_words
            assert any(not img[i * rw:(i + 1) * rw].any()
                       for img in rec.images
                       for i in range(len(img) // rw))
        assert [d.count() for d in ring.kdicts] == \
            [d.count() for d in twin.kdicts]
    finally:
        res.free()
        jres.free()
        assert res.arena is None
        pipe.close()
        jpipe.close()
        for d in jdicts:
            d.close()
        ring.close()
        twin.close()


def _dicts_of(ring, k: int) -> list:
    kl, kmax_l = k * ring.lanes, ring.superbatch_max * ring.lanes
    return [ring.kdicts[(i // kl) * kmax_l + (i % kl)]
            for i in range(ring.n_shards * kl)]


class _StubMap:
    def __init__(self, dtype, n_cpus, max_entries=256, no_batch=False,
                 pad=None):
        self.fd = -1
        self.n_cpus = n_cpus
        self.max_entries = max_entries
        self._no_batch_ops = no_batch
        self._pad_vs = dtype.itemsize if pad is None else pad


class _StubFetcher:
    """The kernel fetchers' duck type over injected maps (fd < 0)."""

    def __init__(self, no_batch=False, max_entries=256, pad=None,
                 features=True):
        self._agg = _StubMap(tbin.FLOW_STATS_DTYPE, 1, max_entries, no_batch)
        self._features = ({"extra": (_StubMap(
            tbin.EXTRA_REC_DTYPE, 4, max_entries, no_batch, pad),
            tbin.EXTRA_REC_DTYPE)} if features else {})


def test_the_gate_probes_with_the_python_chain_then_fuses():
    gate = tloader.NativeEvictPipeline(_StubFetcher(), lanes=2)
    trace = tracing.start_trace("t")
    assert gate.drain(trace, 0.0) is None  # drain 1: the Python chain
    assert gate._pipe is None and not gate.disabled
    out = gate.drain(trace, 0.0)
    assert gate._pipe is not None
    assert out.decode_stats["native_path"] == "fused"
    assert set(out.decode_stats["native"]) == {"drain_s", "merge_s",
                                               "join_s", "pack_s"}
    assert out.decode_stats["drain_lanes"] == 2
    assert len(out.events) == 0 and out.packed is None
    # injected rows ride the next drain
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 256, size=(20, 40), dtype=np.uint8)
    gate._pipe.set_drained(0, keys, _fill(np.zeros(
        (20, 1), tbin.FLOW_STATS_DTYPE), rng))
    gate._pipe.set_drained(1, keys[5:], _fill(np.zeros(
        (15, 4), tbin.EXTRA_REC_DTYPE), rng))
    out = gate.drain(trace, 0.0)
    assert len(out.events) == 20 and out.extra is not None
    # the one copy: the eviction owns its arrays, not the pipe's scratch
    assert out.events.flags.owndata and out.extra.flags.owndata
    gate.close()
    assert gate._pipe is None


@pytest.mark.parametrize("fetcher,why", [
    (dict(no_batch=True), "batch map ops"),
    (dict(max_entries=0), "unknown map capacity"),
    (dict(pad=tbin.EXTRA_REC_DTYPE.itemsize + 8), "kernel-padded"),
    (dict(features=False), "no feature maps")],
    ids=["no-batch-ops", "unknown-capacity", "padded-stride",
         "no-features"])
def test_a_disqualified_gate_stays_on_the_python_chain(fetcher, why,
                                                      caplog):
    gate = tloader.NativeEvictPipeline(_StubFetcher(**fetcher), lanes=1)
    trace = tracing.start_trace("t")
    assert gate.drain(trace, 0.0) is None
    assert gate.drain(trace, 0.0) is None
    assert gate.disabled and gate._pipe is None
    assert gate.drain(trace, 0.0) is None
    assert any(why in r.message for r in caplog.records)


class _StubDict:
    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1


class _StubRing:
    def __init__(self):
        self.kdicts = [_StubDict() for _ in range(4)]
        self.dict_resets = 0
        self._metrics = None


def test_a_raw_fold_invalidates_only_while_an_arena_is_outstanding():
    surface = staging.ResidentPackSurface(_StubRing())
    assert isinstance(surface.lock, type(threading.Lock()))
    surface.invalidate_for_raw_fold()
    assert surface.epoch == 0
    assert all(d.resets == 0 for d in surface.ring.kdicts)
    surface.outstanding = 2
    surface.invalidate_for_raw_fold()
    assert surface.epoch == 1 and surface.outstanding == 0
    assert all(d.resets == 1 for d in surface.ring.kdicts)
    assert surface.ring.dict_resets == 4
    surface.outstanding = 3
    surface.note_external_reset()
    assert surface.epoch == 2 and surface.outstanding == 0
    assert all(d.resets == 1 for d in surface.ring.kdicts)
    surface.invalidate()
    assert surface.epoch == 3 and surface.ring.dict_resets == 8


def test_a_stale_library_raises_in_the_loader_and_the_gate(tmp_path,
                                                         monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = (_build.CSRC / tfp.NATIVE_SOURCE).read_text()
    assert f"#define FP_ABI_VERSION {tfp.ABI_VERSION}" in src
    (csrc / tfp.NATIVE_SOURCE).write_text(src.replace(
        f"#define FP_ABI_VERSION {tfp.ABI_VERSION}",
        f"#define FP_ABI_VERSION {tfp.ABI_VERSION - 1}"))
    (csrc / "records.h").write_bytes((_build.CSRC / "records.h").read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tfp, "_LIB", None)
    with pytest.raises(RuntimeError, match="ABI version"):
        tfp.native_lib()
    gate = tloader.NativeEvictPipeline(_StubFetcher(), lanes=1)
    trace = tracing.start_trace("t")
    assert gate.drain(trace, 0.0) is None
    with pytest.raises(RuntimeError, match="ABI version"):
        gate.drain(trace, 0.0)
    assert not gate.disabled
    with pytest.raises(RuntimeError, match="ABI version"):
        tfp.NativePipe([(-1, "stats", tbin.FLOW_STATS_DTYPE.itemsize, 1,
                         8)])
