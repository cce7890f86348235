"""The port's mesh (netobserv_tpu_torch/parallel/: `MeshSpec`, `make_mesh`,
the owner-sharded Count-Min of ops/countmin.py, the sharded ingests, the
window merge and the delta fold) against the JAX package's
netobserv_tpu/parallel/, on the CPU.

The JAX mesh runs on the first devices of the 8 virtual CPU devices of
tests/conftest.py; the port's on `["cpu"] * n`. Each JAX mesh function is
compiled once per shape in a module-scoped fixture and reused, so the
file stays fast without the slow mark that tests/test_parallel.py needs
for its own 8-device compiles; the other cases hold the port against
itself (the mesh against one-device folds, one transport against
another).

Masses are integer-valued f32 with per-cell sums below 2^24 (bytes below
10,000 a record, a few hundred records a window), so sums in any order are
exact. Held bit for bit: `dist_tables` (the reference's leading-axis
layout, leaf for leaf) before and after every roll, the merged slot table
and every count, sum and register of the report. Two things are computed
by different float libraries and held to stated bounds: the EWMA
baselines after the rolls (the mean to 1e-6 relative, the bound
tests/test_torch_state.py holds one roll to; the variance to 1e-5
relative, since each roll's few f32 roundings pass through diff^2 and
compound over three windows) and, in the report, the HLL estimates (m *
2^-24 relative, m the registers of the estimate), the quantiles (1e-6
relative) and the z-scores (`_report_close`)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax

from netobserv_tpu.ops import countmin as jcm
from netobserv_tpu.parallel import MeshSpec as JMeshSpec
from netobserv_tpu.parallel import make_mesh as jmake_mesh
from netobserv_tpu.parallel import merge as jm
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.ops import countmin as tcm
from netobserv_tpu_torch.ops import hashing as thash
from netobserv_tpu_torch.parallel import MeshSpec, make_mesh
from netobserv_tpu_torch.parallel import merge as tm
from netobserv_tpu_torch.parallel import mesh as tmesh
from netobserv_tpu_torch.sketch import staging as tstg
from netobserv_tpu_torch.sketch import state as ts
from tests.test_parallel import CFG as JCFG
from tests.test_parallel import make_arrays

#: the port's twin of tests/test_parallel.py's geometry
TCFG = ts.SketchConfig(**{k: v for k, v in JCFG._asdict().items()
                          if k in ts.SketchConfig._fields})
SHAPES = [(4, 1), (2, 2), (1, 1)]
M_HLL = 2 ** JCFG.hll_precision
#: EWMA baseline leaves and their relative bound after the rolls (module
#: docstring)
EWMA_FLOAT = {f"{n}.{f}": tol for n in ("ddos", "syn", "drops_ewma")
              for f, tol in (("mean", 1e-6), ("var", 1e-5))}


def _jax_flat(dist) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(dist)
    return {".".join(p.name for p in path): np.asarray(v)
            for path, v in leaves}


def _assert_dist(port, jdist, where: str) -> None:
    got, want = tm.dist_tables(port), _jax_flat(jdist)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, where)
        assert got[k].shape == want[k].shape, (k, where)
        if k in EWMA_FLOAT:
            np.testing.assert_allclose(got[k], want[k], rtol=EWMA_FLOAT[k],
                                       atol=0, err_msg=f"{k} {where}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} {where}")


#: report fields computed by different float libraries (module docstring)
HLL_FIELDS = ("distinct_src", "per_dst_cardinality", "per_src_fanout")
QUANTILE_FIELDS = ("rtt_quantiles_us", "dns_quantiles_us")
Z_FIELDS = ("ddos_z", "syn_z", "drop_z")


def _report_close(trep, jrep) -> None:
    """The merged report against the reference's: the slot table and every
    sum bit for bit; HLL estimates within m * 2^-24 relative; quantiles
    within 1e-6 relative; z-scores within 1e-6 of the report's largest
    |z| (at least 1), absolute, since a z near 0 is a difference of two
    baselines that carry 1e-6 relative each."""
    for f in js.WindowReport._fields:
        if f == "heavy":
            for name in jrep.heavy._fields:
                np.testing.assert_array_equal(
                    getattr(trep.heavy, name).numpy(),
                    np.asarray(getattr(jrep.heavy, name)), err_msg=name)
            continue
        g, w = getattr(trep, f).numpy(), np.asarray(getattr(jrep, f))
        if f in HLL_FIELDS:
            np.testing.assert_allclose(g, w, rtol=M_HLL * 2.0 ** -24,
                                       atol=0, err_msg=f)
        elif f in QUANTILE_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f)
        elif f in Z_FIELDS:
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


class _Pair:
    """One shape's JAX mesh functions, compiled once, and the port's."""

    def __init__(self, shape):
        nd, ns = shape
        self.shape = shape
        self.jmesh = jmake_mesh(JMeshSpec(nd, ns), jax.devices()[:nd * ns])
        self.mesh = make_mesh(MeshSpec(nd, ns), ["cpu"] * (nd * ns))
        self.jingest = jm.make_sharded_ingest_fn(self.jmesh, JCFG,
                                                 donate=False)
        self.jroll = jm.make_merge_fn(self.jmesh, JCFG)
        self.ingest = tm.make_sharded_ingest_fn(self.mesh, TCFG)
        self.roll = tm.make_merge_fn(self.mesh, TCFG)

    def fresh(self):
        return (jm.init_dist_state(JCFG, self.jmesh),
                tm.init_dist_state(TCFG, self.mesh))


@pytest.fixture(scope="module")
def pairs():
    return {shape: _Pair(shape) for shape in SHAPES}


# ------------------------------------------------------------------- mesh


@pytest.mark.parametrize("text,n", [("", 8), ("4", 8), ("4x2", 8),
                                    ("2X1", 3), ("1x4", 4)])
def test_mesh_spec_parse_equals_the_reference(text, n):
    got, want = MeshSpec.parse(text, n), JMeshSpec.parse(text, n)
    assert (got.data, got.sketch) == (want.data, want.sketch)


def test_mesh_spec_parse_refuses_what_the_reference_refuses():
    for text in ("2x2x2", "x", "four"):
        with pytest.raises(ValueError) as want:
            JMeshSpec.parse(text, 8)
        with pytest.raises(ValueError) as got:
            MeshSpec.parse(text, 8)
        assert type(got.value) is type(want.value)


def test_make_mesh_grid_and_its_refusals():
    mesh = make_mesh(MeshSpec(2, 2), ["cpu"] * 5)
    assert mesh.shape == {tmesh.DATA_AXIS: 2, tmesh.SKETCH_AXIS: 2}
    assert mesh.devices == ((torch.device("cpu"),) * 2,) * 2
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(MeshSpec(4, 2), ["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(MeshSpec(2), ["cpu"])
    if not torch.cuda.is_available():
        # the default devices are the visible cards: none here
        assert tmesh.visible_devices() == []
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            make_mesh(MeshSpec(1))
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(MeshSpec(1), ["cuda:0"])


# ------------------------------------------------------- owner sharding


def test_owner_shard_golden_vectors():
    """The owner hash on uint32 lanes held in int64: h2 * 0x9E3779B1 must
    wrap mod 2^32 (ROADMAP C4), h2 near 2^32 included."""
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                    np.uint32)
    h1 = np.concatenate([rng.integers(0, 2**32, 500, dtype=np.uint32),
                         np.repeat(edge, len(edge))])
    h2 = np.concatenate([rng.integers(2**32 - 2**16, 2**32, 250,
                                      dtype=np.uint64).astype(np.uint32),
                         rng.integers(0, 2**32, 250, dtype=np.uint32),
                         np.tile(edge, len(edge))])
    for n in (1, 2, 3, 4, 8):
        want = np.asarray(jcm.owner_shard(jax.numpy.asarray(h1),
                                          jax.numpy.asarray(h2), n))
        got = tcm.owner_shard(torch.from_numpy(h1.astype(np.int64)),
                              torch.from_numpy(h2.astype(np.int64)), n)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(n))
        assert got.min() >= 0 and got.max() < n
    # three fixed vectors, so a change to the hash shows without JAX
    three = tcm.owner_shard(torch.tensor([0, 7, 2**32 - 1]),
                            torch.tensor([2**32 - 1, 7, 0]), 4)
    want3 = np.asarray(jcm.owner_shard(
        jax.numpy.asarray(np.array([0, 7, 2**32 - 1], np.uint32)),
        jax.numpy.asarray(np.array([2**32 - 1, 7, 0], np.uint32)), 4))
    np.testing.assert_array_equal(three.numpy(), want3)


def test_sharded_update_and_queries_equal_the_reference():
    """update_sharded folds only the owned keys (kernel 5's plain version
    on the CPU); the local query answers -1 for other shards' keys; the
    sharded query is the owner's estimate."""
    rng = np.random.default_rng(6)
    n, d, w, n_sh = 300, 3, 256, 3
    keys = rng.integers(0, 2**32, (n, 10), dtype=np.uint32)
    h1, h2 = thash.base_hashes(torch.from_numpy(keys.astype(np.int64)))
    jh1, jh2 = (jax.numpy.asarray(x.numpy().astype(np.uint32))
                for x in (h1, h2))
    vals = rng.integers(1, 100, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    cms, jcms = [], []
    for s in range(n_sh):
        cm = tcm.update_sharded(tcm.init(d, w, torch.device("cpu")), h1, h2,
                                torch.from_numpy(vals),
                                torch.from_numpy(valid), s, n_sh)
        jcms.append(jcm.CountMin(jax.numpy.zeros((d, w), jax.numpy.float32)))
        mine = jax.numpy.asarray(valid) & (jcm.owner_shard(jh1, jh2, n_sh)
                                           == s)
        jcms[-1] = jcm.update(jcms[-1], jh1, jh2, jax.numpy.asarray(vals),
                              mine)
        np.testing.assert_array_equal(cm.counts.numpy(),
                                      np.asarray(jcms[-1].counts))
        local = tcm.query_sharded_local(cm, h1, h2, s, n_sh)
        jlocal = jax.numpy.where(jcm.owner_shard(jh1, jh2, n_sh) == s,
                                 jcm.query(jcms[-1], jh1, jh2), -1.0)
        np.testing.assert_array_equal(local.numpy(), np.asarray(jlocal))
        cms.append(cm)
    owner = tcm.owner_shard(h1, h2, n_sh).numpy()
    want = np.stack([np.asarray(jcm.query(c, jh1, jh2)) for c in jcms])
    np.testing.assert_array_equal(tcm.query_sharded(cms, h1, h2).numpy(),
                                  want[owner, np.arange(n)])


def test_sharded_ingest_raises_for_a_tiered_state():
    from netobserv_tpu_torch.sketch import tiered
    with pytest.raises(NotImplementedError, match="owner-sharded"):
        tm.init_dist_state(TCFG._replace(tiered=tiered.TierSpec()),
                           make_mesh(MeshSpec(2), ["cpu"] * 2))
    with pytest.raises(ValueError, match="split"):
        tm.init_dist_state(TCFG._replace(cm_width=1 << 10),
                           make_mesh(MeshSpec(1, 3), ["cpu"] * 3))


def test_width_sharded_fold_gates_at_the_mesh_shapes():
    """Kernel 5 at a shard's width W / S and B / n_data rows passes the
    wrapper's gate at the default geometry; a local plane past the int32
    indices fails loudly before any table is touched."""
    from netobserv_tpu_torch.ops.kernels import countmin_kernel
    for s in (1, 2, 4):
        assert countmin_kernel.fold_fits(4, 65536 // s, 16384 // 4)
    state = ts.init_state(TCFG, "cpu")
    # a plane of 5 x 2^29 cells, as shapes only (expand holds no memory)
    huge = tcm.CountMin(torch.zeros(1).expand(5, 1 << 29))
    big = state._replace(cm_bytes=huge, cm_pkts=huge)
    arrays = ts.batch_to_device(make_arrays(64, np.random.default_rng(0)),
                                "cpu")
    with pytest.raises(ValueError, match="overflow"):
        ts.ingest(big, arrays, sketch_shard=(1, 2))
    assert float(state.total_records) == 0.0
    assert not bool(state.heavy.valid.any())


# ---------------------------------------------- ingest and merge vs JAX


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_ingest_and_reset_rolls_equal_the_reference(pairs, shape):
    """Three windows of two batches each: the distributed tables before
    and after every roll, and every report."""
    p = pairs[shape]
    nd = shape[0]
    jdist, dist = p.fresh()
    rng = np.random.default_rng(1)
    for w in range(3):
        for _ in range(2):
            arrays = make_arrays(nd * 96, rng, n_distinct=300)
            jdist = p.jingest(jdist, jm.shard_batch(p.jmesh, arrays))
            p.ingest(dist, tm.shard_batch(p.mesh, arrays))
        _assert_dist(dist, jdist, f"pre-roll {w}")
        jdist, jrep = p.jroll(jdist)
        _, trep = p.roll(dist)
        _report_close(trep, jrep)
        _assert_dist(dist, jdist, f"post-roll {w}")
    assert int(dist.window) == 3


def test_decay_and_keep_rolls_equal_the_reference(pairs):
    """Decay mode decays each shard's partial; keep mode keeps it; both
    over three windows of a 2x2 mesh (the local slot tables persist)."""
    p = pairs[(2, 2)]
    for kw in ({"decay_factor": 0.5}, {"reset_sketches": False}):
        jroll = jm.make_merge_fn(p.jmesh, JCFG, **kw)
        roll = tm.make_merge_fn(p.mesh, TCFG, **kw)
        jdist, dist = p.fresh()
        rng = np.random.default_rng(2)
        for w in range(3):
            arrays = make_arrays(2 * 96, rng, n_distinct=300)
            jdist = p.jingest(jdist, jm.shard_batch(p.jmesh, arrays))
            p.ingest(dist, tm.shard_batch(p.mesh, arrays))
            jdist, jrep = jroll(jdist)
            _, trep = roll(dist)
            _report_close(trep, jrep)
            _assert_dist(dist, jdist, f"{kw} {w}")


def test_duplicate_identities_and_ties_merge_as_the_reference(pairs):
    """Few keys over every shard: each identity sits in several shards'
    tables with equal estimates, so the merged table's order rests on the
    stacking order and the tie rule."""
    for shape in ((4, 1), (2, 2)):
        p = pairs[shape]
        jdist, dist = p.fresh()
        rng = np.random.default_rng(3)
        arrays = make_arrays(shape[0] * 64, rng, n_distinct=12)
        arrays["bytes"] = np.full(len(arrays["bytes"]), 5.0, np.float32)
        jdist = p.jingest(jdist, jm.shard_batch(p.jmesh, arrays))
        p.ingest(dist, tm.shard_batch(p.mesh, arrays))
        jdist, jrep = p.jroll(jdist)
        _, trep = p.roll(dist)
        for name in jrep.heavy._fields:
            np.testing.assert_array_equal(
                getattr(trep.heavy, name).numpy(),
                np.asarray(getattr(jrep.heavy, name)), err_msg=name)
        assert int(trep.heavy.valid.sum()) == 12


def test_ddos_alarm_travels_through_the_merge(pairs):
    """Calm windows, then one destination at 1e6 bytes a record: the
    merged z-scores alarm as the reference's do."""
    p = pairs[(4, 1)]
    jdist, dist = p.fresh()
    rng = np.random.default_rng(2)
    calm = make_arrays(4 * 64, rng)
    for _ in range(4):
        jdist = p.jingest(jdist, jm.shard_batch(p.jmesh, calm))
        p.ingest(dist, tm.shard_batch(p.mesh, calm))
        jdist, jrep = p.jroll(jdist)
        _, trep = p.roll(dist)
        assert not bool((trep.ddos_z > 6.0).any())
        _report_close(trep, jrep)
    attack = make_arrays(4 * 64, rng, n_distinct=1)
    attack["bytes"] = np.full(4 * 64, 1e6, np.float32)
    jdist = p.jingest(jdist, jm.shard_batch(p.jmesh, attack))
    p.ingest(dist, tm.shard_batch(p.mesh, attack))
    jdist, jrep = p.jroll(jdist)
    _, trep = p.roll(dist)
    assert bool((trep.ddos_z > 6.0).any())
    np.testing.assert_array_equal(trep.ddos_z.numpy() > 6.0,
                                  np.asarray(jrep.ddos_z) > 6.0)
    _report_close(trep, jrep)


# --------------------------------------- the mesh against one device


def test_data_mesh_equals_one_device_fold():
    """A 4x1 mesh's merged report and tables equal one device's fold of
    the same rows (integer masses: sums in any order are exact), with a
    key universe that fits every table (tests/test_parallel.py's rule:
    beyond it the merged table is a union of local candidates)."""
    mesh = make_mesh(MeshSpec(4), ["cpu"] * 4)
    dist = tm.init_dist_state(TCFG, mesh)
    one = ts.init_state(TCFG, "cpu")
    ingest = tm.make_sharded_ingest_fn(mesh, TCFG)
    roll = tm.make_merge_fn(mesh, TCFG, with_tables=True)
    rng = np.random.default_rng(4)
    keys = make_arrays(4 * 96, rng, n_distinct=12)["keys"]
    for w in range(2):
        # one universe for both windows (make_arrays draws one a call)
        arrays = make_arrays(4 * 96, rng)
        arrays["keys"] = keys[rng.permutation(len(keys))]
        ingest(dist, tm.shard_batch(mesh, arrays))
        ts.ingest(one, ts.batch_to_device(arrays, "cpu"))
        want_tables = ts.state_tables(one)
        _, rep, tables = roll(dist)
        _, want = ts.roll_window(one, TCFG)
        for k in want_tables:
            if k.startswith("heavy_"):
                continue  # one table against four merged: same keys below
            if k == "scalars":
                # the last is heavy_evictions: four tables evict otherwise
                # than one
                np.testing.assert_array_equal(tables[k][:-1],
                                              want_tables[k][:-1])
                continue
            np.testing.assert_array_equal(tables[k], want_tables[k],
                                          err_msg=k)
        got_keys = {tuple(x) for x, v in zip(tables["heavy_words"],
                                             tables["heavy_valid"]) if v}
        want_keys = {tuple(x) for x, v in zip(want_tables["heavy_words"],
                                              want_tables["heavy_valid"])
                     if v}
        assert got_keys == want_keys
        for f in ("total_records", "total_bytes", "syn_rate", "dscp_bytes",
                  "conv_fwd", "distinct_src", "per_dst_cardinality"):
            np.testing.assert_array_equal(getattr(rep, f).numpy(),
                                          getattr(want, f).numpy(),
                                          err_msg=f)


def _events(rng, n, n_distinct=80):
    from tests.test_torch_staging import _feed
    return _feed(rng, n, n_distinct=n_distinct, v4_share=0.97)


@pytest.mark.parametrize("shape,lanes", [((4, 1), 1), ((2, 1), 2),
                                         ((2, 2), 2)],
                         ids=["4x1-lanes1", "2x1-lanes2", "2x2-lanes2"])
def test_dict_dense_and_resident_transports_fold_alike(shape, lanes):
    """The same events through the sharded dict ingest (`shard_batch`) and
    the dense feed (`shard_dense`) leave the same distributed tables, bit
    for bit. Through the resident ring (its lanes, its ladder of (1, 2)),
    whose k = 2 chunk splits its rows over the shards otherwise and whose
    RTT and DNS lanes are range-coded, the merged totals, Count-Min planes
    and HLL registers are the same and the heavy hitters the same keys
    (tests/test_parallel.py's resident-against-dense rule)."""
    nd, ns = shape
    mesh = make_mesh(MeshSpec(nd, ns), ["cpu"] * (nd * ns))
    b = 256
    rng = np.random.default_rng(9)
    ev, f = _events(rng, 3 * b, n_distinct=12)
    states = [tm.init_dist_state(TCFG, mesh) for _ in range(3)]
    ingest = tm.make_sharded_ingest_fn(mesh, TCFG)
    dense_fn = tm.make_sharded_ingest_fn(mesh, TCFG, dense=True)
    for lo in range(0, len(ev), b):
        rows = tfp.pack_dense(ev[lo:lo + b], batch_size=b,
                              **{k: v[lo:lo + b] for k, v in f.items()})
        flat = rows.reshape(-1)
        ingest(states[0], tm.shard_batch(mesh, _arrays_of(flat)))
        dense_fn(states[1], tm.shard_dense(mesh, flat))
    want = tm.dist_tables(states[1])
    got = tm.dist_tables(states[0])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ring = tstg.ShardedResidentStagingRing(
        b, nd, slot_cap=1 << 10, packer="python", lanes=lanes,
        ladder=(1, 2), mesh=mesh)
    ring.fold(states[2], ev, **f)
    assert ring.superbatch_folds == {1: 1, 2: 1}
    res = ts.state_tables(tm.merge_states(states[2]))
    den = ts.state_tables(tm.merge_states(states[1]))
    for k in ("cm_bytes", "cm_pkts", "hll_src"):
        if ns == 1 or not k.startswith("cm_"):
            np.testing.assert_array_equal(res[k], den[k], err_msg=k)
    np.testing.assert_array_equal(res["scalars"][:3], den["scalars"][:3])
    keys = [{tuple(w) for w, v in zip(t["heavy_words"], t["heavy_valid"])
             if v} for t in (res, den)]
    assert keys[0] == keys[1] and len(keys[0]) > 0
    # every region's key table holds its dictionary's keys, slot by slot
    tables = ring.flat_key_tables().numpy().astype(np.uint32)
    assert len(tables) == len(ring.kdicts) == nd * 2 * lanes
    for table, kd in zip(tables, ring.kdicts):
        slots = np.fromiter(kd.slots.values(), np.int64)
        words = np.frombuffer(b"".join(kd.slots), np.uint32).reshape(-1, 10)
        assert len(slots) > 0
        np.testing.assert_array_equal(table[slots], words)
    ring.close()


def _arrays_of(flat: np.ndarray) -> dict:
    """The host columns of a dense feed batch (the dense unpack's, on the
    CPU), for `shard_batch`."""
    arrays = ts.dense_to_arrays(torch.from_numpy(flat.view(np.int32)))
    return {k: v.numpy().astype(np.uint32) if k == "keys" else v.numpy()
            for k, v in arrays.items()}


def test_dense_with_token_returns_each_shards_first_word():
    mesh = make_mesh(MeshSpec(2, 2), ["cpu"] * 4)
    fn = tm.make_sharded_ingest_fn(mesh, TCFG, dense=True, with_token=True)
    rng = np.random.default_rng(10)
    arrays = make_arrays(64, rng)
    flat = ts.arrays_to_dense(arrays)
    dist = tm.init_dist_state(TCFG, mesh)
    out, token = fn(dist, tm.shard_dense(mesh, flat))
    assert out is dist
    words = flat.view(np.int32).reshape(2, -1)
    assert [[int(t) for t in row] for row in token] == \
        [[int(words[d, 0])] * 2 for d in range(2)]
    assert int(dist.shards[0][0].total_records) == 32
    with pytest.raises(ValueError, match="dense"):
        tm.make_sharded_ingest_fn(mesh, TCFG, with_token=True)


# ------------------------------------------- tables and the delta fold


def test_with_tables_and_the_delta_fold_equal_the_reference(pairs):
    """A 4x1 roll's merged tables equal the reference's; the delta fold
    merges one agent's tables into its owner shard only."""
    p = pairs[(4, 1)]
    jroll = jm.make_merge_fn(p.jmesh, JCFG, with_tables=True)
    jfold = jm.make_fold_delta_fn(p.jmesh, JCFG, donate=False)
    roll = tm.make_merge_fn(p.mesh, TCFG, with_tables=True)
    fold = tm.make_fold_delta_fn(p.mesh, TCFG)
    jdist, dist = p.fresh()
    rng = np.random.default_rng(12)
    for owner in (2, 0, 2):
        s = js.init_state(JCFG)
        s = js.ingest(s, {k: jax.numpy.asarray(v) for k, v in
                          make_arrays(64, rng, n_distinct=50).items()})
        tables = {k: np.asarray(v) for k, v in js.state_tables(s).items()}
        jdist = jfold(jdist, {k: jm.put_replicated(p.jmesh, v)
                              for k, v in tables.items()},
                      jm.put_replicated(p.jmesh,
                                        np.asarray([owner], np.int32)))
        ttabs = {k: torch.from_numpy(np.array(
            v, np.int64 if v.dtype == np.uint32 else v.dtype))
            for k, v in tables.items()}
        fold(dist, ttabs, owner)
        _assert_dist(dist, jdist, f"fold {owner}")
    jdist, jrep, jtables = jroll(jdist)
    _, trep, tables = roll(dist)
    _report_close(trep, jrep)
    for k, v in jtables.items():
        np.testing.assert_array_equal(tables[k], np.asarray(v), err_msg=k)
    _assert_dist(dist, jdist, "rolled")


def test_width_sharded_refusals_carry_the_reference_messages(pairs):
    p = pairs[(2, 2)]
    for make in (lambda mod, mesh, cfg: mod.make_merge_fn(
            mesh, cfg, with_tables=True),
            lambda mod, mesh, cfg: mod.make_fold_delta_fn(mesh, cfg)):
        with pytest.raises(ValueError) as want:
            make(jm, p.jmesh, JCFG)
        with pytest.raises(ValueError) as got:
            make(tm, p.mesh, TCFG)
        assert str(got.value) == str(want.value)


def test_sharded_resident_fn_folds_what_the_ring_ships():
    """`make_sharded_ingest_resident_fn` over the regions the mesh ring
    ships (its own key tables from `init_resident_tables`) leaves the
    ring's distributed tables, bit for bit, and returns each shard's
    first word as its token."""
    mesh = make_mesh(MeshSpec(2, 2), ["cpu"] * 4)
    b, lanes = 256, 2
    ring = tstg.ShardedResidentStagingRing(
        b, 2, slot_cap=1 << 10, packer="python", lanes=lanes, mesh=mesh)
    fn = tm.make_sharded_ingest_resident_fn(
        mesh, TCFG, ring.batch_per_region, ring.caps, lanes=lanes)
    tables = tm.init_resident_tables(mesh, 1 << 10, lanes=lanes)
    twin = tm.init_dist_state(TCFG, mesh)
    dispatch = ring._dispatch
    tokens = []

    def both(k, state, flat):
        dispatch(k, state, flat)
        out, _, token = fn(twin, tables, flat)
        assert out is twin
        tokens.append(token)
    ring._dispatch = both
    dist = tm.init_dist_state(TCFG, mesh)
    ev, f = _events(np.random.default_rng(14), 3 * b)
    ring.fold(dist, ev, **f)
    assert len(tokens) == 3 and len(tokens[0]) == 2
    got, want = tm.dist_tables(twin), tm.dist_tables(dist)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for d in range(2):
        assert torch.equal(tables[d][0], ring.key_tables[d][0])
    ring.close()
