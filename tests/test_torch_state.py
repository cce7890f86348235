"""The port's sketch plane as a whole (netobserv_tpu_torch/sketch/state.py,
sketch/carry.py, exporter/torch_sketch.py, exporter/report.py,
scenarios/traffic.py) against the JAX package's, at a small geometry:
d=4, W=2048, HLL p=10, grids 256x32, K=128, hist 256, EWMA m=512, and
ragged batches of 1500 rows padded to 2048 by the exporter.

Float regimes and tolerances:
- state tables: integer-valued masses with every per-cell sum below 2^24,
  so add order cannot matter: bit-exact after dtype normalization;
- the production regime (bytes x large sampling factors): a cell that took
  n adds is within (n-1) * 2^-24 relative of its exact sum in any order,
  so the two forms are held to twice that with n the window's row count;
- report fields: HLL estimates (an f32 sum over m registers) to a relative
  m * 2^-24; every other float to a relative 1e-6 (f32 pow/log/sqrt
  rounding in two libraries);
- histogram buckets: torch's and XLA's f32 log can round a value on a
  bucket edge differently, so a sample may land one bucket apart; the
  bound is the total mass equal and every sample at most one bucket off,
  swept over every integer sample below 10^7."""

import math

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.exporter import tpu_sketch as jexp
from netobserv_tpu.ops import quantile as jq
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.ops import quantile as tq
from netobserv_tpu_torch.ops.kernels import hll_kernel
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered

GEOM = dict(cm_width=2048, hll_precision=10, perdst_buckets=256,
            perdst_precision=5, persrc_buckets=256, persrc_precision=5,
            topk=128, hist_buckets=256, ewma_buckets=512)
JCFG = js.SketchConfig(**GEOM)
TCFG = ts.SketchConfig(**GEOM)
B_PAD = 2048
_jax_ingest = jax.jit(lambda s, d: js.ingest(s, js.dense_to_arrays(d),
                                             use_pallas=False))


def _pool(seed, n_batches=3, sampling_max=0):
    rng = np.random.default_rng(seed)
    universe, pool = traffic.make_pool(rng, batch=1500, n_batches=n_batches,
                                       n_distinct=2000)
    if sampling_max:
        for arrays, _ in pool:
            arrays["sampling"] = rng.integers(0, sampling_max + 1, 1500
                                              ).astype(np.int32)
    return universe, pool


def _jax_tables(state):
    return {k: np.asarray(v) for k, v in js.state_tables(state).items()}


def _assert_tables_equal(got, want, where):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, where)
        assert got[k].shape == want[k].shape, (k, where)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


def _assert_report_close(got, want, m_hll):
    for f in js.WindowReport._fields:
        if f == "heavy":
            for name in want.heavy._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(got.heavy, name)),
                    np.asarray(getattr(want.heavy, name)), err_msg=name)
            continue
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        rtol = 2.0 ** -24 * m_hll if f in (
            "distinct_src", "per_dst_cardinality", "per_src_fanout") else 1e-6
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f)


def _assert_json_close(got, want, path="report"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-5, abs_tol=1e-9), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_dense_to_arrays_field_by_field():
    rng = np.random.default_rng(1)
    n = 333
    arrays = {
        "keys": rng.integers(0, 2**32, (n, 10), dtype=np.uint32),
        "bytes": np.concatenate([[0.0, 1e30, 2.0**24 + 2, 3.5], rng.random(
            n - 4) * 1e6]).astype(np.float32),
        "packets": rng.integers(0, 2**32, n, dtype=np.uint32),
        "rtt_us": rng.integers(0, 2**31, n),
        "dns_latency_us": rng.integers(0, 2**31, n),
        "valid": rng.random(n) < 0.5,
        "sampling": rng.integers(0, 2**31, n),
        "tcp_flags": rng.integers(0, 1 << 16, n),
        "dscp": rng.integers(0, 256, n),
        "markers": rng.integers(0, 256, n),
        "drop_bytes": rng.integers(0, 70000, n),
        "drop_packets": rng.integers(0, 70000, n),
        "drop_cause": rng.integers(0, 70000, n),
    }
    dense = ts.arrays_to_dense(arrays)
    np.testing.assert_array_equal(dense, js.arrays_to_dense(arrays))
    want = js.dense_to_arrays(jnp.asarray(dense))
    got = ts.dense_to_arrays(torch.from_numpy(dense.view(np.int32)))
    assert got.keys() == want.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k == "keys":
            g = g.astype(np.uint32)
        if k == "bytes":
            g, w = g.view(np.uint32), w.view(np.uint32)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("mode", ["reset", "decay", "keep"])
def test_fold_and_roll_schedule_matches_jax(mode):
    """Three windows of three ragged batches through the exporter's dense
    path, rolled in each mode: tables bit-exact before every roll, reports
    and rendered JSON under the tolerances above."""
    universe, pool = _pool(seed=2, sampling_max=3)
    reset, decay = mode == "reset", (0.5 if mode == "decay" else None)
    jroll = jax.jit(lambda s: js.roll_window(s, JCFG, reset, decay))
    exp = TorchSketchExporter(TCFG, batch_size=B_PAD, device="cpu",
                              reset_sketches=reset, decay_factor=decay)
    reports = []
    exp.sink = reports.append
    jstate = js.init_state(JCFG)
    jprev = None
    for w in range(3):
        for dense in traffic.dense_pool(pool):
            jstate = _jax_ingest(jstate, jnp.asarray(dense))
            assert exp.fold_dense(dense) is None
        _assert_tables_equal(exp.state_tables(), _jax_tables(jstate),
                             f"{mode} window {w}")
        tstate_pre = carry.state_to_numpy(exp.state)
        jstate, jrep = jroll(jstate)
        got = exp.roll()
        want = jexp.report_to_json(jrep, prev_heavy_index=jprev)
        jprev = jexp.heavy_identity_index(jrep)
        _assert_json_close(got, want)
        assert reports[-1] is got
        assert tstate_pre["window"] == w
    assert exp.folds == 9 and exp.rolls == 3
    _, trep = ts.roll_window(exp.state, TCFG, reset, decay)
    jstate, jrep = jroll(jstate)
    _assert_report_close(trep, jrep, 2 ** GEOM["hll_precision"])
    exp.close()


def test_production_regime_within_add_order_bound():
    """Sampling factors up to 4000 push byte cells far past 2^24: float
    tables within 2 * (n-1) * 2^-24 relative, n the window's row count;
    integer tables (HLL registers) stay exact."""
    _, pool = _pool(seed=3, sampling_max=4000)
    jstate = js.init_state(JCFG)
    tstate = ts.init_state(TCFG, device="cpu")
    for dense in traffic.dense_pool(pool):
        jstate = _jax_ingest(jstate, jnp.asarray(dense))
        ts.ingest(tstate, ts.dense_to_arrays(
            torch.from_numpy(dense.view(np.int32))))
    got, want = ts.state_tables(tstate), _jax_tables(jstate)
    assert want["cm_bytes"].max() > 2**24
    n = 3 * 1500
    for k in want:
        if want[k].dtype == np.float32:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=2 * (n - 1) * 2.0 ** -24,
                                       atol=0, err_msg=k)
        elif not k.startswith("heavy"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind,n_folds", [("wide", 3), ("fanout_off", 2),
                                          ("tiered", 2)])
def test_ingest_folds_every_hll_in_one_call(kind, n_folds, monkeypatch):
    """One ingest makes one `update_folds` call (one launch on the card):
    the global-src HLL and both grids on the wide state, the global HLL and
    the per-dst grid with fan-out off, and the two grids on the tiered
    state's interior form, where kernel 7 folds the packed global bank."""
    calls = []
    real = hll_kernel.update_folds

    def spy(folds):
        calls.append([tuple(f[0].shape) for f in folds])
        return real(folds)

    monkeypatch.setattr(hll_kernel, "update_folds", spy)
    cfg = TCFG._replace(enable_fanout=kind != "fanout_off",
                        tiered=tiered.TierSpec() if kind == "tiered"
                        else None)
    assert ts.tiered_fold_form(cfg) == ("interior" if kind == "tiered"
                                        else None)
    _, pool = _pool(seed=5, n_batches=1)
    state = ts.init_state(cfg, device="cpu")
    dense = traffic.dense_pool(pool)[0]
    ts.ingest(state, ts.dense_to_arrays(torch.from_numpy(dense.view(
        np.int32))), enable_fanout=cfg.enable_fanout)
    grids = {"global": (1 << GEOM["hll_precision"],),
             "per_dst": (GEOM["perdst_buckets"], 1 << GEOM["perdst_precision"]),
             "per_src": (GEOM["persrc_buckets"],
                         1 << GEOM["persrc_precision"])}
    want = {"wide": ["global", "per_dst", "per_src"],
            "fanout_off": ["global", "per_dst"],
            "tiered": ["per_dst", "per_src"]}[kind]
    assert calls == [[grids[k] for k in want]] and len(want) == n_folds
    wide = state.rest if kind == "tiered" else state
    assert float(wide.total_records) == float(pool[0][0]["valid"].sum())


def test_carry_round_trip_then_fold_agrees():
    """A JAX state (two windows of history, so the EWMA baselines are live)
    carried across with its dotted field paths, then one more batch and a
    roll on each side: the port agrees with JAX."""
    _, pool = _pool(seed=4)
    dense = traffic.dense_pool(pool)
    jroll = jax.jit(lambda s: js.roll_window(s, JCFG))
    jstate = js.init_state(JCFG)
    for w in range(2):
        for d in dense:
            jstate = _jax_ingest(jstate, jnp.asarray(d))
        jstate, _ = jroll(jstate)
    jstate = _jax_ingest(jstate, jnp.asarray(dense[0]))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jstate)
    flat = {".".join(p.name for p in path): np.asarray(v)
            for path, v in leaves}
    tstate = carry.state_from_numpy(flat, device="cpu")
    back = carry.state_to_numpy(tstate)
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    jstate = _jax_ingest(jstate, jnp.asarray(dense[1]))
    ts.ingest(tstate, ts.dense_to_arrays(
        torch.from_numpy(dense[1].view(np.int32))))
    _assert_tables_equal(ts.state_tables(tstate), _jax_tables(jstate),
                         "carried")
    jstate, jrep = jroll(jstate)
    _, trep = ts.roll_window(tstate, TCFG)
    _assert_report_close(trep, jrep, 2 ** GEOM["hll_precision"])
    for name in ("ddos", "syn", "drops_ewma"):
        for f in ("mean", "var", "windows"):
            np.testing.assert_allclose(
                getattr(getattr(tstate, name), f).numpy(),
                np.asarray(getattr(getattr(jstate, name), f)), rtol=1e-6,
                err_msg=f"{name}.{f}")
    with pytest.raises(ValueError):
        carry.state_from_numpy({k: v for k, v in flat.items()
                                if k != "window"}, device="cpu")


def test_quantile_bucket_edges_at_most_one_bucket_apart():
    nb = 1024  # the default geometry's hist_buckets
    gamma = jq.gamma_for(nb)
    v = np.arange(0, 10_000_000, dtype=np.int32)
    want = np.asarray(jax.jit(lambda x: jq.bucket_of(x, nb, gamma))(
        jnp.asarray(v)))
    got = tq.bucket_of(torch.from_numpy(v), nb, gamma).numpy()
    off = np.abs(got - want)
    assert off.max() <= 1
    assert np.count_nonzero(off) <= 1e-5 * v.size
    np.testing.assert_array_equal(
        np.bincount(got, minlength=nb).sum(),
        np.bincount(want, minlength=nb).sum())


def test_exporter_window_deadline_and_padding():
    _, pool = _pool(seed=5, n_batches=1)
    exp = TorchSketchExporter(TCFG, batch_size=1024, device="cpu",
                              window_s=0.0)
    dense = traffic.dense_pool(pool)[0]  # 1500 rows: two folds of 1024
    report = exp.fold_dense(dense)
    assert exp.folds == 2 and exp.rolls == 1
    assert report["Records"] == 1500.0 and report["Window"] == 0
    with pytest.raises(ValueError):
        exp.fold_dense(dense[:7])
    exp.close()
    with pytest.raises(RuntimeError):
        exp.fold_dense(dense)


def test_traffic_is_the_bench_traffic_and_oracle():
    import bench

    universe, pool = traffic.make_pool(np.random.default_rng(0))
    buniverse, bpool = bench.make_pool(np.random.default_rng(0))
    np.testing.assert_array_equal(universe, buniverse)
    for (a, ra), (b, rb) in zip(pool, bpool):
        np.testing.assert_array_equal(ra, rb)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ranks = pool[0][1]
    words = universe[np.unique(ranks)[:120]]

    class _Table:
        pass

    t = _Table()
    t.heavy = _Table()
    t.heavy.words, t.heavy.valid = words, np.ones(len(words), bool)
    assert traffic.check_recall(words, t.heavy.valid, [0, 1], universe,
                                pool) == bench.check_recall(
        t, [0, 1], universe, pool)
