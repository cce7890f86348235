"""Kernel 1's plain twin (netobserv_tpu_torch/ops/countmin.update_two, the
CPU path of ops/kernels/countmin_kernel.py) against the JAX package's
`countmin.update_two` scatter form and its Pallas `update_two` in interpret
mode, d=4, W=2048, a ragged B=1500; and on the seeded contract cases of
`netobserv_tpu_torch/ops/kernels/cases.py` at W = 512 (one kernel-6 tile)
and 2048, through the wrapper's CPU path, onto tables of small integers.

Float regimes:
- integer-valued masses whose per-cell sums stay below 2^24: bit-exact;
- production masses (bytes x sampling, cells past 2^24): a cell that took
  n adds is within (n-1) * 2^-24 relative of the exact (float64) sum in
  any add order, so each form is held to that, and the two forms to twice
  it."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from netobserv_tpu.ops import countmin as jcm
from netobserv_tpu.ops import hashing as jh
from netobserv_tpu.ops.pallas import countmin_kernel as jcmk
from netobserv_tpu_torch.ops import countmin as tcm
from netobserv_tpu_torch.ops.kernels import cases
from netobserv_tpu_torch.ops.kernels import countmin_kernel as tcmk

D, W, B = 4, 2048, 1500
U = 2.0 ** -24


def _batch(seed, big=False):
    rng = np.random.default_rng(seed)
    universe = rng.integers(0, 2**32, (300, 10), dtype=np.uint32)
    words = universe[np.minimum(rng.zipf(1.2, B) - 1, 299)]
    if big:  # bytes x sampling: per-cell sums far past 2^24
        va = (rng.integers(64, 9000, B) * rng.integers(1, 2000, B)
              ).astype(np.float32)
    else:
        va = rng.integers(1, 9000, B).astype(np.float32)
    vb = rng.integers(1, 12, B).astype(np.float32)
    valid = rng.random(B) < 0.9
    return words, va, vb, valid


def _hashes(words):
    h1, h2 = jh.base_hashes(jnp.asarray(words))
    return (h1, h2), (torch.from_numpy(np.asarray(h1).astype(np.int64)),
                      torch.from_numpy(np.asarray(h2).astype(np.int64)))


def _fold(batches):
    ja, jb = jcm.init(D, W), jcm.init(D, W)
    ta = tcm.init(D, W, torch.device("cpu"))
    tb = tcm.init(D, W, torch.device("cpu"))
    for words, va, vb, valid in batches:
        (j1, j2), (t1, t2) = _hashes(words)
        ja, jb = jcm.update_two(ja, jb, j1, j2, jnp.asarray(va),
                                jnp.asarray(vb), jnp.asarray(valid))
        tcm.update_two(ta, tb, t1, t2, torch.from_numpy(va),
                       torch.from_numpy(vb), torch.from_numpy(valid))
    return (ja, jb), (ta, tb)


def test_update_two_and_query_integer_regime_bit_exact():
    batches = [_batch(s) for s in (1, 2, 3)]
    (ja, jb), (ta, tb) = _fold(batches)
    assert float(np.asarray(ja.counts).max()) < 2**24
    np.testing.assert_array_equal(ta.counts.numpy(), np.asarray(ja.counts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    (j1, j2), (t1, t2) = _hashes(batches[0][0])
    np.testing.assert_array_equal(tcm.query(ta, t1, t2).numpy(),
                                  np.asarray(jcm.query(ja, j1, j2)))
    assert float(tcm.total(ta)) == float(jcm.total(ja))


def test_update_two_production_regime_within_add_order_bound():
    batches = [_batch(s, big=True) for s in (4, 5, 6)]
    (ja, _), (ta, _) = _fold(batches)
    exact = np.zeros((D, W))
    adds = np.zeros((D, W))
    for words, va, _, valid in batches:
        (j1, j2), _ = _hashes(words)
        idx = np.asarray(jh.row_indices(j1, j2, D, W))
        for r in range(D):
            np.add.at(exact[r], idx[r], np.where(valid, va, 0.0))
            np.add.at(adds[r], idx[r], 1)
    assert exact.max() > 2**24  # the regime under test
    bound = np.maximum(adds - 1, 0) * U * exact
    got, want = ta.counts.numpy().astype(np.float64), np.asarray(
        ja.counts).astype(np.float64)
    assert np.all(np.abs(got - exact) <= bound)
    assert np.all(np.abs(want - exact) <= bound)
    assert np.all(np.abs(got - want) <= 2 * bound)


def test_plain_twin_matches_pallas_kernel_interpret_bit_exact():
    words, va, vb, valid = _batch(7)
    (j1, j2), (t1, t2) = _hashes(words)
    pa, pb = jcmk.update_two(jcm.init(D, W), jcm.init(D, W), j1, j2,
                             jnp.asarray(va), jnp.asarray(vb),
                             jnp.asarray(valid), interpret=True)
    ta = tcm.init(D, W, torch.device("cpu"))
    tb = tcm.init(D, W, torch.device("cpu"))
    tcm.update_two(ta, tb, t1, t2, torch.from_numpy(va),
                   torch.from_numpy(vb), torch.from_numpy(valid))
    np.testing.assert_array_equal(ta.counts.numpy(), np.asarray(pa.counts))
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(pb.counts))


CASE_NAMES = [name for name, _ in cases.countmin_cases(512)]


@pytest.mark.parametrize("w", [512, 2048])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_update_two_bit_exact_vs_jax_on_contract_cases(name, w):
    """Kernel 1's plain twin (the wrapper on CPU tensors) against the JAX
    scatter form and, for B > 0, the Pallas kernel in interpret mode (whose
    chunk walk cannot take an empty batch), onto non-zero tables."""
    c = dict(cases.countmin_cases(w))[name]
    rng = np.random.default_rng(5)
    init = [rng.integers(0, 50, (D, w)).astype(np.float32) for _ in "ab"]
    ta, tb = (torch.from_numpy(x.copy()) for x in init)
    tcmk.update_two(ta, tb, *(torch.from_numpy(c[f])
                              for f in ("h1", "h2", "va", "vb")))
    h1, h2 = (jnp.asarray(c[f].astype(np.uint32)) for f in ("h1", "h2"))
    jargs = (jcm.CountMin(jnp.asarray(init[0])),
             jcm.CountMin(jnp.asarray(init[1])), h1, h2,
             jnp.asarray(c["va"]), jnp.asarray(c["vb"]),
             jnp.ones(len(c["va"]), bool))
    refs = [jcm.update_two(*jargs)]
    if len(c["va"]):
        refs.append(jcmk.update_two(*jargs, interpret=True))
    assert float(refs[0][0].counts.max()) < 2 ** 24
    for ja, jb in refs:
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja.counts))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb.counts))
    if name == "every_row_one_key":
        cols = (c["h1"][0] + np.arange(D)) % w
        np.testing.assert_array_equal(
            ta.numpy()[np.arange(D), cols] - init[0][np.arange(D), cols],
            np.full(D, c["va"].sum()))


#: (d, w, n) about d * max(w, n) = 2^31, on either side of it
FIT_SHAPES = [(4, 1 << 16, 16384), (4, 1 << 28, 16384), (4, 1 << 29, 16384),
              (4, 1 << 16, (1 << 29) - 1), (4, 1 << 16, 1 << 29),
              (1, 1 << 30, (1 << 31) - 1), (1, 1 << 31, 1),
              (3, 1 << 28, 715827882), (3, 1 << 28, 715827883),
              (3, 1 << 29, 64)]


@pytest.mark.parametrize("d,w,n", FIT_SHAPES)
def test_fold_fits_agrees_with_the_wrappers(monkeypatch, d, w, n):
    """On the CUDA branch (`on_cuda` patched, launches recorded) kernels 1
    and 5's wrappers raise exactly where `fold_fits` is false, before any
    launch, and launch once where it is true. Meta tensors: d * n = 2^31
    costs no memory."""
    seen = []
    monkeypatch.setattr(tcmk, "on_cuda", lambda t: True)
    monkeypatch.setattr(tcmk, "check", lambda *a: None)
    for k in (tcmk.KERNEL, tcmk.KERNEL_ONE):
        monkeypatch.setattr(k, "launch", lambda ptrs, ints, dev, _k=k:
                            seen.append((_k.symbol, ints)))
    table = torch.empty((d, w), device="meta")
    lane = torch.empty((n,), dtype=torch.int64, device="meta")
    vals = torch.empty((n,), device="meta")
    calls = {"cm_fold2": lambda: tcmk.update_two(table, table, lane, lane,
                                                 vals, vals),
             "cm_fold": lambda: tcmk.update(table, lane, lane, vals)}
    fits = tcmk.fold_fits(d, w, n)
    assert fits == (d * max(w, n) < 2 ** 31)
    for symbol, call in calls.items():
        if fits:
            call()
            assert seen[-1] == (symbol, [n, d, w])
        else:
            with pytest.raises(ValueError, match="int32 cell and thread "
                                                 "indices would overflow"):
                call()
    assert len(seen) == (2 if fits else 0)
