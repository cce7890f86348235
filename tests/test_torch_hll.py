"""Kernel 3's plain twin (netobserv_tpu_torch/ops/hll.update, the CPU path
of ops/kernels/hll_kernel.py) and the HLL module around it, against the JAX
package's `hll` and its Pallas `hll_kernel.update` in interpret mode; and
the folds launch (`hll_kernel.update_folds`, kernels 3 and 8 of one batch
in one launch) on the ingest's fold sets and on the contract cases of
`netobserv_tpu_torch/ops/kernels/cases.py`, against the reference applied
fold by fold.

Registers are integer maxima: bit-exact. `estimate` sums 2^-reg over m f32
terms, whose add order may differ between the two packages: held to a
relative m * 2^-24 (observed: about one ulp)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.ops import hashing as jh
from netobserv_tpu.ops import hll as jhll
from netobserv_tpu.ops.pallas import hll_kernel as jhk
from netobserv_tpu_torch.ops import hll as thll
from netobserv_tpu_torch.ops.kernels import cases
from netobserv_tpu_torch.ops.kernels import hll_kernel as thk

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _hashes(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (n, 10), dtype=np.uint32)
    h1, h2 = jh.base_hashes(jnp.asarray(w))
    return h1, h2, rng.random(n) < 0.9


def test_rank_edge_values():
    edge = np.array([0, 1, 2, 3, 2**31 - 1, 2**31, 2**32 - 1, 0x00010000,
                     0x0000FFFF], np.uint32)
    edge = np.concatenate([edge, np.random.default_rng(1).integers(
        0, 2**32, 4096, dtype=np.uint32)])
    got = thll._rank(_t(edge))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jhll._rank(jnp.asarray(edge))))
    assert got[0] == 33 and got[1] == 32 and got[5] == 1 and got[6] == 1


def test_update_bit_exact_vs_scatter_and_pallas():
    h1, h2, valid = _hashes(1500, 2)  # ragged: the Pallas form pads
    want = jhll.update(jhll.init(10), h1, h2, jnp.asarray(valid))
    pallas = jhk.update(jhll.init(10), h1, h2, jnp.asarray(valid),
                        interpret=True)
    got = thll.update(thll.init(10, CPU), _t(h1), _t(h2),
                      torch.from_numpy(valid))
    np.testing.assert_array_equal(got.regs.numpy(), np.asarray(want.regs))
    np.testing.assert_array_equal(got.regs.numpy(), np.asarray(pallas.regs))


def test_update_per_dst_bit_exact():
    h1, h2, valid = _hashes(1500, 3)
    dst, _, _ = _hashes(1500, 4)
    want = jhll.update_per_dst(jhll.init_per_dst(256, 5), dst, h1, h2,
                               jnp.asarray(valid))
    got = thll.update_per_dst(thll.init_per_dst(256, 5, CPU), _t(dst),
                              _t(h1), _t(h2), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.regs.numpy(), np.asarray(want.regs))


def test_estimate_within_sum_order_bound():
    rng = np.random.default_rng(6)
    m = 1024
    regs = [
        np.zeros(m, np.int32),                                  # empty
        np.where(rng.random(m) < 0.05, 1, 0).astype(np.int32),  # linear
        rng.geometric(0.5, m).astype(np.int32),                 # raw
        (rng.geometric(0.5, m) + 22).astype(np.int32),          # large
    ]
    for r in regs + [np.stack(regs).reshape(-1, 32)]:
        got = thll.estimate(torch.from_numpy(r)).numpy()
        want = np.asarray(jax.jit(jhll.estimate)(jnp.asarray(r)))
        np.testing.assert_allclose(got, want, rtol=r.shape[-1] * 2.0 ** -24,
                                   atol=0)


def test_update_refuses_non_power_of_two_registers_on_the_cpu():
    """The CPU twin would fold a register file the card refuses: the
    wrapper refuses it on either device."""
    h = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        thk.update(torch.zeros(24, dtype=torch.int32), h, h,
                   torch.ones(4, dtype=torch.bool))


#: the ingest's fold sets at a small geometry (every register file 512
#: registers, the Pallas tile): the global-src HLL (m = 512), the per-dst
#: grid (32 x 16) and the per-src grid (16 x 32)
FOLD_SETS = {"wide": ("global", "per_dst", "per_src"),
             "wide_fanout_off": ("global", "per_dst"),
             "tiered": ("per_dst", "per_src")}
GEOMETRY = {"global": (1, 512), "per_dst": (32, 16), "per_src": (16, 32)}


def _jax_fold(regs, lanes, pallas: bool):
    """The reference's fold of one register file: `hll.update` or
    `update_per_dst`, or their Pallas kernels in interpret mode."""
    if regs.ndim == 1:
        fn = jhk.update if pallas else jhll.update
        kw = {"interpret": True} if pallas else {}
        return np.asarray(fn(jhll.HLL(jnp.asarray(regs)), *lanes, **kw).regs)
    fn = jhk.update_per_dst if pallas else jhll.update_per_dst
    kw = {"interpret": True} if pallas else {}
    return np.asarray(fn(jhll.PerDstHLL(jnp.asarray(regs)), *lanes,
                         **kw).regs)


def _fold_all_ways(start, lane_sets):
    """Fold each batch (a list of per-fold lane tuples: (h1, h2, valid) or
    (dst, h1, h2, valid), numpy) into copies of the `start` register files
    through `update_folds_plain`, `update_folds` on CPU tensors and the
    reference's scatter and Pallas forms fold by fold; return the four
    results, each a list of register files."""
    plain = [torch.from_numpy(r.copy()) for r in start]
    port = [torch.from_numpy(r.copy()) for r in start]
    ref, pal = [r.copy() for r in start], [r.copy() for r in start]
    for lanes in lane_sets:
        n = len(lanes[0][-1])
        tl = [tuple(torch.from_numpy(x) for x in ls) for ls in lanes]
        thk.update_folds_plain(tuple((r, *t) for r, t in zip(plain, tl)))
        thk.update_folds(tuple((r, *t) for r, t in zip(port, tl)))
        for i, ls in enumerate(lanes):
            jl = [jnp.asarray(x.astype(np.uint32)) for x in ls[:-1]]
            jl.append(jnp.asarray(ls[-1]))
            ref[i] = _jax_fold(ref[i], jl, pallas=False)
            if n:  # the Pallas chunk walk cannot take an empty batch
                pal[i] = _jax_fold(pal[i], jl, pallas=True)
    return ([r.numpy() for r in plain], [r.numpy() for r in port], ref,
            pal)


@pytest.mark.parametrize("batch", ["n512", "n777", "all_invalid"])
@pytest.mark.parametrize("fold_set", list(FOLD_SETS))
def test_update_folds_bit_exact_vs_reference_fold_by_fold(fold_set, batch):
    """The folds launch's twin and its CPU wrapper on each fold set of the
    ingest, B = 512 or a ragged 777 with about 10 % invalid rows, or an
    all-invalid batch, folded twice so the second fold meets live
    registers."""
    rng = np.random.default_rng(21)
    n = 777 if batch == "n777" else 512
    names = FOLD_SETS[fold_set]
    start = [np.zeros(GEOMETRY[k][1] if k == "global" else GEOMETRY[k],
                      np.int32) for k in names]
    lane_sets = []
    for _ in range(2):
        words = rng.integers(0, 2**32, (3, n, 10), dtype=np.uint32)
        hashes = [tuple(np.asarray(h).astype(np.int64) for h in
                        jh.base_hashes(jnp.asarray(w))) for w in words]
        valid = (rng.random(n) < 0.9) & (batch != "all_invalid")
        fanout = valid & (rng.random(n) < 0.7)
        per = {"global": (hashes[0][0], hashes[0][1], valid),
               "per_dst": (hashes[1][0], hashes[0][0], hashes[0][1], valid),
               "per_src": (hashes[0][0], hashes[2][0], hashes[2][1], fanout)}
        lane_sets.append([per[k] for k in names])
    plain, port, ref, pal = _fold_all_ways(start, lane_sets)
    for i, k in enumerate(names):
        assert ref[i].shape == start[i].shape
        assert ref[i].any() == (batch != "all_invalid"), k
        np.testing.assert_array_equal(pal[i], ref[i], err_msg=k)
        np.testing.assert_array_equal(plain[i], ref[i], err_msg=k)
        np.testing.assert_array_equal(port[i], ref[i], err_msg=k)


HLL_CASE_NAMES = [name for name, _ in cases.hll_fold_cases(1, 512)]


@pytest.mark.parametrize("name", HLL_CASE_NAMES)
def test_update_folds_bit_exact_on_contract_cases(name):
    """The three folds of one launch (global 512, grids 32 x 16 and 16 x
    32) on one contract case each (cases.py), from its pre-fold registers,
    against the reference fold by fold: bit-exact."""
    start, lanes = [], []
    for seed, k in enumerate(("global", "per_dst", "per_src")):
        d, m = GEOMETRY[k]
        c = dict(cases.hll_fold_cases(d, m, seed))[name]
        if k == "global":
            start.append(c["regs"].reshape(m))
            lanes.append((c["h1"], c["h2"], c["valid"]))
        else:
            start.append(c["regs"])
            lanes.append((c["dst"], c["h1"], c["h2"], c["valid"]))
    plain, port, ref, pal = _fold_all_ways(start, [lanes])
    for i in range(3):
        if len(lanes[0][-1]):
            np.testing.assert_array_equal(pal[i], ref[i])
        np.testing.assert_array_equal(plain[i], ref[i])
        np.testing.assert_array_equal(port[i], ref[i])


def _refusal_folds(kind):
    h = torch.zeros(8, dtype=torch.int64)
    v = torch.ones(8, dtype=torch.bool)
    glob = (torch.zeros(64, dtype=torch.int32), h, h, v)
    grid = (torch.zeros((16, 8), dtype=torch.int32), h, h, h, v)
    return {"no_folds": (),
            "four_folds": (glob, grid, grid, grid),
            "unequal_n": (glob, (grid[0], h, h[:7], h, v)),
            "buckets_not_power_of_two": (
                glob, (torch.zeros((12, 8), dtype=torch.int32), h, h, h, v)),
            "registers_not_power_of_two": (
                (torch.zeros(48, dtype=torch.int32), h, h, v), grid),
            }[kind]


@pytest.mark.parametrize("kind", [
    "no_folds", "four_folds", "unequal_n", "buckets_not_power_of_two",
    "registers_not_power_of_two"])
def test_update_folds_refuses_what_the_card_cannot_fold(kind):
    """Refused before the device branch, so the CPU twin never folds what
    the card would refuse; the registers are untouched."""
    folds = _refusal_folds(kind)
    before = [f[0].clone() for f in folds]
    with pytest.raises(ValueError):
        thk.update_folds(folds)
    for f, b in zip(folds, before):
        assert torch.equal(f[0], b)
