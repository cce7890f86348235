"""Kernels 8 and 5 of the port on the CPU, where their wrappers run the plain
twins, against the JAX package.

- Kernel 8, the HLL grid fold (`ops/kernels/hll_kernel.update_per_dst`,
  reached through `ops/hll.update_per_dst`), against the reference's scatter
  form `hll.update_per_dst` and its Pallas `hll_kernel.update_per_dst` in
  interpret mode, on the schedule of `tests/test_pallas_kernels.py`'s grid
  test. Registers are integer maxima: bit-exact.
- Kernel 5, the single-plane Count-Min fold (`ops/kernels/countmin_kernel.
  update`, reached through `ops/countmin.update`), against the reference's
  `countmin.update` and its Pallas `countmin_kernel.update` in interpret
  mode, on the schedules of `tests/test_pallas_kernels.py`'s Count-Min
  tests, and on the seeded contract cases of `ops/kernels/cases.py` at
  widths TILE_W and 4,096 (`va` as the value row). The masses are integers
  whose per-cell sums stay below 2^24, so add order cannot change a bit:
  bit-exact."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from netobserv_tpu.ops import countmin as jcm
from netobserv_tpu.ops import hashing as jh
from netobserv_tpu.ops import hll as jhll
from netobserv_tpu.ops.pallas import countmin_kernel as jck
from netobserv_tpu.ops.pallas import hll_kernel as jhk
from netobserv_tpu_torch.ops import countmin as tcm
from netobserv_tpu_torch.ops import hll as thll
from netobserv_tpu_torch.ops.kernels import cases
from netobserv_tpu_torch.ops.kernels import countmin_kernel as tck
from netobserv_tpu_torch.ops.kernels import hll_kernel as thk

CPU = torch.device("cpu")
KW = 10


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n", [512, 777])
def test_grid_fold_bit_exact_vs_scatter_and_pallas(n):
    """Grid 32 x 16 (512 registers), B = 512 and a ragged 777, folded twice
    so the second fold meets live registers."""
    rng = np.random.default_rng(5)
    s_ref = jhll.init_per_dst(dst_buckets=32, precision=4)
    s_pal = s_ref
    port = thll.init_per_dst(32, 4, CPU)
    twin = torch.zeros((32, 16), dtype=torch.int32)
    for _ in range(2):
        dsts = jnp.asarray(rng.integers(0, 2**32, (n, 4), dtype=np.uint32))
        srcs = jnp.asarray(rng.integers(0, 2**32, (n, 4), dtype=np.uint32))
        valid = rng.random(n) < 0.9
        dh, _ = jh.base_hashes(dsts, seed=1)
        sh1, sh2 = jh.base_hashes(srcs)
        s_ref = jhll.update_per_dst(s_ref, dh, sh1, sh2, jnp.asarray(valid))
        s_pal = jhk.update_per_dst(s_pal, dh, sh1, sh2, jnp.asarray(valid),
                                   interpret=True)
        args = (_t(dh), _t(sh1), _t(sh2), torch.from_numpy(valid))
        thll.update_per_dst(port, *args)
        thk.update_per_dst_plain(twin, *args)
    want = np.asarray(s_ref.regs)
    assert want.any()
    np.testing.assert_array_equal(np.asarray(s_pal.regs), want)
    np.testing.assert_array_equal(port.regs.numpy(), want)
    np.testing.assert_array_equal(twin.numpy(), want)


def test_grid_fold_refuses_non_power_of_two_shapes():
    regs = torch.zeros((24, 16), dtype=torch.int32)
    h = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="powers of two"):
        thk.update_per_dst(regs, h, h, h, torch.ones(4, dtype=torch.bool))


def _cm_case(rng, b, vals=None, valid_share=1.0):
    words = jnp.asarray(rng.integers(0, 2**32, (b, KW), dtype=np.uint32))
    if vals is None:
        vals = rng.integers(1, 1000, b).astype(np.float32)
    valid = rng.random(b) < valid_share
    h1, h2 = jh.base_hashes(words)
    return h1, h2, vals, valid


def _fold_three_ways(depth, width, cases):
    ref = jcm.init(depth, width)
    pal = jcm.init(depth, width)
    port = tcm.init(depth, width, CPU)
    for h1, h2, vals, valid in cases:
        ref = jcm.update(ref, h1, h2, jnp.asarray(vals), jnp.asarray(valid))
        pal = jck.update(pal, h1, h2, jnp.asarray(vals), jnp.asarray(valid),
                         interpret=True)
        got = tcm.update(port, _t(h1), _t(h2), torch.from_numpy(vals),
                         torch.from_numpy(valid))
        assert got is port  # in place
    want = np.asarray(ref.counts)
    assert want.max() < 2**24 and want.any()
    np.testing.assert_array_equal(np.asarray(pal.counts), want)
    np.testing.assert_array_equal(port.counts.numpy(), want)
    return port


@pytest.mark.parametrize("schedule", ["valid_0.9", "ragged", "accumulate"])
def test_single_plane_fold_bit_exact_vs_scatter_and_pallas(schedule):
    """3 x 2048 at B = 2048 with 90 % valid rows; 2 x 1024 at a ragged
    B = 777; 2 x 1024 over three accumulating calls of unit masses."""
    rng = np.random.default_rng(11)
    if schedule == "valid_0.9":
        _fold_three_ways(3, 1 << 11, [_cm_case(rng, 2048, valid_share=0.9)])
    elif schedule == "ragged":
        _fold_three_ways(2, 1 << 10, [_cm_case(
            rng, 777, vals=rng.integers(1, 10, 777).astype(np.float32))])
    else:
        case = _cm_case(rng, 1024, vals=np.ones(1024, np.float32))
        port = _fold_three_ways(2, 1 << 10, [case] * 3)
        est = tcm.query(port, _t(case[0]), _t(case[1]))
        assert float(est.min()) >= 3.0


def test_single_plane_twin_equals_one_plane_of_the_dual_fold():
    """Kernel 5's twin is kernel 1's with one value row."""
    rng = np.random.default_rng(12)
    h1, h2, vals, _ = _cm_case(rng, 999)
    v = torch.from_numpy(vals)
    one = torch.zeros((4, 512))
    a, b = torch.zeros((4, 512)), torch.zeros((4, 512))
    tck.update(one, _t(h1), _t(h2), v)
    tck.update_two_plain(a, b, _t(h1), _t(h2), v, 2 * v)
    np.testing.assert_array_equal(one.numpy(), a.numpy())
    np.testing.assert_array_equal(2 * one.numpy(), b.numpy())


CASE_NAMES = [name for name, _ in cases.countmin_cases(tck.TILE_W)]


@pytest.mark.parametrize("w", [tck.TILE_W, 4096])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_single_plane_twin_bit_exact_vs_jax_on_contract_cases(name, w):
    """Kernel 5's plain twin (the wrapper on CPU tensors), `va` as its one
    value row, onto a table of small integers, against the JAX scatter
    form and, for B > 0, the Pallas kernel in interpret mode (whose chunk
    walk cannot take an empty batch): the contract cases `chip_smoke.py`
    holds the kernel to on the card."""
    c = dict(cases.countmin_cases(w))[name]
    d = 4
    init = np.random.default_rng(6).integers(0, 50, (d, w)).astype(
        np.float32)
    port = torch.from_numpy(init.copy())
    tck.update(port, *(torch.from_numpy(c[f]) for f in ("h1", "h2", "va")))
    h1, h2 = (jnp.asarray(c[f].astype(np.uint32)) for f in ("h1", "h2"))
    jargs = (jcm.CountMin(jnp.asarray(init)), h1, h2, jnp.asarray(c["va"]),
             jnp.ones(len(c["va"]), bool))
    refs = [jcm.update(*jargs)]
    if len(c["va"]):
        refs.append(jck.update(*jargs, interpret=True))
    assert float(refs[0].counts.max()) < 2 ** 24
    for ref in refs:
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref.counts))
    if name == "every_row_one_key":
        cols = (c["h1"][0] + np.arange(d)) % w
        np.testing.assert_array_equal(
            port.numpy()[np.arange(d), cols] - init[np.arange(d), cols],
            np.full(d, c["va"].sum()))
