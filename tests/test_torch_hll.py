"""Kernel 3's plain twin (netobserv_tpu_torch/ops/hll.update, the CPU path
of ops/kernels/hll_kernel.py) and the HLL module around it, against the JAX
package's `hll` and its Pallas `hll_kernel.update` in interpret mode.

Registers are integer maxima: bit-exact. `estimate` sums 2^-reg over m f32
terms, whose add order may differ between the two packages: held to a
relative m * 2^-24 (observed: about one ulp)."""

import numpy as np
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.ops import hashing as jh
from netobserv_tpu.ops import hll as jhll
from netobserv_tpu.ops.pallas import hll_kernel as jhk
from netobserv_tpu_torch.ops import hll as thll

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
