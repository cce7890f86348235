"""Kernel 2's plain twin (netobserv_tpu_torch/ops/kernels/topk_kernel.py
`reduce_plain`, the CPU path of `reduce`) and the slot-table maintenance
around it, against the JAX package's `topk._slot_reduce_scatter`, its
Pallas `topk_kernel.reduce` in interpret mode, and `topk.slot_update`.

The reductions are maxima of f32 values and a minimum of row ids, exact in
any order, so every comparison is bit-exact; the slot-update stream uses
integer byte counts whose Count-Min cells stay below 2^24 (bit-exact
regime)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.ops import countmin as jcm
from netobserv_tpu.ops import hashing as jh
from netobserv_tpu.ops import topk as jtopk
from netobserv_tpu.ops.pallas import topk_kernel as jtk
from netobserv_tpu_torch.ops import countmin as tcm
from netobserv_tpu_torch.ops import hashing as th
from netobserv_tpu_torch.ops import topk as ttopk
from netobserv_tpu_torch.ops.kernels import cases
from netobserv_tpu_torch.ops.kernels import topk_kernel as ttk

K = 128
TOPK_CASES = [name for name, _ in cases.topk_cases(K)]
CPU = torch.device("cpu")


def _adversarial_rows(n, seed=5):
    rng = np.random.default_rng(seed)
    mslot = rng.integers(0, K + 1, n).astype(np.int32)
    target = rng.integers(0, K + 1, n).astype(np.int32)
    est = rng.integers(0, 500, n).astype(np.float32)
    est[rng.random(n) < 0.2] = -1.0     # dead rows
    est[rng.random(n) < 0.05] = -3.0    # below the -1 floor
    # exact ties on slot 7: the lowest row must win
    target[target == 7] = 8
    target[[10, 40, 90]] = 7
    est[[10, 40, 90]] = 333.0
    # a slot whose only challengers are dead rows elects no winner
    target[target == 9] = 8
    target[[20, 21]] = 9
    est[[20, 21]] = -1.0
    return mslot, target, est


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_reductions_bit_exact_vs_scatter_and_pallas_on_adversarial_rows():
    n = jtk.CHUNK_B + 37  # ragged: the Pallas form pads
    mslot, target, est = _adversarial_rows(n)
    got = ttopk._slot_reduce_scatter(_t(mslot), _t(target),
                                     torch.from_numpy(est), K)
    scatter = jtopk._slot_reduce_scatter(jnp.asarray(mslot),
                                         jnp.asarray(target),
                                         jnp.asarray(est), K)
    pallas = jtk.reduce(jnp.asarray(mslot), jnp.asarray(target),
                        jnp.asarray(est), K, interpret=True)
    for name, g, s, p in zip(("match_max", "chall_max", "win_row"), got,
                             scatter, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(s), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p), err_msg=name)
    assert int(got[2][7]) == 10
    assert int(got[2][9]) == ttk.NO_WINNER and float(got[1][9]) == -1.0
    assert got[2].dtype == torch.int32 and got[0].dtype == torch.float32


@pytest.mark.parametrize("k", [128, 1024])
@pytest.mark.parametrize("name", TOPK_CASES)
def test_reductions_bit_exact_vs_jax_on_contract_cases(name, k):
    """The contract cases the cluster kernel must get right (cases.py),
    through the wrapper's CPU path, against the JAX scatter form and, for
    B > 0, the Pallas kernel in interpret mode (whose chunk walk cannot
    take an empty batch)."""
    c = dict(cases.topk_cases(k))[name]
    got = ttk.reduce(torch.from_numpy(c["mslot"]),
                     torch.from_numpy(c["target"]),
                     torch.from_numpy(c["est"]), k)
    args = (jnp.asarray(c["mslot"].astype(np.int32)),
            jnp.asarray(c["target"].astype(np.int32)),
            jnp.asarray(c["est"]))
    refs = [jtopk._slot_reduce_scatter(*args, k)]
    if c["est"].shape[0]:
        refs.append(jtk.reduce(*args, k, interpret=True))
    for ref in refs:
        for field, g, r in zip(("match_max", "chall_max", "win_row"), got,
                               ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"{name}: {field}")
    if name == "empty":
        assert (got[0] == -1).all() and (got[1] == -1).all()
        assert (got[2] == ttk.NO_WINNER).all()
    if name == "equal_est_far_apart":
        assert int(got[2][1]) == ttk.THREADS + 2 and int(got[2][2]) == 10
    if name == "est_at_or_below_minus_one":
        assert float(got[0][0]) == -1.0 and float(got[1][0]) == -1.0
        assert int(got[2][0]) == ttk.NO_WINNER


_jax_slot_update = jax.jit(
    lambda t, cm, w, h1, h2, v, win: jtopk.slot_update(
        t, cm, w, h1, h2, v, window=win, use_pallas=False))


def test_slot_update_stream_every_field_bit_exact():
    """Four ragged batches under capacity pressure (1000 keys, K=128), with
    a reset roll after the second: every SlotTable field and the eviction
    count equal the JAX scatter form's."""
    rng = np.random.default_rng(12)
    universe = rng.integers(0, 2**32, (1000, 10), dtype=np.uint32)
    jcms = jcm.init(4, 1 << 12)
    tcms = tcm.init(4, 1 << 12, CPU)
    tcmp = tcm.init(4, 1 << 12, CPU)
    jt = jtopk.init_slots(K, 10)
    tt = ttopk.init_slots(K, 10, CPU)
    for it in range(4):
        n = 1500
        words = universe[np.minimum(rng.zipf(1.3, n) - 1, 999)]
        vals = rng.integers(64, 9000, n).astype(np.float32)
        valid = rng.random(n) < 0.9
        j1, j2 = jh.base_hashes(jnp.asarray(words))
        jcms = jcm.update(jcms, j1, j2, jnp.asarray(vals), jnp.asarray(valid))
        jt, jev = _jax_slot_update(jt, jcms, jnp.asarray(words), j1, j2,
                                   jnp.asarray(valid), it)
        tw = _t(words)
        t1, t2 = th.base_hashes(tw)
        tcm.update_two(tcms, tcmp, t1, t2, torch.from_numpy(vals),
                       torch.ones(n), torch.from_numpy(valid))
        tt, tev = ttopk.slot_update(tt, tcms, tw, t1, t2,
                                    torch.from_numpy(valid),
                                    window=torch.tensor(it,
                                                        dtype=torch.int32))
        for name in jtopk.SlotTable._fields:
            g = getattr(tt, name).numpy()
            if name in ("words", "h1", "h2"):
                g = g.astype(np.uint32)
            np.testing.assert_array_equal(
                g, np.asarray(getattr(jt, name)), err_msg=f"{name} @ {it}")
        assert float(tev) == float(jev)
        if it == 1:
            jt = jtopk.slot_roll(jt, 0.0)
            ttopk.slot_roll(tt, 0.0)
    assert int(tt.valid.sum()) > K // 2
