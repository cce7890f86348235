"""Kernel 4's plain twin (netobserv_tpu_torch/ops/kernels/signal_kernel.py
`update_plain`, the CPU path of `update`) against the JAX package's
signal-plane scatter chain (the form `sketch/state.ingest` runs without the
kernel) and its Pallas `signal_kernel.update` in interpret mode, m=512.

Masses are integer-valued with per-cell sums below 2^24, the regime where
add order cannot matter: bit-exact. The production regime of the same fold
is held under its bound by tests/test_torch_state.py."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from netobserv_tpu.ops.pallas import signal_kernel as jsk
from netobserv_tpu_torch.ops.kernels import cases
from netobserv_tpu_torch.ops.kernels import signal_kernel as tsk

M = 512
SIGNAL_CASES = [name for name, _ in cases.signal_cases(M)]


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([
        rng.integers(0, M, b), rng.integers(0, M, b), rng.integers(0, M, b),
        rng.integers(0, 64, b), rng.integers(0, 128, b)]).astype(np.int32)
    # a hot bucket per family, as Zipf traffic makes
    idx[:3, rng.random(b) < 0.2] = 7
    vals = rng.integers(0, 9000, (8, b)).astype(np.float32)
    vals *= rng.random((8, b)) < 0.8
    return idx, vals


def _jax_planes():
    z = lambda n: jnp.zeros((n,), jnp.float32)  # noqa: E731
    return jsk.SignalPlanes(z(M), z(M), z(M), z(M), z(M), z(M),
                            z(cases.N_DSCP), z(cases.N_CAUSE))


def _scatter_chain(planes, idx, vals):
    out = []
    for row, table in enumerate(planes):
        out.append(table.at[idx[tsk.FAMILY[row]]].add(vals[row],
                                                      mode="drop"))
    return jsk.SignalPlanes(*out)


def test_plain_twin_bit_exact_vs_scatter_chain_and_pallas():
    tp = tsk.SignalPlanes(*(torch.zeros(p.shape[0]) for p in _jax_planes()))
    jp = _jax_planes()
    pp = _jax_planes()
    for seed in (1, 2, 3):
        idx, vals = _batch(1500, seed)  # ragged: the Pallas form pads
        tsk.update(tp, torch.from_numpy(idx.astype(np.int64)),
                   torch.from_numpy(vals))
        jp = _scatter_chain(jp, jnp.asarray(idx), jnp.asarray(vals))
        pp = jsk.update(pp, jnp.asarray(idx), jnp.asarray(vals),
                        interpret=True)
    for name, t, j, p in zip(tsk.SignalPlanes._fields, tp, jp, pp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(p), err_msg=name)
    assert float(tp.ddos_rate.max()) < 2**24


@pytest.mark.parametrize("name", SIGNAL_CASES)
def test_plain_twin_bit_exact_vs_jax_on_contract_cases(name):
    """The contract cases the CUDA kernel must get right (cases.py),
    through the wrapper's CPU path onto non-zero tables, against the JAX
    scatter chain and, for B > 0, the Pallas kernel in interpret mode (whose
    chunk walk cannot take an empty batch)."""
    c = dict(cases.signal_cases(M))[name]
    rng = np.random.default_rng(7)
    start = [rng.integers(0, 50, p.shape[0]).astype(np.float32)
             for p in _jax_planes()]
    tp = tsk.SignalPlanes(*(torch.from_numpy(a.copy()) for a in start))
    tsk.update(tp, torch.from_numpy(c["idx"]), torch.from_numpy(c["vals"]))
    jp = jsk.SignalPlanes(*(jnp.asarray(a) for a in start))
    idx, vals = jnp.asarray(c["idx"].astype(np.int32)), jnp.asarray(c["vals"])
    refs = [_scatter_chain(jp, idx, vals)]
    if c["vals"].shape[1]:
        refs.append(jsk.update(jp, idx, vals, interpret=True))
    for ref in refs:
        for field, t, r in zip(tsk.SignalPlanes._fields, tp, ref):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r),
                                          err_msg=f"{name}: {field}")
    assert max(float(t.max()) for t in tp) < 2**24
    if name == "every_row_one_dst_bucket":
        hot = M // 2 + 1
        assert float(tp.ddos_rate[hot] - start[0][hot]) == float(
            c["vals"][0].sum())
