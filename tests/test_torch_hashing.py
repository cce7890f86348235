"""The port's hashing (netobserv_tpu_torch/ops/hashing.py) against the JAX
package's: every hash family, the Count-Min row indices and the slot
candidates, bit-exact on 4096 keys that include the all-zero and
all-ones words (integer arithmetic: no float regime applies)."""

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
import jax.numpy as jnp

from netobserv_tpu.model import columnar as jcol
from netobserv_tpu.ops import hashing as jh
from netobserv_tpu.ops import topk as jtopk
from netobserv_tpu_torch.model import columnar as tcol
from netobserv_tpu_torch.ops import hashing as th
from netobserv_tpu_torch.ops import topk as ttopk


def _keys(n=4096, seed=3):
    w = np.random.default_rng(seed).integers(0, 2**32, (n, 10),
                                             dtype=np.uint32)
    w[0] = 0
    w[1] = 0xFFFFFFFF
    w[2, ::2] = 0xFFFFFFFF
    return w


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_base_hashes_multi_bit_exact():
    w = _keys()
    want = jh.base_hashes_multi(jnp.asarray(w))
    got = th.base_hashes_multi(_t(w))
    for name in jh.MultiHashes._fields:
        np.testing.assert_array_equal(_u32(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_hash_words_base_hashes_and_fmix_bit_exact():
    w = _keys(seed=4)
    for seed in (0, jh.DST_BUCKET_SEED, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            _u32(th.hash_words(_t(w), seed)),
            np.asarray(jh.hash_words(jnp.asarray(w), jnp.uint32(seed))))
    for a, b in zip(th.base_hashes(_t(w), 7), jh.base_hashes(jnp.asarray(w),
                                                             7)):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))
    edge = np.array([0, 1, 2**31, 2**32 - 1, 0x9747B28C], np.uint32)
    np.testing.assert_array_equal(_u32(th.fmix32(_t(edge))),
                                  np.asarray(jh.fmix32(jnp.asarray(edge))))
    np.testing.assert_array_equal(th.hash_words_np(w[:, 4:8], 5),
                                  jh.hash_words_np(w[:, 4:8], 5))


def test_row_indices_and_slot_candidates_bit_exact():
    w = _keys(seed=5)
    h1, h2 = jh.base_hashes(jnp.asarray(w))
    t1, t2 = _t(h1), _t(h2)
    for d, width in ((4, 2048), (4, 1 << 16), (3, 1 << 11)):
        np.testing.assert_array_equal(
            th.row_indices(t1, t2, d, width).numpy(),
            np.asarray(jh.row_indices(h1, h2, d, width)))
    for k in (128, 1024):
        np.testing.assert_array_equal(
            ttopk.slot_candidates(t1, t2, k).numpy(),
            np.asarray(jtopk.slot_candidates(h1, h2, k)))


def test_key_word_layout_matches():
    """The key-word layout copy: unpack and pack agree with the JAX
    package's field by field and round-trip the words."""
    w = _keys(n=64, seed=6)
    w[:, 9] &= 0x00FFFFFF  # the proto word carries 24 bits
    got, want = tcol.unpack_key_words(w), jcol.unpack_key_words(w)
    assert got.dtype.names == want.dtype.names
    for name in want.dtype.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(tcol.pack_key_words(got), w)
    np.testing.assert_array_equal(tcol.pack_key_words(want),
                                  jcol.pack_key_words(want))
