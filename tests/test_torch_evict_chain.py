"""The port's drain chain (netobserv_tpu_torch/datapath/flowpack.py
merges and event compose, datapath/loader.py) against the JAX package's,
on the CPU.

- `merge_percpu_batch` of all seven kinds, one thread and three (the row
  split engages past 4,096 keys), with and without `out=`, equals the
  reference's native batch merge and the port's plain twin
  (`model/accumulate.COLUMNAR_MERGES`) byte for byte, on seeded random
  partials (the reference suite's `_rand_partials`); `merge_percpu` of
  one key equals the reference's.
- `events_from_keys_stats` equals the reference's and the plain twin,
  its zeroed tail included, and refuses what the reference refuses.
- `_hash_keys_u64` and `_join_keys` equal the reference's, on random keys
  and on an engineered 64-bit collision that takes the lexicographic path
  on both sides.
- `decode_eviction` with orphans, duplicate aggregation keys, empty maps
  and an orphan-only drain equals the reference's, every output array
  byte for byte, and `_drain_map_arrays` over a duck-typed map (batched,
  kernel-padded, per key) the reference's.
- `resolve_drain_lanes` over the reference's cases
  (`tests/test_evict_parallel.py:233-257`).

The reference's native library is built here with g++ by its own
`flowpack.build_native`, the port's by `ops/kernels/_build.build_host`.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu.datapath import loader as jloader
from netobserv_tpu.model import binfmt as jbin
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.datapath import loader as tloader
from netobserv_tpu_torch.model import accumulate as tacc
from netobserv_tpu_torch.model import binfmt as tbin
from tests.test_evict_columnar import KINDS, _keys_u8, _rand_partials

#: the EvictedFlows arrays a decode fills
ARRAYS = ("events", "extra", "dns", "drops", "nevents", "xlat", "quic")


@pytest.fixture(scope="module", autouse=True)
def libraries():
    if not jfp.build_native():
        pytest.skip("no g++ to build the reference's libflowpack")
    assert jfp.native_available()
    return tfp.native_lib()


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_merge_percpu_batch_equals_the_reference_and_the_plain_twin(
        kind, threads):
    rng = np.random.default_rng(KINDS.index(kind) * 10 + threads)
    n_keys = 4100 if threads > 1 else 300
    vals = _rand_partials(kind, n_keys, 5, rng)
    want = jfp.merge_percpu_batch(kind, vals, use_native=True,
                                  threads=threads)
    got = tfp.merge_percpu_batch(kind, vals, threads=threads)
    assert got.dtype == tfp.PIPE_DTYPES[kind] == want.dtype
    assert got.tobytes() == want.tobytes()
    assert tacc.COLUMNAR_MERGES[kind](vals).tobytes() == got.tobytes()
    out = np.zeros(n_keys, tfp.PIPE_DTYPES[kind])
    assert tfp.merge_percpu_batch(kind, vals, out=out,
                                  threads=threads) is out
    assert out.tobytes() == want.tobytes()
    one = tfp.merge_percpu(kind, vals[7])
    assert one.tobytes() == jfp.merge_percpu(kind, vals[7],
                                             use_native=True).tobytes()
    assert one.tobytes() == got[7].tobytes()


def test_merge_percpu_batch_refusals_and_empty():
    vals = np.zeros((4, 2), tbin.EXTRA_REC_DTYPE)
    with pytest.raises(ValueError, match="n_keys, n_cpus"):
        tfp.merge_percpu_batch("extra", vals[:, 0])
    for bad in (np.zeros(3, tbin.EXTRA_REC_DTYPE),
                np.zeros(4, tbin.DNS_REC_DTYPE)):
        with pytest.raises(ValueError, match="out must be"):
            tfp.merge_percpu_batch("extra", vals, out=bad)
    empty = tfp.merge_percpu_batch("dns", np.zeros((0, 3),
                                                   tbin.DNS_REC_DTYPE))
    assert empty.dtype == tbin.DNS_REC_DTYPE and len(empty) == 0


def test_events_from_keys_stats_equals_the_reference():
    rng = np.random.default_rng(3)
    keys = _keys_u8(50, rng)
    stats = _rand_partials("stats", 50, 1, rng)[:, 0]
    for n_total in (None, 50, 57):
        got = tfp.events_from_keys_stats(keys, stats, n_total=n_total)
        want = jfp.events_from_keys_stats(keys, stats, n_total=n_total,
                                          use_native=True)
        assert got.dtype == tbin.FLOW_EVENT_DTYPE
        assert got.tobytes() == want.tobytes()
        twin = tbin.events_from_keys_stats(
            keys.view(tbin.FLOW_KEY_DTYPE).reshape(-1), stats,
            n_total=n_total)
        assert twin.tobytes() == got.tobytes()
    structured = keys.view(tbin.FLOW_KEY_DTYPE).reshape(-1)
    assert tfp.events_from_keys_stats(structured, stats).tobytes() == \
        got[:50].tobytes()
    assert len(tfp.events_from_keys_stats(
        np.empty((0, 40), np.uint8), stats[:0], n_total=3)) == 3
    with pytest.raises(ValueError, match="mismatch"):
        tfp.events_from_keys_stats(keys, stats[:-1])
    with pytest.raises(ValueError, match="n_total"):
        tfp.events_from_keys_stats(keys, stats, n_total=49)


def colliding_keys(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two distinct 40-byte keys with one `_hash_keys_u64`: the hash's
    rounds are invertible (odd multipliers mod 2^64 and an xorshift), so
    the last word of the second solves in closed form (the reference's
    `tests/test_native_pipeline.py:144-185`)."""
    mask, c, m = (1 << 64) - 1, 0xC2B2AE3D27D4EB4F, 0x9E3779B97F4A7C15
    c_inv, m_inv = pow(c, -1, 1 << 64), pow(m, -1, 1 << 64)

    def rounds(words, upto):
        h = words[0]
        for i in range(1, upto):
            h = ((h ^ (words[i] * c & mask)) * m) & mask
            h ^= h >> 29
        return h

    def unshift29(y):
        x = y
        for _ in range(3):
            x = y ^ (x >> 29)
        return x

    rng = np.random.default_rng(seed)
    a = [int(x) for x in rng.integers(0, 1 << 63, size=5)]
    prefix = [int(x) for x in rng.integers(0, 1 << 63, size=4)]
    h = rounds(prefix, 4)
    w4 = ((((unshift29(rounds(a, 5)) * m_inv) & mask) ^ h) * c_inv) & mask
    b = prefix + [w4]
    assert rounds(a, 5) == rounds(b, 5) and a != b
    return tuple(np.frombuffer(np.array(x, "<u8").tobytes(), np.uint8)
                 for x in (a, b))


def test_hash_and_join_equal_the_reference_with_and_without_a_collision():
    rng = np.random.default_rng(5)
    key_a, key_b = colliding_keys(11)
    filler = _keys_u8(40, rng)
    assert tloader._hash_keys_u64(filler).tobytes() == \
        jloader._hash_keys_u64(filler).tobytes()
    pair = np.stack([key_a, key_b])
    hs = tloader._hash_keys_u64(pair)
    assert hs[0] == hs[1] == jloader._hash_keys_u64(pair)[0]
    for agg, blocks in (
            (filler[:30], [filler[10:35], filler[25:]]),
            (np.vstack([pair, filler[:20]]),
             [np.vstack([key_b[None], key_a[None], filler[15:25]]),
              filler[18:40]])):
        got = tloader._join_keys(agg, blocks)
        want = jloader._join_keys(agg, blocks)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[2].tobytes() == want[2].tobytes()
        # the feature rows of both colliding keys land on their own rows
        if len(agg) > 30:
            assert got[0][0][:2].tolist() == [1, 0]


def _assert_same_eviction(got, want):
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    assert got.decode_stats["fallback_rows"] == \
        want.decode_stats["fallback_rows"]


def _drains(seed: int) -> list:
    """(agg keys, agg vals, drained) cases: orphans shared by two
    features, duplicate agg keys, an empty feature map, an empty drain,
    an orphan-only drain and a colliding pair."""
    rng = np.random.default_rng(seed)
    keys = _keys_u8(90, rng)
    orphans = _keys_u8(6, rng, port_base=50_000)
    agg = np.vstack([keys[:60], keys[3:5]])  # rows 3, 4 twice
    stats = _rand_partials("stats", len(agg), 1, rng)
    sel = rng.permutation(60)[:45]
    drained = {
        "extra": (np.vstack([keys[sel], orphans]),
                  _rand_partials("extra", 51, 4, rng)),
        "dns": (np.vstack([orphans[:2], keys[:10]]),
                _rand_partials("dns", 12, 4, rng)),
        "drops": (np.empty((0, 40), np.uint8),
                  np.empty((0, 4), tbin.DROPS_REC_DTYPE)),
        "nevents": (keys[50:70], _rand_partials("nevents", 20, 2, rng)),
        "xlat": (keys[5:9], _rand_partials("xlat", 4, 3, rng)),
        "quic": (np.vstack([keys[:3], keys[:3]]),
                 _rand_partials("quic", 6, 2, rng)),
    }
    key_a, key_b = colliding_keys(seed)
    pair = np.stack([key_a, key_b])
    return [
        (agg, stats, drained),
        (np.empty((0, 40), np.uint8),
         np.empty((0, 1), tbin.FLOW_STATS_DTYPE), {}),
        (keys[:4], stats[:4], {"dns": (np.empty((0, 40), np.uint8),
                                       np.empty((0, 2),
                                                tbin.DNS_REC_DTYPE))}),
        (np.empty((0, 40), np.uint8),
         np.empty((0, 1), tbin.FLOW_STATS_DTYPE),
         {"extra": (orphans, _rand_partials("extra", 6, 2, rng))}),
        (np.vstack([pair, keys[:8]]), stats[:10],
         {"extra": (np.vstack([pair[::-1], orphans[:2]]),
                    _rand_partials("extra", 4, 3, rng))}),
    ]


@pytest.mark.parametrize("threads", [1, 3])
def test_decode_eviction_equals_the_reference(threads):
    for i, (agg, stats, drained) in enumerate(_drains(21)):
        got = tloader.decode_eviction(agg, stats, drained,
                                      merge_threads=threads)
        want = jloader.decode_eviction(agg, stats, drained,
                                       merge_threads=threads)
        _assert_same_eviction(got, want)
        assert got.decode_stats.keys() == want.decode_stats.keys()
        # the merged form skips the merges and decodes the same
        merged = {a: tfp.merge_percpu_batch(a, v)
                  for a, (_k, v) in drained.items()}
        again = tloader.decode_eviction(
            agg, stats, {a: (k, None) for a, (k, _v) in drained.items()},
            merged=merged)
        _assert_same_eviction(again, want)
        if i == 0:
            # the six orphan keys and the nevents rows of keys 60-69
            assert got.decode_stats["fallback_rows"] == 16
            assert got.drops is None


class _Map:
    """A duck-typed map (`drain_batched_arrays`, `drain`, `n_cpus`,
    `key_size`, `_pad_vs`) over fixed rows."""

    def __init__(self, keys, vals, pad=None, batched=True):
        self.key_size, self.n_cpus = 40, vals.shape[1]
        item = vals.dtype.itemsize
        self._pad_vs = pad or item
        raw = np.zeros((len(keys), self.n_cpus, self._pad_vs), np.uint8)
        raw[:, :, :item] = vals.view(np.uint8).reshape(
            len(keys), self.n_cpus, item)
        self._keys, self._raw, self._batched = keys, raw, batched

    def drain_batched_arrays(self):
        if not self._batched:
            return None
        return self._keys, self._raw.reshape(len(self._keys), -1)

    def drain(self):
        return [(k.tobytes(), r.tobytes())
                for k, r in zip(self._keys, self._raw)]


@pytest.mark.parametrize("pad,batched", [(None, True), (40, True),
                                         (None, False)],
                         ids=["batched", "padded", "per-key"])
def test_drain_map_arrays_equals_the_reference(pad, batched):
    rng = np.random.default_rng(8)
    keys = _keys_u8(12, rng)
    vals = _rand_partials("extra", 12, 3, rng)
    bmap = _Map(keys, vals, pad, batched)
    got = tloader._drain_map_arrays(bmap, tbin.EXTRA_REC_DTYPE)
    want = jloader._drain_map_arrays(bmap, jbin.EXTRA_REC_DTYPE)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.tobytes() == w.tobytes()
    assert got[1].tobytes() == vals.tobytes()


def test_resolve_drain_lanes_equals_the_reference(monkeypatch):
    cases = [(1, 6), (0, 0), (4, 0), (4, 6), (8, 3), (32, 6), (0, 6)]
    for cpus in (1, 2, 16):
        monkeypatch.setattr(os, "cpu_count", lambda c=cpus: c)
        for req, maps in cases:
            assert tloader.resolve_drain_lanes(req, maps) == \
                jloader.resolve_drain_lanes(req, maps), (cpus, req, maps)
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    assert tloader.resolve_drain_lanes(0, 6) == 2
    assert tloader.resolve_drain_lanes(32, 6) == tloader._MAX_DRAIN_LANES
