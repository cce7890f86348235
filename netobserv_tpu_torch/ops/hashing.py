"""Vectorized flow-key hashing with uint32 lanes carried in int64.

Counterpart of `netobserv_tpu/ops/hashing.py` (`fmix32`, `hash_words`,
`base_hashes`, `base_hashes_multi`, `row_indices`, `hash_words_np`,
`base_hashes_multi_np` (`:164-197`), `tenant_of` and `tenant_of_np`
(`:231-246`) and the seed constants, `TENANT_SEED` among them
(`:79-84`)). Murmur3-style
mixing over the KEY_WORDS uint32 words of each flow key;
Kirsch–Mitzenmacher double hashing derives the Count-Min rows.

torch lacks ``<<``, ``>>``, ``+`` and ``%`` on ``torch.uint32``, so every
uint32 lane here is an ``int64`` tensor holding a value in ``[0, 2**32)``.
A 32x32-bit product can reach 2**64 and overflow int64, so `_mul32` splits
the constant into 16-bit halves: each partial product stays below 2**49 and
the low 32 bits come out exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 5
_N1 = 0xE6546B64
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35

#: seed of the victim/destination bucket family (per-dst HLL grid, every
#: EWMA victim bucket, the conversation pair hash, host-side victim naming)
DST_BUCKET_SEED = 0x0D57
#: seed of the source-hash family (global/per-src HLL)
SRC_BUCKET_SEED = 0x0517
#: seed of the (dst addr, dst port) fan-out family
DSTPORT_FANOUT_SEED = 0x5CA7
#: seed of the tenant-owner family (tenant planes): the host router assigns
#: every evicted flow to a tenant by this hash of the full flow key, so a
#: flow's tenant is stable across windows and agents; `tenant_of` and
#: `tenant_of_np` both derive from it
TENANT_SEED = 0x7E4A
_H1_SEED = 0x9747B28C
_H2_SEED = 0x5BD1E995


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for x in [0, 2**32) and a constant c < 2**32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer: full avalanche on a uint32 lane."""
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def _k_mix(w: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl32(_mul32(w, _C1), 15), _C2)


def _absorb(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return (_rotl32(h ^ k, 13) * _M5 + _N1) & M32


def _lanes(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & M32


def hash_words(words: torch.Tensor, seed: int) -> torch.Tensor:
    """Hash packed key words [..., W] -> uint32 lane [...] (int64)."""
    words = _lanes(words)
    w = words.shape[-1]
    h = torch.full(words.shape[:-1], seed & M32, dtype=torch.int64,
                   device=words.device)
    for i in range(w):
        h = _absorb(h, _k_mix(words[..., i]))
    return fmix32(h ^ (w * 4))


def base_hashes(words: torch.Tensor, seed: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent base hashes (h2 forced odd)."""
    h1 = hash_words(words, _H1_SEED ^ seed)
    h2 = hash_words(words, _H2_SEED ^ seed)
    return h1, h2 | 1


class MultiHashes(NamedTuple):
    """Every hash family the sketch ingest consumes, from one sweep."""

    h1: torch.Tensor       #: flow family h1 (all KEY_WORDS, seed 0)
    h2: torch.Tensor       #: flow family h2 (odd)
    src_h1: torch.Tensor   #: SRC_BUCKET_SEED over the src words (0:4)
    src_h2: torch.Tensor   #: ... h2 (odd)
    dst_h1: torch.Tensor   #: DST_BUCKET_SEED over the dst words (4:8)
    dp_h1: torch.Tensor    #: DSTPORT_FANOUT_SEED over dst words + dst port
    dp_h2: torch.Tensor    #: ... h2 (odd)
    src_sym: torch.Tensor  #: DST_BUCKET_SEED over the src words


_FLOW_IDXS = tuple(range(10))
_SRC_IDXS = (0, 1, 2, 3)
_DST_IDXS = (4, 5, 6, 7)
_DP_IDXS = (4, 5, 6, 7, 10)  # index 10: the dst-port column (word 8 low half)


def base_hashes_multi(words: torch.Tensor) -> MultiHashes:
    """All hash families in one pass over the key words: the per-word k-mix
    is seed-independent, so it runs once per word and every family shares
    it. Bit-identical to separate `base_hashes` calls."""
    words = _lanes(words)
    if words.shape[-1] != 10:
        raise ValueError("base_hashes_multi expects KEY_WORDS=10")
    ks = [_k_mix(words[..., i]) for i in range(10)]
    ks.append(_k_mix(words[..., 8] & 0xFFFF))

    def run(seed: int, idxs: tuple[int, ...]) -> torch.Tensor:
        h = torch.full(words.shape[:-1], seed, dtype=torch.int64,
                       device=words.device)
        for i in idxs:
            h = _absorb(h, ks[i])
        return fmix32(h ^ (len(idxs) * 4))

    return MultiHashes(
        h1=run(_H1_SEED, _FLOW_IDXS),
        h2=run(_H2_SEED, _FLOW_IDXS) | 1,
        src_h1=run(_H1_SEED ^ SRC_BUCKET_SEED, _SRC_IDXS),
        src_h2=run(_H2_SEED ^ SRC_BUCKET_SEED, _SRC_IDXS) | 1,
        dst_h1=run(_H1_SEED ^ DST_BUCKET_SEED, _DST_IDXS),
        dp_h1=run(_H1_SEED ^ DSTPORT_FANOUT_SEED, _DP_IDXS),
        dp_h2=run(_H2_SEED ^ DSTPORT_FANOUT_SEED, _DP_IDXS) | 1,
        src_sym=run(_H1_SEED ^ DST_BUCKET_SEED, _SRC_IDXS),
    )


def row_indices(h1: torch.Tensor, h2: torch.Tensor, depth: int,
                width: int) -> torch.Tensor:
    """Kirsch–Mitzenmacher: row i's column is (h1 + i*h2) mod width, for a
    power-of-two width. Returns int64[depth, ...]."""
    if width & (width - 1):
        raise ValueError("width must be a power of two")
    rows = torch.arange(depth, dtype=torch.int64, device=h1.device).reshape(
        (depth,) + (1,) * h1.ndim)
    return (h1[None] + rows * h2[None]) & (width - 1)


def hash_words_np(words: np.ndarray, seed: int = 0) -> np.ndarray:
    """Numpy twin of `hash_words` under `base_hashes`' h1 seeding, for
    host-side bucket lookups that must not launch device work."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    nwords = w.shape[-1]
    c1, c2, m5, n1 = (np.uint32(c) for c in (_C1, _C2, _M5, _N1))
    f1, f2 = np.uint32(_F1), np.uint32(_F2)
    with np.errstate(over="ignore"):
        h = np.full(w.shape[:-1], np.uint32(_H1_SEED) ^ np.uint32(seed),
                    np.uint32)
        for i in range(nwords):
            k = w[..., i] * c1
            k = ((k << np.uint32(15)) | (k >> np.uint32(17))) * c2
            h = h ^ k
            h = ((h << np.uint32(13)) | (h >> np.uint32(19))) * m5 + n1
        h = h ^ np.uint32(nwords * 4)
        h = h ^ (h >> np.uint32(16))
        h = h * f1
        h = h ^ (h >> np.uint32(13))
        h = h * f2
        h = h ^ (h >> np.uint32(16))
    return h


def tenant_of(words: torch.Tensor, n_tenants: int) -> torch.Tensor:
    """Tenant owner of each flow key: int32[...] in [0, n_tenants).

    The full key words hashed under TENANT_SEED (h1 family), mod the tenant
    count, decorrelated from every sketch family. `n_tenants` need not be a
    power of two; the `%` is taken on the int64 lane (`torch.uint32` has
    none)."""
    h = hash_words(words, _H1_SEED ^ TENANT_SEED)
    return (h % n_tenants).to(torch.int32)


def tenant_of_np(words: np.ndarray, n_tenants: int) -> np.ndarray:
    """Numpy twin of `tenant_of`: the host router (`sketch/tenancy.py`)
    assigns evicted rows with it."""
    h = hash_words_np(words, TENANT_SEED)
    return (h % np.uint32(n_tenants)).astype(np.int32)


def base_hashes_multi_np(words: np.ndarray) -> dict[str, np.ndarray]:
    """Numpy twin of `base_hashes_multi` (the same field names, as a dict of
    uint32 arrays), for host-side point queries that must not launch
    device work (`query/core.frequency_payload`)."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    if w.shape[-1] != 10:
        raise ValueError("base_hashes_multi_np expects KEY_WORDS=10")
    c1, c2, m5, n1 = (np.uint32(c) for c in (_C1, _C2, _M5, _N1))
    f1, f2 = np.uint32(_F1), np.uint32(_F2)
    with np.errstate(over="ignore"):
        def k_mix(col):
            k = col * c1
            return ((k << np.uint32(15)) | (k >> np.uint32(17))) * c2

        ks = [k_mix(w[..., i]) for i in range(10)]
        ks.append(k_mix(w[..., 8] & np.uint32(0xFFFF)))

        def run(seed: int, idxs: tuple[int, ...]) -> np.ndarray:
            h = np.full(w.shape[:-1], np.uint32(seed), np.uint32)
            for i in idxs:
                h = h ^ ks[i]
                h = ((h << np.uint32(13)) | (h >> np.uint32(19))) * m5 + n1
            h = h ^ np.uint32(len(idxs) * 4)
            h = h ^ (h >> np.uint32(16))
            h = h * f1
            h = h ^ (h >> np.uint32(13))
            h = h * f2
            return h ^ (h >> np.uint32(16))

        one = np.uint32(1)
        return {
            "h1": run(_H1_SEED, _FLOW_IDXS),
            "h2": run(_H2_SEED, _FLOW_IDXS) | one,
            "src_h1": run(_H1_SEED ^ SRC_BUCKET_SEED, _SRC_IDXS),
            "src_h2": run(_H2_SEED ^ SRC_BUCKET_SEED, _SRC_IDXS) | one,
            "dst_h1": run(_H1_SEED ^ DST_BUCKET_SEED, _DST_IDXS),
            "dp_h1": run(_H1_SEED ^ DSTPORT_FANOUT_SEED, _DP_IDXS),
            "dp_h2": run(_H2_SEED ^ DSTPORT_FANOUT_SEED, _DP_IDXS) | one,
            "src_sym": run(_H1_SEED ^ DST_BUCKET_SEED, _SRC_IDXS),
        }
