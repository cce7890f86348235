"""A frozen copy of the sketch plane's hash arithmetic, in plain PyTorch.

Murmur3-style mixing over the ten uint32 words of a packed flow key, every
uint32 lane held in an int64 tensor (torch has no shifts or products on
uint32). One sweep gives every hash family that the sketches read:

- `h1`, `h2` (odd): the flow key, all ten words;
- `src_h1`, `src_h2` (odd): the source address, words 0-3;
- `dst_h1`: the destination address, words 4-7;
- `dp_h1`, `dp_h2` (odd): the destination address and port;
- `src_sym`: the source address under the destination family's seed.

The constants and the order of the steps are the sketch plane's own; this
file exists so that the benchmark's reference does not import the program.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

_C1, _C2, _M5, _N1 = 0xCC9E2D51, 0x1B873593, 5, 0xE6546B64
_F1, _F2 = 0x85EBCA6B, 0xC2B2AE35
_H1_SEED, _H2_SEED = 0x9747B28C, 0x5BD1E995
DST_BUCKET_SEED = 0x0D57
SRC_BUCKET_SEED = 0x0517
DSTPORT_FANOUT_SEED = 0x5CA7

FAMILIES = ("h1", "h2", "src_h1", "src_h2", "dst_h1", "dp_h1", "dp_h2",
            "src_sym")


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of x * c, the constant split in 16-bit halves so that no
    partial product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _F1)
    h = h ^ (h >> 13)
    h = _mul32(h, _F2)
    return h ^ (h >> 16)


def _k_mix(w: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl32(_mul32(w, _C1), 15), _C2)


def _absorb(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return (_rotl32(h ^ k, 13) * _M5 + _N1) & M32


def multi_hashes(words: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every family of `FAMILIES` for keys int64[n, 10] (uint32 values)."""
    words = words.to(torch.int64) & M32
    ks = [_k_mix(words[:, i]) for i in range(10)]
    ks.append(_k_mix(words[:, 8] & 0xFFFF))  # the destination port

    def run(seed: int, idxs) -> torch.Tensor:
        h = torch.full(words.shape[:1], seed, dtype=torch.int64,
                       device=words.device)
        for i in idxs:
            h = _absorb(h, ks[i])
        return fmix32(h ^ (len(idxs) * 4))

    flow, src, dst, dp = range(10), (0, 1, 2, 3), (4, 5, 6, 7), \
        (4, 5, 6, 7, 10)
    return {
        "h1": run(_H1_SEED, flow),
        "h2": run(_H2_SEED, flow) | 1,
        "src_h1": run(_H1_SEED ^ SRC_BUCKET_SEED, src),
        "src_h2": run(_H2_SEED ^ SRC_BUCKET_SEED, src) | 1,
        "dst_h1": run(_H1_SEED ^ DST_BUCKET_SEED, dst),
        "dp_h1": run(_H1_SEED ^ DSTPORT_FANOUT_SEED, dp),
        "dp_h2": run(_H2_SEED ^ DSTPORT_FANOUT_SEED, dp) | 1,
        "src_sym": run(_H1_SEED ^ DST_BUCKET_SEED, src),
    }


def cm_cells(h1: torch.Tensor, h2: torch.Tensor, depth: int,
             width: int) -> torch.Tensor:
    """Flat Count-Min cell of each (row, key): row * width + (h1 + row *
    h2) mod width, int64[depth, n] (Kirsch-Mitzenmacher)."""
    rows = torch.arange(depth, dtype=torch.int64, device=h1.device)[:, None]
    return rows * width + ((h1[None] + rows * h2[None]) & (width - 1))


def hll_rank(h2: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a uint32 lane plus one, in [1, 33]."""
    v = h2 & M32
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = torch.where(big, v >> s, v)
        n = n + big * s
    return 33 - (n + v)
