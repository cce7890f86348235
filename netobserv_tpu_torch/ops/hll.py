"""HyperLogLog cardinality sketches, flat and per-destination-bucket.

Counterpart of `netobserv_tpu/ops/hll.py` (`init`, `init_per_dst`, `_rank`,
`update`, `update_per_dst`, `estimate`, `merge_regs`). Registers are int32; the index comes
from h1's low bits, the rank from the leading zeros of h2.

`update` folds in place through kernel 3 and `update_per_dst` through kernel
8 (`ops/kernels/hll_kernel.py`) on CUDA, and through their plain twins on
the CPU. The ingest folds the global HLL and both grids of a batch in one
launch of the same body (`hll_kernel.update_folds`). The JAX package keeps
the grids on XLA scatter, because its TPU kernel pays D*m lane compares per
record; kernel 8 pays at most one atomic, as the scatter does. Both are in
place on the registers (JAX donated them). `merge_regs` merges two
register files by their elementwise max; `merge_regs_` writes it into the
first in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from netobserv_tpu_torch.ops.kernels import hll_kernel

_rank = hll_kernel.rank


class HLL(NamedTuple):
    regs: torch.Tensor  # int32[m], m = 2^precision

    @property
    def precision(self) -> int:
        return int(self.regs.shape[-1]).bit_length() - 1


class PerDstHLL(NamedTuple):
    """D independent small HLLs, one per destination hash bucket."""

    regs: torch.Tensor  # int32[D, m]


def init(precision: int, device: torch.device) -> HLL:
    return HLL(torch.zeros((1 << precision,), dtype=torch.int32,
                           device=device))


def init_per_dst(dst_buckets: int, precision: int,
                 device: torch.device) -> PerDstHLL:
    if dst_buckets & (dst_buckets - 1):
        raise ValueError("dst_buckets must be a power of two")
    return PerDstHLL(torch.zeros((dst_buckets, 1 << precision),
                                 dtype=torch.int32, device=device))


def update(h: HLL, h1: torch.Tensor, h2: torch.Tensor,
           valid: torch.Tensor) -> HLL:
    hll_kernel.update(h.regs, h1, h2, valid)
    return h


def update_per_dst(s: PerDstHLL, dst_h: torch.Tensor, src_h1: torch.Tensor,
                   src_h2: torch.Tensor, valid: torch.Tensor) -> PerDstHLL:
    """Fold (dst, src) pairs: register (dst_bucket, src_reg) <- max rank."""
    hll_kernel.update_per_dst(s.regs, dst_h, src_h1, src_h2, valid)
    return s


def _alpha(m: int) -> float:
    if m <= 16:
        return 0.673
    if m <= 32:
        return 0.697
    if m <= 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """Cardinality estimate with small/large-range corrections.

    regs: int32[..., m]; returns f32[...] — flat and per-dst alike."""
    m = regs.shape[-1]
    harm = torch.exp2(-regs.to(torch.float32)).sum(dim=-1)
    raw = _alpha(m) * m * m / harm
    zeros = (regs == 0).to(torch.float32).sum(dim=-1)
    lin = m * torch.log(torch.where(zeros > 0,
                                    m / torch.clamp(zeros, min=1e-9), 1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)
    two32 = 2.0 ** 32
    return torch.where(est > two32 / 30.0,
                       -two32 * torch.log1p(-est / two32), est)


def merge_regs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge: the elementwise max of two register files (either form)."""
    return torch.maximum(a, b)


def merge_regs_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`merge_regs` into `a` in place; returns a."""
    return torch.maximum(a, b, out=a)
