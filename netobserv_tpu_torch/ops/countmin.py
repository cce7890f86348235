"""Count-Min sketch: a point-queryable frequency table in O(d*w) memory.

Counterpart of `netobserv_tpu/ops/countmin.py` (`init`, `update`,
`update_two`, `query`, `total`, `merge`). Counters are a dense f32 [depth, width] tensor. With
w = 2^k and depth d, a point query overestimates by at most e/w * N with
probability 1 - e^-d (Cormode & Muthukrishnan).

`update_two` and `update` fold in place (JAX donated the planes): on CUDA
through kernels 1 and 5 (`ops/kernels/countmin_kernel.py`), on the CPU
through their plain twins. `merge` is the linear merge, and `merge_` its
in-place form, which the federation aggregator's captured merge uses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from netobserv_tpu_torch.ops import hashing
from netobserv_tpu_torch.ops.kernels import countmin_kernel


class CountMin(NamedTuple):
    """Sketch state: counts f32[depth, width]."""

    counts: torch.Tensor

    @property
    def depth(self) -> int:
        return self.counts.shape[0]

    @property
    def width(self) -> int:
        return self.counts.shape[1]


def init(depth: int, width: int, device: torch.device) -> CountMin:
    if width & (width - 1):
        raise ValueError("width must be a power of two")
    return CountMin(torch.zeros((depth, width), dtype=torch.float32,
                                device=device))


def update(cm: CountMin, h1: torch.Tensor, h2: torch.Tensor,
           values: torch.Tensor, valid: torch.Tensor) -> CountMin:
    """Fold one batch into the sketch in place; returns the same sketch.

    h1/h2: int64[B] uint32 base hashes; values: [B]; valid: bool[B].
    Duplicate keys within a batch accumulate (scatter-add semantics)."""
    vals = torch.where(valid, values.to(torch.float32), 0.0)
    countmin_kernel.update(cm.counts, h1, h2, vals)
    return cm


def update_two(cm_a: CountMin, cm_b: CountMin, h1: torch.Tensor,
               h2: torch.Tensor, vals_a: torch.Tensor, vals_b: torch.Tensor,
               valid: torch.Tensor) -> tuple[CountMin, CountMin]:
    """Fold one batch into two same-shape f32 sketches that share hash
    indices (bytes and packets), in place. Returns the same sketches."""
    if cm_a.counts.shape != cm_b.counts.shape:
        raise ValueError("update_two needs two same-shape sketches")
    va = torch.where(valid, vals_a.to(torch.float32), 0.0)
    vb = torch.where(valid, vals_b.to(torch.float32), 0.0)
    countmin_kernel.update_two(cm_a.counts, cm_b.counts, h1, h2, va, vb)
    return cm_a, cm_b


def query(cm: CountMin, h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Point-query estimated counts for keys given their base hashes."""
    d, w = cm.counts.shape
    idx = hashing.row_indices(h1, h2, d, w)
    return torch.gather(cm.counts, 1, idx.reshape(d, -1)).reshape(
        idx.shape).amin(dim=0)


def total(cm: CountMin) -> torch.Tensor:
    """Total inserted mass (any single row sums to N)."""
    return cm.counts[0].sum()


def merge(a: CountMin, b: CountMin) -> CountMin:
    """Linear merge: a new sketch of the elementwise sum."""
    return CountMin(a.counts + b.counts)


def merge_(a: CountMin, b: CountMin | torch.Tensor) -> CountMin:
    """`merge` into `a` in place (b a sketch or its counts); returns a."""
    a.counts.add_(b.counts if isinstance(b, CountMin) else b)
    return a
