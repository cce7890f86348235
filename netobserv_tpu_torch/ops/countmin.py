"""Count-Min sketch: a point-queryable frequency table in O(d*w) memory.

Counterpart of `netobserv_tpu/ops/countmin.py` (`init`, `update`,
`update_two`, `query`, `total`, `merge`, and the owner-sharded forms
`owner_shard`, `update_sharded`, `query_sharded_local` and
`query_sharded`, `:168-203`). Counters are a dense f32 [depth, width] tensor. With
w = 2^k and depth d, a point query overestimates by at most e/w * N with
probability 1 - e^-d (Cormode & Muthukrishnan).

`update_two` and `update` fold in place (JAX donated the planes): on CUDA
through kernels 1 and 5 (`ops/kernels/countmin_kernel.py`), on the CPU
through their plain twins. `merge` is the linear merge, and `merge_` its
in-place form, which the federation aggregator's captured merge uses.

Owner sharding (a mesh's `sketch` axis, `parallel/`): an independent hash
of the key identity names the one shard that owns a key, and the owner
folds the key's whole depth into its local [d, W / n] plane. A shard then
point-queries its own keys with no other shard's planes. The shard index
is a Python int here, where the reference reads `axis_index` inside
`shard_map`, and `query_sharded` sums the shards' owner-masked queries
itself, where the reference's is one psum. `update_sharded` is kernel 5
on CUDA, with `valid & (owner == shard)` as its mask.
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


def owner_shard(h1: torch.Tensor, h2: torch.Tensor,
                n_shards: int) -> torch.Tensor:
    """The sketch shard that owns each key: `fmix32(h1 ^ (h2 *
    0x9E3779B1)) % n_shards` on uint32 lanes (int64 here; the product
    wraps mod 2^32 through 16-bit halves, ROADMAP C4), as int64."""
    return hashing.fmix32(h1 ^ hashing._mul32(h2, 0x9E3779B1)) % n_shards


def update_sharded(cm_local: CountMin, h1: torch.Tensor, h2: torch.Tensor,
                   values: torch.Tensor, valid: torch.Tensor, shard: int,
                   n_shards: int) -> CountMin:
    """Fold a batch into shard `shard`'s local plane of an owner-sharded
    sketch, in place: only the keys it owns, at full depth."""
    mine = valid & (owner_shard(h1, h2, n_shards) == shard)
    return update(cm_local, h1, h2, values, mine)


def query_sharded_local(cm_local: CountMin, h1: torch.Tensor,
                        h2: torch.Tensor, shard: int,
                        n_shards: int) -> torch.Tensor:
    """Shard `shard`'s point query: whole estimates for the keys it owns,
    -1 (dead) for every other shard's keys."""
    mine = owner_shard(h1, h2, n_shards) == shard
    return torch.where(mine, query(cm_local, h1, h2), -1.0)


def query_sharded(cms: list[CountMin], h1: torch.Tensor,
                  h2: torch.Tensor) -> torch.Tensor:
    """The exact point query of an owner-sharded sketch whose local planes
    are `cms` (shard order, all on h1's device): the sum over the shards
    of each one's owner-masked query, in shard order. Exactly one shard
    owns each key, so the others add 0."""
    n = len(cms)
    owner = owner_shard(h1, h2, n)
    out = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
    for s, cm in enumerate(cms):
        out = out + torch.where(owner == s, query(cm, h1, h2), 0.0)
    return out


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
