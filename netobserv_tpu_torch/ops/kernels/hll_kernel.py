"""Kernels 3 and 8: the HyperLogLog max folds, one CUDA body
(`csrc/hll_fold.cu`) behind three C entries.

Kernel 3 replaces the Pallas kernel `netobserv_tpu/ops/pallas/hll_kernel.py`
`update`. Register h1 & (m-1) becomes the max of itself and rank(h2), where
rank = clz(h2 as int32) + 1 and invalid rows have rank 0.

Kernel 8 replaces the Pallas kernel `update_per_dst`: the per-dst and
per-src (bucket, register) grids, folded as one flat array of D*m registers
(cell = (dst_h & (D-1)) * m + (src_h1 & (m-1)), rank from src_h2).

Both Pallas kernels run one body, `_fold_flat`; so do the port's. A fold is
`(regs, h1, h2, valid)` for int32[m] registers (kernel 3) or
`(regs, dst_h, src_h1, src_h2, valid)` for an int32[D, m] grid (kernel 8).
`update` launches one kernel-3 fold (C entry `hll_fold`), `update_per_dst`
one kernel-8 fold (`hll_fold_grid`), and `update_folds` one to MAX_FOLDS
folds of one batch in one launch (`hll_fold_folds`): the ingest folds its
global HLL and both grids with one call. Each entry has its own launch
counter. A CUDA tensor launches the kernel or raises; a CPU tensor takes
the plain twin (`update_plain`, `update_per_dst_plain`,
`update_folds_plain`: `scatter_reduce_` with "amax"). In place on the
registers (JAX donated them). The integer maximum is exact in any order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from netobserv_tpu_torch.ops.kernels._build import (
    CudaKernel, LaunchShape, check, on_cuda,
)

SOURCE = "hll_fold.cu"
KERNEL = CudaKernel(SOURCE, "hll_fold", n_ptrs=4, n_ints=2)
KERNEL_GRID = CudaKernel(SOURCE, "hll_fold_grid", n_ptrs=5, n_ints=3)
#: folds a launch at most (the source's HLL_MAX_FOLDS)
MAX_FOLDS = 3
KERNEL_FOLDS = CudaKernel(SOURCE, "hll_fold_folds", n_ptrs=5 * MAX_FOLDS,
                          n_ints=2 + 2 * MAX_FOLDS)
#: threads per block, one per record (the source's HLL_THREADS)
THREADS = 256


def launch_shape(n: int, folds: int = 1) -> LaunchShape:
    """The grid of one launch of `folds` folds of B = n records: one thread
    per record in blocks of THREADS, a row of blocks per fold."""
    return LaunchShape(max(1, -(-n // THREADS)) * folds, 1, THREADS, 0)


def rank(h2: torch.Tensor) -> torch.Tensor:
    """clz(h2 as int32) + 1 in [1, 33] for uint32 lanes held in int64: 33
    for h2 == 0, 1 for h2 >= 2**31. torch has no clz, so the bit length
    comes from a five-step binary search."""
    v = h2 & 0xFFFFFFFF
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = torch.where(big, v >> s, v)
        n = n + big * s
    return (33 - (n + v)).to(torch.int32)


def _pow2(x: int) -> bool:
    return x > 0 and not x & (x - 1)


def update_plain(regs: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                 valid: torch.Tensor) -> None:
    """regs[h1 & (m-1)] = max(regs, rank(h2) or 0 if invalid), in place."""
    m = regs.shape[0]
    r = torch.where(valid, rank(h2), 0)
    regs.scatter_reduce_(0, h1 & (m - 1), r, "amax")


def update(regs: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
           valid: torch.Tensor) -> None:
    """Fold one batch into int32[m] registers in place.

    h1/h2: int64[B] uint32 lanes; valid: bool[B]."""
    m = regs.shape[0]
    if not _pow2(m):
        raise ValueError("register count must be a power of two")
    if not on_cuda(regs):
        update_plain(regs, h1, h2, valid)
        return
    n = h1.shape[0]
    dev = regs.device
    check(regs, "regs", torch.int32, (m,), dev)
    check(h1, "h1", torch.int64, (n,), dev)
    check(h2, "h2", torch.int64, (n,), dev)
    check(valid, "valid", torch.bool, (n,), dev)
    KERNEL.launch([regs, h1, h2, valid], [n, m], dev)


def update_per_dst_plain(regs: torch.Tensor, dst_h: torch.Tensor,
                         src_h1: torch.Tensor, src_h2: torch.Tensor,
                         valid: torch.Tensor) -> None:
    """regs[dst_h & (D-1), src_h1 & (m-1)] = max(regs, rank(src_h2) or 0
    if invalid), in place."""
    dbuckets, m = regs.shape
    cell = (dst_h & (dbuckets - 1)) * m + (src_h1 & (m - 1))
    r = torch.where(valid, rank(src_h2), 0)
    regs.view(-1).scatter_reduce_(0, cell, r, "amax")


def update_per_dst(regs: torch.Tensor, dst_h: torch.Tensor,
                   src_h1: torch.Tensor, src_h2: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """Fold (dst, src) pairs into an int32[D, m] grid in place.

    dst_h/src_h1/src_h2: int64[B] uint32 lanes; valid: bool[B]."""
    dbuckets, m = regs.shape
    if not (_pow2(dbuckets) and _pow2(m)):
        raise ValueError("grid buckets and registers must be powers of two")
    if not on_cuda(regs):
        update_per_dst_plain(regs, dst_h, src_h1, src_h2, valid)
        return
    n = dst_h.shape[0]
    dev = regs.device
    check(regs, "regs", torch.int32, (dbuckets, m), dev)
    for name, t in (("dst_h", dst_h), ("src_h1", src_h1),
                    ("src_h2", src_h2)):
        check(t, name, torch.int64, (n,), dev)
    check(valid, "valid", torch.bool, (n,), dev)
    KERNEL_GRID.launch([regs, dst_h, src_h1, src_h2, valid],
                       [n, dbuckets, m], dev)


def update_folds_plain(folds: Sequence[tuple]) -> None:
    """Each fold in order: `update_plain` on a 4-tuple, `update_per_dst_plain`
    on a 5-tuple."""
    for f in folds:
        (update_plain if len(f) == 4 else update_per_dst_plain)(*f)


def _grid_of(f: tuple) -> tuple[int, int]:
    """(D, m) of a fold: (1, m) for registers int32[m] with their 4-tuple,
    the grid's shape for a 5-tuple."""
    if len(f) == 4 and f[0].dim() == 1:
        return 1, f[0].shape[0]
    if len(f) == 5 and f[0].dim() == 2:
        return tuple(f[0].shape)
    raise ValueError("a fold is (regs[m], h1, h2, valid) or "
                     "(regs[D, m], dst_h, src_h1, src_h2, valid)")


def update_folds(folds: Sequence[tuple]) -> None:
    """Fold one batch of B records into 1 to MAX_FOLDS register files in
    place, in one launch: each fold as `update` (a 4-tuple) or
    `update_per_dst` (a 5-tuple) would, in order (the register files are
    distinct, so the order changes no bit)."""
    if not 1 <= len(folds) <= MAX_FOLDS:
        raise ValueError(f"1 to {MAX_FOLDS} folds a launch, got {len(folds)}")
    grids = [_grid_of(f) for f in folds]
    if not all(_pow2(d) and _pow2(m) for d, m in grids):
        raise ValueError("grid buckets and registers must be powers of two")
    n = folds[0][1].shape[0]
    if any(t.shape[0] != n for f in folds for t in f[1:]):
        raise ValueError("every fold of a launch takes the same B records")
    if not on_cuda(folds[0][0]):
        update_folds_plain(folds)
        return
    dev = folds[0][0].device
    ptrs, ints = [], []
    for f, (d, m) in zip(folds, grids):
        if d * m > 1 << 31:
            raise ValueError("the kernel indexes at most 2^31 registers")
        check(f[0], "regs", torch.int32, tuple(f[0].shape), dev)
        for t in f[1:-1]:
            check(t, "hash lane", torch.int64, (n,), dev)
        check(f[-1], "valid", torch.bool, (n,), dev)
        # bucket, register, rank and valid lanes; kernel 3's fold (D = 1,
        # mask 0) passes h1 as its bucket lane
        ptrs += [f[0], f[1], *f[-3:]]
        ints += [d, m]
    ptrs += ptrs[:5] * (MAX_FOLDS - len(folds))
    ints += ints[:2] * (MAX_FOLDS - len(folds))
    KERNEL_FOLDS.launch(ptrs, [len(folds), n, *ints], dev)
