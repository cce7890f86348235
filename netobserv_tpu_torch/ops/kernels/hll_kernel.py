"""Kernels 3 and 8: the HyperLogLog max folds (`csrc/hll_fold.cu`).

Kernel 3 replaces the Pallas kernel `netobserv_tpu/ops/pallas/hll_kernel.py`
`update`. Register h1 & (m-1) becomes the max of itself and rank(h2), where
rank = clz(h2 as int32) + 1 and invalid rows have rank 0.

Kernel 8 replaces the Pallas kernel `update_per_dst`: the per-dst and
per-src (bucket, register) grids, folded as one flat array of D*m registers
(cell = (dst_h & (D-1)) * m + (src_h1 & (m-1)), rank from src_h2).

Both use an integer atomicMax per record (exact in any order); see the
source note. `update` and `update_per_dst` are the wrappers: a CUDA tensor
launches the kernel, a CPU tensor takes `update_plain` /
`update_per_dst_plain` (`scatter_reduce_` with "amax"). In place on the
registers (JAX donated them).
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops.kernels._build import (
    CudaKernel, LaunchShape, check, on_cuda,
)

SOURCE = "hll_fold.cu"
KERNEL = CudaKernel(SOURCE, "hll_fold", n_ptrs=4, n_ints=2)
KERNEL_GRID = CudaKernel(SOURCE, "hll_fold_grid", n_ptrs=5, n_ints=3)
#: threads per block of both kernels, one per record (the source's
#: `threads`)
THREADS = 256


def launch_shape(n: int) -> LaunchShape:
    """The grid of kernels 3 and 8 for B = n records: one thread per record
    in blocks of THREADS."""
    return LaunchShape(max(1, -(-n // THREADS)), 1, THREADS, 0)


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
    if not on_cuda(regs):
        update_plain(regs, h1, h2, valid)
        return
    m = regs.shape[0]
    if m & (m - 1):
        raise ValueError("register count must be a power of two")
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
    if dbuckets & (dbuckets - 1) or m & (m - 1):
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
