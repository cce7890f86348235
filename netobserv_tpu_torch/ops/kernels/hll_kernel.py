"""Kernel 3: the global source HyperLogLog fold (`csrc/hll_fold.cu`).

Replaces the Pallas kernel `netobserv_tpu/ops/pallas/hll_kernel.py`
`update`. Register h1 & (m-1) becomes the max of itself and rank(h2), where
rank = clz(h2 as int32) + 1 and invalid rows have rank 0. The kernel uses an
integer atomicMax per record (exact in any order); see the source note.

`update` is the wrapper: a CUDA tensor launches the kernel, a CPU tensor
takes `update_plain` (`scatter_reduce_` with "amax"). In place on the
registers (JAX donated them).
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops.kernels._build import CudaKernel, check, on_cuda

SOURCE = "hll_fold.cu"
KERNEL = CudaKernel(SOURCE, "hll_fold", n_ptrs=4, n_ints=2)


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
