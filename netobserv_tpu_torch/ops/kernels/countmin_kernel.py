"""Kernel 1: the dual-plane Count-Min fold (`csrc/countmin_fold2.cu`).

Replaces the Pallas kernel `netobserv_tpu/ops/pallas/countmin_kernel.py`
`update_two`. Both planes (bytes, packets) take the same row indices, so one
launch folds both. On this card L2 atomic throughput bounds the fold; the
kernel computes each column from (h1, h2) itself and makes two atomicAdds
per (record, depth row), with no one-hot tiling (see the source note).

`update_two` is the wrapper: a CUDA tensor launches the kernel, a CPU tensor
takes `update_two_plain`, the same function written with `index_add_`. The
fold is in place on the counter planes (JAX donated them).
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops import hashing
from netobserv_tpu_torch.ops.kernels._build import CudaKernel, check, on_cuda

SOURCE = "countmin_fold2.cu"
KERNEL = CudaKernel(SOURCE, "cm_fold2", n_ptrs=6, n_ints=3)


def update_two_plain(counts_a: torch.Tensor, counts_b: torch.Tensor,
                     h1: torch.Tensor, h2: torch.Tensor, va: torch.Tensor,
                     vb: torch.Tensor) -> None:
    """counts_x[r, (h1 + r*h2) & (W-1)] += vx for every record and row r,
    in place. va/vb are already masked (0 for invalid rows)."""
    d, w = counts_a.shape
    idx = hashing.row_indices(h1, h2, d, w)
    flat = (idx + torch.arange(d, device=idx.device)[:, None] * w).reshape(-1)
    counts_a.view(-1).index_add_(0, flat, va.expand(d, -1).reshape(-1))
    counts_b.view(-1).index_add_(0, flat, vb.expand(d, -1).reshape(-1))


def update_two(counts_a: torch.Tensor, counts_b: torch.Tensor,
               h1: torch.Tensor, h2: torch.Tensor, va: torch.Tensor,
               vb: torch.Tensor) -> None:
    """Fold one batch into both f32 [d, W] planes in place.

    h1/h2: int64[B] uint32 lanes; va/vb: f32[B] masked values."""
    if not on_cuda(counts_a):
        update_two_plain(counts_a, counts_b, h1, h2, va, vb)
        return
    d, w = counts_a.shape
    if w & (w - 1):
        raise ValueError("width must be a power of two")
    n = h1.shape[0]
    dev = counts_a.device
    check(counts_a, "counts_a", torch.float32, (d, w), dev)
    check(counts_b, "counts_b", torch.float32, (d, w), dev)
    check(h1, "h1", torch.int64, (n,), dev)
    check(h2, "h2", torch.int64, (n,), dev)
    check(va, "va", torch.float32, (n,), dev)
    check(vb, "vb", torch.float32, (n,), dev)
    KERNEL.launch([counts_a, counts_b, h1, h2, va, vb], [n, d, w], dev)
