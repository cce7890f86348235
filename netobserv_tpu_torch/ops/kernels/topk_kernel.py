"""Kernel 2: the per-slot top-K reductions (`csrc/topk_reduce.cu`).

Replaces the Pallas kernel `netobserv_tpu/ops/pallas/topk_kernel.py`
`reduce`. For each of K slots: `match_max` (max est among rows already in
the slot), `chall_max` (max est among the slot's challengers) and `win_row`
(the lowest row at `chall_max`, NO_WINNER if none; est <= -1 never wins).
The kernel does the maxima with integer atomics on an order-preserving
form of the f32, and the winner with one 64-bit atomicMax on
(ordered est << 32 | ~row), so it is exact and deterministic; see the
source note.

`reduce` is the wrapper: a CUDA tensor launches the kernel, a CPU tensor
takes `reduce_plain` (`scatter_reduce_` with "amax" / "amin").
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops.kernels._build import CudaKernel, check, on_cuda

SOURCE = "topk_reduce.cu"
KERNEL = CudaKernel(SOURCE, "topk_reduce", n_ptrs=7, n_ints=2)

#: "no winner" sentinel of win_row
NO_WINNER = 0x7FFFFFFF


def reduce_plain(mslot: torch.Tensor, target: torch.Tensor,
                 est: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three reductions as scatters. Slot id k marks an inactive row;
    the tables carry one spare entry for it, which is dropped."""
    dev = est.device
    rows = torch.arange(est.shape[0], dtype=torch.int32, device=dev)
    match_max = torch.full((k + 1,), -1.0, device=dev).scatter_reduce_(
        0, mslot, est, "amax")[:k]
    chall_full = torch.full((k + 1,), -1.0, device=dev).scatter_reduce_(
        0, target, est, "amax")
    winner = (target < k) & (est == chall_full[target]) & (est > -1.0)
    win_row = torch.full((k + 1,), NO_WINNER, dtype=torch.int32,
                         device=dev).scatter_reduce_(
        0, torch.where(winner, target, k), rows, "amin")[:k]
    return match_max, chall_full[:k], win_row


def reduce(mslot: torch.Tensor, target: torch.Tensor, est: torch.Tensor,
           k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mslot/target: int64[B] slot ids in [0, k] (k = inactive); est:
    f32[B]. Returns (match_max f32[k], chall_max f32[k], win_row i32[k])."""
    if not on_cuda(est):
        return reduce_plain(mslot, target, est, k)
    n = est.shape[0]
    dev = est.device
    check(mslot, "mslot", torch.int64, (n,), dev)
    check(target, "target", torch.int64, (n,), dev)
    check(est, "est", torch.float32, (n,), dev)
    match_max = torch.empty(k, dtype=torch.float32, device=dev)
    chall_max = torch.empty(k, dtype=torch.float32, device=dev)
    win_row = torch.empty(k, dtype=torch.int32, device=dev)
    best = torch.empty(k, dtype=torch.int64, device=dev)
    KERNEL.launch([match_max, chall_max, win_row, best, mslot, target, est],
                  [n, k], dev)
    return match_max, chall_max, win_row
