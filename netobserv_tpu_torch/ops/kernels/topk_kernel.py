"""Kernel 2: the per-slot top-K reductions (`csrc/topk_reduce.cu`).

Replaces the Pallas kernel `netobserv_tpu/ops/pallas/topk_kernel.py`
`reduce`. For each of K slots: `match_max` (max est among rows already in
the slot), `chall_max` (max est among the slot's challengers) and `win_row`
(the lowest row at `chall_max`, NO_WINNER if none; est <= -1 never wins).
The kernel does the maxima with integer atomics on an order-preserving
form of the f32, and the winner with one 64-bit max on
(ordered est << 32 | ~row), so it is exact and deterministic. One launch of
one thread-block cluster: each CTA folds its share of the rows into a
private copy of the slot tables in shared memory with shared-memory
atomics, and the CTAs then split the slots and merge the copies through
distributed shared memory; see the source note.

`reduce` is the wrapper: a CUDA tensor launches the kernel, a CPU tensor
takes `reduce_plain` (`scatter_reduce_` with "amax" / "amin").
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops.kernels._build import (
    SMEM_LIMIT, CudaKernel, LaunchShape, check, on_cuda,
)

SOURCE = "topk_reduce.cu"
KERNEL = CudaKernel(SOURCE, "topk_reduce", n_ptrs=6, n_ints=2)

#: "no winner" sentinel of win_row
NO_WINNER = 0x7FFFFFFF
#: CTAs of the one cluster and threads per CTA (TOPK_CLUSTER and
#: TOPK_THREADS of the source); a CTA's pass over the rows is THREADS rows
CLUSTER = 8
THREADS = 1024
#: shared memory per slot: the ordered match max (4 B), the winner key (8 B)
SLOT_BYTES = 12
#: slots per tile (TOPK_TILE of the source): a private copy of a tile's
#: tables fills one CTA's shared memory; each tile is one walk over the rows
TILE = SMEM_LIMIT // SLOT_BYTES


def launch_shape(k: int) -> LaunchShape:
    """The kernel's grid for K slots: one cluster, each CTA holding a copy
    of one tile of min(K, TILE) slots."""
    return LaunchShape(1, CLUSTER, THREADS, min(k, TILE) * SLOT_BYTES)


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
    f32[B]. Returns (match_max f32[k], chall_max f32[k], win_row i32[k]).

    On CUDA every K takes the kernel: the slots go in tiles of TILE
    (19,370), one walk over the rows each, so a K past one tile costs a
    walk per tile. The call allocates only the three outputs and makes one
    launch."""
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
    KERNEL.launch([match_max, chall_max, win_row, mslot, target, est],
                  [n, k], dev)
    return match_max, chall_max, win_row
