"""Kernels 4 and 7: the fused signal-plane fold (`csrc/signal_fold.cu`),
and its tiered form with the packed global HLL (`csrc/signal_fold_tiered.cu`).

Replaces the Pallas kernel `netobserv_tpu/ops/pallas/signal_kernel.py`
`update`. Eight value rows add into six m-wide tables (ddos, syn, drops,
synack, conv_fwd, conv_rev) and two aux tables (dscp bytes, drop causes)
over five index families (dst, src, pair, dscp, cause). Kernel 4 takes
one thread per record: the lanes of a warp with the same index combine
their values, and the group's leader adds the sum straight into the
L2-resident global table with one atomic; see the source note.

`update` is the wrapper: CUDA tensors launch the kernel, CPU tensors take
`update_plain` (eight `index_add_`). In place on the tables (JAX donated
them).

Kernel 7 replaces the Pallas kernel `update_tiered` (`_fold_tiered_kernel`):
kernel 4's fold plus a max fold of the global source HLL straight into its
6-bit packed bank (`sketch/tiered.pack_hll` layout), in one launch of two
roles. The first blocks each own TILE_R packed triples: they unpack them
into shared memory, walk the batch testing tile membership on h1 alone,
load h2 and valid only for their hits, max-fold with shared-memory
atomics, and pack back. The other blocks run kernel 4's per-record body
(`csrc/signal_agg.cuh`, shared by both kernels), so no table lives in
shared memory and the table width has no bound. The design it replaces
(a private copy of the eight tables in each block's shared memory, HLL
blocks loading all three HLL columns) is in the source note and PERF.md.
`update_tiered` is its wrapper, `update_tiered_plain` its twin:
`update_plain`, then `unpack_hll`, `hll_kernel.update_plain` and
`pack_hll`. Both update the tables and the packed bank in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from netobserv_tpu_torch.ops.kernels import hll_kernel
from netobserv_tpu_torch.ops.kernels._build import (
    CudaKernel, LaunchShape, check, on_cuda,
)

SOURCE = "signal_fold.cu"
KERNEL = CudaKernel(SOURCE, "signal_fold", n_ptrs=10, n_ints=4)
SOURCE_TIERED = "signal_fold_tiered.cu"
KERNEL_TIERED = CudaKernel(SOURCE_TIERED, "signal_fold_tiered", n_ptrs=14,
                           n_ints=5)
#: packed register triples per kernel-7 HLL block
TILE_R = 512
#: kernel 4's records per block, one per thread (SIGNAL_THREADS of the
#: source)
THREADS = 128
#: kernel 7's threads per block, one record a thread in a signal block
#: (TIERED_THREADS of the source), and h1 loads in flight a thread of an
#: HLL block (HLL_UNROLL), which walks the batch in rounds of
#: TIERED_THREADS * HLL_UNROLL records
TIERED_THREADS = 1024
HLL_UNROLL = 8

#: value row -> index family: [ddos, syn, drops | synack | fwd, rev | dscp |
#: cause] over families [dst, src, pair, dscp, cause]
FAMILY = (0, 0, 0, 1, 2, 2, 3, 4)
N_VALS = 8
N_IDX = 5
#: most entries of an aux table (dscp, causes): the reference's shared
#: aux row
AUX_W = 256


def launch_shape(n: int) -> LaunchShape:
    """Kernel 4's grid for B = n records: ceil(n / THREADS) blocks of
    THREADS threads, no cluster and no shared memory."""
    return LaunchShape(max(1, -(-n // THREADS)), 1, THREADS, 0)


def launch_shape_tiered(n: int, n_packed: int) -> LaunchShape:
    """Kernel 7's grid for B = n records and a packed bank of n_packed
    bytes: one HLL block per tile of min(n3, TILE_R) triples, with the
    tile's registers (4 ints a triple) in shared memory, then
    ceil(n / TIERED_THREADS) signal blocks, all of TIERED_THREADS
    threads."""
    n3 = n_packed // 3
    tile_r = min(n3, TILE_R)
    return LaunchShape(n3 // tile_r + max(1, -(-n // TIERED_THREADS)), 1,
                       TIERED_THREADS, 4 * tile_r * 4)


class SignalPlanes(NamedTuple):
    """The signal tables the fused fold updates (views of the state)."""

    ddos_rate: torch.Tensor   # f32[m]
    syn_rate: torch.Tensor    # f32[m]
    drops_rate: torch.Tensor  # f32[m]
    synack: torch.Tensor      # f32[m]
    conv_fwd: torch.Tensor    # f32[m]
    conv_rev: torch.Tensor    # f32[m]
    dscp_bytes: torch.Tensor  # f32[n_dscp]  (n_dscp <= AUX_W)
    drop_causes: torch.Tensor  # f32[n_causes] (n_causes <= AUX_W)


def update_plain(planes: SignalPlanes, idx: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """planes[j][idx[FAMILY[j]]] += vals[j] for each value row j, in place.
    Indices are already masked into their table's range."""
    for j, table in enumerate(planes):
        table.index_add_(0, idx[FAMILY[j]], vals[j])


def eligible(planes: SignalPlanes) -> bool:
    """The reference's static gate of the fused signal fold: six planes of
    one lane-aligned width, aux tables within the shared aux row."""
    m = planes.ddos_rate.shape[0]
    return (all(p.shape == (m,) for p in planes[1:6]) and m % 128 == 0
            and planes.dscp_bytes.shape[0] <= AUX_W
            and planes.drop_causes.shape[0] <= AUX_W)


def hll_fusible(m: int) -> bool:
    """Static gate of folding the packed global HLL bank (m registers) in
    kernel 7: the register triples must tile evenly."""
    n3 = m // 4
    return m % 4 == 0 and n3 > 0 and (n3 <= TILE_R or n3 % TILE_R == 0)


def _check_tables(planes: SignalPlanes, dev: torch.device) -> None:
    m = planes.ddos_rate.shape[0]
    n_dscp = planes.dscp_bytes.shape[0]
    n_cause = planes.drop_causes.shape[0]
    if n_dscp > AUX_W or n_cause > AUX_W:
        raise ValueError(f"aux tables must fit {AUX_W} entries")
    for name, t in zip(SignalPlanes._fields[:6], planes[:6]):
        check(t, name, torch.float32, (m,), dev)
    check(planes.dscp_bytes, "dscp_bytes", torch.float32, (n_dscp,), dev)
    check(planes.drop_causes, "drop_causes", torch.float32, (n_cause,), dev)


def update(planes: SignalPlanes, idx: torch.Tensor,
           vals: torch.Tensor) -> None:
    """Fold one batch into every signal table in one pass, in place.

    idx: int64[5, B] — [dst, src, pair, dscp, cause] indices; vals:
    f32[8, B] — [ddos, syn, drops, synack, conv_fwd, conv_rev, dscp, cause]
    masses, already masked (0 = no-op)."""
    if not on_cuda(vals):
        update_plain(planes, idx, vals)
        return
    n = vals.shape[1]
    dev = vals.device
    _check_tables(planes, dev)
    check(idx, "idx", torch.int64, (N_IDX, n), dev)
    check(vals, "vals", torch.float32, (N_VALS, n), dev)
    if n == 0:
        return  # nothing to fold: no launch
    KERNEL.launch([*planes, idx, vals],
                  [n, planes.ddos_rate.shape[0], planes.dscp_bytes.shape[0],
                   planes.drop_causes.shape[0]], dev)


def update_tiered_plain(planes: SignalPlanes, packed: torch.Tensor,
                        idx: torch.Tensor, vals: torch.Tensor,
                        h1: torch.Tensor, h2: torch.Tensor,
                        valid: torch.Tensor) -> None:
    """Kernel 7's twin: `update_plain`, then the packed bank unpacked,
    max-folded by `hll_kernel.update_plain` and packed back in place."""
    from netobserv_tpu_torch.sketch import tiered
    update_plain(planes, idx, vals)
    regs = tiered.unpack_hll(packed)
    hll_kernel.update_plain(regs, h1, h2, valid)
    packed.copy_(tiered.pack_hll(regs))


def update_tiered(planes: SignalPlanes, packed: torch.Tensor,
                  idx: torch.Tensor, vals: torch.Tensor, h1: torch.Tensor,
                  h2: torch.Tensor, valid: torch.Tensor) -> None:
    """`update` plus the global source HLL folded into its packed bank
    uint8[m//4*3] in the same launch, in place: register h1 & (m-1) takes
    the max of itself and rank(h2) (0 for an invalid row). Any table width
    m: the kernel keeps no table in shared memory.

    idx/vals: as for `update`; h1/h2: int64[B] uint32 lanes; valid:
    bool[B]."""
    n_packed = packed.shape[0]
    m_hll = n_packed // 3 * 4
    if n_packed % 3 or m_hll & (m_hll - 1) or not hll_fusible(m_hll):
        raise ValueError(f"a packed HLL bank of {n_packed} bytes cannot be "
                         "fused into the signal fold")
    if not on_cuda(vals):
        update_tiered_plain(planes, packed, idx, vals, h1, h2, valid)
        return
    n = vals.shape[1]
    dev = vals.device
    _check_tables(planes, dev)
    check(idx, "idx", torch.int64, (N_IDX, n), dev)
    check(vals, "vals", torch.float32, (N_VALS, n), dev)
    check(packed, "packed", torch.uint8, (n_packed,), dev)
    check(h1, "h1", torch.int64, (n,), dev)
    check(h2, "h2", torch.int64, (n,), dev)
    check(valid, "valid", torch.bool, (n,), dev)
    if n == 0:
        return  # nothing to fold: no launch
    KERNEL_TIERED.launch(
        [*planes, idx, vals, packed, h1, h2, valid],
        [n, planes.ddos_rate.shape[0], planes.dscp_bytes.shape[0],
         planes.drop_causes.shape[0], n_packed], dev)
