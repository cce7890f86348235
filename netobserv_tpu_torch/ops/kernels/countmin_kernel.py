"""Kernels 1, 5 and 6: the dual-plane Count-Min fold (kernel 1) and the
single-plane fold (kernel 5), one body behind two C entries
(`csrc/countmin_fold2.cu`), and the tier-interior fold (kernel 6,
`csrc/countmin_tier2.cu`).

Kernel 1 replaces the Pallas kernel `netobserv_tpu/ops/pallas/countmin_kernel.py`
`update_two`. Both planes (bytes, packets) take the same row indices, so one
launch folds both. On this card L2 atomic throughput bounds the fold, and a
hot key's rows serialize on its d cells. One thread per (row, record),
row-major, so a warp holds 32 records of one row: the lanes with the same
cell sum their values and one lane makes the atomicAdds (see the source
note). No one-hot tiling.

Kernel 5 replaces the Pallas kernel `update` (`_fold_kernel`): the same
body with one value row (C entry `cm_fold`; kernel 1's is `cm_fold2`).
No path of the JAX package runs it (only its tests do), so no path of the
port does either: `ops/countmin.update` reaches it.

`update_two` and `update` are the wrappers: a CUDA tensor launches the
kernel, a CPU tensor takes `update_two_plain` or `update_plain`, the same
function written with `index_add_`. The fold is in place on the counter
planes (JAX donated them). Both launch only where `fold_fits`: the
kernel's cell and thread indices are 32-bit.

Kernel 6 replaces the Pallas kernel `update_two_tiered` (`_tier2_kernel`
with `tier_tiles.py`): it folds both planes straight into their resident
tiers (`sketch/tiered.py`: u8 base, u16 mid, u32 top) and returns the
post-fold, pre-promotion bytes estimate of every record (what the slot
table ranks on). One C call makes TIER2_LAUNCHES launches: the batch's
(record, row) pairs are counted and binned by TILE_W-column tile, then one
thread block per tile decodes its tiles into a wide view in shared memory,
folds only its bin (warp-aggregated), gathers the estimate and promotes,
and a last launch takes the min over rows (see the source note). The
wrapper allocates the outputs q and est and two int32 scratch arrays: the
per-tile counts and cursors (2 x W / TILE_W) and the bins' d x B entries;
no device buffer holds a wide counter. `update_two_tiered` is its wrapper,
and `update_two_tiered_plain` its twin: decode, the wide fold above,
`plane_add` of the delta, and the min over rows of the gathered wide
values. Both write the tiers in place.
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops import hashing
from netobserv_tpu_torch.ops.kernels._build import (
    SMEM_LIMIT, CudaKernel, LaunchShape, check, on_cuda,
)

SOURCE = "countmin_fold2.cu"
KERNEL = CudaKernel(SOURCE, "cm_fold2", n_ptrs=6, n_ints=3)
KERNEL_ONE = CudaKernel(SOURCE, "cm_fold", n_ptrs=4, n_ints=3)
SOURCE_TIER2 = "countmin_tier2.cu"
KERNEL_TIER2 = CudaKernel(SOURCE_TIER2, "cm_tier2", n_ptrs=14, n_ints=7)
#: threads per block of kernels 1 and 5, one per (row, record) pair
#: (CM2_THREADS of countmin_fold2.cu)
THREADS = 256
#: columns per kernel-6 fold block: a tile holds whole top groups
TILE_W = 512
#: kernel 6's threads per fold block (TIER2_THREADS), per count and
#: scatter block, one per record (BIN_THREADS), and per est block
#: (EST_THREADS)
TIER2_THREADS = 1024
BIN_THREADS = 256
EST_THREADS = 256
#: kernel launches of kernel 6's one C call (count, scatter, fold, est;
#: besides, one memset of the counts)
TIER2_LAUNCHES = 4


def launch_shape(n: int, d: int) -> LaunchShape:
    """Kernel 1's grid (and kernel 5's) for B = n records and d rows: one
    thread per (row, record) pair in blocks of THREADS."""
    return LaunchShape(max(1, -(-n * d // THREADS)), 1, THREADS, 0)


def fold_fits(d: int, w: int, n: int) -> bool:
    """Whether kernels 1 and 5 can fold n records into d x w planes: their
    int32 cell index r * W + col and thread index r * n + b cannot
    overflow. Both wrappers raise on a CUDA tensor where it is false."""
    return d * max(w, n) < 2 ** 31


def _refuse_unfit(d: int, w: int, n: int) -> None:
    if not fold_fits(d, w, n):
        raise ValueError(f"depth {d} x {max(w, n)}: the kernel's int32 cell "
                         "and thread indices would overflow")


def tier2_smem(d: int, mid_group: int, top_group: int) -> int:
    """Shared memory of one kernel-6 fold block, over both planes' tiles:
    `dec` (padded by one f32 per mid group), `wide` and the mid spill in
    f32, and the top (u32), mid (u16) and base (u8) tiers."""
    cells = 2 * d * TILE_W
    mcells, tcells = cells // mid_group, cells // top_group
    return (2 * cells + 2 * mcells) * 4 + tcells * 4 + mcells * 2 + cells


def launch_shapes_tier2(n: int, d: int, w: int, mid_group: int,
                        top_group: int) -> list[LaunchShape]:
    """Kernel 6's TIER2_LAUNCHES grids for B = n records, d rows and width
    w: count and scatter (one thread per record; per-tile tables in shared
    memory, one for the count, three for the scatter), fold (one block per
    tile) and est."""
    tiles = w // TILE_W
    blocks = max(1, -(-n // BIN_THREADS))
    return [LaunchShape(blocks, 1, BIN_THREADS, 4 * tiles),
            LaunchShape(blocks, 1, BIN_THREADS, 3 * 4 * tiles),
            LaunchShape(tiles, 1, TIER2_THREADS,
                        tier2_smem(d, mid_group, top_group)),
            LaunchShape(max(1, -(-n // EST_THREADS)), 1, EST_THREADS, 0)]


def _flat_cells(counts: torch.Tensor, h1: torch.Tensor,
                h2: torch.Tensor) -> torch.Tensor:
    """Flat index r * W + ((h1 + r*h2) & (W-1)) of every (row r, record)."""
    d, w = counts.shape
    idx = hashing.row_indices(h1, h2, d, w)
    return (idx + torch.arange(d, device=idx.device)[:, None] * w).reshape(-1)


def update_plain(counts: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """counts[r, (h1 + r*h2) & (W-1)] += vals for every record and row r,
    in place. vals are already masked (0 for invalid rows)."""
    d = counts.shape[0]
    counts.view(-1).index_add_(0, _flat_cells(counts, h1, h2),
                               vals.expand(d, -1).reshape(-1))


def update(counts: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
           vals: torch.Tensor) -> None:
    """Fold one batch into an f32 [d, W] plane in place.

    h1/h2: int64[B] uint32 lanes; vals: f32[B] masked values."""
    if not on_cuda(counts):
        update_plain(counts, h1, h2, vals)
        return
    d, w = counts.shape
    if w & (w - 1):
        raise ValueError("width must be a power of two")
    n = h1.shape[0]
    _refuse_unfit(d, w, n)
    dev = counts.device
    check(counts, "counts", torch.float32, (d, w), dev)
    check(h1, "h1", torch.int64, (n,), dev)
    check(h2, "h2", torch.int64, (n,), dev)
    check(vals, "vals", torch.float32, (n,), dev)
    KERNEL_ONE.launch([counts, h1, h2, vals], [n, d, w], dev)


def update_two_plain(counts_a: torch.Tensor, counts_b: torch.Tensor,
                     h1: torch.Tensor, h2: torch.Tensor, va: torch.Tensor,
                     vb: torch.Tensor) -> None:
    """counts_x[r, (h1 + r*h2) & (W-1)] += vx for every record and row r,
    in place. va/vb are already masked (0 for invalid rows)."""
    d = counts_a.shape[0]
    flat = _flat_cells(counts_a, h1, h2)
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
    _refuse_unfit(d, w, n)
    dev = counts_a.device
    check(counts_a, "counts_a", torch.float32, (d, w), dev)
    check(counts_b, "counts_b", torch.float32, (d, w), dev)
    check(h1, "h1", torch.int64, (n,), dev)
    check(h2, "h2", torch.int64, (n,), dev)
    check(va, "va", torch.float32, (n,), dev)
    check(vb, "vb", torch.float32, (n,), dev)
    KERNEL.launch([counts_a, counts_b, h1, h2, va, vb], [n, d, w], dev)


def tiered_eligible(width: int, spec) -> bool:
    """Static gate of the tier-interior fold: whole tiles, and whole top
    groups per tile, so promotion never crosses a block."""
    return width % TILE_W == 0 and TILE_W % spec.top_group == 0


def tier2_fits(depth: int, width: int, spec) -> bool:
    """Whether kernel 6 can launch at this depth and width under `spec`:
    a fold block's tiles (`tier2_smem`) and the scatter's three per-tile
    tables each fit one block's shared memory. The port's tier gates
    require it beside `tiered_eligible`, the reference's gate."""
    return (tier2_smem(depth, spec.mid_group, spec.top_group) <= SMEM_LIMIT
            and 3 * 4 * (width // TILE_W) <= SMEM_LIMIT)


def update_two_tiered_plain(plane_a, plane_b, h1: torch.Tensor,
                            h2: torch.Tensor, va: torch.Tensor,
                            vb: torch.Tensor, spec) -> torch.Tensor:
    """Kernel 6's twin: decode both planes, fold the wide view with
    `update_two_plain`, promote `new - dec` into the tiers in place
    (`tiered.plane_add`), and return est f32[B], the min over rows of the
    post-fold bytes view at each record's columns."""
    from netobserv_tpu_torch.sketch import tiered
    d, w = plane_a.base.shape
    dec_a = tiered.decode_plane(plane_a, spec, spec.bytes_unit)
    dec_b = tiered.decode_plane(plane_b, spec, 1)
    new_a, new_b = dec_a.clone(), dec_b.clone()
    update_two_plain(new_a, new_b, h1, h2, va, vb)
    tiered.copy_plane(plane_a, tiered.plane_add(
        plane_a, new_a - dec_a, spec, spec.bytes_unit))
    tiered.copy_plane(plane_b, tiered.plane_add(plane_b, new_b - dec_b,
                                                spec, 1))
    idx = hashing.row_indices(h1, h2, d, w)
    return torch.gather(new_a, 1, idx).amin(dim=0)


def update_two_tiered(plane_a, plane_b, h1: torch.Tensor, h2: torch.Tensor,
                      va: torch.Tensor, vb: torch.Tensor,
                      spec) -> torch.Tensor:
    """Fold one batch into both tiered planes (bytes, packets) in place and
    return the post-fold bytes estimate est f32[B].

    plane_x: (base uint8[d, W], mid uint16[d, W/mid_group], top
    uint32[d, W/top_group]); h1/h2: int64[B] uint32 lanes; va/vb: f32[B]
    masked values."""
    d, w = plane_a.base.shape
    if not tiered_eligible(w, spec):
        raise ValueError(f"width {w} / top_group {spec.top_group} is "
                         "ineligible for the tier-interior fold")
    if not on_cuda(va):
        return update_two_tiered_plain(plane_a, plane_b, h1, h2, va, vb,
                                       spec)
    mg, tg = spec.mid_group, spec.top_group
    if any(x & (x - 1) for x in (w, mg, tg, spec.bytes_unit)):
        raise ValueError("width, tier groups and unit must be powers of two")
    if not tier2_fits(d, w, spec):
        raise ValueError(
            f"depth {d}: a tile does not fit one block's shared memory"
            if tier2_smem(d, mg, tg) > SMEM_LIMIT else
            f"width {w}: the scatter's three per-tile tables do not fit one "
            "block's shared memory")
    n = h1.shape[0]
    if d * n >= 2 ** 31:
        raise ValueError(f"depth {d} x {n} records: the int32 bin entries "
                         "would overflow")
    dev = va.device
    for name, plane in (("plane_a", plane_a), ("plane_b", plane_b)):
        check(plane.base, f"{name}.base", torch.uint8, (d, w), dev)
        if plane.base.data_ptr() % 4:
            raise ValueError(f"{name}.base: the kernel moves it in 32-bit "
                             "words and needs 4-byte alignment")
        check(plane.mid, f"{name}.mid", torch.uint16, (d, w // mg), dev)
        check(plane.top, f"{name}.top", torch.uint32, (d, w // tg), dev)
    check(h1, "h1", torch.int64, (n,), dev)
    check(h2, "h2", torch.int64, (n,), dev)
    check(va, "va", torch.float32, (n,), dev)
    check(vb, "vb", torch.float32, (n,), dev)
    q = torch.empty((d, n), dtype=torch.float32, device=dev)
    est = torch.empty((n,), dtype=torch.float32, device=dev)
    counts = torch.empty((2 * (w // TILE_W),), dtype=torch.int32, device=dev)
    entries = torch.empty((d * n,), dtype=torch.int32, device=dev)
    KERNEL_TIER2.launch([*plane_a, *plane_b, h1, h2, va, vb, q, est, counts,
                         entries], [n, d, w, mg, tg, spec.bytes_unit, 1], dev)
    return est
