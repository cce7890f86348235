"""Tiered counter planes (SKETCH_TIERED): narrow resident sketch tables.

Counterpart of `netobserv_tpu/sketch/tiered.py` (`BASE_MAX`, `MID_MAX`,
`TOP_MAX`, `TierSpec`, `TieredPlane`, `TieredTables`, `TieredState`,
`_group_sum`, `_expand`, `_spill`, `init_plane`, `encode_plane`,
`plane_add`, `decay_plane`, `decode_plane`, `pack_hll`, `unpack_hll`,
`_strip`, `widen`, `widen_interior`, `interior_encode`, `decode_state`,
`decay_encode`, `encode_state`, `fold_encode`, `COUNTER_TABLES`,
`array_bytes`, `counter_table_bytes`, `plane_occupancy`).

The Count-Min planes stay resident as a u8 base plane over the full
[d, w] geometry (the bytes plane counts in `bytes_unit`-byte units, ceil
per fold; the packets plane counts raw) plus two direct-mapped overflow
tiers: a u16 mid tier (one cell per `mid_group` columns) and a u32 top
tier (one cell per `top_group` columns). A counter that saturates its base
cell spills into its group's mid cell, a saturated mid cell into its top
cell, and the top cell clamps at TOP_MAX. Decode attributes a shared
overflow cell to every promoted member of its group, so estimates only
ever overestimate, the Count-Min error direction. The HLL banks keep their
ranks (<= 33) 6-bit packed, four registers to three bytes, losslessly.

Per plane and fold:

1. `du = ceil(max(delta, 0) / unit)`;
2. `s = base + du`, `base' = min(s, 255)`; the base overflow `s - base'`
   group-sums into mid, `mid' = min(mid + spill, 65535)`; the mid overflow
   group-sums into top, `top' = top + min(spill, TOP_MAX - top)` (u32
   integer saturating add, the spill clamped to TOP_MAX before the cast);
3. decode: `units = base + [base == 255] * (mid_g + [mid_g == 65535] *
   top_G)`, value `units * unit`.

Storage dtypes are exactly the reference's: torch.uint8 base and packed
HLL bytes, torch.uint16 mid, torch.uint32 top. torch computes little on
uint16/uint32, so every function here casts to int32/int64/float32 to
compute and casts back only to store. The functions on planes and packed
banks return new tensors; the state-level ones (`fold_encode`,
`interior_encode`, `decay_encode`) write the resident tier tensors in
place, where JAX donated them, and return the state they were given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from netobserv_tpu_torch.ops import countmin, hll

#: base plane saturation point (u8)
BASE_MAX = 255
#: mid tier saturation point (u16)
MID_MAX = 65535
#: top tier clamp (u32 storage; a power of two, so the f32 clamp is exact)
TOP_MAX = 1 << 30


class TierSpec(NamedTuple):
    """Static tier geometry: `mid_group`/`top_group` are columns per
    overflow cell, `bytes_unit` the byte quantum of the bytes plane."""

    mid_group: int = 32
    top_group: int = 256
    bytes_unit: int = 256

    def check(self, cm_width: int) -> None:
        for name, v in (("mid_group", self.mid_group),
                        ("top_group", self.top_group)):
            if v < 2 or v & (v - 1):
                raise ValueError(
                    f"tier {name} must be a power of two >= 2 (got {v})")
        if self.bytes_unit < 1 or self.bytes_unit & (self.bytes_unit - 1):
            raise ValueError("tier bytes_unit must be a power of two >= 1 "
                             f"(got {self.bytes_unit})")
        if self.top_group <= self.mid_group:
            raise ValueError(
                f"tier top_group ({self.top_group}) must exceed mid_group "
                f"({self.mid_group}): tiers must narrow as they widen")
        if cm_width % self.top_group:
            raise ValueError(
                f"tier top_group ({self.top_group}) must divide the CM "
                f"width ({cm_width})")


class TieredPlane(NamedTuple):
    """One Count-Min plane in tiered form (values in units)."""

    base: torch.Tensor  # uint8  [d, w]
    mid: torch.Tensor   # uint16 [d, w // mid_group]
    top: torch.Tensor   # uint32 [d, w // top_group]


class TieredTables(NamedTuple):
    """The resident narrow form of every tier-covered table."""

    cm_bytes: TieredPlane
    cm_pkts: TieredPlane
    hll_src: torch.Tensor      # uint8 [m//4*3], 6-bit packed registers
    hll_per_dst: torch.Tensor  # uint8 [D, m//4*3]
    hll_per_src: torch.Tensor  # uint8 [S, m//4*3]


class TieredState(NamedTuple):
    """Sketch state with the big counter tables resident in tiered form.

    `rest` is an ordinary SketchState whose CM and HLL fields hold
    zero-size placeholders that nothing reads; `spec` is the tier
    geometry."""

    tables: TieredTables
    rest: object
    spec: TierSpec

    @property
    def heavy(self):
        return self.rest.heavy

    @property
    def window(self):
        return self.rest.window


# ------------------------------------------------------------------ planes


def _group_sum(x: torch.Tensor, g: int) -> torch.Tensor:
    d, n = x.shape
    return x.reshape(d, n // g, g).sum(dim=-1)


def _expand(x: torch.Tensor, g: int) -> torch.Tensor:
    d, n = x.shape
    return x[:, :, None].expand(d, n, g).reshape(d, n * g)


def _spill(over: torch.Tensor, mid_f: torch.Tensor, top: torch.Tensor,
           spec: TierSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Cascade base overflow (units, f32 [d, w]) through the mid and top
    tiers: group-sum, saturate, spill, and a u32 integer saturating add at
    the top (f32 there would round small spills away past 2^24 units, an
    undercount). `top` is the resident uint32 tier. Returns the new
    (uint16 mid, uint32 top)."""
    s2 = mid_f + _group_sum(over, spec.mid_group)
    new_mid = torch.clamp(s2, max=float(MID_MAX))
    spill = _group_sum(s2 - new_mid, spec.top_group // spec.mid_group)
    # clamp BEFORE the integer cast, then saturate against the room left
    inc = torch.clamp(spill, max=float(TOP_MAX)).to(torch.int64)
    top_i = top.to(torch.int64)
    new_top = top_i + torch.minimum(inc, TOP_MAX - top_i)
    return (new_mid.to(torch.int32).to(torch.uint16),
            new_top.to(torch.uint32))


def init_plane(depth: int, width: int, spec: TierSpec,
               device: torch.device) -> TieredPlane:
    return TieredPlane(
        base=torch.zeros((depth, width), dtype=torch.uint8, device=device),
        mid=torch.zeros((depth, width // spec.mid_group),
                        dtype=torch.uint16, device=device),
        top=torch.zeros((depth, width // spec.top_group),
                        dtype=torch.uint32, device=device))


def encode_plane(wide: torch.Tensor, spec: TierSpec,
                 unit: int) -> TieredPlane:
    """From-scratch encode of a wide value table (init, reset roll). Not
    the per-fold path, which is `plane_add`. Always ceil, unit 1 included:
    a fractional value must round up into whole units."""
    vu = torch.ceil(wide.to(torch.float32) / unit)
    base = torch.clamp(vu, max=float(BASE_MAX))
    d, w = wide.shape
    dev = wide.device
    mid, top = _spill(vu - base,
                      torch.zeros((d, w // spec.mid_group), device=dev),
                      torch.zeros((d, w // spec.top_group),
                                  dtype=torch.uint32, device=dev), spec)
    return TieredPlane(base=base.to(torch.uint8), mid=mid, top=top)


def plane_add(plane: TieredPlane, delta: torch.Tensor, spec: TierSpec,
              unit: int) -> TieredPlane:
    """Fold one batch's per-counter delta (raw values, >= 0) into the
    plane through the saturation-promotion path."""
    du = torch.ceil(torch.clamp(delta, min=0.0) / unit)
    s = plane.base.to(torch.float32) + du
    new_base = torch.clamp(s, max=float(BASE_MAX))
    mid, top = _spill(s - new_base, plane.mid.to(torch.float32), plane.top,
                      spec)
    return TieredPlane(base=new_base.to(torch.uint8), mid=mid, top=top)


def decay_plane(plane: TieredPlane, factor: float) -> TieredPlane:
    """Window decay on the representation: scale each tier elementwise
    (ceil), keeping saturated base and mid cells saturated. Not decode ->
    decay -> encode, which would re-sum a shared cell's attribution into
    it and grow the aliasing every window."""
    base_i = plane.base.to(torch.int32)
    basef = torch.ceil(base_i.to(torch.float32) * factor)
    new_base = torch.where(base_i == BASE_MAX, base_i,
                           basef.to(torch.int32))
    mid_i = plane.mid.to(torch.int32)
    midf = torch.ceil(mid_i.to(torch.float32) * factor)
    new_mid = torch.where(mid_i == MID_MAX, mid_i, midf.to(torch.int32))
    new_top = torch.ceil(plane.top.to(torch.float32) * factor)
    return TieredPlane(base=new_base.to(torch.uint8),
                       mid=new_mid.to(torch.uint16),
                       top=new_top.to(torch.int64).to(torch.uint32))


def decode_plane(plane: TieredPlane, spec: TierSpec,
                 unit: int) -> torch.Tensor:
    """Wide f32 [d, w] view. A shared overflow cell counts for every
    promoted member of its group: overestimate only."""
    mid_i = plane.mid.to(torch.int32)
    top_per_mid = _expand(plane.top.to(torch.float32),
                          spec.top_group // spec.mid_group)
    mid_tot = mid_i.to(torch.float32) + torch.where(
        mid_i == MID_MAX, top_per_mid, 0.0)
    per_col = _expand(mid_tot, spec.mid_group)
    base_i = plane.base.to(torch.int32)
    units = base_i.to(torch.float32) + torch.where(
        base_i == BASE_MAX, per_col, 0.0)
    return units * unit if unit > 1 else units


# ------------------------------------------------------- HLL register packing


def pack_hll(regs: torch.Tensor) -> torch.Tensor:
    """int32[..., m] registers -> uint8[..., m//4*3], 4 per 3 bytes."""
    *lead, m = regs.shape
    if m % 4:
        raise ValueError(f"HLL register count {m} must be a multiple of 4")
    r = regs.to(torch.int64).reshape(*lead, m // 4, 4)
    v = r[..., 0] | (r[..., 1] << 6) | (r[..., 2] << 12) | (r[..., 3] << 18)
    b = torch.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(*lead, (m // 4) * 3)


def unpack_hll(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_hll` -> int32[..., m]."""
    *lead, n = packed.shape
    b = packed.to(torch.int32).reshape(*lead, n // 3, 3)
    v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    r = torch.stack([v & 63, (v >> 6) & 63, (v >> 12) & 63, (v >> 18) & 63],
                    dim=-1)
    return r.reshape(*lead, (n // 3) * 4)


# -------------------------------------------------- state encode / decode


def copy_plane(dst: TieredPlane, src: TieredPlane) -> None:
    """Write `src`'s tiers into the resident tensors of `dst`."""
    for d, s in zip(dst, src):
        d.copy_(s)


def copy_tables(dst: TieredTables, src: TieredTables) -> None:
    """Write every tier array of `src` into the resident tensors of `dst`."""
    copy_plane(dst.cm_bytes, src.cm_bytes)
    copy_plane(dst.cm_pkts, src.cm_pkts)
    for name in ("hll_src", "hll_per_dst", "hll_per_src"):
        getattr(dst, name).copy_(getattr(src, name))


def _strip(wide):
    """A SketchState whose tier-covered tables are zero-size placeholders."""
    dev = wide.window.device
    return wide._replace(
        cm_bytes=countmin.CountMin(torch.zeros((0, 0), device=dev)),
        cm_pkts=countmin.CountMin(torch.zeros((0, 0), device=dev)),
        hll_src=hll.HLL(torch.zeros((0,), dtype=torch.int32, device=dev)),
        hll_per_dst=hll.PerDstHLL(torch.zeros((0, 0), dtype=torch.int32,
                                              device=dev)),
        hll_per_src=hll.PerDstHLL(torch.zeros((0, 0), dtype=torch.int32,
                                              device=dev)))


def widen(ts: TieredState, cmb_wide: torch.Tensor, cmp_wide: torch.Tensor):
    """The transient wide SketchState of a decode-wrapped fold or a roll:
    the given CM planes, freshly unpacked HLL banks, and `rest`'s own
    tensors for everything else (so in-place updates reach the state)."""
    t = ts.tables
    return ts.rest._replace(
        cm_bytes=countmin.CountMin(cmb_wide),
        cm_pkts=countmin.CountMin(cmp_wide),
        hll_src=hll.HLL(unpack_hll(t.hll_src)),
        hll_per_dst=hll.PerDstHLL(unpack_hll(t.hll_per_dst)),
        hll_per_src=hll.PerDstHLL(unpack_hll(t.hll_per_src)))


def widen_interior(ts: TieredState, fuse_hll_src: bool):
    """The transient SketchState of the tier-interior fold: the CM planes
    keep their placeholders (kernel 6 folds the tiers directly), the
    global-src bank stays packed when kernel 7 folds it (`fuse_hll_src`),
    and only the per-bucket grids unpack (their fold is a scatter)."""
    t = ts.tables
    rest = ts.rest._replace(
        hll_per_dst=hll.PerDstHLL(unpack_hll(t.hll_per_dst)),
        hll_per_src=hll.PerDstHLL(unpack_hll(t.hll_per_src)))
    if not fuse_hll_src:
        rest = rest._replace(hll_src=hll.HLL(unpack_hll(t.hll_src)))
    return rest


def interior_encode(ts: TieredState, fuse_hll_src: bool,
                    new_work) -> TieredState:
    """Close one tier-interior fold in place: the CM tiers (and, when
    fused, the packed global-src bank) were written by the fold itself;
    the per-bucket grids, and the global-src bank when not fused, re-pack
    from the work state. Everything else rode `rest`'s tensors."""
    t = ts.tables
    if not fuse_hll_src:
        t.hll_src.copy_(pack_hll(new_work.hll_src.regs))
    t.hll_per_dst.copy_(pack_hll(new_work.hll_per_dst.regs))
    t.hll_per_src.copy_(pack_hll(new_work.hll_per_src.regs))
    return ts


def decode_state(ts: TieredState):
    """The canonical wide SketchState (what the roll and `state_tables`
    see); its non-tiered fields are `rest`'s own tensors."""
    spec = ts.spec
    return widen(ts, decode_plane(ts.tables.cm_bytes, spec, spec.bytes_unit),
                 decode_plane(ts.tables.cm_pkts, spec, 1))


def _pack_banks_into(t: TieredTables, wide) -> None:
    t.hll_src.copy_(pack_hll(wide.hll_src.regs))
    t.hll_per_dst.copy_(pack_hll(wide.hll_per_dst.regs))
    t.hll_per_src.copy_(pack_hll(wide.hll_per_src.regs))


def decay_encode(ts: TieredState, wide_decayed,
                 factor: float) -> TieredState:
    """The decayed-window re-encode, in place: the CM tiers scale
    elementwise (`decay_plane`), the HLL banks re-pack from the decayed
    wide state (decay resets them)."""
    t = ts.tables
    copy_plane(t.cm_bytes, decay_plane(t.cm_bytes, factor))
    copy_plane(t.cm_pkts, decay_plane(t.cm_pkts, factor))
    _pack_banks_into(t, wide_decayed)
    return ts


def encode_state(wide, spec: TierSpec) -> TieredState:
    """From-scratch encode of a wide state (init, reset roll): new tier
    tensors, and `rest` holding the wide state's other tensors."""
    tables = TieredTables(
        cm_bytes=encode_plane(wide.cm_bytes.counts, spec, spec.bytes_unit),
        cm_pkts=encode_plane(wide.cm_pkts.counts, spec, 1),
        hll_src=pack_hll(wide.hll_src.regs),
        hll_per_dst=pack_hll(wide.hll_per_dst.regs),
        hll_per_src=pack_hll(wide.hll_per_src.regs))
    return TieredState(tables, _strip(wide), spec)


def fold_encode(ts: TieredState, cmb_wide: torch.Tensor,
                cmp_wide: torch.Tensor, new_wide) -> TieredState:
    """Close one decode-wrapped fold in place: the CM planes advance by
    the fold's exact per-counter delta (new - decoded), the HLL banks
    re-pack losslessly."""
    spec, t = ts.spec, ts.tables
    copy_plane(t.cm_bytes, plane_add(t.cm_bytes,
                                     new_wide.cm_bytes.counts - cmb_wide,
                                     spec, spec.bytes_unit))
    copy_plane(t.cm_pkts, plane_add(t.cm_pkts,
                                    new_wide.cm_pkts.counts - cmp_wide,
                                    spec, 1))
    _pack_banks_into(t, new_wide)
    return ts


# -------------------------------------------------------------- accounting

#: the sketch tables the tiered representation covers
COUNTER_TABLES = ("cm_bytes", "cm_pkts", "hll_src", "hll_per_dst",
                  "hll_per_src")


def array_bytes(tree) -> int:
    """Total bytes of the tensors in a nest of tuples (shape math only);
    a leaf that is not a tensor (the tier geometry) counts nothing."""
    if isinstance(tree, torch.Tensor):
        return math.prod(tree.shape) * tree.element_size()
    if not isinstance(tree, tuple):
        return 0
    return sum(array_bytes(x) for x in tree)


def counter_table_bytes(state) -> dict[str, int]:
    """Resident bytes of each tier-covered table, for a wide SketchState
    or a TieredState."""
    src = state.tables if isinstance(state, TieredState) else state
    return {name: array_bytes(getattr(src, name))
            for name in COUNTER_TABLES}


def plane_occupancy(plane: TieredPlane) -> dict[str, int]:
    """Tier occupancy of one CM plane (copies the tiers to the host)."""
    base, mid, top = (x.to("cpu").numpy() for x in plane)
    return {
        "base_counters": int(base.size),
        "promoted": int((base == BASE_MAX).sum()),
        "mid_cells": int(mid.size),
        "mid_active": int((mid > 0).sum()),
        "mid_saturated": int((mid == MID_MAX).sum()),
        "top_cells": int(top.size),
        "top_active": int((top > 0).sum()),
        "top_saturated": int((top == np.uint32(TOP_MAX)).sum()),
    }
