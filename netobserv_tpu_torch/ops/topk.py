"""Persistent-slot heavy-hitter table maintained on the device.

Counterpart of the SlotTable half of `netobserv_tpu/ops/topk.py`
(`init_slots`, `slot_candidates`, `slot_prepare`, `_slot_reduce_scatter`,
`slot_compose`, `slot_update`, `slot_roll`, `merge_slot_tables`). A SpaceSaving-style
SLOT_WAYS-way set-associative table: a key keeps its slot, and its
`first_seen` window, until a heavier key evicts it, across folds and window
rolls. Counts are Count-Min point estimates.

Key words and the (h1, h2) identity are uint32 lanes held in int64. The
per-slot reductions run through kernel 2 (`ops/kernels/topk_kernel.py`) on
CUDA and its plain twin on the CPU; `slot_prepare` and `slot_compose` are
shared by both. `slot_update` and `slot_roll` write the table in place (JAX
donated it).

`merge_slot_tables` is the one roll-time reconciliation of tables stacked
along their first axis (an aggregate and a delta frame's table, at the
federation tier). Its shapes depend on the stacked size only, never on the
data, so it runs inside a captured CUDA graph. Three points hold it to the
reference bit for bit:

- `jax.lax.sort((h1, h2, idx), num_keys=2)` is a stable lexicographic sort
  on uint32 keys. Here the lanes are int64, where `h1 << 32 | h2`
  overflows, so h1 is biased by -2^31 first: the key then fits an int64
  and orders as the pair does, and a stable sort keeps the index order;
- `jax.lax.top_k` puts the lower index first among equal values, which
  `torch.topk` does not promise. CM estimates are integer-valued f32
  masses, so ties are common: the selection is a stable descending sort;
- the segment sum, min and max are fixed-shape `index_add_` and
  `scatter_reduce_` calls, with XLA's identities for empty segments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from netobserv_tpu_torch.ops import countmin, hashing
from netobserv_tpu_torch.ops.kernels import topk_kernel

SLOT_WAYS = 8
_SLOT_SEED = 0x705C
SLOT_ROUNDS = 2
#: no insertion winner (the reference's NO_WINNER): the empty first_seen
NO_WINNER = 0x7FFFFFFF
_I32_MIN = -(1 << 31)


class SlotTable(NamedTuple):
    """Heavy-hitter table with persistent per-slot identity; invalid slots
    carry zeros everywhere."""

    words: torch.Tensor        # int64[K, W] uint32 key words
    h1: torch.Tensor           # int64[K] uint32 lane
    h2: torch.Tensor           # int64[K] uint32 lane
    counts: torch.Tensor       # f32[K] current-window CM estimate
    prev_counts: torch.Tensor  # f32[K] previous window's final estimate
    first_seen: torch.Tensor   # i32[K] window id at insertion
    epoch: torch.Tensor        # i32[K] insertion generation counter
    valid: torch.Tensor        # bool[K]

    @property
    def k(self) -> int:
        return self.words.shape[0]


def init_slots(k: int, key_words: int, device: torch.device) -> SlotTable:
    if k & (k - 1):
        raise ValueError("slot table size must be a power of two")

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SlotTable(
        words=z(k, key_words, dtype=torch.int64),
        h1=z(k, dtype=torch.int64), h2=z(k, dtype=torch.int64),
        counts=z(k, dtype=torch.float32),
        prev_counts=z(k, dtype=torch.float32),
        first_seen=z(k, dtype=torch.int32), epoch=z(k, dtype=torch.int32),
        valid=z(k, dtype=torch.bool))


def slot_candidates(h1: torch.Tensor, h2: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The SLOT_WAYS candidate slots of each key identity: int64[B, WAYS]
    (Kirsch–Mitzenmacher over a slot-family remix; odd stride, so the ways
    are distinct mod the power-of-two K)."""
    s1 = hashing.fmix32(h1 ^ _SLOT_SEED)
    s2 = hashing.fmix32(h2 ^ (_SLOT_SEED * 2 + 1)) | 1
    ways = torch.arange(SLOT_WAYS, dtype=torch.int64, device=h1.device)
    return (s1[:, None] + ways[None, :] * s2[:, None]) & (k - 1)


def _first_way(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True way of each row (SLOT_WAYS where none) —
    written out so ties never depend on an argmax implementation."""
    ways = torch.arange(SLOT_WAYS, device=mask.device)
    return torch.where(mask, ways, SLOT_WAYS).amin(dim=1)


def slot_prepare(table: SlotTable, h1: torch.Tensor, h2: torch.Tensor,
                 est: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Classify every batch row against the pre-batch table:
    `mslot` int64[B], the slot the row's key occupies (K if none), and
    `target` int64[B], the weakest candidate slot it challenges (K if it
    matched, is dead, or does not beat the defense). The defense of a slot
    is max(counts, prev_counts) of its occupant, -1 for an empty slot; ties
    of the weakest candidate go to the lowest way."""
    k = table.k
    live = est > 0.0
    cands = slot_candidates(h1, h2, k)
    occ_valid = table.valid[cands]
    match_way = (occ_valid & (table.h1[cands] == h1[:, None])
                 & (table.h2[cands] == h2[:, None]))
    mw = _first_way(match_way)
    matched = live & (mw < SLOT_WAYS)
    mslot = torch.gather(cands, 1, mw.clamp(max=SLOT_WAYS - 1)[:, None])[:, 0]
    mslot = torch.where(matched, mslot, k)
    defense = torch.where(occ_valid, torch.maximum(
        table.counts[cands], table.prev_counts[cands]), -1.0)
    tdef = defense.amin(dim=1)
    tj = _first_way(defense == tdef[:, None])
    target = torch.gather(cands, 1, tj[:, None])[:, 0]
    challenger = live & ~matched & (est > tdef)
    return mslot, torch.where(challenger, target, k)


def _slot_reduce_scatter(mslot: torch.Tensor, target: torch.Tensor,
                         est: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter form of the three per-slot reductions: kernel 2's plain
    twin (`topk_kernel.reduce_plain`)."""
    return topk_kernel.reduce_plain(mslot, target, est, k)


def slot_compose(table: SlotTable, match_max: torch.Tensor,
                 chall_max: torch.Tensor, win_row: torch.Tensor,
                 words: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                 window: torch.Tensor) -> torch.Tensor:
    """Apply the per-slot reductions to the table in place. Matched slots
    refresh `counts`; a slot with a winning challenger is overwritten
    (identity, counts = the winner's estimate, prev_counts = 0, first_seen
    = window, epoch + 1) unless its occupant's refreshed estimate meets the
    challenge. Returns the number of valid occupants evicted (f32[])."""
    has_winner = chall_max > 0.0
    wr = torch.clamp(win_row, max=h1.shape[0] - 1).to(torch.int64)
    counts = torch.maximum(table.counts, match_max)
    sel = has_winner & (chall_max > match_max)
    evicted = (sel & table.valid).to(torch.float32).sum()
    table.words.copy_(torch.where(sel[:, None], words[wr], table.words))
    table.h1.copy_(torch.where(sel, h1[wr], table.h1))
    table.h2.copy_(torch.where(sel, h2[wr], table.h2))
    table.counts.copy_(torch.where(sel, chall_max, counts))
    table.prev_counts.masked_fill_(sel, 0.0)
    table.first_seen.copy_(torch.where(sel, window, table.first_seen))
    table.epoch.add_(sel.to(torch.int32))
    table.valid.logical_or_(sel)
    return evicted


def slot_update(table: SlotTable, cm: countmin.CountMin, words: torch.Tensor,
                h1: torch.Tensor, h2: torch.Tensor, valid: torch.Tensor,
                window: torch.Tensor,
                query_fn=None) -> tuple[SlotTable, torch.Tensor]:
    """Fold one batch (whose mass is already in `cm`) into the table in
    SLOT_ROUNDS rounds. `query_fn(h1, h2) -> est` replaces the CM point
    query (the tiered fold hands in kernel 6's estimate). Returns (the same
    table, f32[] evictions)."""
    if query_fn is None:
        query_fn = lambda a, b: countmin.query(cm, a, b)  # noqa: E731
    est = torch.where(valid, query_fn(h1, h2), -1.0)
    evicted = torch.zeros((), dtype=torch.float32, device=est.device)
    for _ in range(SLOT_ROUNDS):
        mslot, target = slot_prepare(table, h1, h2, est)
        match_max, chall_max, win_row = topk_kernel.reduce(
            mslot, target, est, table.k)
        evicted = evicted + slot_compose(table, match_max, chall_max,
                                         win_row, words, h1, h2, window)
    return table, evicted


def slot_roll(table: SlotTable, carry: float = 0.0) -> SlotTable:
    """Roll across a window boundary in place without touching identity:
    prev_counts <- counts, counts <- counts * carry (0 = reset, 1 = keep,
    else a decay factor)."""
    table.prev_counts.copy_(table.counts)
    table.counts.mul_(carry)
    return table


def merge_slot_tables(stacked: SlotTable, cm_merged: countmin.CountMin,
                      k: int, query_fn=None) -> SlotTable:
    """Merge slot tables stacked along axis 0 into one new size-k table.
    Counts re-score against the merged CM (`query_fn(h1, h2) -> est`
    replaces the point query); duplicate identities collapse, with
    `prev_counts` summed, `first_seen` the min (clamped to 0x7FFFFFFE)
    and `epoch` the max of their valid rows; the top k by estimate with
    an estimate above 0 survive, lower stacked index first among ties
    (module docstring)."""
    if query_fn is None:
        query_fn = lambda a, b: countmin.query(cm_merged, a, b)  # noqa: E731
    valid = stacked.valid
    est = torch.where(valid, query_fn(stacked.h1, stacked.h2), -1.0)
    n = stacked.h1.shape[0]
    key = ((stacked.h1 - (1 << 31)) << 32) | stacked.h2
    s_idx = torch.sort(key, stable=True).indices
    s_h1 = stacked.h1[s_idx]
    s_h2 = stacked.h2[s_idx]
    s_valid = valid[s_idx]
    first = torch.ones(n, dtype=torch.bool, device=key.device)
    first[1:] = (s_h1[1:] != s_h1[:-1]) | (s_h2[1:] != s_h2[:-1])
    seg = torch.cumsum(first, 0) - 1
    prev_sum = torch.zeros(n, dtype=torch.float32, device=key.device)
    prev_sum.index_add_(0, seg, torch.where(
        s_valid, stacked.prev_counts[s_idx], 0.0))
    fs_min = torch.full((n,), NO_WINNER, dtype=torch.int32,
                        device=key.device)
    fs_min.scatter_reduce_(0, seg, torch.where(
        s_valid, stacked.first_seen[s_idx], NO_WINNER), "amin",
        include_self=False)
    ep_max = torch.full((n,), _I32_MIN, dtype=torch.int32, device=key.device)
    ep_max.scatter_reduce_(0, seg, torch.where(
        s_valid, stacked.epoch[s_idx], 0), "amax", include_self=False)
    s_est = torch.where(first & s_valid, est[s_idx], -1.0)
    ranked = torch.sort(s_est, descending=True, stable=True)
    top_est, top_pos = ranked.values[:k], ranked.indices[:k]
    sid = seg[top_pos]
    sel = top_est > 0
    return SlotTable(
        words=torch.where(sel[:, None], stacked.words[s_idx[top_pos]], 0),
        h1=torch.where(sel, s_h1[top_pos], 0),
        h2=torch.where(sel, s_h2[top_pos], 0),
        counts=torch.where(sel, top_est, 0.0),
        prev_counts=torch.where(sel, prev_sum[sid], 0.0),
        first_seen=torch.where(sel, fs_min[sid].clamp(max=0x7FFFFFFE), 0),
        epoch=torch.where(sel, ep_max[sid], 0),
        valid=sel)