"""Seeded edge cases of the contracts of kernel 2 (the top-K slot reduce),
kernels 4 and 7 (the signal fold, and its tiered form with the packed
global HLL bank), kernels 1, 5 and 6 (the wide, the single-plane and the
tier-interior Count-Min folds) and kernels 3 and 8 (the HLL max folds), as
numpy arrays.

The CPU tests hold the plain twins against the JAX package on these cases
(`tests/test_torch_topk.py`, `tests/test_torch_signal.py`,
`tests/test_torch_countmin.py`, `tests/test_torch_grid_kernels.py`,
`tests/test_torch_tiered.py`, `tests/test_torch_hll.py`), and
`chip_smoke.py` holds the CUDA kernels against the plain twins on the same
cases. Each case is named after the edge it covers; the sizes follow the
kernels' launch shapes (a top-K CTA's pass is THREADS rows, a cluster's
pass CLUSTER * THREADS; a signal block's THREADS rows, a kernel-7 block's
TIERED_THREADS and an HLL block's round TIERED_THREADS * HLL_UNROLL; a
Count-Min warp 32 records, a kernel-1 or kernel-5 block and a kernel-6
count or scatter block 256, a kernel-6 fold block's round TIER2_THREADS bin
entries, an HLL fold's warp 32 records and its block THREADS), so "one row
past" lands in the next warp, CTA, block or round.
Signal and Count-Min values are integers whose per-cell sums stay below
2^24, where the f32 adds are exact in any order, so every case is held
bit-exact; kernel 7's max fold is exact in any order.
"""

from __future__ import annotations

import numpy as np

from netobserv_tpu_torch.ops.kernels import (
    countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
)
from netobserv_tpu_torch.sketch.state import N_DROP_CAUSES as N_CAUSE
from netobserv_tpu_torch.sketch.state import N_DSCP


def topk_cases(k: int, seed: int = 0) -> list[tuple[str, dict]]:
    """(name, {"mslot", "target": int64[B] in [0, k], "est": f32[B]}) for
    K = k slots (k >= 8). Slot k marks an inactive row."""
    rng = np.random.default_rng(seed)
    share = topk_kernel.THREADS
    cluster_pass = topk_kernel.CLUSTER * share

    def rows(n: int) -> dict:
        est = rng.integers(0, 500, n).astype(np.float32)
        est[rng.random(n) < 0.1] = -1.0      # dead rows
        est[rng.random(n) < 0.05] = -3.0     # below the -1 floor
        est[rng.random(n) < 0.05] = -0.5     # live, negative
        return {"mslot": rng.integers(0, k + 1, n),
                "target": rng.integers(0, k + 1, n), "est": est}

    cases = [("empty", rows(0)),
             ("one_row", {"mslot": np.array([k - 1]),
                          "target": np.array([3]),
                          "est": np.array([5.0], np.float32)}),
             ("cta_share_plus_one", rows(share + 1)),
             ("cluster_pass_plus_one", rows(cluster_pass + 1))]

    one = rows(2 * share + 3)
    one["mslot"][:] = k // 2
    one["target"][:] = k // 2
    cases.append(("every_row_one_slot", one))

    # the maximum of slot 1 on rows in CTAs 1, 3 and 5 (and a warp-mate):
    # the lowest of them must win
    ties = rows(cluster_pass + 64)
    ties["target"][ties["target"] == 1] = 2
    ties["est"][ties["target"] == 2] = np.minimum(
        ties["est"][ties["target"] == 2], 100.0)
    tie_rows = [3 * share + 5, share + 2, 5 * share + 1, share + 3]
    ties["target"][tie_rows] = 1
    ties["est"][tie_rows] = 777.0
    ties["target"][[10, 11]] = 2    # a tie within one warp on slot 2
    ties["est"][[10, 11]] = 400.0
    cases.append(("equal_est_far_apart", ties))

    # slot 0's challengers and members are all at or below -1: no winner,
    # and chall_max / match_max stay -1
    dead = rows(share + 40)
    live_slot0 = (dead["target"] == 0) | (dead["mslot"] == 0)
    dead["est"][live_slot0] = -1.0
    at = np.arange(share, share + 40)
    dead["target"][at] = 0
    dead["mslot"][at] = 0
    dead["est"][at] = np.where(at % 2, -1.0, -3.0)
    cases.append(("est_at_or_below_minus_one", dead))

    # almost every row inactive (slot k) with the largest estimates
    idle = rows(cluster_pass + 3)
    idle["mslot"][:] = k
    idle["target"][:] = k
    idle["est"][:] = 1e6
    idle["mslot"][[7, cluster_pass]] = [k - 1, 0]
    idle["target"][[7, cluster_pass]] = [0, k - 1]
    idle["est"][[7, cluster_pass]] = 12.0
    cases.append(("inactive_slot", idle))
    return [(name, {"mslot": c["mslot"].astype(np.int64),
                    "target": c["target"].astype(np.int64),
                    "est": c["est"].astype(np.float32)})
            for name, c in cases]


def signal_cases(m: int, seed: int = 0) -> list[tuple[str, dict]]:
    """(name, {"idx": int64[5, B], "vals": f32[8, B]}) for m-wide tables
    and the N_DSCP / N_CAUSE aux tables; every index is in its table."""
    rng = np.random.default_rng(seed)
    share = signal_kernel.THREADS
    blocks = 8 * share  # rows of eight full blocks

    def batch(n: int) -> dict:
        idx = np.stack([rng.integers(0, m, n), rng.integers(0, m, n),
                        rng.integers(0, m, n), rng.integers(0, N_DSCP, n),
                        rng.integers(0, N_CAUSE, n)])
        vals = rng.integers(0, 4000, (8, n)).astype(np.float32)
        vals *= rng.random((8, n)) < 0.8
        return {"idx": idx, "vals": vals}

    cases = [("empty", batch(0)), ("one_row", batch(1)),
             ("block_plus_one", batch(share + 1)),
             ("ragged_last_block", batch(3 * blocks + 77))]

    hot = batch(2 * blocks + 5)
    hot["idx"][0] = m // 2 + 1
    cases.append(("every_row_one_dst_bucket", hot))

    edges = batch(blocks + 9)
    ends = np.where(np.arange(edges["idx"].shape[1]) % 2, m - 1, 0)
    edges["idx"][:3] = ends
    edges["idx"][3] = N_DSCP - 1
    edges["idx"][4] = N_CAUSE - 1
    cases.append(("index_0_and_m_minus_1_dscp_63_cause_127", edges))

    zeros = batch(blocks + 31)
    zeros["vals"] *= rng.random(zeros["vals"].shape) < 0.1
    zeros["vals"][[2, 5]] = 0.0
    cases.append(("zero_values", zeros))
    return [(name, {"idx": c["idx"].astype(np.int64),
                    "vals": c["vals"].astype(np.float32)})
            for name, c in cases]


def tiered_signal_cases(m: int, m_hll: int,
                        seed: int = 0) -> list[tuple[str, dict]]:
    """(name, {"m": table width, "idx": int64[5, B], "vals": f32[8, B],
    "regs": int32[m_hll] pre-fold registers, "h1", "h2": int64[B] uint32
    lanes, "valid": bool[B]}) for kernel 7 at table width m (the last case
    at 16,384, past the shared-memory bound of kernel 7's first design) and
    a packed bank of m_hll registers (a power of two, m_hll // 4 triples
    within one TILE_R tile or a multiple of it). Register h1 & (m_hll - 1)
    takes rank clz(h2) + 1 on a valid row. Pre-fold registers are below 6,
    so most hits raise theirs."""
    rng = np.random.default_rng(seed)
    share = signal_kernel.TIERED_THREADS
    blocks = 8 * share  # rows of eight full signal blocks
    hll_round = signal_kernel.TIERED_THREADS * signal_kernel.HLL_UNROLL
    bits = m_hll.bit_length() - 1

    def batch(n: int, width: int = m) -> dict:
        idx = np.stack([rng.integers(0, width, n), rng.integers(0, width, n),
                        rng.integers(0, width, n), rng.integers(0, N_DSCP, n),
                        rng.integers(0, N_CAUSE, n)])
        vals = rng.integers(0, 4000, (8, n)).astype(np.float32)
        vals *= rng.random((8, n)) < 0.8
        return {"m": width, "idx": idx, "vals": vals,
                "regs": rng.integers(0, 6, m_hll),
                "h1": rng.integers(0, 2 ** 32, n),
                "h2": rng.integers(0, 2 ** 32, n),
                "valid": rng.random(n) < 0.9}

    def on_register(c: dict, reg) -> None:
        """Keep each row's high h1 bits, with register `reg` below them."""
        c["h1"] = (c["h1"] >> bits << bits) | reg

    cases = [("empty", batch(0)), ("one_row", batch(1)),
             ("block_plus_one", batch(share + 1)),
             ("ragged_last_block", batch(hll_round + 3 * share + 77))]

    hot = batch(2 * blocks + 5)
    hot["idx"][0] = m // 2 + 1
    hot["vals"] %= 1000  # the hot cells' sums stay below 2^24
    cases.append(("every_row_one_dst_bucket", hot))

    one = batch(2 * blocks + 5)
    on_register(one, m_hll // 2 + 3)
    cases.append(("every_valid_row_one_register", one))

    # registers 0 and m_hll - 1, and the four fields of one triple
    t = m_hll // 8
    edges = batch(blocks + 9)
    picks = np.array([0, m_hll - 1, 4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3])
    on_register(edges, picks[np.arange(len(edges["h1"])) % len(picks)])
    edges["h2"][::7] = 0
    cases.append(("registers_0_and_last_and_one_triple", edges))

    dead = batch(blocks + 31)
    dead["valid"][:] = False
    cases.append(("all_rows_invalid", dead))

    zero = batch(share + 31)
    zero["h2"][:] = 0
    cases.append(("h2_zero_rank_33", zero))

    cases.append(("table_width_16384", batch(share + 9, width=16384)))
    return [(name, {"m": c["m"], "idx": c["idx"].astype(np.int64),
                    "vals": c["vals"].astype(np.float32),
                    "regs": c["regs"].astype(np.int32),
                    "h1": c["h1"].astype(np.int64),
                    "h2": c["h2"].astype(np.int64),
                    "valid": c["valid"].astype(np.bool_)})
            for name, c in cases]


def countmin_cases(w: int, seed: int = 0) -> list[tuple[str, dict]]:
    """(name, {"h1", "h2": int64[B] uint32 lanes, "va", "vb": f32[B]
    masked values}) for kernels 1 and 6, and kernel 5 with `va` as its
    value row, at width w (a power of two and a multiple of TILE_W) and
    any depth up to 8. Columns are (h1 + r * h2) & (w - 1) in uint32
    arithmetic."""
    rng = np.random.default_rng(seed)
    warp = 32
    block = max(countmin_kernel.THREADS, countmin_kernel.BIN_THREADS)
    fold_block = countmin_kernel.TIER2_THREADS
    tile = countmin_kernel.TILE_W

    def rows(n: int, keys: int = 64) -> dict:
        universe = rng.integers(0, 2 ** 32, (keys, 2))
        hk = universe[np.minimum(rng.zipf(1.3, n) - 1, keys - 1)]
        va = rng.integers(1, 1000, n).astype(np.float32)
        vb = rng.integers(1, 12, n).astype(np.float32)
        dead = rng.random(n) < 0.1  # invalid rows: both values masked
        va[dead] = 0.0
        vb[dead] = 0.0
        return {"h1": hk[:, 0], "h2": hk[:, 1], "va": va, "vb": vb}

    cases = [("empty", rows(0)), ("one_row", rows(1)),
             ("warp_plus_one", rows(warp + 1)),
             ("block_plus_one", rows(block + 1)),
             ("ragged_hot_key", rows(3 * block + 77, keys=50))]

    # every row on one key whose d columns lie in one tile: one bin holds
    # all d x B entries, more rounds of the fold block than a lane keeps
    one = rows(2 * fold_block + 3)
    one["h1"][:] = rng.integers(0, w // tile) * tile + 7
    one["h2"][:] = 1
    cases.append(("every_row_one_key", one))

    zeros = rows(block + 31)
    pick = rng.random(len(zeros["va"]))
    zeros["va"][pick < 0.5] = 0.0                   # both zero or va zero
    zeros["vb"][(pick < 0.3) | (pick > 0.8)] = 0.0  # both zero or vb zero
    cases.append(("zero_values_both_and_one", zeros))

    # the last column of a tile and the first of the next (h2 = 1), and the
    # first of a tile and the last of the one below (h2 = 2^32 - 1)
    edges = rows(2 * warp + 5)
    k = rng.integers(0, w // tile, len(edges["h1"]))
    up = np.arange(len(k)) % 2 == 0
    edges["h1"] = np.where(up, k * tile + tile - 1, k * tile)
    edges["h2"] = np.where(up, 1, 2 ** 32 - 1)
    cases.append(("tile_edges", edges))

    wrap = rows(block + 5)
    wrap["h1"] = rng.integers(2 ** 32 - 2 ** 16, 2 ** 32, len(wrap["h1"]))
    wrap["h2"] = rng.integers(2 ** 31, 2 ** 32, len(wrap["h1"]))
    cases.append(("h1_plus_r_h2_wraps_2_32", wrap))
    return [(name, {"h1": c["h1"].astype(np.int64),
                    "h2": c["h2"].astype(np.int64),
                    "va": c["va"].astype(np.float32),
                    "vb": c["vb"].astype(np.float32)})
            for name, c in cases]


def hll_fold_cases(dbuckets: int, m: int,
                   seed: int = 0) -> list[tuple[str, dict]]:
    """(name, {"regs": int32[D, m] pre-fold registers, "dst", "h1", "h2":
    int64[B] uint32 lanes, "valid": bool[B]}) for one fold of kernels 3 and
    8 at D x m (powers of two; D = 1 is kernel 3's fold, whose register file
    is regs[0]). Cell (dst & (D-1)) * m + (h1 & (m-1)) takes rank
    clz(h2) + 1 on a valid row. A case's B follows from the launch shape
    alone, so the cases of one name at several geometries make one launch
    of several folds. Pre-fold registers are below 6, so most hits raise
    theirs."""
    rng = np.random.default_rng(seed)
    warp, block = 32, hll_kernel.THREADS
    cells = dbuckets * m

    def rows(n: int) -> dict:
        return {"regs": rng.integers(0, 6, (dbuckets, m)),
                "dst": rng.integers(0, 2 ** 32, n),
                "h1": rng.integers(0, 2 ** 32, n),
                "h2": rng.integers(0, 2 ** 32, n),
                "valid": rng.random(n) < 0.9}

    def on_cells(c: dict, cell) -> None:
        """Keep each row's bits above the masks, with `cell` below them."""
        hi = ~np.int64(m - 1) & (2 ** 32 - 1)
        c["h1"] = (c["h1"] & hi) | (cell % m)
        c["dst"] = (c["dst"] & (~np.int64(dbuckets - 1) & (2 ** 32 - 1))
                    ) | (cell // m)

    cases = [("empty", rows(0)), ("one_row", rows(1)),
             ("warp_plus_one", rows(warp + 1)),
             ("block_plus_one", rows(block + 1))]

    hot = rows(2 * block + 5)
    on_cells(hot, rng.integers(0, cells))
    cases.append(("every_row_one_cell", hot))

    # three cells shared by the lanes of every warp: disjoint groups of one
    # match, each taking its own maximum; in even warps the first lane of
    # each group (the one that makes the group's atomic) is invalid
    groups = rows(4 * warp + 7)
    pick = rng.integers(0, 3, len(groups["h1"]))
    on_cells(groups, rng.choice(cells, 3, replace=False)[pick])
    for w in range(0, len(pick), 2 * warp):
        for g in range(3):
            lanes = np.flatnonzero(pick[w:w + warp] == g)
            if len(lanes):
                groups["valid"][w + lanes[0]] = False
    cases.append(("three_groups_a_warp", groups))

    edges = rows(2 * warp + 5)
    on_cells(edges, np.where(np.arange(len(edges["h1"])) % 2 == 0, 0,
                             cells - 1))
    cases.append(("first_and_last_cell", edges))

    ranks = rows(block + 31)
    h2s = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1, 0xFFFF])
    ranks["h2"] = h2s[np.arange(len(ranks["h2"])) % len(h2s)]
    cases.append(("rank_33_32_17_2_1", ranks))

    dead = rows(block + 31)
    dead["valid"][:] = False
    cases.append(("all_rows_invalid", dead))

    full = rows(block + 9)
    full["regs"][:, ::2] = 33
    cases.append(("half_the_registers_at_33", full))
    return [(name, {"regs": c["regs"].astype(np.int32),
                    **{f: c[f].astype(np.int64) for f in ("dst", "h1", "h2")},
                    "valid": c["valid"].astype(np.bool_)})
            for name, c in cases]


def tier_planes(d: int, w: int, mid_group: int, top_group: int,
                seed: int = 0) -> list[tuple[np.ndarray, ...]]:
    """Pre-fold tiers (base uint8[d, w], mid uint16[d, w / mid_group], top
    uint32[d, w / top_group]) of the two planes for kernel 6's cases: a
    quarter of the bases saturated, mids below 200 (never saturated), so a
    decoded cell stays below 455 units and, at a unit up to 256, the fold's
    sums stay integers below 2^24."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        base = rng.integers(0, 255, (d, w))
        base[rng.random((d, w)) < 0.25] = 255
        out.append((base.astype(np.uint8),
                    rng.integers(0, 200, (d, w // mid_group)).astype(
                        np.uint16),
                    rng.integers(0, 50, (d, w // top_group)).astype(
                        np.uint32)))
    return out
