"""The comparison that decides a run's `correct`.

Every window the agent closed during a run is held against the plain
reference (`sketch.py`) of the evictions it folded. The numbers, each the
worst over the run's windows:

- `sum_gap`: the widest relative gap of a summed cell: both Count-Min
  planes, the signal planes, the window totals and the histogram totals
  (a cell the reference leaves at zero and the program does not counts
  1), and the report's totals against the same;
- `hll_diff`: registers of the three HyperLogLog tables that differ (an
  exact comparison);
- `hist_out`: the histogram mass outside the reference's envelope, as a
  share of the samples (exact: each bucket must hold at least the samples
  that must land there and at most those that may);
- `heavy_gap`: over the window's `HEAVY_TOP` heaviest flows by exact
  bytes, how far the count of each that the heavy-hitter table holds lies
  outside [its exact bytes, its Count-Min estimate at the window's end],
  relative (a slot's count is the estimate at the last fold that saw the
  key, which lies between the two), and 1 for a flow that the table
  lacks in a window the timer closed. A shorter window (the set-up's, a
  flush's) may lack one: an incumbent key defends its slot with its count
  of the previous, longer window, so a flow that is heavy only in the
  short window need not displace it;
- `count_gap`: the rows a window counted against the rows of the
  evictions it took, exact: the program's count is its RTT histogram's
  samples (integers far below 2^24 in each float32 bucket, summed in
  float64), the reference's the rows of those evictions with an RTT (all
  but the rows of RTT 0, one in 5,001 of the mixes' rows). One fold of a
  window lost, or one row in a million, reads above 0;
- `evictions_lost`: evictions handed to the agent that no closed window
  counts (exact).

A window's evictions follow from that exact count: windows close between
two evictions, in order, so each takes the next evictions whose rows its
count covers.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import sketch

HEAVY_TOP = 100
#: the report's totals, in `sketch.SCALARS` order
REPORT_TOTALS = ("Records", "Bytes", "DropBytes", "DropPackets",
                 "QuicRecords", "NatRecords")
NUMBERS = ("sum_gap", "hll_diff", "hist_out", "heavy_gap", "count_gap",
           "evictions_lost")


def split_windows(sizes: list[int], records: list[float]
                  ) -> tuple[list[tuple[int, int]], int]:
    """[start, end) of each window in the handed sequence of evictions of
    `sizes` rows, from the windows' counts of rows, and the evictions no
    window took. A window whose count is not its evictions' rows fails
    `count_gap`."""
    out, i = [], 0
    for rec in records:
        start, left = i, rec
        while i < len(sizes) and left >= sizes[i] / 2:
            left -= sizes[i]
            i += 1
        out.append((start, i))
    return out, len(sizes) - i


def _gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest relative gap of `prog` against `ref` cell by cell."""
    prog, ref = prog.reshape(-1).to(torch.float64), ref.reshape(-1)
    if prog.shape != ref.shape:
        raise ValueError(f"table of {tuple(prog.shape)} cells against "
                         f"{tuple(ref.shape)}")
    pos = ref != 0
    rel = torch.where(pos, (prog - ref).abs() / torch.where(pos, ref.abs(),
                                                           1.0),
                      (prog != 0).to(torch.float64))
    return float(rel.max()) if rel.numel() else 0.0


def _hist_out(prog: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              n: float) -> float:
    prog = prog.reshape(-1).to(torch.float64)
    out = (torch.clamp(lo - prog, min=0) + torch.clamp(prog - hi, min=0))
    return float(out.sum()) / max(n, 1.0)


def _heavy_gap(tables: dict, ref: dict, live: list, geo, device,
               full: bool) -> tuple[float, list[int]]:
    """`heavy_gap` of one window (module docstring), and the ranks of the
    heaviest flows the table lacks."""
    ids = torch.cat([ids for (_, ids, _), _ in live])
    byt = torch.cat([e["rows"]["bytes"] * c for (e, _, _), c in live])
    if not len(ids):
        return 0.0, []
    universe = int(ids.max()) + 1
    exact = torch.zeros(universe, dtype=torch.float64, device=device)
    exact.index_add_(0, ids, byt.to(torch.float64))
    top = torch.topk(exact, min(HEAVY_TOP, int((exact > 0).sum()))).indices
    row_of = torch.full((universe,), -1, dtype=torch.int64, device=device)
    row_of[ids] = torch.arange(len(ids), device=device)
    rows = row_of[top]
    words = torch.cat([e["rows"]["words"] for (e, _, _), _ in live])[rows]
    h1 = torch.cat([e["rows"]["h1"] for (e, _, _), _ in live])[rows]
    h2 = torch.cat([e["rows"]["h2"] for (e, _, _), _ in live])[rows]
    est = sketch.cm_estimate(ref["cm_bytes"], h1, h2, geo)
    slots = {tuple(w): float(c) for w, c, v in zip(
        np.asarray(tables["heavy_words"], np.int64),
        np.asarray(tables["heavy_counts"], np.float64),
        np.asarray(tables["heavy_valid"])) if v}
    worst, missing = 0.0, []
    for rank, (w, e, u) in enumerate(zip(words.cpu().numpy(),
                                         exact[top].cpu().numpy(),
                                         est.cpu().numpy())):
        c = slots.get(tuple(w))
        if c is None:
            missing.append(rank)
            worst = max(worst, 1.0 if full else 0.0)
        else:
            worst = max(worst, float((e - c) / e), float((c - u) / u))
    return worst, missing


def judge(geo, evs: list, sequence: list[int], windows: list[dict],
          device, detail: list | None = None) -> dict[str, float]:
    """The numbers of a run (module docstring). `evs[i]` is pool eviction
    i's (tables from `sketch.eviction_tables`, flow ids int64[rows] on
    `device`, rows); `sequence` the pool index of each eviction handed, in
    order; `windows` each closed window, in order, as {"tables": the
    program's pre-roll tables (numpy), "report": its rendered report or
    None, "full": whether the timer closed it (default True)}. Each
    window's evictions and heavy-hitter reading are appended
    to `detail` when given."""
    with_rtt = [int(round(float(e["rtt_n"]))) for e, _, _ in evs]
    sizes = [with_rtt[i] for i in sequence]
    records = [float(np.asarray(w["tables"]["hist_rtt"], np.float64).sum())
               for w in windows]
    spans, lost = split_windows(sizes, records)
    num = dict.fromkeys(NUMBERS, 0.0)
    num["evictions_lost"] = float(abs(lost))
    for w, rec, (a, b) in zip(windows, records, spans):
        num["count_gap"] = max(num["count_gap"], abs(rec - sum(sizes[a:b])))
        counts = np.bincount(np.asarray(sequence[a:b], np.int64),
                             minlength=len(evs)).tolist()
        ref = sketch.window_tables([e for e, _, _ in evs], counts)
        tab = {k: torch.as_tensor(np.asarray(w["tables"][k])).to(device)
               for k in (*sketch.LINEAR, *sketch.REGISTERS, "scalars",
                         *(f"hist_{h}" for h in sketch.HISTS))}
        for k in sketch.LINEAR:
            num["sum_gap"] = max(num["sum_gap"], _gap(tab[k], ref[k]))
        num["sum_gap"] = max(num["sum_gap"],
                             _gap(tab["scalars"][:len(sketch.SCALARS)],
                                  ref["scalars"]))
        for name in sketch.HISTS:
            hist = tab[f"hist_{name}"]
            num["sum_gap"] = max(num["sum_gap"], _gap(
                hist.to(torch.float64).sum().reshape(1),
                ref[f"{name}_n"].reshape(1)))
            num["hist_out"] = max(num["hist_out"], _hist_out(
                hist, ref[f"{name}_lo"], ref[f"{name}_hi"],
                float(ref[f"{name}_n"])))
        if w.get("report") is not None:
            rep = torch.tensor([float(w["report"][k]) for k in REPORT_TOTALS],
                               dtype=torch.float64, device=device)
            num["sum_gap"] = max(num["sum_gap"], _gap(rep, ref["scalars"]))
        for k in sketch.REGISTERS:
            p = tab[k].reshape(-1).to(torch.int64)
            r = ref[k].reshape(-1).to(torch.int64)
            if p.shape != r.shape:
                raise ValueError(f"{k} of {tuple(p.shape)} registers "
                                 f"against {tuple(r.shape)}")
            num["hll_diff"] += float((p != r).sum())
        live = [(evs[i], c) for i, c in enumerate(counts) if c]
        gap, missing = _heavy_gap(w["tables"], ref, live, geo, device,
                                  w.get("full", True)) \
            if live else (0.0, [])
        num["heavy_gap"] = max(num["heavy_gap"], gap)
        if detail is not None:
            detail.append({"window": w.get("window"), "evictions": b - a,
                           "full": w.get("full", True),
                           "heavy_gap": gap, "missing_ranks": missing})
    return num
