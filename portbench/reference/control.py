"""The control: the reference put in the program's place, one precision
lower.

The configuration states float32 tables. The control computes what the
program hands the harness for each window (its tables and its heavy-hitter
table) from the same evictions, with every sum kept in bfloat16: each
eviction's sums, and the window's running sum of them in the order the
evictions arrive. Its heavy-hitter table holds the `topk` flows of the
largest bfloat16 Count-Min estimates, with those estimates as counts. The
judge must find it not correct; the smallest number it reads is the upper
reading of each limit.

`python -m portbench.control` reads its numbers at a cell's own size.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import judge, sketch


def window_tables(evs_low: list, ids: list, sequence: list[int],
                  geo: sketch.Geometry, topk: int, device) -> dict:
    """The control's tables of one window that folded `sequence` (pool
    indices, in order); `evs_low` are the pool's eviction tables in
    bfloat16."""
    low = torch.bfloat16
    out = {}
    first = evs_low[0]
    for k in sketch.LINEAR:
        out[k] = torch.zeros_like(first[k], dtype=low)
    out["scalars"] = torch.zeros(7, dtype=low, device=device)
    hist = {h: torch.zeros(geo.hist_buckets, dtype=low, device=device)
            for h in sketch.HISTS}
    for i in sequence:
        e = evs_low[i]
        for k in sketch.LINEAR:
            out[k] += e[k].to(low)
        out["scalars"][:6] += e["scalars"].to(low)
        for h in sketch.HISTS:
            hist[h] += e[f"{h}_lo"].to(low)
    for k in sketch.REGISTERS:
        live = sorted(set(sequence))
        out[k] = torch.stack([evs_low[i][k] for i in live]).amax(0) \
            if live else torch.zeros_like(first[k])
    for h in sketch.HISTS:
        out[f"hist_{h}"] = hist[h]
    # the heavy-hitter table: the flows of the largest estimates
    live = sorted(set(sequence))
    uid = torch.cat([ids[i] for i in live])
    h1 = torch.cat([evs_low[i]["rows"]["h1"] for i in live])
    h2 = torch.cat([evs_low[i]["rows"]["h2"] for i in live])
    words = torch.cat([evs_low[i]["rows"]["words"] for i in live])
    first_row = torch.full((int(uid.max()) + 1,), -1, dtype=torch.int64,
                           device=device)
    first_row[uid] = torch.arange(len(uid), device=device)
    rows = first_row[first_row >= 0]
    est = sketch.cm_estimate(out["cm_bytes"].to(torch.float32), h1[rows],
                             h2[rows], geo)
    top = torch.topk(est, min(topk, len(rows))).indices
    n = len(top)
    heavy_words = torch.zeros((topk, 10), dtype=torch.int64, device=device)
    heavy_words[:n] = words[rows[top]]
    counts = torch.zeros(topk, dtype=torch.float32, device=device)
    counts[:n] = est[top]
    valid = torch.zeros(topk, dtype=torch.bool, device=device)
    valid[:n] = True
    tables = {k: v.to(torch.float32).cpu().numpy() if v.is_floating_point()
              else v.cpu().numpy() for k, v in out.items()}
    tables["hll_per_dst"] = tables["hll_per_dst"].reshape(
        geo.perdst_buckets, -1)
    tables["hll_per_src"] = tables["hll_per_src"].reshape(
        geo.persrc_buckets, -1)
    tables.update(heavy_words=heavy_words.cpu().numpy().astype(np.uint32),
                  heavy_counts=counts.cpu().numpy(),
                  heavy_valid=valid.cpu().numpy())
    return tables


def readings(mix: dict, config: dict, seed: int, window_evictions: int,
             windows: int, device, dtypes: dict) -> dict[str, float]:
    """The judge's numbers for the control over `windows` windows of
    `window_evictions` evictions each, the pool handed as a run hands it."""
    from portbench import generator
    pool = generator.make_pool(mix, seed, dtypes)
    geo = sketch.Geometry.from_dict(config["geometry"])
    feed = config["env"].get("SKETCH_FEED", "resident")
    topk = int(config["env"].get("SKETCH_TOPK", "1024"))
    ref, low, ids = [], [], []
    for i in range(len(pool)):
        cols = sketch.columns(pool.events[i], pool.lanes[i])
        ids.append(torch.as_tensor(pool.flow_ids[i], device=device))
        ref.append((sketch.eviction_tables(cols, geo, feed, device), ids[-1],
                    len(pool.events[i])))
        low.append(sketch.eviction_tables(cols, geo, feed, device,
                                          dtype=torch.bfloat16))
    seq = generator.hand_order(mix, seed)[:windows * window_evictions]
    seq = seq.tolist()
    wins = []
    for w in range(windows):
        part = seq[w * window_evictions:(w + 1) * window_evictions]
        wins.append({"window": w, "report": None, "tables": window_tables(
            low, ids, part, geo, topk, device)})
    return judge.judge(geo, ref, seq, wins, device)
