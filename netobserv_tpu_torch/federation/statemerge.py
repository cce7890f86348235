"""In-place merge of one decoded delta frame's tables into a SketchState.

Counterpart of `netobserv_tpu/federation/statemerge.py` (`merge_tables`).
The aggregate is a wide `SketchState` fed by table deltas instead of flow
records: every structure merges by its own operator (Count-Min planes,
histograms, rates and totals add, HLL registers take the max, the heavy
table concatenates and re-scores against the merged Count-Min), so the
window roll (`sketch/state.roll_window`) and the report renderer serve the
cluster-wide report unchanged. The reference returns a new state (JAX
donated the old one); here every table is written in place, and the
function's shapes depend on the geometry only, so the aggregator captures
it as one CUDA graph (`federation/aggregator.py`).
"""

from __future__ import annotations

import torch

from netobserv_tpu_torch.ops import countmin, hll, quantile, topk
from netobserv_tpu_torch.sketch import state as sk

#: the window totals of the `scalars` tensor, in SCALAR_FIELDS order
_SCALARS = ("total_records", "total_bytes", "total_drop_bytes",
            "total_drop_packets", "quic_records", "nat_records",
            "heavy_evictions")


def merge_tables(state: sk.SketchState, t: dict, query_fn=None,
                 candidate_valid=None) -> sk.SketchState:
    """Merge one agent's delta tables `t` (`federation.delta.TABLE_SPEC`
    names, tensors on the state's device, uint32 lanes in int64,
    `heavy_valid` any integer or bool) into `state` in place; returns it.

    `query_fn(h1, h2) -> est` overrides the plain CM point query of the
    top-K re-score (owner-sharded meshes); `candidate_valid` additionally
    masks which delta candidates this shard may adopt (key ownership).
    EWMA baselines (mean/var) are untouched: the aggregator rolls its own
    cluster-level baselines over the merged per-window rates."""
    if not isinstance(state, sk.SketchState):
        raise TypeError("merge_tables merges into a wide SketchState")
    countmin.merge_(state.cm_bytes, t["cm_bytes"])
    countmin.merge_(state.cm_pkts, t["cm_pkts"])
    d_valid = t["heavy_valid"] != 0
    if candidate_valid is not None:
        d_valid = d_valid & candidate_valid
    # persistent-slot merge: aggregate table + delta table concatenated,
    # duplicate identities collapse (prev_counts sum, first_seen min,
    # epoch max), counts re-score against the merged CM; v1/v2 frames
    # reach here with zeroed churn tensors (delta.upgrade_tables)
    h = state.heavy
    stacked = topk.SlotTable(
        words=torch.cat([h.words, t["heavy_words"]]),
        h1=torch.cat([h.h1, t["heavy_h1"]]),
        h2=torch.cat([h.h2, t["heavy_h2"]]),
        counts=torch.cat([h.counts, t["heavy_counts"]]),
        prev_counts=torch.cat([h.prev_counts, t["heavy_prev_counts"]]),
        first_seen=torch.cat([h.first_seen, t["heavy_first_seen"]]),
        epoch=torch.cat([h.epoch, t["heavy_epoch"]]),
        valid=torch.cat([h.valid, d_valid]))
    sk.copy_state_(h, topk.merge_slot_tables(stacked, state.cm_bytes, h.k,
                                             query_fn=query_fn))
    hll.merge_regs_(state.hll_src.regs, t["hll_src"])
    hll.merge_regs_(state.hll_per_dst.regs, t["hll_per_dst"])
    hll.merge_regs_(state.hll_per_src.regs, t["hll_per_src"])
    quantile.merge_(state.hist_rtt, t["hist_rtt"])
    quantile.merge_(state.hist_dns, t["hist_dns"])
    state.ddos.rate.add_(t["ddos_rate"])
    state.syn.rate.add_(t["syn_rate"])
    state.drops_ewma.rate.add_(t["drops_rate"])
    for name in ("synack", "drop_causes", "dscp_bytes", "conv_fwd",
                 "conv_rev"):
        getattr(state, name).add_(t[name])
    scalars = t["scalars"]
    for i, name in enumerate(_SCALARS):
        getattr(state, name).add_(scalars[i])
    return state
