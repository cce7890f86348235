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

`TableStack` holds table snapshots on the device for such a merge: the
aggregator's frame buffer (one snapshot) and the archive's merge ladder
(`archive/query.py`, `ladder_max` snapshots) share its layout.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from netobserv_tpu_torch.federation.delta import TABLE_SPEC
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


class TableStack:
    """`n` table snapshots of `shapes` (TABLE_SPEC names) in one flat
    int32 device buffer, every table at its spec dtype's bits, snapshot i
    at words [i * words, (i + 1) * words), and a host twin of the same
    layout, pinned on CUDA. uint32 lanes cross as their int32 bits and
    widen to the port's int64 lanes on the device, once, here
    (`device_tables`, `write_`)."""

    def __init__(self, shapes: Mapping[str, tuple], n: int,
                 device: torch.device):
        layout, off = [], 0
        for name, dt in TABLE_SPEC:
            shape = tuple(shapes[name])
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            layout.append((name, dt, shape, off, size))
            off += size
        self.layout = layout
        self.words = off
        self.n = n
        cuda = device.type == "cuda"
        self.host = torch.zeros(n * off, dtype=torch.int32, pin_memory=cuda)
        self.dev = torch.zeros(n * off, dtype=torch.int32, device=device)

    def host_views(self, i: int = 0) -> dict[str, np.ndarray]:
        """Snapshot i of the host twin as spec-dtype numpy views."""
        host = self.host.numpy()[i * self.words:(i + 1) * self.words]
        return {name: host[o:o + size].view(dt).reshape(shape)
                for name, dt, shape, o, size in self.layout}

    def device_tables(self, buf: torch.Tensor, i: int = 0) -> dict:
        """Snapshot i of `buf` (this layout's device buffer or a prefix of
        it) as the tables `merge_tables` takes: views, uint32 lanes widened
        to int64."""
        base = i * self.words
        out = {}
        for name, dt, shape, o, size in self.layout:
            v = buf[base + o:base + o + size]
            if dt == "<f4":
                v = v.view(torch.float32)
            elif dt == "<u4":
                v = v.to(torch.int64) & 0xFFFFFFFF
            out[name] = v.view(shape)
        return out

    def write_(self, buf: torch.Tensor, tables: Mapping[str, torch.Tensor],
               i: int = 0) -> None:
        """Write device tables in the port's dtypes (`sketch.state.
        table_tensors`) into snapshot i of `buf` at their spec dtype's
        bits, in place."""
        base = i * self.words
        for name, dt, shape, o, size in self.layout:
            v = buf[base + o:base + o + size].view(shape)
            t = tables[name]
            if dt == "<f4":
                v.view(torch.float32).copy_(t)
            elif dt == "<u4":
                # the low 32 bits as int32: values at or past 2^31 wrap
                t = t.to(torch.int64)
                v.copy_(torch.where(t >= 1 << 31, t - (1 << 32), t))
            else:
                v.copy_(t)
