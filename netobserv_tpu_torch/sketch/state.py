"""Combined sketch state, the ingest step and the window roll.

Counterpart of `netobserv_tpu/sketch/state.py` (`SketchConfig`,
`SketchState`, `WindowReport`, `init_state`, `batch_to_device`,
`dense_to_arrays`, `arrays_to_dense`, `tiered_fold_form`, `ingest`,
`decay_state`, `roll_window` (its mode step `roll_tables_`),
`state_tables`, `copy_state_` and
`host_cm_planes` (the query plane's staged copy and the CM planes of its
snapshots, `exporter/tpu_sketch.py:1881-1939`), the compact feed's
`COMPACT_WORDS` and `compact_to_arrays` with the ingest of
`make_ingest_compact_fn` (`:709-770`), and the resident feed's
`init_key_table`, `resident_to_arrays`, `init_key_tables`,
`_resident_region_words`, `resident_lane_arrays` and the ingests of
`make_ingest_resident_fn` and `make_ingest_resident_lanes_fn`
(`:773-965`)), on one device.

One `ingest` call folds a fixed-shape columnar flow batch into the Count-Min
planes (kernel 1), the persistent-slot top-K table (kernel 2), the global
source HLL (kernel 3) and the per-dst and per-src HLL grids (kernel 8, the
three folds in one launch of their shared body), the RTT and DNS
histograms, the signal planes (kernel 4) and the window totals. On CUDA
tensors each goes through its hand-written kernel; on CPU tensors through
its plain PyTorch twin. Where JAX donated the state, this
module updates the preallocated tensors in place: `ingest`, `decay_state`
and `roll_window` mutate the state they are given and return it.

With `SketchConfig.tiered` set (a `tiered.TierSpec`) the state is a
`tiered.TieredState`: the CM planes and HLL banks stay resident narrow.
Where the width tiles (`countmin_kernel.tiered_eligible`) and kernel 6
can launch at the depth and width (`countmin_kernel.tier2_fits`), the fold
is tier-interior: kernel 6 folds the CM tiers directly and hands the slot
table its estimate, kernel 7 folds the packed global HLL bank with the
signal planes (where `signal_kernel.eligible` and `hll_fusible` hold),
and only the per-bucket HLL grids unpack. Otherwise the fold decodes the
tiers to wide, runs the wide fold, and promotes the delta back. Rolls and
`state_tables` see the decoded wide tables, as in the reference.

Three host feeds reach `ingest`. The dense feed (`dense_to_arrays`) ships
20 words per record. The compact feed (`compact_to_arrays`,
`ingest_compact`) ships 10 words per v4 record and a dense spill lane for
the rest. The resident feed (`resident_to_arrays`, `ingest_resident`) ships
a 3-word hot row naming its key by a slot of a device key table
(`init_key_table`), sparse DNS and drop lanes, a new-key lane that defines
slots, and a full-width spill lane; split into lanes
(`resident_lane_arrays`, `ingest_resident_lanes`), each region has a key
table of its own, a row of `init_key_tables`. The host side is
`datapath/flowpack` (`pack_dense`, `pack_compact`, `pack_resident`).

Each ingest entry (`ingest`, `ingest_compact`, `ingest_resident`,
`ingest_resident_lanes`, and so the tiered form) first calls
`check_fold_shapes`, which raises for a fold that a kernel of the path
cannot hold, before the first in-place update of a table or a key table:
the reference's jitted ingest folds a batch whole or not at all, and an
eager ingest that raised midway would leave its tables partly folded.

`SketchConfig.from_agent_config` is a copy of the reference's
(`:70-87`) without `use_pallas`: on CUDA the port always folds through
its kernels. It reads SKETCH_USE_PALLAS, which selects nothing here, and
logs a warning once when it asks for no kernels.

The owner-sharded ingest of a mesh's sketch axis (`sketch_shard=(index,
n_shards)`, the reference's `sketch_axis` branch, `:470-490`): the
Count-Min folds are `countmin.update_sharded` (kernel 5 on CUDA, once a
plane) into the shard's local width, and the slot table ranks on
`countmin.query_sharded_local`, so each sketch shard tracks the keys it
owns. The HLL and signal folds keep the kernels of the whole-width fold;
they compute the same function as the reference's scatter forms there. A
tiered state has no sharded form and raises NotImplementedError, as the
reference's does (`:358-362`).
"""

from __future__ import annotations

import logging
from typing import Mapping, NamedTuple

import numpy as np
import torch

from netobserv_tpu_torch.datapath.flowpack import (
    COMPACT_WORDS, DENSE_WORDS, HOT_WORDS, NK_WORDS, RESIDENT_HDR,
    V4_PREFIX_WORD2, ResidentCaps, resident_buf_len,
)
from netobserv_tpu_torch.model.columnar import KEY_WORDS
from netobserv_tpu_torch.model.flow import TcpFlags
from netobserv_tpu_torch.ops import countmin, ewma, hashing, hll, quantile, topk
from netobserv_tpu_torch.ops.kernels import (
    countmin_kernel, hll_kernel, signal_kernel,
)
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.utils.platform import pick_device

log = logging.getLogger("netobserv_tpu_torch.sketch.state")
#: whether the SKETCH_USE_PALLAS warning was logged (once a process)
_use_pallas_warned = False

class SketchConfig(NamedTuple):
    cm_depth: int = 4
    cm_width: int = 1 << 16
    hll_precision: int = 14
    perdst_buckets: int = 4096
    perdst_precision: int = 6
    persrc_buckets: int = 4096
    persrc_precision: int = 6
    topk: int = 1024
    hist_buckets: int = 1024
    ewma_buckets: int = 4096
    ewma_alpha: float = 0.3
    #: False skips the per-source fan-out grid fold (port-scan signal)
    enable_fanout: bool = True
    #: False skips the conversation-asymmetry fold (one-way detection)
    enable_asym: bool = True
    #: tiered counter planes (SKETCH_TIERED): a tiered.TierSpec keeps the
    #: CM planes and HLL banks resident narrow; None keeps them wide
    tiered: tiered.TierSpec | None = None

    @classmethod
    def from_agent_config(cls, cfg) -> "SketchConfig":
        """The geometry of an `AgentConfig` (`config.py`): SKETCH_CM_DEPTH,
        SKETCH_CM_WIDTH, SKETCH_HLL_PRECISION, SKETCH_TOPK,
        SKETCH_EWMA_ALPHA and, with SKETCH_TIERED, the tier geometry."""
        global _use_pallas_warned
        raw = str(cfg.sketch_use_pallas).strip().lower()
        if raw not in ("auto", "", "1", "true", "yes", "on") \
                and not _use_pallas_warned:
            _use_pallas_warned = True
            log.warning("SKETCH_USE_PALLAS=%s selects nothing in the port: "
                        "on CUDA every fold runs its CUDA kernels",
                        cfg.sketch_use_pallas)
        tiers = None
        if getattr(cfg, "sketch_tiered", False):
            tiers = tiered.TierSpec(
                mid_group=cfg.sketch_tier_mid_group,
                top_group=cfg.sketch_tier_top_group,
                bytes_unit=cfg.sketch_tier_bytes_unit)
        return cls(cm_depth=cfg.sketch_cm_depth, cm_width=cfg.sketch_cm_width,
                   hll_precision=cfg.sketch_hll_precision,
                   topk=cfg.sketch_topk, ewma_alpha=cfg.sketch_ewma_alpha,
                   tiered=tiers)


class SketchState(NamedTuple):
    cm_bytes: countmin.CountMin
    cm_pkts: countmin.CountMin
    heavy: topk.SlotTable
    hll_src: hll.HLL
    hll_per_dst: hll.PerDstHLL
    hll_per_src: hll.PerDstHLL
    hist_rtt: quantile.LogHist
    hist_dns: quantile.LogHist
    ddos: ewma.EWMA
    syn: ewma.EWMA
    synack: torch.Tensor          # f32[m] current-window SYN-ACK responses
    drops_ewma: ewma.EWMA
    drop_causes: torch.Tensor     # f32[N_DROP_CAUSES]
    dscp_bytes: torch.Tensor      # f32[N_DSCP]
    conv_fwd: torch.Tensor        # f32[m] bytes toward the canonical dir
    conv_rev: torch.Tensor        # f32[m]
    total_records: torch.Tensor   # f32[]
    total_bytes: torch.Tensor
    total_drop_bytes: torch.Tensor
    total_drop_packets: torch.Tensor
    quic_records: torch.Tensor
    nat_records: torch.Tensor
    heavy_evictions: torch.Tensor
    window: torch.Tensor          # i32[]


class WindowReport(NamedTuple):
    """Snapshot emitted at each window roll (tensors on the state's device,
    copies that later folds do not touch)."""

    heavy: topk.SlotTable
    distinct_src: torch.Tensor
    per_dst_cardinality: torch.Tensor
    per_src_fanout: torch.Tensor
    rtt_quantiles_us: torch.Tensor
    dns_quantiles_us: torch.Tensor
    ddos_z: torch.Tensor
    syn_z: torch.Tensor
    syn_rate: torch.Tensor
    synack_rate: torch.Tensor
    drop_z: torch.Tensor
    drop_causes: torch.Tensor
    dscp_bytes: torch.Tensor
    conv_fwd: torch.Tensor
    conv_rev: torch.Tensor
    total_records: torch.Tensor
    total_bytes: torch.Tensor
    total_drop_bytes: torch.Tensor
    total_drop_packets: torch.Tensor
    quic_records: torch.Tensor
    nat_records: torch.Tensor
    heavy_evictions: torch.Tensor
    window: torch.Tensor


QS = (0.5, 0.9, 0.95, 0.99, 0.999)
#: drop-cause histogram size; causes clamp to the last bucket
N_DROP_CAUSES = 128
#: DSCP class histogram size (6-bit code space)
N_DSCP = 64

_SCALARS = ("total_records", "total_bytes", "total_drop_bytes",
            "total_drop_packets", "quic_records", "nat_records",
            "heavy_evictions")


def init_state(cfg: SketchConfig = SketchConfig(),
               device: str | torch.device | None = None) -> SketchState:
    """A zero state on `device` (CUDA unless the caller names the CPU); a
    TieredState when `cfg.tiered` is set."""
    if cfg.tiered is not None:
        # from zeros the encode is exact; everything downstream branches on
        # the state's type
        cfg.tiered.check(cfg.cm_width)
        return tiered.encode_state(
            init_state(cfg._replace(tiered=None), device), cfg.tiered)
    dev = pick_device(device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SketchState(
        cm_bytes=countmin.init(cfg.cm_depth, cfg.cm_width, dev),
        cm_pkts=countmin.init(cfg.cm_depth, cfg.cm_width, dev),
        heavy=topk.init_slots(cfg.topk, KEY_WORDS, dev),
        hll_src=hll.init(cfg.hll_precision, dev),
        hll_per_dst=hll.init_per_dst(cfg.perdst_buckets,
                                     cfg.perdst_precision, dev),
        hll_per_src=hll.init_per_dst(cfg.persrc_buckets,
                                     cfg.persrc_precision, dev),
        hist_rtt=quantile.init(cfg.hist_buckets, dev),
        hist_dns=quantile.init(cfg.hist_buckets, dev),
        ddos=ewma.init(cfg.ewma_buckets, dev),
        syn=ewma.init(cfg.ewma_buckets, dev),
        synack=zeros(cfg.ewma_buckets),
        drops_ewma=ewma.init(cfg.ewma_buckets, dev),
        drop_causes=zeros(N_DROP_CAUSES),
        dscp_bytes=zeros(N_DSCP),
        conv_fwd=zeros(cfg.ewma_buckets),
        conv_rev=zeros(cfg.ewma_buckets),
        **{name: zeros() for name in _SCALARS},
        window=zeros(dtype=torch.int32),
    )


#: ingest dtype of every column a batch may carry (uint32 lanes as int64)
_COLUMN_DTYPES = {
    "keys": torch.int64, "bytes": torch.float32, "packets": torch.int32,
    "rtt_us": torch.int32, "dns_latency_us": torch.int32,
    "valid": torch.bool, "sampling": torch.int32, "tcp_flags": torch.int32,
    "dscp": torch.int32, "markers": torch.int32, "drop_bytes": torch.int32,
    "drop_packets": torch.int32, "drop_cause": torch.int32,
}


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: str | torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
    """Put a host batch (column name -> numpy array) on `device` with the
    dtypes `ingest` expects. Columns `ingest` does not read are dropped."""
    dev = pick_device(device)
    out = {}
    for name, dtype in _COLUMN_DTYPES.items():
        if name in batch:
            arr = np.asarray(batch[name])
            if name == "keys":
                arr = arr.astype(np.uint32).astype(np.int64)
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=dev, dtype=dtype)
    return out


def dense_to_arrays(dense: torch.Tensor) -> dict[str, torch.Tensor]:
    """Device-side unpack of the dense feed: int32 words holding the uint32
    bits of (B, 20) rows, flat (B*20,) or 2-D. Row layout as in flowpack.cc
    fp_pack_dense; word 10 is the f32 bit pattern of the byte count."""
    if dense.dtype != torch.int32:
        raise TypeError(f"dense feed must be int32 words, got {dense.dtype}")
    if dense.ndim == 1:
        dense = dense.reshape(-1, DENSE_WORDS)
    f16, f17 = dense[:, 16], dense[:, 17]
    return {
        "keys": dense[:, :KEY_WORDS].to(torch.int64) & hashing.M32,
        "bytes": dense[:, 10].contiguous().view(torch.float32),
        "packets": dense[:, 11],
        "rtt_us": dense[:, 12],
        "dns_latency_us": dense[:, 13],
        "valid": dense[:, 14] != 0,
        "sampling": dense[:, 15],
        "tcp_flags": f16 & 0xFFFF,
        "dscp": (f16 >> 16) & 0xFF,
        "markers": (f16 >> 24) & 0xFF,
        "drop_bytes": f17 & 0xFFFF,
        "drop_packets": (f17 >> 16) & 0xFFFF,
        "drop_cause": dense[:, 18] & 0xFFFF,
    }


def arrays_to_dense(arrays: Mapping[str, np.ndarray]) -> np.ndarray:
    """Host-side inverse of dense_to_arrays: pack an array dict into the
    flat uint32 dense feed. Absent feature columns pack as zero; the 16-bit
    drop lanes saturate."""
    n = len(arrays["valid"])
    zeros = np.zeros(n, np.uint32)

    def col(name):
        return np.asarray(arrays.get(name, zeros), np.uint32)

    dense = np.zeros((n, DENSE_WORDS), np.uint32)
    dense[:, :KEY_WORDS] = arrays["keys"]
    dense[:, 10] = np.asarray(arrays["bytes"], np.float32).view(np.uint32)
    dense[:, 11] = arrays["packets"]
    dense[:, 12] = arrays["rtt_us"]
    dense[:, 13] = arrays["dns_latency_us"]
    dense[:, 14] = np.asarray(arrays["valid"], np.uint32)
    dense[:, 15] = col("sampling")
    dense[:, 16] = ((col("tcp_flags") & 0xFFFF) | (col("dscp") << 16)
                    | (col("markers") << 24))
    dense[:, 17] = (np.minimum(col("drop_bytes"), 0xFFFF)
                    | (np.minimum(col("drop_packets"), 0xFFFF) << 16))
    dense[:, 18] = np.minimum(col("drop_cause"), 0xFFFF)
    return dense.reshape(-1)


def compact_to_arrays(flat: torch.Tensor, batch_size: int,
                      spill_cap: int) -> dict[str, torch.Tensor]:
    """Device-side unpack of the compact feed: int32 words holding the
    uint32 bits of a flat `[batch_size * 10 v4 rows | spill_cap * 20 dense
    rows]` buffer (`flowpack.pack_compact`). Rebuilds each v4 row's 10-word
    v4-mapped key from its 4 words and appends the spill lane's rows, so the
    arrays have batch_size + spill_cap rows for `ingest`. The drop columns
    of the v4 rows are zero: rows with drop data ride the spill lane. Every
    right shift whose top bit can be set is masked."""
    if flat.dtype != torch.int32:
        raise TypeError(f"compact feed must be int32 words, got {flat.dtype}")
    if flat.shape != (batch_size * COMPACT_WORDS + spill_cap * DENSE_WORDS,):
        raise ValueError(f"compact feed of {tuple(flat.shape)} words, "
                         f"expected {batch_size} v4 and {spill_cap} spill "
                         "rows")
    c = flat[:batch_size * COMPACT_WORDS].reshape(batch_size, COMPACT_WORDS)
    spill = dense_to_arrays(flat[batch_size * COMPACT_WORDS:])
    c64 = c.to(torch.int64) & hashing.M32
    zeros = torch.zeros(batch_size, dtype=torch.int64, device=flat.device)
    prefix = torch.full_like(zeros, V4_PREFIX_WORD2)
    keys = torch.stack([zeros, zeros, prefix, c64[:, 0],
                        zeros, zeros, prefix, c64[:, 1],
                        c64[:, 2], c64[:, 3] & 0x00FFFFFF], dim=1)
    izeros = torch.zeros(batch_size, dtype=torch.int32, device=flat.device)
    w9 = c[:, 9]
    comp = {
        "keys": keys,
        "bytes": c[:, 4].contiguous().view(torch.float32),
        "packets": c[:, 5],
        "rtt_us": c[:, 6],
        "dns_latency_us": c[:, 7],
        "valid": (c[:, 3] >> 31) != 0,
        "sampling": c[:, 8],
        "tcp_flags": w9 & 0xFFFF,
        "dscp": (w9 >> 16) & 0xFF,
        "markers": (w9 >> 24) & 0xFF,
        "drop_bytes": izeros,
        "drop_packets": izeros,
        "drop_cause": izeros,
    }
    return {k: torch.cat([v, spill[k]]) for k, v in comp.items()}


def ingest_compact(state: SketchState, flat: torch.Tensor, batch_size: int,
                   spill_cap: int, enable_fanout: bool = True,
                   enable_asym: bool = True) -> SketchState:
    """Fold one compact-feed buffer: `compact_to_arrays`, then `ingest`.
    The counterpart of the function `make_ingest_compact_fn` builds;
    returns `state`, updated in place."""
    check_fold_shapes(state, batch_size + spill_cap)
    return ingest(state, compact_to_arrays(flat, batch_size, spill_cap),
                  enable_fanout=enable_fanout, enable_asym=enable_asym)


def init_key_table(slot_cap: int,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Device twin of the host `KeyDict`: the key words of each slot as
    int32 bits, (slot_cap + 1, KEY_WORDS), updated from the new-key lane
    and gathered by hot-row slot id. The last row is a sink that takes the
    undefined new-key rows, so the update needs no mask. Auxiliary state,
    not part of the sketch state: rolls leave it alone."""
    return torch.zeros((slot_cap + 1, KEY_WORDS), dtype=torch.int32,
                       device=pick_device(device))


def init_key_tables(n_lanes: int, slot_cap: int,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
    """Key tables of the lane-sharded resident feed, one a region:
    (n_lanes, slot_cap + 1, KEY_WORDS) int32, each row an `init_key_table`
    with its own sink row. The reference's is (n_lanes, slot_cap,
    KEY_WORDS) u32 (`sketch/carry` converts)."""
    return torch.zeros((n_lanes, slot_cap + 1, KEY_WORDS), dtype=torch.int32,
                       device=pick_device(device))


def _resident_region_words(batch_size: int, caps: ResidentCaps) -> int:
    """Flat word count of one resident region: the layout twin of
    `flowpack.resident_buf_len`."""
    return (RESIDENT_HDR + batch_size * HOT_WORDS + caps.dns + caps.drop * 2
            + caps.nk * NK_WORDS + caps.spill * DENSE_WORDS)


def _row_index(local: torch.Tensor, base: torch.Tensor, n_b: int,
               rows: int) -> torch.Tensor:
    """Flat row of each sparse-lane entry: its region's base plus its row
    in the region, or `rows` (a sink row, cut off) for a row at or past
    n_b, which the reference's mode="drop" scatter drops."""
    return torch.where(local < n_b, local + base, rows).reshape(-1).to(
        torch.int64)


def _scatter_rows(rows: int, idx: torch.Tensor, vals: torch.Tensor,
                  reduce: str) -> torch.Tensor:
    """Scatter `vals` onto `rows` zero rows at `idx` (`_row_index`), by sum
    ("sum") or max ("amax")."""
    out = torch.zeros(rows + 1, dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        out.index_add_(0, idx, vals)
    else:
        out.scatter_reduce_(0, idx, vals, reduce)
    return out[:rows]


def resident_lane_arrays(flat: torch.Tensor, key_tables: torch.Tensor,
                         batch_per_lane: int, caps: ResidentCaps,
                         n_lanes: int
                         ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Device-side unpack of `n_lanes` concatenated resident regions, each
    against its own key table (row i of `key_tables`, which may hold more
    rows: the superbatch ladder's entries share one table array sized for
    the largest), into one array dict for `ingest`: region 0's hot rows and
    spill rows, then region 1's, and so on, n_lanes * (batch_per_lane +
    caps.spill) rows. Returns (arrays, key_tables).

    Every region's new-key lane is written into `key_tables` in place, in
    one `index_put_`, before any hot row is gathered: a slot a hot row
    references may be defined by the same region, and regions are
    row-disjoint (undefined new-key rows go to the region's sink row). The
    regions have one shape, so each step runs once over all of them. The
    words are uint32 held in int32: every right shift whose top bit can be
    set is masked."""
    words = _resident_region_words(batch_per_lane, caps)
    if flat.dtype != torch.int32:
        raise TypeError(f"resident feed must be int32 words, got {flat.dtype}")
    if flat.shape != (n_lanes * words,):
        raise ValueError(f"resident feed of {tuple(flat.shape)} words, "
                         f"expected {n_lanes} regions of {words}")
    if (key_tables.ndim != 3 or key_tables.shape[0] < n_lanes
            or key_tables.shape[2] != KEY_WORDS):
        raise ValueError(f"key tables {tuple(key_tables.shape)} for "
                         f"{n_lanes} regions")
    n_b, dev = batch_per_lane, flat.device
    hot_off = RESIDENT_HDR
    dns_off = hot_off + n_b * HOT_WORDS
    drop_off = dns_off + caps.dns
    nk_off = drop_off + caps.drop * 2
    spill_off = nk_off + caps.nk * NK_WORDS
    reg = flat.reshape(n_lanes, words)
    hot = reg[:, hot_off:dns_off].reshape(n_lanes, n_b, HOT_WORDS)
    dnsl = reg[:, dns_off:drop_off]
    dropl = reg[:, drop_off:nk_off].reshape(n_lanes, caps.drop, 2)
    nk = reg[:, nk_off:spill_off].reshape(n_lanes, caps.nk, NK_WORDS)
    spill = dense_to_arrays(reg[:, spill_off:].reshape(-1, DENSE_WORDS))

    # the defined bit is bit 31: `>> 31` of int32 gives -1 or 0
    sink = key_tables.shape[1] - 1
    nk_slot = torch.where((nk[:, :, 0] >> 31) != 0, nk[:, :, 0] & 0xFFFFF,
                          sink).to(torch.int64)
    lane = torch.arange(n_lanes, device=dev).unsqueeze(1)
    key_tables.index_put_((lane.expand(-1, caps.nk).reshape(-1),
                           nk_slot.reshape(-1)),
                          nk[:, :, 1:].reshape(-1, KEY_WORDS))
    w0 = hot[:, :, 0]
    keys = key_tables[lane, (w0 & 0xFFFFF).to(torch.int64)]
    rtt = ((w0 >> 20) & 0xFF) << (2 * ((w0 >> 28) & 0x7))
    w2 = hot[:, :, 2]
    # sparse lanes, by row of the flattened regions: unused entries are
    # all-zero, so they add 0 to (and max 0 into) their region's row 0
    base = lane * n_b
    rows = n_lanes * n_b
    d_idx = _row_index((dnsl >> 16) & 0xFFFF, base, n_b, rows)
    d_val = ((dnsl & 0xFFF) << ((dnsl >> 12) & 0xF)).reshape(-1)
    r_idx = _row_index((dropl[:, :, 0] >> 16) & 0xFFFF, base, n_b, rows)
    dw = dropl[:, :, 1].reshape(-1)
    comp = {
        "keys": keys.to(torch.int64) & hashing.M32,
        "bytes": hot[:, :, 1].contiguous().view(torch.float32),
        "packets": w2 & 0x7FF,
        "rtt_us": rtt,
        "dns_latency_us": _scatter_rows(rows, d_idx, d_val, "sum"),
        "valid": (w0 >> 31) != 0,
        "sampling": reg[:, :1].expand(n_lanes, n_b),
        "tcp_flags": (w2 >> 11) & 0x7FF,
        "dscp": (w2 >> 22) & 0x3F,
        "markers": (w2 >> 28) & 0xF,
        "drop_bytes": _scatter_rows(rows, r_idx, dw & 0xFFFF, "sum"),
        "drop_packets": _scatter_rows(rows, r_idx, (dw >> 16) & 0xFFFF,
                                      "sum"),
        # the cause is a value, not a count: max, as the reference
        # scatters it
        "drop_cause": _scatter_rows(
            rows, r_idx, (dropl[:, :, 0] & 0xFFFF).reshape(-1), "amax"),
    }
    arrays = {}
    for k, v in comp.items():
        v = v.reshape(n_lanes, n_b, *v.shape[2:])
        s = spill[k].reshape(n_lanes, caps.spill, *v.shape[2:])
        arrays[k] = torch.cat([v, s], dim=1).reshape(-1, *v.shape[2:])
    return arrays, key_tables


def resident_to_arrays(flat: torch.Tensor, key_table: torch.Tensor,
                       batch_size: int, caps: ResidentCaps
                       ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Device-side unpack of one resident region: int32 words holding the
    uint32 bits of a `flowpack.pack_resident` buffer, against one key table
    (`init_key_table`), as `resident_lane_arrays` unpacks a region.

    Writes the new-key lane into `key_table` in place first, then gathers
    the 10-word keys by slot id, decodes the range-coded rtt and DNS codes,
    scatters the sparse DNS and drop lanes onto their rows, and appends the
    spill lane's rows. Returns (arrays for `ingest`, key_table); the arrays
    have batch_size + caps.spill rows, the hot lane's then the spill
    lane's."""
    if flat.dtype == torch.int32 and flat.shape != (
            resident_buf_len(batch_size, caps),):
        raise ValueError(f"resident region of {tuple(flat.shape)} words, "
                         f"expected {resident_buf_len(batch_size, caps)}")
    arrays, _ = resident_lane_arrays(flat, key_table.unsqueeze(0), batch_size,
                                     caps, 1)
    return arrays, key_table


def ingest_resident(state: SketchState, key_table: torch.Tensor,
                    flat: torch.Tensor, batch_size: int, caps: ResidentCaps,
                    enable_fanout: bool = True,
                    enable_asym: bool = True) -> SketchState:
    """Fold one resident region: `resident_to_arrays` (which updates
    `key_table` in place), then `ingest`. The counterpart of the function
    `make_ingest_resident_fn` builds; returns `state`, updated in place."""
    check_fold_shapes(state, batch_size + caps.spill)
    arrays, _ = resident_to_arrays(flat, key_table, batch_size, caps)
    return ingest(state, arrays, enable_fanout=enable_fanout,
                  enable_asym=enable_asym)


def ingest_resident_lanes(state: SketchState, key_tables: torch.Tensor,
                          flat: torch.Tensor, batch_per_lane: int,
                          caps: ResidentCaps, n_lanes: int,
                          enable_fanout: bool = True,
                          enable_asym: bool = True,
                          sketch_shard: tuple[int, int] | None = None
                          ) -> SketchState:
    """Fold `n_lanes` resident regions in one ingest:
    `resident_lane_arrays` (which updates `key_tables` in place), then
    `ingest` (`sketch_shard` as there). The counterpart of the function
    `make_ingest_resident_lanes_fn` builds, and of one shard's step of
    `parallel/merge.make_sharded_ingest_resident_fn`; returns `state`,
    updated in place."""
    check_fold_shapes(state, n_lanes * (batch_per_lane + caps.spill))
    arrays, _ = resident_lane_arrays(flat, key_tables, batch_per_lane, caps,
                                     n_lanes)
    return ingest(state, arrays, sketch_shard=sketch_shard,
                  enable_fanout=enable_fanout, enable_asym=enable_asym)


def _interior(depth: int, width: int, spec: tiered.TierSpec) -> bool:
    """The tier-interior gate: the reference's (`tiered_eligible`), and a
    shape kernel 6 can launch (`tier2_fits`)."""
    return (countmin_kernel.tiered_eligible(width, spec)
            and countmin_kernel.tier2_fits(depth, width, spec))


def tiered_fold_form(cfg: SketchConfig) -> str | None:
    """Which fold a tiered state under `cfg` takes: "interior" (kernels 6
    and 7 on the tiers), "decode" (decode to wide, wide fold, promote), or
    None when tiers are off. The gate is static and the same on CUDA and
    the CPU, where the kernels' plain twins run the interior form."""
    if cfg.tiered is None:
        return None
    if _interior(cfg.cm_depth, cfg.cm_width, cfg.tiered):
        return "interior"
    return "decode"


def _pow2(x: int) -> bool:
    return x > 0 and not x & (x - 1)


def check_fold_shapes(state, n: int) -> None:
    """Raise ValueError where a kernel of the fold path cannot fold n rows
    into `state`, before any table changes: the wrappers' shape gates,
    checked here on CUDA and the CPU alike. Count-Min planes: kernel 1's
    `countmin_kernel.fold_fits` (the decode form's wide fold too); the
    tier-interior form: kernel 6's power-of-two geometry and int32 bin
    entries (its tiles already passed `tier2_fits` in the form's gate);
    the HLL folds launch: power-of-two grids of at most 2^31 registers;
    the signal fold: aux tables of at most `signal_kernel.AUX_W` entries.
    A fold that passes can still raise on a device fault, which is the
    exporter's to contain (`exporter/torch_sketch.py`)."""
    if isinstance(state, tiered.TieredState):
        t, spec, rest = state.tables, state.spec, state.rest
        d, w = t.cm_bytes.base.shape
        grids = [(1, t.hll_src.shape[0] // 3 * 4),
                 (t.hll_per_dst.shape[0], t.hll_per_dst.shape[1] // 3 * 4),
                 (t.hll_per_src.shape[0], t.hll_per_src.shape[1] // 3 * 4)]
        if _interior(d, w, spec):
            if not all(map(_pow2, (w, spec.mid_group, spec.top_group,
                                   spec.bytes_unit))):
                raise ValueError("width, tier groups and unit must be "
                                 "powers of two")
            if d * n >= 2 ** 31:
                raise ValueError(f"depth {d} x {n} records: kernel 6's "
                                 "int32 bin entries would overflow")
            d = w = 0  # no wide Count-Min fold
    else:
        rest = state
        d, w = state.cm_bytes.counts.shape
        grids = [(1, state.hll_src.regs.shape[0]),
                 tuple(state.hll_per_dst.regs.shape),
                 tuple(state.hll_per_src.regs.shape)]
    if d and not countmin_kernel.fold_fits(d, w, n):
        raise ValueError(f"depth {d} x {max(w, n)}: kernel 1's int32 cell "
                         "and thread indices would overflow")
    for gd, m in grids:
        if not (_pow2(gd) and _pow2(m)) or gd * m > 1 << 31:
            raise ValueError(f"an HLL grid of {gd} x {m} registers: the "
                             "folds launch takes powers of two, at most "
                             "2^31 registers")
    if max(rest.dscp_bytes.shape[0],
           rest.drop_causes.shape[0]) > signal_kernel.AUX_W:
        raise ValueError(f"aux tables must fit {signal_kernel.AUX_W} "
                         "entries")


def _ingest_tiered(state: tiered.TieredState,
                   arrays: Mapping[str, torch.Tensor],
                   enable_fanout: bool,
                   enable_asym: bool) -> tiered.TieredState:
    spec = state.spec
    if _interior(*state.tables.cm_bytes.base.shape, spec):
        m_hll = state.tables.hll_src.shape[0] // 3 * 4
        fuse = (signal_kernel.eligible(signal_planes(state.rest))
                and signal_kernel.hll_fusible(m_hll))
        work = tiered.widen_interior(state, fuse)
        ingest(work, arrays, enable_fanout=enable_fanout,
               enable_asym=enable_asym, _tier=state, _fuse_hll=fuse)
        return tiered.interior_encode(state, fuse, work)
    cmb = tiered.decode_plane(state.tables.cm_bytes, spec, spec.bytes_unit)
    cmp = tiered.decode_plane(state.tables.cm_pkts, spec, 1)
    wide = tiered.widen(state, cmb.clone(), cmp.clone())
    ingest(wide, arrays, enable_fanout=enable_fanout,
           enable_asym=enable_asym)
    return tiered.fold_encode(state, cmb, cmp, wide)


def ingest(state: SketchState, arrays: Mapping[str, torch.Tensor],
           sketch_shard: tuple[int, int] | None = None,
           enable_fanout: bool = True,
           enable_asym: bool = True,
           _tier: tiered.TieredState | None = None,
           _fuse_hll: bool = False) -> SketchState:
    """Fold one batch into every sketch, in place; returns `state`.

    Feature columns (tcp_flags, dscp, markers, drop_*) are optional: a
    batch without one skips the signals that read it, exactly as a zero
    value row would. `sketch_shard=(index, n_shards)` with n_shards > 1
    folds the owner-sharded Count-Min of that sketch shard (module
    docstring). `_tier` and `_fuse_hll` are the tier-interior fold's
    (`_ingest_tiered`): kernel 6 folds `_tier`'s CM tiers, and with
    `_fuse_hll` kernel 7 its packed global-src bank."""
    if sketch_shard is not None and isinstance(state, tiered.TieredState):
        raise NotImplementedError(
            "SKETCH_TIERED has no owner-sharded form yet — tiered counter "
            "planes are single-device (config.validate blocks "
            "SKETCH_MESH_SHAPE with SKETCH_TIERED)")
    if sketch_shard is not None and sketch_shard[1] <= 1:
        sketch_shard = None
    if _tier is None:
        check_fold_shapes(state, arrays["keys"].shape[0])
    if isinstance(state, tiered.TieredState):
        return _ingest_tiered(state, arrays, enable_fanout, enable_asym)
    words = arrays["keys"]
    valid = arrays["valid"]
    bytes_f = arrays["bytes"]
    pkts = arrays["packets"]
    samp = arrays.get("sampling")
    if samp is not None:
        # de-bias sampled traffic: a 1-in-N sampled record stands for N
        factor = torch.clamp(samp, min=1)
        bytes_f = bytes_f * factor.to(torch.float32)
        pkts = pkts * factor

    mh = hashing.base_hashes_multi(words)
    h1, h2 = mh.h1, mh.h2
    src_h1, src_h2, dst_h1 = mh.src_h1, mh.src_h2, mh.dst_h1

    if _tier is not None:
        # kernel 6 folds the resident tiers and returns the post-fold bytes
        # estimate, the query the slot table ranks on
        t = _tier.tables
        est = countmin_kernel.update_two_tiered(
            t.cm_bytes, t.cm_pkts, h1, h2, torch.where(valid, bytes_f, 0.0),
            torch.where(valid, pkts.to(torch.float32), 0.0), _tier.spec)
        _, evicted = topk.slot_update(state.heavy, state.cm_bytes, words, h1,
                                      h2, valid, window=state.window,
                                      query_fn=lambda a, b: est)
    elif sketch_shard is not None:
        # each sketch shard folds and ranks only the keys it owns
        shard, n_sh = sketch_shard
        countmin.update_sharded(state.cm_bytes, h1, h2, bytes_f, valid,
                                shard, n_sh)
        countmin.update_sharded(state.cm_pkts, h1, h2, pkts, valid, shard,
                                n_sh)
        _, evicted = topk.slot_update(
            state.heavy, state.cm_bytes, words, h1, h2, valid,
            window=state.window,
            query_fn=lambda a, b: countmin.query_sharded_local(
                state.cm_bytes, a, b, shard, n_sh))
    else:
        countmin.update_two(state.cm_bytes, state.cm_pkts, h1, h2, bytes_f,
                            pkts, valid)
        _, evicted = topk.slot_update(state.heavy, state.cm_bytes, words,
                                      h1, h2, valid, window=state.window)
    # the HLL folds in one launch: the global-src HLL (unless kernel 7
    # folds its packed bank below), the per-dst grid and the per-src grid
    hll_folds = [] if _fuse_hll else [
        (state.hll_src.regs, src_h1, src_h2, valid)]
    hll_folds.append((state.hll_per_dst.regs, dst_h1, src_h1, src_h2, valid))
    flags = arrays.get("tcp_flags")
    if enable_fanout:
        # port-scan signal: only initiator-side flows count (a flow that
        # sent SYN+ACK together is a responder)
        fanout_valid = valid
        if flags is not None:
            fanout_valid = valid & ((flags & TcpFlags.SYN_ACK) == 0)
        hll_folds.append((state.hll_per_src.regs, src_h1, mh.dp_h1, mh.dp_h2,
                          fanout_valid))
    hll_kernel.update_folds(tuple(hll_folds))
    rtt = arrays["rtt_us"]
    dns = arrays["dns_latency_us"]
    gamma = quantile.gamma_for(state.hist_rtt.n_buckets)
    quantile.update(state.hist_rtt, rtt, valid & (rtt > 0), gamma)
    quantile.update(state.hist_dns, dns, valid & (dns > 0), gamma)

    # --- signal planes: one fused fold over eight value rows ---
    mass = factor.to(torch.float32) if samp is not None else 1.0
    sig_idx, sig_vals = signal_rows(arrays, mh, valid, bytes_f, mass,
                                    state.conv_fwd.shape[0], enable_asym)
    if _fuse_hll:
        signal_kernel.update_tiered(signal_planes(state),
                                    _tier.tables.hll_src, sig_idx,
                                    sig_vals, src_h1, src_h2, valid)
    else:
        signal_kernel.update(signal_planes(state), sig_idx, sig_vals)
    db = arrays.get("drop_bytes")
    if db is not None:
        state.total_drop_bytes.add_(sig_vals[2].sum())
        state.total_drop_packets.add_(torch.where(
            valid, arrays["drop_packets"].to(torch.float32) * mass,
            0.0).sum())

    mk = arrays.get("markers")
    if mk is not None:
        state.quic_records.add_((valid & ((mk & 1) != 0)).sum())
        state.nat_records.add_((valid & ((mk & 2) != 0)).sum())
    state.total_records.add_(valid.sum())
    state.total_bytes.add_(torch.where(valid, bytes_f, 0.0).sum())
    state.heavy_evictions.add_(evicted)
    return state


def signal_rows(arrays: Mapping[str, torch.Tensor],
                mh: hashing.MultiHashes, valid: torch.Tensor,
                bytes_f: torch.Tensor, mass: torch.Tensor | float, m: int,
                enable_asym: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4's inputs for one batch: idx int64[5, B] over the families
    [dst, src, pair, dscp, cause] and vals f32[8, B] = [ddos, syn, drops,
    synack, conv_fwd, conv_rev, dscp, cause] masses, already masked. An
    absent feature column gives a zero value row, the same as skipping
    its signal."""
    zeros_f = torch.zeros_like(bytes_f)
    zeros_i = torch.zeros(bytes_f.shape, dtype=torch.int64,
                          device=bytes_f.device)
    src_sym, dst_h1 = mh.src_sym, mh.dst_h1
    flags = arrays.get("tcp_flags")
    v_syn = v_synack = zeros_f
    if flags is not None:
        # half-open attempts bucket by victim = dst; SYN-ACK responses by
        # victim = src (the responder), under the same seed
        half_open = (valid & ((flags & TcpFlags.SYN) != 0)
                     & ((flags & TcpFlags.ACK) == 0))
        is_synack = valid & ((flags & TcpFlags.SYN_ACK) != 0)
        v_syn = torch.where(half_open, mass, 0.0)
        v_synack = torch.where(is_synack, mass, 0.0)
    db = arrays.get("drop_bytes")
    v_drops, cause_idx, v_cause = zeros_f, zeros_i, zeros_f
    if db is not None:
        v_drops = torch.where(valid, db.to(torch.float32) * mass, 0.0)
        cause = arrays.get("drop_cause")
        if cause is not None:
            dpf = arrays["drop_packets"].to(torch.float32) * mass
            cause_idx = torch.clamp(cause.to(torch.int64),
                                    max=N_DROP_CAUSES - 1)
            v_cause = torch.where(valid & (dpf > 0), dpf, 0.0)
    pair_idx, v_fwd, v_rev = zeros_i, zeros_f, zeros_f
    if enable_asym:
        # the pair bucket is direction-invariant; the lower endpoint hash
        # is the canonical "fwd"; self-pairs have no direction
        pair_idx = (src_sym + dst_h1) & (m - 1)
        is_fwd = src_sym < dst_h1
        conv_ok = valid & (src_sym != dst_h1)
        v_fwd = torch.where(conv_ok & is_fwd, bytes_f, 0.0)
        v_rev = torch.where(conv_ok & ~is_fwd, bytes_f, 0.0)
    dscp = arrays.get("dscp")
    dscp_idx, v_dscp = zeros_i, zeros_f
    if dscp is not None:
        dscp_idx = dscp.to(torch.int64) & (N_DSCP - 1)
        v_dscp = torch.where(valid, bytes_f, 0.0)
    idx = torch.stack([dst_h1 & (m - 1), src_sym & (m - 1), pair_idx,
                       dscp_idx, cause_idx])
    vals = torch.stack([torch.where(valid, bytes_f, 0.0), v_syn, v_drops,
                        v_synack, v_fwd, v_rev, v_dscp, v_cause])
    return idx, vals


def signal_planes(state: SketchState) -> signal_kernel.SignalPlanes:
    """The state's eight signal tables, in kernel 4's row order."""
    return signal_kernel.SignalPlanes(
        ddos_rate=state.ddos.rate, syn_rate=state.syn.rate,
        drops_rate=state.drops_ewma.rate, synack=state.synack,
        conv_fwd=state.conv_fwd, conv_rev=state.conv_rev,
        dscp_bytes=state.dscp_bytes, drop_causes=state.drop_causes)


def decay_state(state: SketchState, factor: float) -> SketchState:
    """Sliding-window roll in place: scale the linear sketches by `factor`
    (HLL registers cannot decay and are reset; eviction events and the
    SYN-ACK window reset). A tiered state decays its CM tiers
    elementwise (`tiered.decay_plane`), never through a re-encode."""
    if isinstance(state, tiered.TieredState):
        wide = tiered.decode_state(state)
        decay_state(wide, factor)
        return tiered.decay_encode(state, wide, factor)
    topk.slot_roll(state.heavy, factor)
    for t in (state.cm_bytes.counts, state.cm_pkts.counts,
              state.hist_rtt.counts, state.hist_dns.counts,
              state.drop_causes, state.dscp_bytes, state.conv_fwd,
              state.conv_rev, *(getattr(state, n) for n in _SCALARS[:-1])):
        t.mul_(factor)
    for t in (state.hll_src.regs, state.hll_per_dst.regs,
              state.hll_per_src.regs, state.synack, state.heavy_evictions):
        t.zero_()
    return state


#: QS as an f32 tensor per device, made once (`_qs`)
_QS: dict[torch.device, torch.Tensor] = {}


def _qs(device: torch.device) -> torch.Tensor:
    """QS on `device`, made on first use and kept: a roll then copies
    nothing from host memory, which a CUDA graph could not capture
    (`archive/query.py` captures the roll)."""
    t = _QS.get(device)
    if t is None:
        t = torch.tensor(QS, dtype=torch.float32).to(device)
        _QS[device] = t
    return t


def _clone_slots(t: topk.SlotTable) -> topk.SlotTable:
    return topk.SlotTable(*(x.clone() for x in t))


def roll_window(state: SketchState, cfg: SketchConfig,
                reset_sketches: bool = True,
                decay_factor: float | None = None
                ) -> tuple[SketchState, WindowReport]:
    """Close the current window in place: build the report, roll the EWMA
    baselines, and reset (or decay, or keep) the windowed state. Returns
    (`state`, report); the report holds copies.

    A tiered state rolls its decoded wide view, then re-tiers per mode
    without a decode -> encode round trip of live counts (which would
    re-sum shared overflow cells every window): reset encodes the fresh
    zeros, decay scales the tiers elementwise, keep leaves them as they
    are."""
    if isinstance(state, tiered.TieredState):
        wide = tiered.decode_state(state)
        _, report = roll_window(wide, cfg, reset_sketches, decay_factor)
        if decay_factor is not None:
            tiered.decay_encode(state, wide, decay_factor)
        elif reset_sketches:
            tiered.copy_tables(state.tables,
                               tiered.encode_state(wide, state.spec).tables)
        return state, report
    gamma = quantile.gamma_for(state.hist_rtt.n_buckets)
    qs = _qs(state.window.device)
    pre = {n: getattr(state, n).clone() for n in
           ("synack", "drop_causes", "dscp_bytes", "conv_fwd", "conv_rev",
            *_SCALARS, "window")}
    heavy = _clone_slots(state.heavy)
    syn_rate = state.syn.rate.clone()
    distinct_src = hll.estimate(state.hll_src.regs)
    per_dst = hll.estimate(state.hll_per_dst.regs)
    per_src = hll.estimate(state.hll_per_src.regs)
    rtt_q = quantile.quantile(state.hist_rtt, qs, gamma)
    dns_q = quantile.quantile(state.hist_dns, qs, gamma)
    _, z = ewma.roll(state.ddos, cfg.ewma_alpha)
    _, syn_z = ewma.roll(state.syn, cfg.ewma_alpha)
    _, drop_z = ewma.roll(state.drops_ewma, cfg.ewma_alpha)
    report = WindowReport(
        heavy=heavy, distinct_src=distinct_src, per_dst_cardinality=per_dst,
        per_src_fanout=per_src, rtt_quantiles_us=rtt_q,
        dns_quantiles_us=dns_q, ddos_z=z, syn_z=syn_z, syn_rate=syn_rate,
        synack_rate=pre["synack"], drop_z=drop_z,
        drop_causes=pre["drop_causes"], dscp_bytes=pre["dscp_bytes"],
        conv_fwd=pre["conv_fwd"], conv_rev=pre["conv_rev"],
        **{n: pre[n] for n in _SCALARS}, window=pre["window"])
    roll_tables_(state, reset_sketches, decay_factor)
    state.window.add_(1)
    return state, report


def roll_tables_(state: SketchState, reset_sketches: bool = True,
                 decay_factor: float | None = None) -> SketchState:
    """The window roll's mode step on a wide state, in place: decay the
    windowed tables, reset them, or keep them. The EWMA baselines and the
    window counter are the caller's (`roll_window`; a mesh shard's local
    partial in `parallel/merge.make_merge_fn`)."""
    if decay_factor is not None:
        decay_state(state, decay_factor)
    elif reset_sketches:
        # the slot table keeps its identity across the roll; only its
        # windowed counts roll (prev_counts <- counts, counts <- 0)
        topk.slot_roll(state.heavy, 0.0)
        for t in (state.cm_bytes.counts, state.cm_pkts.counts,
                  state.hll_src.regs, state.hll_per_dst.regs,
                  state.hll_per_src.regs, state.hist_rtt.counts,
                  state.hist_dns.counts, state.synack, state.drop_causes,
                  state.dscp_bytes, state.conv_fwd, state.conv_rev,
                  *(getattr(state, n) for n in _SCALARS)):
            t.zero_()
    else:
        # keep mode: synack pairs with the syn EWMA's per-window rate and
        # resets with it; eviction events stay per-window
        topk.slot_roll(state.heavy, 1.0)
        state.synack.zero_()
        state.heavy_evictions.zero_()
    return state


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy: never a view of the live (in-place updated) state."""
    return t.detach().to("cpu", copy=True).numpy()


def table_tensors(state: SketchState) -> dict[str, torch.Tensor]:
    """The mergeable tables of a (pre-roll) wide state on its device, in
    `federation.delta.TABLE_SPEC` order: the state's own tensors (uint32
    lanes in int64, `heavy_valid` bool, no copy) and the window totals
    stacked in SCALAR_FIELDS order. No host copy, so a CUDA graph can take
    it (`archive/query.py`)."""
    h = state.heavy
    return {
        "cm_bytes": state.cm_bytes.counts,
        "cm_pkts": state.cm_pkts.counts,
        "heavy_words": h.words,
        "heavy_h1": h.h1,
        "heavy_h2": h.h2,
        "heavy_counts": h.counts,
        "heavy_valid": h.valid,
        "heavy_prev_counts": h.prev_counts,
        "heavy_first_seen": h.first_seen,
        "heavy_epoch": h.epoch,
        "hll_src": state.hll_src.regs,
        "hll_per_dst": state.hll_per_dst.regs,
        "hll_per_src": state.hll_per_src.regs,
        "hist_rtt": state.hist_rtt.counts,
        "hist_dns": state.hist_dns.counts,
        "ddos_rate": state.ddos.rate,
        "syn_rate": state.syn.rate,
        "synack": state.synack,
        "drops_rate": state.drops_ewma.rate,
        "drop_causes": state.drop_causes,
        "dscp_bytes": state.dscp_bytes,
        "conv_fwd": state.conv_fwd,
        "conv_rev": state.conv_rev,
        # federation.delta.SCALAR_FIELDS order
        "scalars": torch.stack([getattr(state, n) for n in _SCALARS]),
    }


def state_tables(state: SketchState) -> dict[str, np.ndarray]:
    """The mergeable table snapshot of a (pre-roll) state as host numpy
    arrays with the JAX package's dtypes (uint32 lanes back to np.uint32):
    the layout of the federation delta frame. EWMA baselines are absent by
    design. A tiered state gives its decoded wide tables."""
    if isinstance(state, tiered.TieredState):
        return state_tables(tiered.decode_state(state))
    out = {k: _np(v) for k, v in table_tensors(state).items()}
    for k in ("heavy_words", "heavy_h1", "heavy_h2"):
        out[k] = out[k].astype(np.uint32)
    return out


def copy_state_(dst, src) -> None:
    """Copy every tensor of `src` into the same tensor of `dst` in place: a
    state, wide or tiered, into a twin made once by `init_state` with the
    same config (the torch form of the reference's
    `jax.tree.map(jnp.copy, state)`, with no allocation). A leaf that is
    not a tensor (the tier geometry) must be equal."""
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
    elif isinstance(src, tuple):
        if type(dst) is not type(src) or len(dst) != len(src):
            raise ValueError(f"cannot copy a {type(src).__name__} into a "
                             f"{type(dst).__name__}")
        for d, s_ in zip(dst, src):
            copy_state_(d, s_)
    elif dst != src:
        raise ValueError(f"states differ in a fixed leaf: {src!r} vs "
                         f"{dst!r}")


def host_cm_planes(state) -> dict[str, np.ndarray]:
    """The wide Count-Min planes of a (pre-roll) state as host f32 copies,
    `cm_bytes` and `cm_pkts`; a tiered state gives its decoded planes
    (`tiered.decode_plane`), as `state_tables` does."""
    if isinstance(state, tiered.TieredState):
        t, spec = state.tables, state.spec
        return {"cm_bytes": _np(tiered.decode_plane(t.cm_bytes, spec,
                                                    spec.bytes_unit)),
                "cm_pkts": _np(tiered.decode_plane(t.cm_pkts, spec, 1))}
    return {"cm_bytes": _np(state.cm_bytes.counts),
            "cm_pkts": _np(state.cm_pkts.counts)}
