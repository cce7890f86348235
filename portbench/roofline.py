"""The least time the card could take for the sketch folds' CUDA kernels.

A frozen copy of the byte arithmetic of `chip_smoke.py` (`bound_of`,
`_sector_bytes`, `_signal_bytes_ops`): a call's bound is the larger of the
bytes it must move over HBM bandwidth and its float32 operations over the
float32 peak. Bytes are the call's input lanes, read once, and of each
table the distinct 32-byte sectors that the rows' cells reach, read once
and written once. The counts follow from the rows folded, not from how
the kernels do the work.

One fold of B rows launches: kernel 1 (`cm_fold2_kernel`, both Count-Min
planes), kernel 2 (`topk_reduce_kernel`) once a round of the slot table's
`SLOT_ROUNDS`, the HLL folds launch (`hll_fold_kernel`, three folds) and
kernel 4 (`signal_fold_kernel`, eight planes).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench.reference import hashing, sketch

#: CUDA kernels of the program's `csrc/`, by the name in a device trace,
#: and how many launches one fold makes
CSRC_KERNELS = {"cm_fold2_kernel": 1, "topk_reduce_kernel": 2,
                "hll_fold_kernel": 1, "signal_fold_kernel": 1,
                "signal_fold_tiered_kernel": 0, "cm_tier2_kernel": 0,
                "cm_tier2_count_kernel": 0, "cm_tier2_scatter_kernel": 0,
                "cm_tier2_est_kernel": 0, "launch_floor_kernel": 0}
SLOT_ROUNDS = 2
#: the value rows of kernel 4 and the index family each reads: bytes by
#: destination, SYNs by destination, drop bytes by destination, SYN-ACKs
#: by source, both conversation directions by pair, DSCP, drop cause
SIGNAL_FAMILY = (0, 0, 0, 1, 2, 2, 3, 4)


def peaks(root: Path) -> dict:
    with open(root / "peaks.json") as f:
        return json.load(f)


def csrc_kernel(name: str) -> str | None:
    """The `CSRC_KERNELS` entry a traced kernel name is, or None."""
    base = name.split("(")[0].split("<")[0].split()[-1] if name else ""
    return base if base in CSRC_KERNELS else None


def sector_bytes(elems: torch.Tensor, elem_size: int = 4) -> int:
    """Bytes of the distinct 32-byte sectors the element indices reach,
    read once and written once."""
    return 2 * 32 * int(torch.unique(elems // (32 // elem_size)).numel())


def fold_bounds(cols: dict, geo: "sketch.Geometry", topk: int,
                peak: dict) -> dict[str, float]:
    """Bound seconds of each kernel for one fold of the given rows (all
    valid), summed over its launches."""
    dev = cols["bytes"].device
    n = len(cols["bytes"])
    h = hashing.multi_hashes(cols["words"])
    bw, f32 = peak["hbm_bytes_per_s"], peak["f32_ops_per_s"]

    def bound(nbytes: float, ops: float) -> float:
        return max(nbytes / bw, ops / f32)

    out = {}
    cells = hashing.cm_cells(h["h1"], h["h2"], geo.cm_depth, geo.cm_width)
    cm_bytes, cm_ops = n * (8 + 8 + 4 + 4), 0
    for v in (cols["bytes"], cols["packets"]):
        hit = cells[:, v != 0].reshape(-1)
        cm_bytes += sector_bytes(hit)
        cm_ops += hit.numel()
    out["cm_fold2_kernel"] = bound(cm_bytes, cm_ops)
    out["topk_reduce_kernel"] = SLOT_ROUNDS * bound(n * (8 + 8 + 4)
                                                    + 3 * topk * 4, 3 * n)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    initiator = (cols["tcp_flags"] & sketch.SYN_ACK) == 0
    m_src = 1 << geo.hll_precision
    m_d, m_s = 1 << geo.perdst_precision, 1 << geo.persrc_precision
    folds = (
        ((h["src_h1"] & (m_src - 1)), valid),
        ((h["dst_h1"] & (geo.perdst_buckets - 1)) * m_d
         + (h["src_h1"] & (m_d - 1)), valid),
        ((h["src_h1"] & (geo.persrc_buckets - 1)) * m_s
         + (h["dp_h1"] & (m_s - 1)), initiator))
    # lanes src_h1, src_h2, dst_h1, dp_h1, dp_h2 and two masks, each once
    hll_bytes = n * (5 * 8 + 2) + sum(sector_bytes(c[k]) for c, k in folds)
    out["hll_fold_kernel"] = bound(hll_bytes, sum(int(k.sum())
                                                  for _, k in folds))
    m = geo.ewma_buckets
    b = cols["bytes"]
    flags = cols["tcp_flags"]
    zero = torch.zeros_like(b)
    idx = (h["dst_h1"] & (m - 1), h["src_sym"] & (m - 1),
           (h["src_sym"] + h["dst_h1"]) & (m - 1),
           cols["dscp"] & (sketch.N_DSCP - 1),
           torch.clamp(cols["drop_cause"], max=sketch.N_DROP_CAUSES - 1))
    fwd, conv = h["src_sym"] < h["dst_h1"], h["src_sym"] != h["dst_h1"]
    vals = (b, ((flags & sketch.SYN) != 0) & ((flags & sketch.ACK) == 0),
            cols["drop_bytes"], (flags & sketch.SYN_ACK) != 0,
            torch.where(conv & fwd, b, zero),
            torch.where(conv & ~fwd, b, zero), b, cols["drop_packets"])
    sig_bytes = n * (5 * 8 + 8 * 4)
    sig_ops = 0
    for j, v in enumerate(vals):
        nz = v != 0
        sig_bytes += sector_bytes(idx[SIGNAL_FAMILY[j]][nz])
        sig_ops += int(nz.sum())
    out["signal_fold_kernel"] = bound(sig_bytes, sig_ops)
    return out
