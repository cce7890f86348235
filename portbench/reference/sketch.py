"""The plain reference of a node agent's sketch window, in PyTorch.

What one window of the sketch plane must hold, worked out again from the
flow events the benchmark handed to the agent, with no kernel, no staging
and nothing of the program:

- two Count-Min planes (bytes and packets), `depth` rows of `width`
  cells, each key added at (h1 + row * h2) mod width of every row;
- a HyperLogLog of sources and two grids of small HyperLogLogs, one of
  sources per destination bucket and one of (destination, port) pairs per
  source bucket (the fan-out grid, which leaves out responders: flows with
  the SYN-ACK flag);
- latency histograms of RTT and DNS latency, log buckets of ratio gamma;
- the signal planes: bytes by destination bucket, half-open SYNs by
  destination, drop bytes by destination, SYN-ACKs by source, bytes of
  each conversation by direction, bytes by DSCP and dropped packets by
  cause;
- the window's totals.

Sums are kept in float64, so they are exact for these integer inputs, and
each eviction's tables are computed once: a window that folded eviction e
c_e times holds sum_e c_e * T_e, and for the registers, which keep a
maximum, the maximum over the evictions it folded.

A histogram bucket is ceil(log(v) / log(gamma)) + 1, which the program
computes in float32: where that ratio lies within `EDGE` of an integer
the sample may land in either bucket. The resident feed ships the RTT of
a row that rides its hot lane with an 8-bit mantissa and a base-4
exponent, and the DNS latency with a 12-bit mantissa: exactly for rows
that spill, and which rows spill depends on the packer. So each sample has
a set of buckets it may land in, and the reference gives, per bucket, the
samples that must land there (`*_lo`) and those that may (`*_hi`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import hashing

#: TCP flag bits the signals read
SYN, ACK, SYN_ACK = 0x02, 0x10, 0x100
N_DROP_CAUSES = 128
N_DSCP = 64
#: distance of a float32 bucket ratio from an integer inside which the
#: program's float32 logarithm may round to either side
EDGE = 1e-3
#: the window totals, in the order of the program's `scalars` table
SCALARS = ("total_records", "total_bytes", "total_drop_bytes",
           "total_drop_packets", "quic_records", "nat_records")
LINEAR = ("cm_bytes", "cm_pkts", "ddos_rate", "syn_rate", "drops_rate",
          "synack", "conv_fwd", "conv_rev", "dscp_bytes", "drop_causes")
REGISTERS = ("hll_src", "hll_per_dst", "hll_per_src")
HISTS = ("rtt", "dns")


@dataclass(frozen=True)
class Geometry:
    """The sketch sizes a configuration states (`geometry` of its file)."""

    cm_depth: int
    cm_width: int
    hll_precision: int
    perdst_buckets: int
    perdst_precision: int
    persrc_buckets: int
    persrc_precision: int
    hist_buckets: int
    hist_max_value: float
    ewma_buckets: int

    @classmethod
    def from_dict(cls, d: dict) -> "Geometry":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__})

    @property
    def log_gamma(self) -> float:
        return math.log(self.hist_max_value) / max(self.hist_buckets - 2, 1)


def columns(events: np.ndarray, lanes: dict) -> dict[str, np.ndarray]:
    """The row values a fold reads, from the flow events and their feature
    lanes (numpy structured arrays, by field name)."""
    key, st = events["key"], events["stats"]
    n = len(events)
    words = np.zeros((n, 10), np.uint32)
    words[:, 0:4] = np.ascontiguousarray(key["src_ip"]).view(
        np.uint32).reshape(n, 4)
    words[:, 4:8] = np.ascontiguousarray(key["dst_ip"]).view(
        np.uint32).reshape(n, 4)
    words[:, 8] = (key["src_port"].astype(np.uint32) << 16) | \
        key["dst_port"].astype(np.uint32)
    words[:, 9] = (key["proto"].astype(np.uint32) << 16) | \
        (key["icmp_type"].astype(np.uint32) << 8) | \
        key["icmp_code"].astype(np.uint32)
    zeros = np.zeros(n, np.int64)
    extra, dns, drops = lanes.get("extra"), lanes.get("dns"), \
        lanes.get("drops")
    quic, xlat = lanes.get("quic"), lanes.get("xlat")
    markers = zeros.copy()
    if quic is not None:
        markers |= ((quic["version"] != 0) | (quic["seen_long_hdr"] != 0)
                    | (quic["seen_short_hdr"] != 0)).astype(np.int64)
    if xlat is not None:
        markers |= (xlat["src_ip"].any(axis=1)
                    & xlat["dst_ip"].any(axis=1)).astype(np.int64) << 1
    return {
        "words": words.astype(np.int64),
        "bytes": st["bytes"].astype(np.float64),
        "packets": st["packets"].astype(np.float64),
        "sampling": st["sampling"].astype(np.int64),
        "tcp_flags": st["tcp_flags"].astype(np.int64),
        "dscp": st["dscp"].astype(np.int64),
        "markers": markers,
        "rtt_us": (extra["rtt_ns"] // 1000).astype(np.int64)
        if extra is not None else zeros,
        "dns_us": (dns["latency_ns"] // 1000).astype(np.int64)
        if dns is not None else zeros,
        "drop_bytes": drops["bytes"].astype(np.float64)
        if drops is not None else zeros.astype(np.float64),
        "drop_packets": drops["packets"].astype(np.float64)
        if drops is not None else zeros.astype(np.float64),
        "drop_cause": np.minimum(drops["latest_cause"], 0xFFFF).astype(
            np.int64) if drops is not None else zeros,
    }


def rtt_hot(us: torch.Tensor) -> torch.Tensor:
    """An RTT as the resident feed's hot lane carries it: the largest
    m << 2e <= us with m < 256."""
    e = torch.zeros_like(us)
    for _ in range(8):
        e = torch.where((us >> (2 * e)) > 0xFF, e + 1, e)
    return ((us >> (2 * e)) & 0xFF) << (2 * e)


def dns_hot(us: torch.Tensor) -> torch.Tensor:
    """A DNS latency as the resident feed's DNS lane carries it: a 12-bit
    mantissa and a 4-bit exponent, saturating."""
    e = torch.zeros_like(us)
    for _ in range(15):
        e = torch.where(((us >> e) > 0xFFF) & (e < 15), e + 1, e)
    return torch.clamp(us >> e, max=0xFFF) << e


def _buckets(v: torch.Tensor, geo: Geometry) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The two buckets a positive sample may land in (equal away from an
    edge)."""
    x = torch.log(torch.clamp(v.to(torch.float64), min=1.0)) / geo.log_gamma
    top = geo.hist_buckets - 1
    lo = torch.clamp(torch.ceil(x - EDGE).to(torch.int64) + 1, 1, top)
    hi = torch.clamp(torch.ceil(x + EDGE).to(torch.int64) + 1, 1, top)
    return lo, hi


def _envelope(values: list[torch.Tensor], geo: Geometry
              ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(must, may, samples) of a histogram whose positive samples may each
    take any of the given forms (`values`, one tensor a form)."""
    n = geo.hist_buckets
    pos = values[0] > 0
    cands = []
    for v in values:
        lo, hi = _buckets(v[pos], geo)
        cands += [lo, hi]
    first = cands[0]
    same = torch.ones_like(first, dtype=torch.bool)
    for c in cands[1:]:
        same &= c == first
    must = torch.bincount(first[same], minlength=n).to(torch.float64)
    # a sample counts once in `may` for every distinct bucket it may take
    stack, _ = torch.sort(torch.stack(cands, dim=1), dim=1)
    distinct = torch.ones_like(stack, dtype=torch.bool)
    distinct[:, 1:] = stack[:, 1:] != stack[:, :-1]
    may = torch.bincount(stack[distinct], minlength=n).to(torch.float64)
    return must, may, float(pos.sum())


def eviction_tables(cols: dict[str, np.ndarray], geo: Geometry,
                    feed: str, device, dtype=torch.float64) -> dict:
    """The tables one eviction adds to a window, on `device`: sums in
    `dtype` (float64 for the reference; the control passes a lower one),
    registers as int32, the histogram envelopes, the totals, and the
    per-row hashes and bytes the heavy-hitter check reads."""
    t = {k: torch.as_tensor(v, device=device) for k, v in cols.items()}
    h = hashing.multi_hashes(t["words"].to(torch.int64))
    valid = torch.ones(len(t["bytes"]), dtype=torch.bool, device=device)
    factor = torch.clamp(t["sampling"], min=1).to(dtype)
    b = t["bytes"].to(dtype) * factor
    p = t["packets"].to(dtype) * factor
    mass = factor
    d, w = geo.cm_depth, geo.cm_width
    cells = hashing.cm_cells(h["h1"], h["h2"], d, w)

    def add(size: int, idx: torch.Tensor, vals: torch.Tensor):
        out = torch.zeros(size, dtype=dtype, device=device)
        return out.index_add_(0, idx.reshape(-1), vals.reshape(-1).to(dtype))

    out = {
        "cm_bytes": add(d * w, cells, b.expand(d, -1)),
        "cm_pkts": add(d * w, cells, p.expand(d, -1)),
    }

    def regs(size: int, cell: torch.Tensor, rank: torch.Tensor,
             keep: torch.Tensor):
        r = torch.zeros(size, dtype=torch.int64, device=device)
        r.scatter_reduce_(0, cell, torch.where(keep, rank, 0), "amax")
        return r.to(torch.int32)

    m_src = 1 << geo.hll_precision
    out["hll_src"] = regs(m_src, h["src_h1"] & (m_src - 1),
                          hashing.hll_rank(h["src_h2"]), valid)
    m_d = 1 << geo.perdst_precision
    out["hll_per_dst"] = regs(
        geo.perdst_buckets * m_d,
        (h["dst_h1"] & (geo.perdst_buckets - 1)) * m_d
        + (h["src_h1"] & (m_d - 1)), hashing.hll_rank(h["src_h2"]), valid)
    m_s = 1 << geo.persrc_precision
    flags = t["tcp_flags"]
    initiator = (flags & SYN_ACK) == 0
    out["hll_per_src"] = regs(
        geo.persrc_buckets * m_s,
        (h["src_h1"] & (geo.persrc_buckets - 1)) * m_s
        + (h["dp_h1"] & (m_s - 1)), hashing.hll_rank(h["dp_h2"]), initiator)

    rtt, dns = t["rtt_us"], t["dns_us"]
    rtt_forms, dns_forms = [rtt], [dns]
    if feed == "resident":
        rtt_forms.append(rtt_hot(rtt))
        dns_forms.append(dns_hot(dns))
    for name, forms in (("rtt", rtt_forms), ("dns", dns_forms)):
        must, may, n = _envelope(forms, geo)
        out[f"{name}_lo"], out[f"{name}_hi"] = must, may
        out[f"{name}_n"] = torch.tensor(n, dtype=torch.float64,
                                        device=device)

    m = geo.ewma_buckets
    dst_i, src_i = h["dst_h1"] & (m - 1), h["src_sym"] & (m - 1)
    half_open = ((flags & SYN) != 0) & ((flags & ACK) == 0)
    is_synack = (flags & SYN_ACK) != 0
    drop_b = t["drop_bytes"].to(dtype) * mass
    drop_p = t["drop_packets"].to(dtype) * mass
    pair = (h["src_sym"] + h["dst_h1"]) & (m - 1)
    fwd = h["src_sym"] < h["dst_h1"]
    conv = h["src_sym"] != h["dst_h1"]
    zero = torch.zeros_like(b)
    out.update({
        "ddos_rate": add(m, dst_i, b),
        "syn_rate": add(m, dst_i, torch.where(half_open, mass, zero)),
        "drops_rate": add(m, dst_i, drop_b),
        "synack": add(m, src_i, torch.where(is_synack, mass, zero)),
        "conv_fwd": add(m, pair, torch.where(conv & fwd, b, zero)),
        "conv_rev": add(m, pair, torch.where(conv & ~fwd, b, zero)),
        "dscp_bytes": add(N_DSCP, t["dscp"] & (N_DSCP - 1), b),
        "drop_causes": add(N_DROP_CAUSES,
                           torch.clamp(t["drop_cause"], max=N_DROP_CAUSES - 1),
                           torch.where(drop_p > 0, drop_p, zero)),
    })
    mk = t["markers"]
    out["scalars"] = torch.stack([
        valid.sum().to(dtype), b.sum(), drop_b.sum(), drop_p.sum(),
        ((mk & 1) != 0).sum().to(dtype), ((mk & 2) != 0).sum().to(dtype)])
    out["rows"] = {"h1": h["h1"], "h2": h["h2"], "bytes": b,
                   "words": t["words"].to(torch.int64)}
    return out


def window_tables(evs: list[dict], counts: list[int]) -> dict:
    """The tables of a window that folded eviction i `counts[i]` times."""
    live = [(e, c) for e, c in zip(evs, counts) if c]
    out = {}
    keys = [k for k in evs[0] if k != "rows"]
    for k in keys:
        if k in REGISTERS:
            if live:
                out[k] = torch.stack([e[k] for e, _ in live]).amax(0)
            else:
                out[k] = torch.zeros_like(evs[0][k])
        else:
            acc = torch.zeros_like(evs[0][k])
            for e, c in live:
                acc = acc + e[k] * c
            out[k] = acc
    return out


def cm_estimate(cm: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                geo: Geometry) -> torch.Tensor:
    """Count-Min point estimate of each key from flat planes."""
    return cm[hashing.cm_cells(h1, h2, geo.cm_depth, geo.cm_width)].amin(0)
