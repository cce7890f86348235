"""Seeded flow traffic and its exact heavy-hitter oracle.

A numpy copy of the JAX package's bench traffic (`bench.py` `make_pool`,
`check_recall`): 50,000 distinct random flow keys drawn with Zipf a = 1.2,
bytes 64-9000, the full feature lane (TCP flags, DSCP, markers, and drops
on about 2 % of rows). The tests and `chip_smoke.py` share it.
`event_pool` gives the same batches as raw flow events with feature lanes,
the input of the resident feed. With `v4=True` the keys are v4-in-v6
mapped, as the compact feed packs them, with a share of v6 rows.
"""

from __future__ import annotations

import numpy as np
import torch

from netobserv_tpu_torch.datapath.flowpack import V4_PREFIX_WORD2
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.columnar import (
    pack_key_words, unpack_key_words,
)
from netobserv_tpu_torch.sketch.state import arrays_to_dense, batch_to_device

BATCH = 16384
N_BATCHES_POOL = 8
N_DISTINCT = 50_000
ZIPF_A = 1.2


def make_pool(rng: np.random.Generator, batch: int = BATCH,
              n_batches: int = N_BATCHES_POOL,
              n_distinct: int = N_DISTINCT, zipf_a: float = ZIPF_A,
              v4: bool = False, v6_share=0.05):
    """(universe uint32[n_distinct, 10], [(arrays, ranks)] * n_batches):
    each batch's column dict and the universe row of each record.

    With `v4` both addresses of the universe's keys are v4-in-v6 mapped
    (words 0-1 and 4-5 zero, words 2 and 6 the mapped prefix), and the
    universe has a v6 twin of each key (rows n_distinct.., words 0-2 and
    4-6 random) that a row takes with probability `v6_share` (a float, or
    one a batch). The draws of a pool without `v4` are unchanged."""
    universe = rng.integers(0, 2**32, (n_distinct, 10), dtype=np.uint32)
    if v4:
        v6 = universe.copy()
        universe[:, [0, 1, 4, 5]] = 0
        universe[:, [2, 6]] = V4_PREFIX_WORD2
        universe = np.concatenate([universe, v6])
        shares = (list(v6_share) if np.ndim(v6_share)
                  else [v6_share] * n_batches)
    pool = []
    for bi in range(n_batches):
        ranks = np.minimum(rng.zipf(zipf_a, batch) - 1, n_distinct - 1)
        if v4:
            ranks = ranks + n_distinct * (rng.random(batch) < shares[bi])
        drop_b = np.where(rng.random(batch) < 0.02,
                          rng.integers(1, 1500, batch), 0).astype(np.int32)
        pool.append(({
            "keys": universe[ranks],
            "bytes": rng.integers(64, 9000, batch).astype(np.float32),
            "packets": rng.integers(1, 12, batch).astype(np.int32),
            "rtt_us": rng.integers(0, 5000, batch).astype(np.int32),
            "dns_latency_us": rng.integers(0, 2000, batch).astype(np.int32),
            "sampling": np.zeros(batch, np.int32),
            "valid": np.ones(batch, np.bool_),
            "tcp_flags": rng.integers(0, 1 << 9, batch).astype(np.int32),
            "dscp": rng.integers(0, 64, batch).astype(np.int32),
            "markers": rng.integers(0, 4, batch).astype(np.int32),
            "drop_bytes": drop_b,
            "drop_packets": (drop_b > 0).astype(np.int32),
            "drop_cause": np.where(drop_b > 0, 2, 0).astype(np.int32),
        }, ranks))
    return universe, pool


def dense_pool(pool) -> list[np.ndarray]:
    """Each pool batch as the flat uint32 dense feed."""
    return [arrays_to_dense(arrays) for arrays, _ in pool]


def event_pool(pool, rng: np.random.Generator, dns_share: float = 0.05
               ) -> list[tuple[np.ndarray, dict[str, np.ndarray]]]:
    """Each pool batch as (flow events, feature lanes for
    `TorchSketchExporter.fold_events`): keys, bytes, packets, TCP flags,
    DSCP and sampling in the events; rtt in `extra`; drop bytes, packets
    and cause in `drops`; marker bit 0 as a QUIC version in `quic` and bit
    1 as a complete NAT translation in `xlat`, as the packer reads them
    back. The keys are the flow keys of the universe's rows: word 9's top
    byte is no field of a flow key, so it is lost (`event_universe` gives
    the universe as the events carry it). The one departure from the dense
    feed's traffic: the DNS latency is kept on a `dns_share` of the rows,
    drawn from `rng`, and is zero elsewhere, since the resident feed's DNS
    lane is sized for DNS rows as a minority (B/16)."""
    out = []
    for arrays, _ in pool:
        n = len(arrays["valid"])
        ev = np.zeros(n, binfmt.FLOW_EVENT_DTYPE)
        ev["key"] = unpack_key_words(arrays["keys"])
        st = ev["stats"]
        st["bytes"] = arrays["bytes"]
        st["packets"] = arrays["packets"]
        st["tcp_flags"] = arrays["tcp_flags"]
        st["dscp"] = arrays["dscp"]
        st["sampling"] = arrays["sampling"]
        extra = np.zeros(n, binfmt.EXTRA_REC_DTYPE)
        extra["rtt_ns"] = arrays["rtt_us"].astype(np.uint64) * 1000
        dns = np.zeros(n, binfmt.DNS_REC_DTYPE)
        keep = rng.random(n) < dns_share
        dns["latency_ns"] = np.where(
            keep, arrays["dns_latency_us"].astype(np.uint64) * 1000, 0)
        drops = np.zeros(n, binfmt.DROPS_REC_DTYPE)
        drops["bytes"] = arrays["drop_bytes"]
        drops["packets"] = arrays["drop_packets"]
        drops["latest_cause"] = arrays["drop_cause"]
        quic = np.zeros(n, binfmt.QUIC_REC_DTYPE)
        quic["version"] = arrays["markers"] & 1
        xlat = np.zeros(n, binfmt.XLAT_REC_DTYPE)
        nat = (arrays["markers"] & 2) != 0
        xlat["src_ip"][nat, 0] = 1
        xlat["dst_ip"][nat, 0] = 1
        out.append((ev, dict(extra=extra, dns=dns, drops=drops, xlat=xlat,
                             quic=quic)))
    return out


def event_universe(universe: np.ndarray) -> np.ndarray:
    """The universe's key words as `event_pool`'s flow keys carry them
    (word 9 masked to its 24 bits of fields): the oracle keys of the
    resident feed."""
    return pack_key_words(unpack_key_words(universe))


def device_pool(pool, device: str | torch.device | None = None
                ) -> list[dict[str, torch.Tensor]]:
    """Each pool batch as ingest-ready tensors on `device` (CUDA unless the
    caller names the CPU)."""
    return [batch_to_device(arrays, device) for arrays, _ in pool]


def check_recall(heavy_words: np.ndarray, heavy_valid: np.ndarray, feed,
                 universe: np.ndarray, pool, k: int = 100) -> float:
    """Recall@k of a heavy-hitter table against the exact byte totals of
    the pool batches folded in `feed` (their indices, in order)."""
    exact: dict[int, float] = {}
    for bi in feed:
        arrays, ranks = pool[bi]
        for r, b in zip(ranks, arrays["bytes"]):
            exact[int(r)] = exact.get(int(r), 0.0) + float(b)
    true_top = sorted(exact, key=exact.get, reverse=True)[:k]
    got = {tuple(w) for w, v in zip(np.asarray(heavy_words, np.uint32),
                                    np.asarray(heavy_valid)) if v}
    return sum(tuple(universe[t]) in got for t in true_top) / k
