"""The one traffic generator: a pool of map evictions from a mix's file.

A traffic mix is a JSON file of parameters (`portbench/traffic/<name>.json`);
this module turns it and a seed into a pool of evictions, each a drained
kernel map: every flow once, its counters merged. The pool is made once,
in set-up, and the harness hands its evictions to the agent in turn.

Parameters of a mix:

- `universe`: the flows that exist, each a distinct 5-tuple (`v6_share`
  of them IPv6, the rest IPv4 in v4-mapped form) with random ports, a rate
  drawn once from a Pareto law (`rate_pareto_alpha`, floor
  `rate_floor_bytes` bytes a tick) and a packet size drawn from
  `packet_bytes`. Every flow a node agent sees has one endpoint on its
  node: one of `node_addresses` addresses (its pods and its own address)
  in the node's pod prefix, a /24 for IPv4 and a /64 for IPv6, both drawn
  from the seed; that endpoint is the destination on an `inbound_share`
  of the flows and the source on the rest. The other endpoint is a random
  address;
- `flows_per_eviction`, `pool`: the size of each eviction and how many
  distinct evictions the pool holds;
- `hand`: the order in which the harness hands the pool (`hand_order`):
  "shuffle" passes over it in a fresh random order each time, "cycle" in
  the pool's own order;
- `draw`: "zipf" takes each eviction's flows without replacement with
  activity weights rank^-`zipf_a` over a fixed random ranking, so heavy
  flows recur tick after tick; "sequential" takes the universe in a fixed
  random order, `flows_per_eviction` at a time, so a flow recurs only after
  all the others have passed;
- `jitter`: each eviction scales every flow's rate by one factor drawn from
  this range; a row's bytes are max(rate * factor, rate floor) and its
  packets bytes over the flow's packet size, rounded up;
- order: an eviction lists its flows as a kernel hash map drains them,
  bucket by bucket: by a fixed random bucket number of each flow;
- per row: RTT uniform over `rtt_us`, a DNS latency uniform over
  `dns_latency_us` on a `dns_share` of the rows, drops on a `drop_share`
  (bytes uniform over `drop_bytes`, one packet, cause `drop_cause`), TCP
  flags of `tcp_flag_bits` random bits, a DSCP below `dscp_values`, and
  QUIC and NAT markers each on a `marker_share` of the rows.

Every draw comes from one generator seeded by the run's seed, so a seed
gives the same pool, row for row.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: bytes 8..11 of a v4-mapped IPv6 address as a little-endian word
V4_MAPPED_WORD2 = 0xFFFF0000


@dataclass
class Pool:
    """The pool of evictions: `events[i]` and its feature lanes
    `lanes[i]` (numpy structured arrays), and `flow_ids[i]` the universe
    index of each row."""

    events: list
    lanes: list
    flow_ids: list

    def __len__(self) -> int:
        return len(self.events)


def load_mix(root: Path, name: str) -> dict:
    """The mix `name`'s parameters, from `traffic/<name>.json` under
    `root`."""
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def hand_order(mix: dict, seed: int, passes: int = 4096) -> np.ndarray:
    """The pool index of each eviction handed, in order: `passes` passes
    over the pool, each in the order the mix's `hand` says."""
    n = int(mix["pool"])
    if mix["hand"] == "cycle":
        return np.tile(np.arange(n), passes)
    if mix["hand"] != "shuffle":
        raise ValueError(f"unknown hand {mix['hand']!r}")
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x0DE5])
    return np.concatenate([rng.permutation(n) for _ in range(passes)])


def _node_side(rng: np.random.Generator, mix: dict, v4: np.ndarray
               ) -> np.ndarray:
    """The node's endpoint of each flow as four address words: one of
    `node_addresses` host numbers in the node's IPv4 /24 (v4-mapped) or
    IPv6 /64, both prefixes drawn from the seed."""
    n = len(v4)
    net4 = np.array([10, *rng.integers(0, 256, 2)], np.uint32)
    net6 = np.concatenate([[0xFD], rng.integers(0, 256, 7)]).astype(np.uint8)
    host = rng.integers(1, int(mix["node_addresses"]) + 1, n).astype(
        np.uint32)
    out = np.zeros((n, 4), np.uint32)
    out[:, 0:2] = net6.view(np.uint32)
    out[:, 3] = host << 24
    out[v4, 0:2] = 0
    out[v4, 2] = V4_MAPPED_WORD2
    out[v4, 3] = net4[0] | (net4[1] << 8) | (net4[2] << 16) | (
        host[v4] << 24)
    return out


def _universe(rng: np.random.Generator, mix: dict) -> dict:
    n = int(mix["universe"])
    words = rng.integers(0, 1 << 32, (n, 10), dtype=np.uint64).astype(
        np.uint32)
    v4 = rng.random(n) >= float(mix["v6_share"])
    w = words[v4]
    w[:, [0, 1, 4, 5]] = 0
    w[:, [2, 6]] = V4_MAPPED_WORD2
    words[v4] = w
    node = _node_side(rng, mix, v4)
    inbound = rng.random(n) < float(mix["inbound_share"])
    words[inbound, 4:8] = node[inbound]
    words[~inbound, 0:4] = node[~inbound]
    # word 9 holds the protocol and the ICMP type and code: 24 bits
    words[:, 9] &= 0xFFFFFF
    alpha = float(mix["rate_pareto_alpha"])
    rate = float(mix["rate_floor_bytes"]) * (1.0 - rng.random(n)) ** (
        -1.0 / alpha)
    lo, hi = mix["packet_bytes"]
    inv_weight = np.arange(1, n + 1, dtype=np.float64) ** float(
        mix.get("zipf_a", 0.0))
    return {"words": words, "rate": rate, "inv_weight": inv_weight,
            "pkt": rng.integers(lo, hi + 1, n).astype(np.float64),
            "order": rng.permutation(n),
            "bucket": rng.integers(0, 1 << 32, n, dtype=np.uint64)}


def _draw(rng: np.random.Generator, mix: dict, uni: dict, i: int
          ) -> np.ndarray:
    """The universe indices of eviction i, in the order the map drains:
    by hash bucket, a fixed random number of each flow, so a flow that
    recurs sits near the same place in every eviction."""
    n, k = len(uni["rate"]), int(mix["flows_per_eviction"])
    if mix["draw"] == "sequential":
        ids = uni["order"][(i * k + np.arange(k)) % n]
    elif mix["draw"] == "zipf":
        # Efraimidis-Spirakis: the k largest of u^(1/w) are a weighted draw
        # without replacement, w = rank^-zipf_a
        keys = np.log(rng.random(n)) * uni["inv_weight"]
        ids = uni["order"][np.argpartition(-keys, k - 1)[:k]]
    else:
        raise ValueError(f"unknown draw {mix['draw']!r}")
    return ids[np.argsort(uni["bucket"][ids], kind="stable")]


def make_pool(mix: dict, seed: int, dtypes: dict) -> Pool:
    """The pool of a mix for a seed. `dtypes` gives the record layouts by
    name: `event`, `extra`, `dns`, `drops`, `xlat`, `quic`."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x5EED])
    uni = _universe(rng, mix)
    events, lanes, ids_out = [], [], []
    for i in range(int(mix["pool"])):
        ids = _draw(rng, mix, uni, i)
        k = len(ids)
        lo, hi = mix["jitter"]
        factor = rng.uniform(lo, hi)
        floor = float(mix["rate_floor_bytes"])
        nbytes = np.maximum(np.floor(uni["rate"][ids] * factor), floor)
        packets = np.ceil(nbytes / uni["pkt"][ids])
        ev = np.zeros(k, dtypes["event"])
        w = uni["words"][ids]
        key, st = ev["key"], ev["stats"]
        key["src_ip"] = np.ascontiguousarray(w[:, 0:4]).view(
            np.uint8).reshape(k, 16)
        key["dst_ip"] = np.ascontiguousarray(w[:, 4:8]).view(
            np.uint8).reshape(k, 16)
        key["src_port"] = w[:, 8] >> 16
        key["dst_port"] = w[:, 8] & 0xFFFF
        key["proto"] = (w[:, 9] >> 16) & 0xFF
        key["icmp_type"] = (w[:, 9] >> 8) & 0xFF
        key["icmp_code"] = w[:, 9] & 0xFF
        st["bytes"] = nbytes.astype(np.uint64)
        st["packets"] = packets.astype(np.uint32)
        st["tcp_flags"] = rng.integers(0, 1 << int(mix["tcp_flag_bits"]), k)
        st["dscp"] = rng.integers(0, int(mix["dscp_values"]), k)
        extra = np.zeros(k, dtypes["extra"])
        r0, r1 = mix["rtt_us"]
        extra["rtt_ns"] = rng.integers(r0, r1 + 1, k).astype(np.uint64) * 1000
        dns = np.zeros(k, dtypes["dns"])
        d0, d1 = mix["dns_latency_us"]
        lat = rng.integers(d0, d1 + 1, k).astype(np.uint64) * 1000
        dns["latency_ns"] = np.where(rng.random(k) < float(mix["dns_share"]),
                                     lat, 0)
        drops = np.zeros(k, dtypes["drops"])
        dropped = rng.random(k) < float(mix["drop_share"])
        b0, b1 = mix["drop_bytes"]
        drops["bytes"] = np.where(dropped, rng.integers(b0, b1 + 1, k), 0)
        drops["packets"] = dropped
        drops["latest_cause"] = np.where(dropped, int(mix["drop_cause"]), 0)
        share = float(mix["marker_share"])
        quic = np.zeros(k, dtypes["quic"])
        quic["version"] = rng.random(k) < share
        xlat = np.zeros(k, dtypes["xlat"])
        nat = rng.random(k) < share
        xlat["src_ip"][nat, 0] = 1
        xlat["dst_ip"][nat, 0] = 1
        events.append(ev)
        lanes.append({"extra": extra, "dns": dns, "drops": drops,
                      "xlat": xlat, "quic": quic})
        ids_out.append(ids.astype(np.int64))
    return Pool(events, lanes, ids_out)
