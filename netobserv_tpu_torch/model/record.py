"""Enriched flow record — what the record path's exporters consume.

A copy of `netobserv_tpu/model/record.py` (lines 1-261): the interface
namer hook, `MonotonicClock`, `Record` and `records_from_events`, which
reconstruct wall-clock times from the datapath's monotonic timestamps,
name interfaces and carry per-feature metrics. `Record.to_json_obj` (the
stdout exporter's rendering, `:97-177`) is not here: the port's only
exporter, the sketch exporter, takes columnar evictions, and its
`export_batch` folds records without rendering them (ROADMAP A8 names the
record exporters).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dfield
from typing import Callable, Optional

import numpy as np

from netobserv_tpu_torch.model.flow import Direction, FlowFeatures, FlowKey

# interfaceNamer hook (reference: `model.SetInterfaceNamer`,
# `pkg/agent/interfaces_listener.go:74-81`)
InterfaceNamer = Callable[[int, bytes], str]


def default_namer(if_index: int, mac: bytes) -> str:
    return str(if_index)


_namer: InterfaceNamer = default_namer


def set_interface_namer(namer: InterfaceNamer) -> None:
    global _namer
    _namer = namer


def interface_namer() -> InterfaceNamer:
    return _namer


class MonotonicClock:
    """Maps datapath monotonic-ns timestamps to wall-clock epochs.

    Reference analog: `pkg/model/record.go:90-97` — current wall time minus the
    (current mono - sample mono) delta. One instance is shared per agent so every
    batch uses a consistent mapping.
    """

    def now_pair(self) -> tuple[int, int]:
        return time.clock_gettime_ns(time.CLOCK_MONOTONIC), time.time_ns()

    def wall_ns(self, mono_ns: int) -> int:
        cur_mono, cur_wall = self.now_pair()
        return cur_wall - (cur_mono - mono_ns)

    def wall_ns_array(self, mono_ns: np.ndarray) -> np.ndarray:
        cur_mono, cur_wall = self.now_pair()
        offset = cur_wall - cur_mono
        return mono_ns.astype(np.int64) + offset


@dataclass(slots=True)
class Record:
    """One enriched flow (reference: `pkg/model/record.go:66-80`)."""

    key: FlowKey
    bytes_: int = 0
    packets: int = 0
    eth_protocol: int = 0
    tcp_flags: int = 0
    direction: int = int(Direction.INGRESS)
    src_mac: bytes = b"\x00" * 6
    dst_mac: bytes = b"\x00" * 6
    if_index: int = 0
    interface: str = ""
    udn: str = ""
    dscp: int = 0
    sampling: int = 0
    errno_fallback: int = 0
    time_flow_start_ns: int = 0  # wall clock
    time_flow_end_ns: int = 0
    mono_start_ns: int = 0
    mono_end_ns: int = 0
    agent_ip: str = ""
    # (interface, direction, udn) observations across NICs — the reference's DupMap
    dup_list: list[tuple[str, int, str]] = dfield(default_factory=list)
    features: FlowFeatures = dfield(default_factory=FlowFeatures)
    ssl_version: int = 0
    tls_cipher_suite: int = 0
    tls_key_share: int = 0
    tls_types: int = 0
    ssl_mismatch: bool = False


def records_from_events(
    events: np.ndarray,
    clock: Optional[MonotonicClock] = None,
    agent_ip: str = "",
    namer: Optional[InterfaceNamer] = None,
) -> list[Record]:
    """Materialize Record objects from a decoded structured array of flow events."""
    clock = clock or MonotonicClock()
    namer = namer or _namer
    if len(events) == 0:
        return []
    cur_mono, cur_wall = clock.now_pair()
    offset = cur_wall - cur_mono  # one offset per batch keeps spans exact
    stats = events["stats"]
    keys = events["key"]
    n = len(events)
    # bulk-convert columns ONCE (C-speed) instead of per-element numpy scalar
    # conversions — this loop is the Record-path hot spot (the reference's
    # "single hottest allocation site", pkg/model/record_bench_test.go)
    starts = (stats["first_seen_ns"].astype(np.int64) + offset).tolist()
    ends = (stats["last_seen_ns"].astype(np.int64) + offset).tolist()
    monos_s = stats["first_seen_ns"].tolist()
    monos_e = stats["last_seen_ns"].tolist()
    ip_w = keys["src_ip"].shape[1]  # stride from the dtype, not a literal
    mac_w = stats["src_mac"].shape[1]
    src_ip_buf = np.ascontiguousarray(keys["src_ip"]).tobytes()
    dst_ip_buf = np.ascontiguousarray(keys["dst_ip"]).tobytes()
    src_mac_buf = np.ascontiguousarray(stats["src_mac"]).tobytes()
    dst_mac_buf = np.ascontiguousarray(stats["dst_mac"]).tobytes()
    sports = keys["src_port"].tolist()
    dports = keys["dst_port"].tolist()
    protos = keys["proto"].tolist()
    itypes = keys["icmp_type"].tolist()
    icodes = keys["icmp_code"].tolist()
    nbytes = stats["bytes"].tolist()
    pkts = stats["packets"].tolist()
    eths = stats["eth_protocol"].tolist()
    flags = stats["tcp_flags"].tolist()
    dirs = stats["direction_first"].tolist()
    ifidx = stats["if_index_first"].tolist()
    dscps = stats["dscp"].tolist()
    samplings = stats["sampling"].tolist()
    errnos = stats["errno_fallback"].tolist()
    ssl_vers = stats["ssl_version"].tolist()
    ciphers = stats["tls_cipher_suite"].tolist()
    shares = stats["tls_key_share"].tolist()
    ttypes = stats["tls_types"].tolist()
    miscs = stats["misc_flags"].tolist()
    n_obs = stats["n_observed_intf"].tolist()
    obs_if = stats["observed_intf"].tolist()
    obs_dir = stats["observed_direction"].tolist()

    out: list[Record] = []
    for i in range(n):
        key = FlowKey(
            src_ip=src_ip_buf[i * ip_w:(i + 1) * ip_w],
            dst_ip=dst_ip_buf[i * ip_w:(i + 1) * ip_w],
            src_port=sports[i], dst_port=dports[i], proto=protos[i],
            icmp_type=itypes[i], icmp_code=icodes[i],
        )
        mac = src_mac_buf[i * mac_w:(i + 1) * mac_w]
        rec = Record(
            key=key,
            bytes_=nbytes[i], packets=pkts[i],
            eth_protocol=eths[i], tcp_flags=flags[i], direction=dirs[i],
            src_mac=mac, dst_mac=dst_mac_buf[i * mac_w:(i + 1) * mac_w],
            if_index=ifidx[i], interface=namer(ifidx[i], mac),
            dscp=dscps[i], sampling=samplings[i], errno_fallback=errnos[i],
            time_flow_start_ns=starts[i], time_flow_end_ns=ends[i],
            mono_start_ns=monos_s[i], mono_end_ns=monos_e[i],
            agent_ip=agent_ip,
            ssl_version=ssl_vers[i], tls_cipher_suite=ciphers[i],
            tls_key_share=shares[i], tls_types=ttypes[i],
            ssl_mismatch=bool(miscs[i] & 0x01),
        )
        seen_obs = set()
        for j in range(min(n_obs[i], len(obs_if[i]))):
            # skip slots a racing reservation published but hasn't written
            # yet (ifindex 0 is never a real interface), and dedup entries a
            # same-interface append race may have duplicated
            pair = (int(obs_if[i][j]), int(obs_dir[i][j]))
            if pair[0] == 0 or pair in seen_obs:
                continue
            seen_obs.add(pair)
            rec.dup_list.append((namer(obs_if[i][j], mac), obs_dir[i][j], ""))
        out.append(rec)
    return out
