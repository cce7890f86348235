"""The gRPC-ingest datapath: a collector-tier worker's record source.

A copy of `netobserv_tpu/datapath/grpc_ingest.py` (lines 1-122) on the
port's own transport and flow wire. Per-node agents export over gRPC
(EXPORT=grpc, the pbflow wire); a central worker runs with
`DATAPATH=grpc:<port>` and `EXPORT=tpu-sketch`, and folds the incoming
stream into cluster-wide sketches on its card.

`GrpcIngestFetcher` serves `pbflow.Collector` with
`grpc/flow.start_flow_collector` (`grpc/h2.py`, the port's `pb/flow.py`
messages) and answers the port's whole `FlowFetcher` protocol
(`datapath/fetcher.py`): each `lookup_and_delete()` drains every message
received since the last one into one `EvictedFlows`, which the map tracer
hands the sketch exporter columnar. It reads no ring buffer and no SSL
events (`read_ssl`, which the reference's fetcher lacks, sleeps and
answers None).

`pb_records_to_events` rebases the wall-clock pb times on the local
monotonic clock, so the pipeline's enrichment gives back the original
wall times. The rebase reads the monotonic clock, then the wall clock,
as the reference's does. An absent sub-message is None in the port's
pbflow (ROADMAP C5), where protobuf gives a default instance: absent
times, RTT and DNS latency read as 0, an absent network or transport as
its defaults, so a record without them converts as the reference's does.
"""

from __future__ import annotations

import logging
import queue
import time
from typing import Optional

import numpy as np

from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.pb_convert import _get_ip, _ns
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.flow import GlobalCounter
from netobserv_tpu_torch.pb import flow as pbflow

log = logging.getLogger("netobserv_tpu_torch.datapath.grpc_ingest")


def pb_records_to_events(entries) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pbflow `Record`s -> (FLOW_EVENT, EXTRA_REC, DNS_REC) arrays
    (`grpc_ingest.py:29-75`)."""
    n = len(entries)
    events = np.zeros(n, dtype=binfmt.FLOW_EVENT_DTYPE)
    extra = np.zeros(n, dtype=binfmt.EXTRA_REC_DTYPE)
    dns = np.zeros(n, dtype=binfmt.DNS_REC_DTYPE)
    mono_now = time.clock_gettime_ns(time.CLOCK_MONOTONIC)
    wall_now = time.time_ns()
    offset = wall_now - mono_now  # wall -> mono rebase
    for i, pb in enumerate(entries):
        network = pb.network or pbflow.Network()
        transport = pb.transport or pbflow.Transport()
        k = events[i]["key"]
        k["src_ip"] = np.frombuffer(_get_ip(network.src_addr), np.uint8)
        k["dst_ip"] = np.frombuffer(_get_ip(network.dst_addr), np.uint8)
        k["src_port"] = transport.src_port
        k["dst_port"] = transport.dst_port
        k["proto"] = transport.protocol
        k["icmp_type"] = pb.icmp_type
        k["icmp_code"] = pb.icmp_code
        s = events[i]["stats"]
        s["bytes"] = pb.bytes
        s["packets"] = pb.packets
        s["eth_protocol"] = pb.eth_protocol
        s["tcp_flags"] = pb.flags
        s["direction_first"] = int(pb.direction)
        s["dscp"] = network.dscp
        s["sampling"] = pb.sampling
        s["first_seen_ns"] = max(_ns(pb.time_flow_start) - offset, 0)
        s["last_seen_ns"] = max(_ns(pb.time_flow_end) - offset, 0)
        rtt = _ns(pb.time_flow_rtt)
        if rtt:
            extra[i]["rtt_ns"] = rtt
            extra[i]["first_seen_ns"] = s["first_seen_ns"]
            extra[i]["last_seen_ns"] = s["last_seen_ns"]
        lat = _ns(pb.dns_latency)
        if lat or pb.dns_id or pb.dns_errno:
            dns[i]["latency_ns"] = lat
            dns[i]["dns_id"] = pb.dns_id
            dns[i]["dns_flags"] = pb.dns_flags
            dns[i]["errno"] = pb.dns_errno
            dns[i]["name"] = pb.dns_name.encode()[:31]
            dns[i]["first_seen_ns"] = s["first_seen_ns"]
            dns[i]["last_seen_ns"] = s["last_seen_ns"]
    return events, extra, dns


class GrpcIngestFetcher:
    """A FlowFetcher over an embedded `pbflow.Collector` server
    (`grpc_ingest.py:78-122`); `port` 0 binds a free one, then `port` is
    the bound one."""

    def __init__(self, port: int):
        from netobserv_tpu_torch.grpc.flow import start_flow_collector
        self._server, self.port, self._inbox = start_flow_collector(port)
        log.info("grpc ingest listening on :%d", self.port)

    def lookup_and_delete(self) -> EvictedFlows:
        """Every message received since the last call, as one eviction;
        `extra` and `dns` only where some row carries an RTT, a DNS
        latency or a DNS id."""
        batches = []
        while True:
            try:
                batches.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        if not batches:
            return EvictedFlows(np.zeros(0, dtype=binfmt.FLOW_EVENT_DTYPE))
        entries = [e for msg in batches for e in msg.entries]
        events, extra, dns = pb_records_to_events(entries)
        return EvictedFlows(
            events,
            extra=extra if extra["rtt_ns"].any() else None,
            dns=dns if (dns["latency_ns"].any() or dns["dns_id"].any()) else None)

    def read_ringbuf(self, timeout_s: float) -> Optional[bytes]:
        time.sleep(timeout_s)
        return None

    def read_ssl(self, timeout_s: float) -> Optional[bytes]:
        time.sleep(timeout_s)
        return None

    def read_global_counters(self) -> dict[GlobalCounter, int]:
        return {}

    def purge_stale(self, older_than_s: float) -> int:
        return 0

    def attach(self, if_index: int, if_name: str, direction: str,
               netns: str = "") -> None:
        pass

    def detach(self, if_index: int, if_name: str,
               netns: str = "") -> None:
        pass

    def close(self) -> None:
        self._server.stop(grace=0.5)
