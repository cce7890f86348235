"""The port's gRPC-ingest datapath (netobserv_tpu_torch/datapath/
grpc_ingest.py) against the JAX package's (netobserv_tpu/datapath/
grpc_ingest.py), on the CPU.

- `pb_records_to_events`: one seeded, serialized pbflow `Records` (v4
  and v6, ICMP, records with and without RTT and DNS, zero times, a DNS
  errno alone, and records whose network, transport, times, RTT or DNS
  latency sub-messages are absent) parsed by the reference's `flow_pb2`
  and by the port's `pb/flow.Records`; both conversions run under one
  patched clock pair (the monotonic read, then the wall read, which both
  modules take from the `time` module), and the events, extra and DNS
  arrays are equal field by field, byte for byte.
- `GrpcIngestFetcher`: the same messages pushed to each package's
  fetcher over its own collector (the port's client and transport, and
  grpcio with `flow_pb2`) give equal `EvictedFlows` under the same
  clock, including the rule that `extra` and `dns` are present only
  where some row has an RTT, or a DNS latency or id; an empty inbox
  gives an empty eviction, and the port's fetcher answers every method
  of the port's `FlowFetcher` protocol, `read_ssl` included.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest

from netobserv_tpu.datapath import grpc_ingest as jingest
from netobserv_tpu.grpc import flow as jgflow
from netobserv_tpu.pb import flow_pb2
from netobserv_tpu_torch.datapath import fetcher as tfetcher
from netobserv_tpu_torch.datapath import grpc_ingest as tingest
from netobserv_tpu_torch.grpc import flow as tgflow
from netobserv_tpu_torch.pb import flow as pbflow

#: the patched clock pair: (monotonic ns, wall ns)
MONO_NS = 912_345_678_901_234
WALL_NS = 1_792_330_748_724_000_123


def _ip(rng, kind: str) -> pbflow.IP:
    if kind == "v4":
        return pbflow.IP(ipv4=int(rng.integers(0, 1 << 32)))
    if kind == "zero6":
        return pbflow.IP(ipv6=bytes(16))
    return pbflow.IP(ipv6=rng.bytes(16))


def _ts(ns: int) -> pbflow.Timestamp:
    t = pbflow.Timestamp()
    t.FromNanoseconds(ns)
    return t


def _dur(ns: int) -> pbflow.Duration:
    d = pbflow.Duration()
    d.FromNanoseconds(ns)
    return d


def seeded_pb(rng) -> pbflow.Record:
    """One pbflow record of the port's classes; about one in six lacks
    each optional sub-message."""
    proto = int(rng.choice([6, 17, 1, 58]))
    icmp = proto in (1, 58)
    pb = pbflow.Record(
        eth_protocol=int(rng.choice([0x0800, 0x86DD])),
        direction=int(rng.integers(0, 2)),
        bytes=int(rng.integers(0, 1 << 40)),
        packets=int(rng.integers(0, 1 << 31)),
        flags=int(rng.integers(0, 1 << 12)),
        icmp_type=int(rng.integers(0, 256)) if icmp else 0,
        icmp_code=int(rng.integers(0, 256)) if icmp else 0,
        sampling=int(rng.integers(0, 3)),
        interface="eth0")
    if rng.random() > 1 / 6:
        kinds = ("v4", "v6", "zero6")
        pb.network = pbflow.Network(
            src_addr=_ip(rng, kinds[int(rng.integers(0, 3))]),
            dst_addr=(_ip(rng, kinds[int(rng.integers(0, 3))])
                      if rng.random() > 0.1 else None),
            dscp=int(rng.integers(0, 64)))
    if rng.random() > 1 / 6:
        pb.transport = pbflow.Transport(
            src_port=int(rng.integers(0, 65536)),
            dst_port=int(rng.integers(0, 65536)), protocol=proto)
    r = rng.random()
    if r < 0.1:
        pass                                   # both times absent
    elif r < 0.2:
        pb.time_flow_start, pb.time_flow_end = _ts(0), _ts(0)
    else:
        start = WALL_NS - int(rng.integers(0, 10**11))
        pb.time_flow_start = _ts(start)
        pb.time_flow_end = _ts(start + int(rng.integers(0, 10**10)))
    if rng.random() < 0.4:
        pb.time_flow_rtt = _dur(int(rng.integers(1, 3 * 10**9)))
    elif rng.random() < 0.2:
        pb.time_flow_rtt = _dur(0)
    d = rng.random()
    if d < 0.3:
        pb.dns_id = int(rng.integers(1, 1 << 16))
        pb.dns_flags = int(rng.integers(0, 1 << 16))
        pb.dns_errno = int(rng.integers(0, 3))
        pb.dns_name = str(rng.choice(["example.com", "",
                                      "a-very-long-name." * 3 + "test",
                                      "ünï.test"]))
        if rng.random() < 0.7:
            pb.dns_latency = _dur(int(rng.integers(0, 5 * 10**9)))
    elif d < 0.4:
        pb.dns_errno = int(rng.integers(1, 3))  # an errno alone
    return pb


def seeded_records(seed: int, n: int) -> pbflow.Records:
    rng = np.random.default_rng(seed)
    return pbflow.Records(entries=[seeded_pb(rng) for _ in range(n)])


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both modules read `time.clock_gettime_ns` and `time.time_ns` of the
    one `time` module: one patch pins both reads in both."""
    assert jingest.time is tingest.time is time
    monkeypatch.setattr(time, "clock_gettime_ns", lambda clk: MONO_NS)
    monkeypatch.setattr(time, "time_ns", lambda: WALL_NS)


def _equal(a, b) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    for name in a.dtype.names:
        assert np.array_equal(a[name], b[name]), name
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_convert_as_the_reference(seed, fixed_clock):
    data = seeded_records(seed, 300).SerializeToString()
    ref = flow_pb2.Records.FromString(data)
    ours = pbflow.Records.FromString(data)
    want = jingest.pb_records_to_events(list(ref.entries))
    got = tingest.pb_records_to_events(ours.entries)
    for g, w in zip(got, want):
        _equal(g, w)
    events, extra, dns = got
    # the seeded draw reaches every branch
    assert (events["stats"]["first_seen_ns"] == 0).any()
    assert (events["stats"]["first_seen_ns"] > 0).any()
    assert (extra["rtt_ns"] > 0).any() and (extra["rtt_ns"] == 0).any()
    assert ((dns["errno"] > 0) & (dns["dns_id"] == 0)).any()
    assert ((dns["dns_id"] > 0) & (dns["latency_ns"] == 0)).any()
    assert any(e.network is None for e in ours.entries)
    assert any(e.transport is None for e in ours.entries)
    assert any(e.time_flow_start is None for e in ours.entries)


def test_a_record_of_defaults_converts():
    """A record with no sub-message at all: zero rows, no exception."""
    events, extra, dns = tingest.pb_records_to_events([pbflow.Record()])
    assert not events.tobytes().strip(b"\x00")
    assert not extra.tobytes().strip(b"\x00")
    assert not dns.tobytes().strip(b"\x00")
    ref = jingest.pb_records_to_events([flow_pb2.Record()])
    for g, w in zip((events, extra, dns), ref):
        _equal(g, w)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _push(fetcher, client_send, messages: list[bytes], want: int):
    """Push each serialized message, then wait until all have queued."""
    for m in messages:
        client_send(m)
    deadline = time.monotonic() + 10
    while fetcher._inbox.qsize() < want and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fetcher._inbox.qsize() == want


@pytest.mark.parametrize("case", ["mixed", "no_features", "errno_only",
                                  "dns_only", "rtt_only"])
def test_fetchers_evict_alike(case, monkeypatch):
    rng = np.random.default_rng(7)
    msgs = []
    for m in range(3):
        recs = seeded_records(10 + m, 40)
        for pb in recs.entries:
            if case != "mixed":
                pb.time_flow_rtt = (_dur(int(rng.integers(1, 10**9)))
                                    if case == "rtt_only" else None)
                if case != "dns_only":
                    pb.dns_latency, pb.dns_id = None, 0
                    pb.dns_errno = 0 if case != "errno_only" else 2
                else:
                    pb.dns_id = int(rng.integers(1, 1 << 16))
        msgs.append(recs.SerializeToString())
    ours = tingest.GrpcIngestFetcher(0)
    ref = jingest.GrpcIngestFetcher(0)
    tclient = tgflow.FlowClient("127.0.0.1", ours.port)
    jclient = jgflow.FlowClient("127.0.0.1", ref.port)
    try:
        empty = ours.lookup_and_delete()
        assert len(empty) == 0 and empty.events.dtype == \
            jingest.binfmt.FLOW_EVENT_DTYPE
        _push(ours, lambda m: tclient.send(pbflow.Records.FromString(m)),
              msgs, len(msgs))
        _push(ref, lambda m: jclient.send(flow_pb2.Records.FromString(m)),
              msgs, len(msgs))
        monkeypatch.setattr(time, "clock_gettime_ns", lambda clk: MONO_NS)
        monkeypatch.setattr(time, "time_ns", lambda: WALL_NS)
        got, want = ours.lookup_and_delete(), ref.lookup_and_delete()
        monkeypatch.undo()
        assert len(got) == len(want) == 120
        _equal(got.events, want.events)
        for lane in ("extra", "dns", "drops", "xlat", "quic", "nevents"):
            g, w = getattr(got, lane), getattr(want, lane)
            assert (g is None) == (w is None), lane
            if g is not None:
                _equal(g, w)
        assert (got.extra is None) == (case not in ("mixed", "rtt_only"))
        assert (got.dns is None) == (case not in ("mixed", "dns_only"))
        assert len(ours.lookup_and_delete()) == 0
    finally:
        tclient.close()
        jclient.close()
        ours.close()
        ref.close()


def test_the_fetcher_answers_the_whole_protocol():
    """Every method of the port's `FlowFetcher` protocol, `read_ssl`
    (which the reference's fetcher lacks) included."""
    names = [n for n in vars(tfetcher.FlowFetcher)
             if not n.startswith("_")]
    assert "read_ssl" in names and "lookup_and_delete" in names
    f = tingest.GrpcIngestFetcher(0)
    try:
        for n in names:
            assert callable(getattr(f, n, None)), n
        assert f.read_ssl(0.01) is None
        assert f.read_ringbuf(0.01) is None
        assert f.read_global_counters() == {}
        assert f.purge_stale(1.0) == 0
        f.attach(1, "lo", "ingress")
        f.detach(1, "lo")
    finally:
        f.close()
    assert not hasattr(jingest.GrpcIngestFetcher, "read_ssl")


def test_datapath_grpc_builds_the_ingest_fetcher(monkeypatch):
    """`build_fetcher` with DATAPATH=grpc:<port> returns a
    `GrpcIngestFetcher` serving that port, as the reference's does."""
    from netobserv_tpu_torch import config as tcfg
    from netobserv_tpu_torch.agent.agent import build_fetcher
    port = _free_port()
    monkeypatch.setenv("DATAPATH", f"grpc:{port}")
    f = build_fetcher(tcfg.load_config({}))
    try:
        assert isinstance(f, tingest.GrpcIngestFetcher)
        assert f.port == port
        client = tgflow.FlowClient("127.0.0.1", port)
        client.send(pbflow.Records(entries=[pbflow.Record(bytes=7)]))
        client.close()
        deadline = time.monotonic() + 10
        got = f.lookup_and_delete()
        while not len(got) and time.monotonic() < deadline:
            time.sleep(0.01)
            got = f.lookup_and_delete()
        assert int(got.events["stats"]["bytes"][0]) == 7
    finally:
        f.close()
