"""The port's embedded flowlogs-pipeline (netobserv_tpu_torch/exporter/
direct_flp.py, flp_map.py, flp_tables.py, flp_enrich.py and
`exporter.build_exporter`'s EXPORT=direct-flp) against the JAX package's,
on the CPU.

It holds a twin of each of `tests/test_direct_flp.py`'s 30 tests, on the
same configurations, and cases those leave out (heartbeats, every
timebased operation, seeded batches through each stdout configuration,
the Loki and SigV4 wire on seeded entries). The port's
`DirectFLPExporter` and the reference's are fed equal records
(`tests.test_torch_pbflow.to_ref` of one port record) and must give

- the same JSON lines, byte for byte;
- the same prom samples after each batch (`_created` timestamps aside);
- the same conntrack, aggregates and timebased records under one patched
  clock (`time.monotonic`), never by sleeping;
- the same Kafka messages at a `FakeBroker`, the same IPFIX bytes under a
  fixed `time.time`, the same pbflow `Records` at the port's collector;
- the same S3 PUTs (path, SigV4 headers, body) under a fixed clock and
  stream id, and the same Loki bodies and headers.

The string tables are held against the reference's tables, and each twin
also keeps its original's assertions on the port's output. Seeded records
add `record_to_map` and `map_to_record` against the reference's.
"""

from __future__ import annotations

import datetime
import http.server
import io
import ipaddress
import json
import socket
import struct
import threading
import time
import urllib.request
import uuid

import prometheus_client
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.exporter import build_exporter as ref_build
from netobserv_tpu.exporter import direct_flp as rdfl
from netobserv_tpu.exporter import flp_enrich as renrich
from netobserv_tpu.exporter import flp_map as rmap
from netobserv_tpu.exporter import flp_tables as rtables
from netobserv_tpu.kafka.producer import KafkaProducer as RefProducer
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.exporter import build_exporter
from netobserv_tpu_torch.exporter import direct_flp as pdfl
from netobserv_tpu_torch.exporter import flp_enrich as penrich
from netobserv_tpu_torch.exporter import flp_map as pmap
from netobserv_tpu_torch.exporter import flp_tables as ptables
from netobserv_tpu_torch.grpc.flow import start_flow_collector
from netobserv_tpu_torch.kafka.producer import KafkaProducer
from netobserv_tpu_torch.metrics import registry as facade
from netobserv_tpu_torch.model import flow as pflow
from netobserv_tpu_torch.model import record as precord
from tests.test_direct_flp import (
    CFG, CT_CFG, GRPC_CFG_TMPL, IPFIX_CFG_TMPL, K8S_LOC_CFG, KAFKA_CFG,
)
from tests.test_kafka_broker import FakeBroker
from tests.test_torch_kafka import _batch_records
from tests.test_torch_pbflow import _named, as_tuple, seeded_records, to_ref

#: the records' wall clock (the reference's `make_record` reads now)
T0_NS = 1_700_000_000_123_456_789


def make_record(src="10.1.1.1", dst="10.2.2.2", sport=1111, dport=443,
                proto=6, nbytes=4321, with_features=True
                ) -> precord.Record:
    """The port twin of `tests.test_exporters.make_record`, at T0_NS."""
    r = precord.Record(
        key=pflow.FlowKey.make(src, dst, sport, dport, proto),
        bytes_=nbytes, packets=7, eth_protocol=0x0800, tcp_flags=0x12,
        direction=1, src_mac=b"\x02\x00\x00\x00\x00\x01",
        dst_mac=b"\x02\x00\x00\x00\x00\x02", if_index=3, interface="eth0",
        dscp=46, sampling=1, time_flow_start_ns=T0_NS - 10**9,
        time_flow_end_ns=T0_NS, agent_ip="192.0.2.1",
        dup_list=[("eth0", 0, "")],
        ssl_version=0x0304, tls_cipher_suite=0x1301, tls_types=0x0C)
    if with_features:
        r.features = pflow.FlowFeatures(
            dns_id=77, dns_flags=0x8180, dns_latency_ns=2_500_000,
            dns_name="example.com", drop_bytes=100, drop_packets=2,
            drop_latest_cause=5, rtt_ns=12_000_000, ipsec_encrypted=True,
            ipsec_encrypted_ret=0)
    return r


class Twin:
    """The port's and the reference's exporter on one configuration, each
    writing into its own buffer."""

    def __init__(self, cfg: str, port_kw=None, ref_kw=None):
        self.bufs = (io.StringIO(), io.StringIO())
        self.exps = (
            pdfl.DirectFLPExporter(flp_config=cfg, stream=self.bufs[0],
                                   **(port_kw or {})),
            rdfl.DirectFLPExporter(flp_config=cfg, stream=self.bufs[1],
                                   **(ref_kw or {})))

    def export(self, records) -> list:
        self.exps[0].export_batch(records)
        self.exps[1].export_batch([to_ref(r) for r in records])
        return self.lines()

    def close(self) -> list:
        for exp in self.exps:
            exp.close()
        return self.lines()

    def lines(self) -> list:
        """The port's JSON lines, once they equal the reference's."""
        ours, theirs = (b.getvalue() for b in self.bufs)
        assert ours == theirs
        return [json.loads(x) for x in ours.splitlines()]


def _run(cfg, records) -> list:
    return Twin(cfg).export(records)


def samples(reg) -> list:
    """Every sample of a registry but the `_created` timestamps."""
    return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                  for m in reg.collect() for s in m.samples
                  if not s.name.endswith("_created"))


class Clock:
    """One patched `time.monotonic` for both packages' timers."""

    def __init__(self, monkeypatch, t: float = 1000.0):
        self.t = t
        monkeypatch.setattr(time, "monotonic", lambda: self.t)

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    return Clock(monkeypatch)


# ------------------------------------------------------------- transforms


def test_pipeline_filters_renames_and_writes():
    out = _run(CFG, [make_record(proto=6), make_record(proto=17)])
    assert len(out) == 1  # UDP filtered by keep_entry_if_equal Proto=6
    entry = out[0]
    assert "SrcMac" not in entry  # removed
    assert entry["SourceAddress"] == "10.1.1.1"  # renamed (preserve policy)
    assert entry["SrcAddr"] == "10.1.1.1"


def test_empty_config_passthrough():
    out = _run("", [make_record()])
    assert len(out) == 1
    assert out[0]["DstPort"] == 443


def test_replace_keys_policy():
    cfg = """
pipeline: [{name: t}, {name: w, follows: t}]
parameters:
  - name: t
    transform:
      type: generic
      generic:
        policy: replace_keys
        rules:
          - {input: Bytes, output: octets}
          - {input: Packets, output: packets}
  - name: w
    write: {type: stdout}
"""
    out = _run(cfg, [make_record(nbytes=777)])
    assert out[0] == {"octets": 777, "packets": 7}


NET_CFG = """
pipeline: [{name: n}, {name: w, follows: n}]
parameters:
  - name: n
    transform:
      type: network
      network:
        subnetLabels:
          - name: internal
            cidrs: ["10.0.0.0/8"]
        directionInfo:
          reporterIPField: AgentIP
          srcHostField: SrcHost
          dstHostField: DstHost
          flowDirectionField: FlowDirection
          ifDirectionField: IfDirections
        rules:
          - type: add_subnet
            add_subnet: {input: SrcAddr, output: SrcSubnet, parameters: /24}
          - type: add_service
            add_service: {input: DstPort, output: Service, protocol: Proto}
          - type: add_subnet_label
            add_subnet_label: {input: SrcAddr, output: SrcLabel}
          - type: decode_tcp_flags
            decode_tcp_flags: {input: Flags, output: Flags}
          - type: reinterpret_direction
  - name: w
    write: {type: stdout}
"""


def _run_with_extra(cfg, records, extra, monkeypatch) -> list:
    """Both packages' `record_to_map` patched to add `extra`."""
    for mod in (pdfl, rdfl):
        orig = mod.record_to_map

        def patched(r, orig=orig):
            m = orig(r)
            m.update(extra)
            return m
        monkeypatch.setattr(mod, "record_to_map", patched)
    return _run(cfg, records)


def test_transform_network_rules(monkeypatch):
    r = make_record(proto=6)     # 10.1.1.1 -> 10.2.2.2:443, flags 0x12
    e = _run_with_extra(NET_CFG, [r], {
        "SrcHost": "nodeA", "DstHost": "nodeB", "FlowDirection": 1},
        monkeypatch)[0]
    assert e["SrcSubnet"] == "10.1.1.0/24"
    assert e["Service"] == "https"
    assert e["SrcLabel"] == "internal"
    assert set(e["Flags"]) == {"SYN", "ACK"}
    assert e["IfDirections"] == 1
    recs = _run_with_extra(NET_CFG, [r], {
        "SrcHost": "192.0.2.1", "DstHost": "nodeB", "FlowDirection": 0},
        monkeypatch)
    assert recs[0]["FlowDirection"] == 1     # reporter is src: egress
    recs = _run_with_extra(NET_CFG, [r], {
        "SrcHost": "x", "DstHost": "x", "FlowDirection": 0}, monkeypatch)
    assert recs[0]["FlowDirection"] == 2     # same node both ends: inner


# ------------------------------------------------------------ encode prom

PROM_CFG = """
pipeline: [{name: e}, {name: w, follows: e}]
parameters:
  - name: e
    encode:
      type: prom
      prom:
        prefix: flp_
        metrics:
          - name: flows_total
            type: counter
            labels: [Proto]
          - name: bytes_total
            type: counter
            valueKey: Bytes
            filters: [{type: equal, key: Proto, value: 6}]
          - name: last_bytes
            type: gauge
            valueKey: Bytes
          - name: bytes_hist
            type: histogram
            valueKey: Bytes
            buckets: [100, 10000]
  - name: w
    write: {type: stdout}
"""


class PromTwin(Twin):
    """A twin whose two sides each get a registry of their own: the
    port's from the facade, the reference's from prometheus_client."""

    def __init__(self, cfg: str, regs=None):
        self.regs = regs or (facade.new_registry(),
                             prometheus_client.CollectorRegistry())
        super().__init__(cfg, {"prom_registry": self.regs[0]},
                         {"prom_registry": self.regs[1]})

    def export(self, records) -> list:
        out = super().export(records)
        assert samples(self.regs[0]) == samples(self.regs[1])
        return out


def test_encode_prom_metrics():
    t = PromTwin(PROM_CFG)
    out = t.export([make_record(proto=6, nbytes=4321),
                    make_record(proto=17, nbytes=10)])
    assert len(out) == 2                       # encode passes entries through
    g = t.regs[0].get_sample_value
    assert g("flp_flows_total", {"Proto": "6"}) == 1
    assert g("flp_flows_total", {"Proto": "17"}) == 1
    assert g("flp_bytes_total") == 4321  # UDP filtered out
    assert g("flp_last_bytes") == 10           # latest entry wins
    assert g("flp_bytes_hist_bucket", {"le": "10000.0"}) == 2
    assert g("flp_bytes_hist_bucket", {"le": "100.0"}) == 1
    t.export([make_record(proto=6, nbytes=50)])
    assert g("flp_bytes_total") == 4371


DUP_CFG = """
pipeline: [{name: e}, {name: w, follows: e}]
parameters:
  - name: e
    encode:
      type: prom
      prom:
        metrics:
          - {name: dup_total, type: counter}
          - {name: dup_total, type: counter}
          - {name: ok_total, type: counter}
  - name: w
    write: {type: stdout}
"""


def test_encode_prom_duplicate_metric_skipped():
    t = PromTwin(DUP_CFG)
    t.export([make_record()])
    reg = t.regs[0]
    assert reg.get_sample_value("dup_total") == 1
    assert reg.get_sample_value("ok_total") == 1
    # a rebuild against the SAME registries adopts the live collectors
    t2 = PromTwin(DUP_CFG, regs=t.regs)
    t2.export([make_record()])
    assert reg.get_sample_value("dup_total") == 2
    assert reg.get_sample_value("ok_total") == 2


def test_encode_prom_cross_stage_duplicate_not_double_counted():
    cfg = """
pipeline: [{name: e1}, {name: e2, follows: e1}, {name: w, follows: e2}]
parameters:
  - name: e1
    encode:
      type: prom
      prom:
        metrics: [{name: xs_total, type: counter}]
  - name: e2
    encode:
      type: prom
      prom:
        metrics: [{name: xs_total, type: counter}]
  - name: w
    write: {type: stdout}
"""
    t = PromTwin(cfg)
    t.export([make_record()])
    assert t.regs[0].get_sample_value("xs_total") == 1


def _hist_cfg(buckets) -> str:
    return f"""
pipeline: [{{name: e}}, {{name: w, follows: e}}]
parameters:
  - name: e
    encode:
      type: prom
      prom:
        metrics:
          - {{name: h_bytes, type: histogram, valueKey: Bytes,
              buckets: {buckets}}}
  - name: w
    write: {{type: stdout}}
"""


def test_encode_prom_rebuild_with_changed_buckets_skips():
    t = PromTwin(_hist_cfg([100, 10000]))
    t.export([make_record(nbytes=500)])
    reg = t.regs[0]
    assert reg.get_sample_value("h_bytes_bucket", {"le": "10000.0"}) == 1
    # same buckets -> adopted, keeps counting
    PromTwin(_hist_cfg([100, 10000]), regs=t.regs).export(
        [make_record(nbytes=500)])
    assert reg.get_sample_value("h_bytes_bucket", {"le": "10000.0"}) == 2
    # changed buckets -> skipped, stale series frozen rather than misbinned
    PromTwin(_hist_cfg([1, 2]), regs=t.regs).export(
        [make_record(nbytes=500)])
    assert reg.get_sample_value("h_bytes_bucket", {"le": "10000.0"}) == 2


# --------------------------------------------------------------- extracts


def _reverse(nbytes: int, flags: int = 0x12) -> precord.Record:
    r = make_record(src="10.2.2.2", dst="10.1.1.1", sport=443, dport=1111,
                    nbytes=nbytes)
    r.tcp_flags = flags
    return r


def test_extract_conntrack_bidirectional(clock):
    t = Twin(CT_CFG)
    t.export([make_record(nbytes=1000)])              # 10.1.1.1 -> 10.2.2.2
    out = t.export([_reverse(300)])
    assert [e["_RecordType"] for e in out] == [
        "newConnection", "flowLog", "flowLog"]
    new = out[0]
    assert new["SrcAddr"] == "10.1.1.1" and new["DstAddr"] == "10.2.2.2"
    hash_id = new["_HashId"]
    assert all(e["_HashId"] == hash_id for e in out), "split connection"
    # FIN from the B side ends the connection after terminatingTimeout
    t.export([_reverse(60, flags=0x211)])             # FIN|ACK|FIN_ACK
    clock.advance(0.05)
    assert t.export([])[-1]["_RecordType"] == "flowLog"  # not yet
    clock.advance(0.1)
    end = t.export([])[-1]                            # timer sweep
    assert end["_RecordType"] == "endConnection", end
    assert end["Bytes_AB"] == 1000 and end["Bytes_BA"] == 360
    assert end["Packets"] == 21                       # 3 logs x 7 packets
    assert end["numFlowLogs"] == 3
    assert end["_HashId"] == hash_id


def test_extract_conntrack_swap_ab(clock):
    cfg = CT_CFG.replace(
        "tcpFlags: {fieldName: Flags, detectEndConnection: true}",
        "tcpFlags: {fieldName: Flags, swapAB: true}")
    t = Twin(cfg)
    out = t.export([_reverse(60, flags=0x112),        # SYN|ACK|SYN_ACK
                    make_record(nbytes=500)])         # 10.1.1.1:1111 -> 443
    new = [e for e in out if e["_RecordType"] == "newConnection"][0]
    assert new["SrcAddr"] == "10.1.1.1" and new["SrcPort"] == 1111
    assert new["DstAddr"] == "10.2.2.2" and new["DstPort"] == 443
    end = [e for e in t.close() if e["_RecordType"] == "endConnection"][0]
    assert end["Bytes_AB"] == 500 and end["Bytes_BA"] == 60


def test_extract_conntrack_close_flushes(clock):
    t = Twin(CT_CFG)
    t.export([make_record()])
    out = t.close()
    assert out[-1]["_RecordType"] == "endConnection"
    assert out[-1]["numFlowLogs"] == 1


def test_extract_conntrack_heartbeat_and_idle_end(clock):
    """The heartbeat and the idle endConnection of the scheduling block,
    each at its own patched instant (no sleep)."""
    cfg = CT_CFG.replace(
        "outputRecordTypes: [newConnection, flowLog, endConnection]",
        "outputRecordTypes: [newConnection, flowLog, heartbeat, "
        "endConnection]").replace("heartbeatInterval: 300s",
                                  "heartbeatInterval: 2s")
    t = Twin(cfg)
    t.export([make_record(nbytes=10)])
    clock.advance(2.5)
    assert t.export([])[-1]["_RecordType"] == "heartbeat"
    clock.advance(60)
    out = t.export([])
    assert out[-1]["_RecordType"] == "endConnection"
    assert t.exps[0]._stages[0].conns == {} == t.exps[1]._stages[0].conns


AGG_CFG = """
pipeline: [{name: agg}, {name: w, follows: agg}]
parameters:
  - name: agg
    extract:
      type: aggregates
      aggregates:
        rules:
          - name: bytes_by_proto
            groupByKeys: [Proto]
            operationType: sum
            operationKey: Bytes
  - name: w
    write: {type: stdout}
"""


def test_extract_aggregates(clock):
    t = Twin(AGG_CFG)
    t.export([make_record(proto=6, nbytes=100), make_record(proto=6, nbytes=50),
              make_record(proto=17, nbytes=7)])
    clock.advance(1)
    out = t.export([make_record(proto=6, nbytes=25)])
    assert all(e["name"] == "bytes_by_proto" for e in out)
    tcp1 = [e for e in out if e["Proto"] == "6"][0]
    assert tcp1["total_value"] == 150 and tcp1["total_count"] == 2
    assert tcp1["recent_op_value"] == 150
    tcp2 = [e for e in out if e["Proto"] == "6"][1]
    assert tcp2["total_value"] == 175 and tcp2["total_count"] == 3
    assert tcp2["recent_op_value"] == 25      # recent_* reset per cycle
    udp = [e for e in out if e["Proto"] == "17"][0]
    assert udp["total_value"] == 7 and udp["aggregate"] == "17"
    clock.advance(121)                          # the 2m default expiry
    t.export([])
    assert all(d["groups"] == {} for d in t.exps[0]._stages[0].defs)


def test_extract_aggregates_missing_key_does_not_skew(clock):
    cfg = """
pipeline: [{name: agg}, {name: w, follows: agg}]
parameters:
  - name: agg
    extract:
      type: aggregates
      aggregates:
        rules:
          - {name: min_rtt, groupByKeys: [Proto], operationType: min,
             operationKey: TimeFlowRttNs}
          - {name: avg_rtt, groupByKeys: [Proto], operationType: avg,
             operationKey: TimeFlowRttNs}
  - name: w
    write: {type: stdout}
"""
    r10, r20 = make_record(proto=6), make_record(proto=6)
    r10.features.rtt_ns, r20.features.rtt_ns = 10, 20
    out = {e["name"]: e for e in _run(cfg, [
        make_record(proto=6, with_features=False), r10, r20])}
    assert out["min_rtt"]["total_value"] == 10     # not 0.0
    assert out["avg_rtt"]["total_value"] == 15     # not diluted by no_rtt
    assert out["min_rtt"]["total_count"] == 2      # keyless entry uncounted


TB_CFG = """
pipeline: [{name: tb}, {name: w, follows: tb}]
parameters:
  - name: tb
    extract:
      type: timebased
      timebased:
        rules:
          - name: top_senders
            indexKeys: [SrcAddr]
            operationType: %s
            operationKey: Bytes
            topK: 2
            timeInterval: 10s
  - name: w
    write: {type: stdout}
"""


def _senders(pairs) -> list:
    return [make_record(src=src, nbytes=n) for src, n in pairs]


def test_extract_timebased_topk(clock):
    t = Twin(TB_CFG % "sum")
    out = t.export(_senders((("10.0.0.1", 100), ("10.0.0.2", 900),
                             ("10.0.0.3", 500), ("10.0.0.2", 50))))
    assert len(out) == 2                       # topK=2
    assert out[0]["SrcAddr"] == "10.0.0.2" and out[0]["Bytes"] == 950
    assert out[1]["SrcAddr"] == "10.0.0.3" and out[1]["Bytes"] == 500
    assert out[0]["name"] == "top_senders"
    assert out[0]["operation"] == "sum"


@pytest.mark.parametrize("op", ["min", "max", "avg", "count", "last",
                                "diff"])
def test_extract_timebased_window_slides(op, clock):
    """Each operation over a window that slides past its first points."""
    t = Twin(TB_CFG % op)
    t.export(_senders((("10.0.0.1", 100), ("10.0.0.2", 900))))
    clock.advance(6)
    t.export(_senders((("10.0.0.1", 300), ("10.0.0.3", 20))))
    clock.advance(6)                          # the first points fall out
    out = t.export(_senders((("10.0.0.1", 7),)))
    assert len(out) == 2 + 2 + 2
    assert "10.0.0.2" not in {e["SrcAddr"] for e in out[4:]}


# ------------------------------------------------------------------- loki


class _LokiCapture:
    """An in-process Loki push endpoint recording each request."""

    def __init__(self):
        got = self.got = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                got.append((self.path, self.headers.get("X-Scope-OrgID"),
                            self.headers.get("Content-Type"), body))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=5)


def test_write_loki():
    caps = (_LokiCapture(), _LokiCapture())
    try:
        exps = []
        for cap, mod in zip(caps, (pdfl, rdfl)):
            exps.append(mod.DirectFLPExporter(flp_config=f"""
pipeline: [{{name: w}}]
parameters:
  - name: w
    write:
      type: loki
      loki:
        url: http://127.0.0.1:{cap.srv.server_port}
        tenantID: netobserv
        labels: [SrcAddr]
        staticLabels: {{app: netobserv}}
"""))
        recs = [make_record(), make_record(src="10.9.9.9")]
        exps[0].export_batch(recs)
        exps[1].export_batch([to_ref(r) for r in recs])
    finally:
        for cap in caps:
            cap.close()
    assert caps[0].got == caps[1].got and len(caps[0].got) == 1
    path, tenant, _ctype, body = caps[0].got[0]
    assert path == "/loki/api/v1/push" and tenant == "netobserv"
    streams = json.loads(body)["streams"]
    assert len(streams) == 2               # one per SrcAddr label set
    by_src = {s["stream"]["SrcAddr"]: s for s in streams}
    assert by_src["10.1.1.1"]["stream"]["app"] == "netobserv"
    assert json.loads(by_src["10.9.9.9"]["values"][0][1])["SrcAddr"] == \
        "10.9.9.9"
    ts = int(by_src["10.1.1.1"]["values"][0][0])
    entry = json.loads(by_src["10.1.1.1"]["values"][0][1])
    assert ts == entry["TimeFlowEndMs"] * 10**6


def test_write_loki_unreachable_does_not_raise():
    cfg = """
pipeline: [{name: w}]
parameters:
  - name: w
    write:
      type: loki
      loki: {url: "http://127.0.0.1:1"}
"""
    t = Twin(cfg)
    t.export([make_record()])                  # must not raise
    assert t.exps[0]._writer._consec_failures == \
        t.exps[1]._writer._consec_failures == 1


def test_write_loki_backoff_after_consecutive_failures(monkeypatch):
    """Both writers through one injected `urlopen`: the same bodies and
    the same dials, none inside the backoff window."""
    attempts = []

    def counting_urlopen(req, timeout=None):
        attempts.append((req.full_url, req.data, timeout))
        assert timeout is not None and timeout <= 5
        raise OSError("connection refused")

    monkeypatch.setattr(urllib.request, "urlopen", counting_urlopen)
    # an entry without TimeFlowEndMs is stamped now
    monkeypatch.setattr(time, "time_ns", lambda: 1_792_000_000_000_000_000)
    counts = []
    for mod in (pdfl, rdfl):
        before = len(attempts)
        w = mod._LokiWriter({"url": "http://127.0.0.1:1"})
        for _ in range(w.FAIL_THRESHOLD):
            w.push([{"SrcAddr": "10.0.0.1"}])
        n = [len(attempts) - before]
        w.push([{"SrcAddr": "10.0.0.1"}])       # inside the backoff window
        n.append(len(attempts) - before)
        w._backoff_until = 0.0                  # window elapses
        w.push([{"SrcAddr": "10.0.0.1"}])
        n.append(len(attempts) - before)
        counts.append(n)
    assert counts[0] == counts[1] == [3, 3, 4]
    assert attempts[:4] == attempts[4:]


def test_write_loki_bodies_equal_on_seeded_records(monkeypatch):
    """Seeded records through both writers' bodies, with labels, static
    labels, a tenant and every timestamp scale."""
    sent = []

    class _Resp:
        def read(self):
            return b""

    def capture(req, timeout=None):
        sent.append((req.full_url, sorted(req.header_items()), req.data))
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", capture)
    # an entry without TimeFlowEndMs is stamped now
    monkeypatch.setattr(time, "time_ns", lambda: 1_792_000_000_000_000_000)
    recs = seeded_records(31, 60) + _named()
    for scale in ("1s", "1ms", "1us", "1ns"):
        params = {"url": "http://loki:3100/", "tenantID": "t1",
                  "labels": ["SrcAddr", "Proto", "DstPort"],
                  "staticLabels": {"app": "netobserv"},
                  "timestampScale": scale}
        pdfl._LokiWriter(params).push([pmap.record_to_map(r) for r in recs])
        rdfl._LokiWriter(params).push(
            [rmap.record_to_map(to_ref(r)) for r in recs])
    assert len(sent) == 8
    for i in range(0, 8, 2):
        assert sent[i] == sent[i + 1]


# ---------------------------------------------------------- string tables


def test_tcp_state_table_matches_reference():
    assert ptables.TCP_STATES == rtables.TCP_STATES
    assert ptables.TCP_STATE_INVALID == rtables.TCP_STATE_INVALID
    for s in range(-1, 20):
        assert ptables.tcp_state_to_str(s) == rtables.tcp_state_to_str(s)
    assert ptables.tcp_state_to_str(99) == "TCP_INVALID_STATE"


def test_dns_rcode_table_matches_reference():
    assert ptables.DNS_RCODES == rtables.DNS_RCODES
    for c in range(0, 40):
        assert ptables.dns_rcode_to_str(c) == rtables.dns_rcode_to_str(c)
    assert ptables.dns_rcode_to_str(30) == "UnDefined"


def test_drop_cause_table_matches_reference():
    assert ptables.DROP_CAUSES == rtables.DROP_CAUSES
    assert (ptables.SKB_DROP_SUBSYS_CORE, ptables.SKB_DROP_SUBSYS_OVS,
            ptables.SKB_DROP_SUBSYS_SHIFT) == (
        rtables.SKB_DROP_SUBSYS_CORE, rtables.SKB_DROP_SUBSYS_OVS,
        rtables.SKB_DROP_SUBSYS_SHIFT)
    codes = list(rtables.DROP_CAUSES) + [0, 1, 81, 12345678,
                                         (3 << 16) + 12]
    for code in codes:
        assert ptables.pkt_drop_cause_to_str(code) == \
            rtables.pkt_drop_cause_to_str(code)
    assert ptables.pkt_drop_cause_to_str(12345678) == \
        "SKB_DROP_UNKNOWN_CAUSE"


def test_ovn_event_causes_match_reference():
    assert ptables.OVN_EVENT_CAUSES == rtables.OVN_EVENT_CAUSES
    assert ptables.OVN_EVENTS_SUBSYS == rtables.OVN_EVENTS_SUBSYS
    for i in range(-1, len(rtables.OVN_EVENT_CAUSES) + 2):
        code = rtables.OVN_EVENTS_SUBSYS + i
        assert ptables.ovn_drop_reason_to_str(code) == \
            rtables.ovn_drop_reason_to_str(code)
        assert ptables.pkt_drop_cause_to_str(code) == \
            rtables.pkt_drop_cause_to_str(code)
    assert ptables.pkt_drop_cause_to_str(
        ptables.OVN_EVENTS_SUBSYS + 4) == "NetworkEvent_NetworkPolicy"


# ------------------------------------------------------- record <-> map


def _map_records() -> list:
    from tests.test_torch_exporters import _records

    recs = _records(8) + [make_record(), make_record(with_features=False)]
    dropped = make_record(proto=17)
    dropped.features.drop_latest_state = 4
    dropped.features.drop_latest_cause = rtables.OVN_EVENTS_SUBSYS + 2
    dropped.features.dns_errno = 3
    return recs + [dropped]


def test_record_to_map_equals_the_references():
    for r in _map_records():
        ours, theirs = pmap.record_to_map(r), rmap.record_to_map(to_ref(r))
        assert list(ours) == list(theirs)       # the key order too
        assert ours == theirs
        assert json.dumps(ours, separators=(",", ":")) == \
            json.dumps(theirs, separators=(",", ":"))


def test_map_to_record_equals_the_references():
    for r in _map_records():
        entry = pmap.record_to_map(r)
        entry.update(Enriched="x")              # unknown keys are ignored
        assert as_tuple(pmap.map_to_record(entry)) == \
            as_tuple(rmap.map_to_record(dict(entry)))
    for entry in ({}, {"SrcMac": b"\x01\x02"}, {"SrcMac": "zz:1"},
                  {"DstMac": "0A:0B:0C:0D:0E:0F", "Proto": "17"}):
        assert as_tuple(pmap.map_to_record(dict(entry))) == \
            as_tuple(rmap.map_to_record(dict(entry)))


@pytest.mark.parametrize("cfg", [
    "", CFG, NET_CFG, CT_CFG, AGG_CFG, TB_CFG % "avg"],
    ids=["empty", "filter_generic", "network", "conntrack", "aggregates",
         "timebased"])
def test_seeded_batches_give_equal_lines(cfg, clock):
    """Seeded records in batches through each stdout configuration, the
    clock moving between batches, then `close()`."""
    recs = _map_records()
    t = Twin(cfg)
    for i in range(0, len(recs), 13):
        t.export(recs[i:i + 13])
        clock.advance(0.7)
    assert t.close() or cfg in (AGG_CFG, TB_CFG % "avg")


# ------------------------------------------------------------- enrichment

KUBE = {"10.1.1.1": {"name": "web-1", "kind": "Pod", "namespace": "prod",
                     "owner_name": "web", "owner_kind": "Deployment",
                     "host_ip": "192.0.2.10", "host_name": "node-a",
                     "zone": "us-east-1a", "labels": {"app": "web"}}}


def test_add_kubernetes_with_pluggable_informer():
    t = Twin(K8S_LOC_CFG,
             {"kube_source": penrich.StaticKubeDataSource(KUBE)},
             {"kube_source": renrich.StaticKubeDataSource(KUBE)})
    entry = t.export([make_record()])[0]
    assert entry["SrcK8S_Namespace"] == "prod"
    assert entry["SrcK8S_Name"] == "web-1"
    assert entry["SrcK8S_Type"] == "Pod"
    assert entry["SrcK8S_OwnerName"] == "web"
    assert entry["SrcK8S_OwnerType"] == "Deployment"
    assert entry["SrcK8S_HostIP"] == "192.0.2.10"
    assert entry["SrcK8S_HostName"] == "node-a"
    assert entry["SrcK8S_Zone"] == "us-east-1a"
    assert entry["SrcK8S_labels_app"] == "web"


def test_add_kubernetes_json_file_and_unknown_ip(tmp_path):
    p = tmp_path / "kube.json"
    p.write_text(json.dumps({"10.9.9.9": {"name": "other",
                                          "kind": "Service"}}))
    t = Twin(K8S_LOC_CFG,
             {"kube_source": penrich.StaticKubeDataSource(path=str(p))},
             {"kube_source": renrich.StaticKubeDataSource(path=str(p))})
    entry = t.export([make_record(), make_record(src="10.9.9.9")])
    assert "SrcK8S_Name" not in entry[0]  # unknown IP: untouched entry
    assert entry[1]["SrcK8S_Name"] == entry[1]["SrcK8S_OwnerName"] == "other"


def test_add_kubernetes_otel_assignee():
    cfg = K8S_LOC_CFG.replace("add_zone: true", "add_zone: true\n"
                              "              assignee: otel")
    t = Twin(cfg, {"kube_source": penrich.StaticKubeDataSource(KUBE)},
             {"kube_source": renrich.StaticKubeDataSource(KUBE)})
    entry = t.export([make_record()])[0]
    assert entry["SrcK8Sk8s.namespace.name"] == "prod"


def _loc_csv(tmp_path) -> str:
    dst = int(ipaddress.ip_address("10.2.2.2"))
    p = tmp_path / "loc.csv"
    p.write_text(
        f'"{dst - 10}","{dst + 10}","US","United States of America",'
        '"California","Mountain View","37.405","-122.078"\n'
        '"3232235520","3232301055","DE","Germany","Berlin","Berlin",'
        '"52.52","13.40"\n')
    return str(p)


def test_add_location_with_csv_db(tmp_path):
    path = _loc_csv(tmp_path)
    t = Twin(K8S_LOC_CFG, {"location_db": penrich.CsvLocationDB(path)},
             {"location_db": renrich.CsvLocationDB(path)})
    entry = t.export([make_record(), make_record(dst="192.168.0.9")])
    assert entry[0]["DstLoc_CountryName"] == "US"
    assert entry[0]["DstLoc_CountryLongName"] == "United States of America"
    assert entry[0]["DstLoc_RegionName"] == "California"
    assert entry[0]["DstLoc_CityName"] == "Mountain View"
    assert entry[0]["DstLoc_Latitude"] == "37.405"
    assert entry[0]["DstLoc_Longitude"] == "-122.078"
    assert entry[1]["DstLoc_CountryName"] == "DE"
    # no k8s source injected: the add_kubernetes rule warned and skipped
    assert "SrcK8S_Name" not in entry[0]


def test_enrichment_backends_from_agent_config(tmp_path):
    """`build_exporter` of both packages wires FLP_KUBE_MAP and
    FLP_LOCATION_DB into the embedded pipeline."""
    kube = tmp_path / "kube.json"
    kube.write_text(json.dumps(
        {"10.1.1.1": {"name": "pod-x", "kind": "Pod", "namespace": "ns1"}}))
    env = {"EXPORT": "direct-flp", "FLP_CONFIG": K8S_LOC_CFG,
           "FLP_KUBE_MAP": str(kube), "FLP_LOCATION_DB": _loc_csv(tmp_path)}
    ours = build_exporter(tcfg.load_config(env))
    ref = ref_build(jcfg.load_config(env))
    assert type(ours).__name__ == type(ref).__name__ == "DirectFLPExporter"
    ours._stream, ref._stream = io.StringIO(), io.StringIO()
    ours.export_batch([make_record()])
    ref.export_batch([to_ref(make_record())])
    assert ours._stream.getvalue() == ref._stream.getvalue()
    entry = json.loads(ours._stream.getvalue().splitlines()[0])
    assert entry["SrcK8S_Name"] == "pod-x" and \
        entry["SrcK8S_Namespace"] == "ns1"
    assert entry["DstLoc_CountryName"] == "US"


def test_location_csv_ipv6_layout_mapped_v4(tmp_path):
    lo = 0xFFFF00000000 + int.from_bytes(bytes([10, 2, 2, 0]), "big")
    v6lo = int(ipaddress.ip_address("2001:db8::"))
    p = tmp_path / "loc6.csv"
    p.write_text(
        f'"{lo}","{lo + 255}","US","United States","CA","MV","1","2"\n'
        '"16777216","n/a","XX","malformed row tolerated","","","",""\n'
        f'"{v6lo}","{v6lo + 2**64}","FR","France","IDF","Paris","3","4"\n')
    ours, ref = penrich.CsvLocationDB(str(p)), renrich.CsvLocationDB(str(p))
    for ip in ("10.2.2.2", "::ffff:10.2.2.2", "10.3.0.1", "2001:db8::5",
               "2001:db9::", "not an ip", "10.2.2.255"):
        assert ours.lookup(ip) == ref.lookup(ip), ip
    assert ours.lookup("10.2.2.2")["CountryName"] == "US"
    assert ours.lookup("::ffff:10.2.2.2")["CountryName"] == "US"
    assert ours.lookup("10.3.0.1") is None
    assert ours.lookup("2001:db8::5")["CityName"] == "Paris"


# --------------------------------------------------------- wire encoders


def _broker_values(broker) -> list:
    return [kv for _p, b in broker.produced for kv in _batch_records(b)]


def test_encode_kafka_produces_and_passes_through(monkeypatch):
    # a keyless message's partition follows the clock: one instant for both
    monkeypatch.setattr(time, "monotonic_ns", lambda: 7_000)
    brokers = (FakeBroker(topic="network-flows"),
               FakeBroker(topic="network-flows"))
    for b in brokers:
        b.start()
    producers = []
    try:
        producers = [KafkaProducer(brokers=[f"127.0.0.1:{brokers[0].port}"],
                                   topic="network-flows"),
                     RefProducer(brokers=[f"127.0.0.1:{brokers[1].port}"],
                                 topic="network-flows")]
        t = Twin(KAFKA_CFG, {"kafka_producer": producers[0]},
                 {"kafka_producer": producers[1]})
        out = t.export([make_record(proto=6), make_record(proto=17)])
        assert len(out) == 2                    # pass-through
        t.export(seeded_records(32, 30))
        got = [_broker_values(b) for b in brokers]
        assert got[0] == got[1] and len(got[0]) == 32
        total = sum(struct.unpack(">i", b[57:61])[0]
                    for _p, b in brokers[0].produced)
        assert total == 32
        blob = b"".join(b for _p, b in brokers[0].produced)
        assert b'"Proto":6' in blob and b'"Proto":17' in blob
        t.close()
    finally:
        for p in producers:
            p.close()
        for b in brokers:
            b.stop()


def _udp_rx():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(3)
    return rx


def _drain_udp(rx) -> list:
    out = []
    rx.settimeout(0.3)
    try:
        while True:
            out.append(rx.recvfrom(65535)[0])
    except socket.timeout:
        pass
    return out


def test_write_ipfix_emits_data_records(monkeypatch):
    from netobserv_tpu_torch.exporter.ipfix import IPFIX_VERSION, TEMPLATE_V4

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    streams = []
    recs = [make_record(proto=6)] + seeded_records(33, 40)
    for mod, conv in ((pdfl, lambda r: r), (rdfl, to_ref)):
        rx = _udp_rx()
        exp = mod.DirectFLPExporter(
            flp_config=IPFIX_CFG_TMPL % rx.getsockname()[1])
        try:
            exp.export_batch([conv(r) for r in recs])
            streams.append(_drain_udp(rx))
        finally:
            exp.close()
            rx.close()
    assert streams[0] == streams[1]
    msg = streams[0][0]
    assert struct.unpack(">HH", msg[:4])[0] == IPFIX_VERSION
    assert struct.unpack(">HH", msg[16:20])[0] == 2  # template set leads
    assert any(struct.unpack(">H", msg[o:o + 2])[0] == TEMPLATE_V4
               for o in range(16, len(msg) - 1, 2))


def test_write_grpc_sends_pbflow_records():
    """Both packages' `write grpc` into the port's collector: the same
    `Records` bytes, every record's fields as `map_to_record` made them."""
    from netobserv_tpu_torch.exporter.pb_convert import pb_to_record

    server, port, out = start_flow_collector(0)
    try:
        recs = [make_record(proto=6), make_record(proto=17)] + \
            seeded_records(34, 20)
        got = []
        for mod, conv in ((pdfl, lambda r: r), (rdfl, to_ref)):
            exp = mod.DirectFLPExporter(flp_config=GRPC_CFG_TMPL % port)
            exp.export_batch([conv(r) for r in recs])
            got.append(out.get(timeout=10))
            exp.close()
        assert got[0].SerializeToString() == got[1].SerializeToString()
        assert len(got[0].entries) == len(recs)
        assert {e.transport.protocol for e in got[0].entries[:2]} == {6, 17}
        back = [pb_to_record(e) for e in got[0].entries]
        assert [r.bytes_ for r in back] == [r.bytes_ for r in recs]
    finally:
        server.stop(0)


def test_write_grpc_to_a_dead_collector_drops_and_closes():
    free = socket.socket()
    free.bind(("127.0.0.1", 0))
    port = free.getsockname()[1]
    free.close()
    exp = pdfl.DirectFLPExporter(flp_config=GRPC_CFG_TMPL % port)
    exp.export_batch([make_record()])          # logged and dropped
    exp.close()
    assert exp._writer._client._channel is None


def _fake_s3(access: str, secret: str, puts: list):
    import hashlib
    import hmac as hmac_mod
    import re

    class FakeS3(http.server.BaseHTTPRequestHandler):
        def do_PUT(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            auth = self.headers["Authorization"]
            m = re.match(
                r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d+)/([^/]+)/s3/"
                r"aws4_request, SignedHeaders=([^,]+), Signature=(\w+)",
                auth)
            assert m, auth
            _key, datestamp, region, signed, got_sig = m.groups()
            headers = {k: self.headers[k] for k in signed.split(";")}
            canonical = "\n".join([
                "PUT", self.path, "",
                "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
                signed, headers["x-amz-content-sha256"]])
            scope = f"{datestamp}/{region}/s3/aws4_request"
            to_sign = "\n".join([
                "AWS4-HMAC-SHA256", headers["x-amz-date"], scope,
                hashlib.sha256(canonical.encode()).hexdigest()])

            def hm(k, msg):
                return hmac_mod.new(k, msg.encode(), hashlib.sha256).digest()
            sig_key = hm(hm(hm(hm(("AWS4" + secret).encode(), datestamp),
                               region), "s3"), "aws4_request")
            want = hmac_mod.new(sig_key, to_sign.encode(),
                                hashlib.sha256).hexdigest()
            ok = (want == got_sig and hashlib.sha256(body).hexdigest()
                  == headers["x-amz-content-sha256"])
            puts.append((self.path, auth, headers["x-amz-date"], body, ok))
            self.send_response(200 if ok else 403)
            self.end_headers()

        def log_message(self, *a):
            pass

    return http.server.HTTPServer(("127.0.0.1", 0), FakeS3)


class _FixedDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 3, 9, 22, 15, 7, tzinfo=tz)


def test_encode_s3_signed_put_roundtrip(monkeypatch):
    """Both packages' `encode s3` against a fake endpoint that re-derives
    SigV4 from the shared secret, under one fixed clock and stream id:
    the same PUTs, signatures included."""
    import re

    monkeypatch.setattr(time, "time", lambda: 1_710_022_507.25)
    monkeypatch.setattr(datetime, "datetime", _FixedDatetime)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0xABCDEF))
    access, secret = "testkey", "testsecret"
    puts: list = []
    srv = _fake_s3(access, secret, puts)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        cfg = f"""
pipeline: [{{name: e}}, {{name: w, follows: e}}]
parameters:
  - name: e
    encode:
      type: s3
      s3:
        endpoint: 127.0.0.1:{srv.server_port}
        bucket: flows
        account: tenant1
        accessKeyId: {access}
        secretAccessKey: {secret}
        batchSize: 2
        objectHeaderParameters: {{cluster: test}}
  - name: w
    write: {{type: stdout}}
"""
        t = Twin(cfg)
        lines = t.export([make_record(proto=6), make_record(proto=17),
                          make_record(proto=6)])
        lines = t.close()  # remainder (1 entry) flushes as a final object
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
    assert len(lines) == 3
    assert len(puts) == 4
    # each batch and the close ran on the port, then on the reference
    assert puts[0::2] == puts[1::2]
    for path, _auth, amz_date, body, sig_ok in puts:
        assert sig_ok, "SigV4 signature mismatch"
        assert amz_date == "20240309T221507Z"
        assert re.match(r"/flows/tenant1/year=2024/month=03/day=09/"
                        r"hour=22/stream-id=\w+/\d{8}", path), path
    o1 = json.loads(puts[0][3])
    assert o1["number_of_flow_logs"] == 2 and o1["cluster"] == "test"
    assert o1["version"] == "v0.1" and len(o1["flow_logs"]) == 2
    assert json.loads(puts[2][3])["number_of_flow_logs"] == 1


def test_sigv4_headers_equal_the_references(monkeypatch):
    """`_sigv4_put`'s request, captured at `http.client`, with a fixed
    `now`: the same path, headers and body in both packages."""
    import http.client

    sent = []

    class _Conn:
        def __init__(self, endpoint, timeout=None):
            self.endpoint = endpoint

        def request(self, method, path, body=None, headers=None):
            sent.append((self.endpoint, method, path, body,
                         sorted(headers.items())))

        def getresponse(self):
            class R:
                status = 200

                def read(self):
                    return b""
            return R()

        def close(self):
            pass

    monkeypatch.setattr(http.client, "HTTPConnection", _Conn)
    now = datetime.datetime(2023, 1, 2, 3, 4, 5,
                            tzinfo=datetime.timezone.utc)
    for body in (b"", b"{}", json.dumps({"a": list(range(50))}).encode()):
        for mod in (pdfl, rdfl):
            mod._sigv4_put("s3.local:9000", False, "bkt", "a/b/00000001",
                           body, "AK", "SK", region="eu-west-3", now=now)
    assert len(sent) == 6
    for i in range(0, 6, 2):
        assert sent[i] == sent[i + 1]


def test_no_yaml_parse_for_an_empty_config(monkeypatch):
    """PyYAML is imported only where a non-empty FLP_CONFIG is parsed."""
    import builtins

    real = builtins.__import__

    def guard(name, *a, **k):
        assert name != "yaml", "yaml imported for an empty FLP_CONFIG"
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guard)
    out = io.StringIO()
    pdfl.DirectFLPExporter(flp_config="  \n", stream=out).export_batch(
        [make_record()])
    assert json.loads(out.getvalue())["Bytes"] == 4321


def test_prom_registry_is_the_agents():
    """`build_exporter` hands the agent's `Metrics.registry` to the prom
    stage, so its series surface on the agent's /metrics."""
    from netobserv_tpu_torch.metrics.registry import Metrics, exposition

    metrics = Metrics()
    exp = build_exporter(tcfg.load_config({
        "EXPORT": "direct-flp", "FLP_CONFIG": PROM_CFG}), metrics=metrics)
    exp._stream = io.StringIO()
    assert exp.prom_registry is metrics.registry
    exp.export_batch([make_record(proto=6)])
    text = exposition(metrics.registry)[0].decode()
    assert 'flp_flows_total{Proto="6"} 1.0' in text
    assert "ebpf_agent_errors_total" in text
