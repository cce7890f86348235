"""The port's record exporters (netobserv_tpu_torch/exporter/stdout_json.py,
ipfix.py, kafka.py, grpc_flow.py, `model/record.Record.to_json_obj` and
`exporter.build_exporter`) against the JAX package's, on the CPU.

- `to_json_obj` and the stdout lines equal the reference's on seeded
  records with network events, TLS names, ICMP and DNS.
- IPFIX messages byte for byte under a fixed `time.time` (v4, v6, mixed,
  UDP splitting, TCP), and `examples/ipfix_collector.py` decoding the
  port's stream.
- Kafka messages and keys through `tests/test_kafka_broker.FakeBroker`
  equal the JAX `KafkaExporter`'s (a network event's map in protobuf's
  deterministic order, ROADMAP C5).
- `build_exporter` for each EXPORT against the reference's.
- The gRPC exporter's chunking to the port's and the reference's
  collectors, its periodic reconnect and its raise on a dead target.
- The agent's record path: in process into each record exporter that
  `build_exporter` makes, every injected row arriving; and a `python -m
  netobserv_tpu_torch` child with EXPORT=grpc on synthetic replay
  delivers records to the port's collector and exits 0 on SIGTERM.
"""

from __future__ import annotations

import importlib.util
import io
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import time

import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.exporter import build_exporter as ref_build
from netobserv_tpu.exporter import ipfix as ripfix
from netobserv_tpu.exporter import kafka as rkafka
from netobserv_tpu.exporter import pb_convert as rconv
from netobserv_tpu.exporter.grpc_flow import GRPCFlowExporter as RefGRPC
from netobserv_tpu.exporter.stdout_json import StdoutJSONExporter as RefStd
from netobserv_tpu.grpc import flow as rgflow
from netobserv_tpu.pb import flow_pb2
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.exporter import build_exporter
from netobserv_tpu_torch.exporter import ipfix as pipfix
from netobserv_tpu_torch.exporter import kafka as pkafka
from netobserv_tpu_torch.exporter import pb_convert as pconv
from netobserv_tpu_torch.exporter.grpc_flow import GRPCFlowExporter
from netobserv_tpu_torch.exporter.stdout_json import StdoutJSONExporter
from netobserv_tpu_torch.grpc import flow as pgflow
from netobserv_tpu_torch.grpc.h2 import RpcError, StatusCode
from netobserv_tpu_torch.model import flow as pflow
from netobserv_tpu_torch.model import record as precord
from tests.test_kafka_broker import FakeBroker
from tests.test_torch_kafka import _batch_records
from tests.test_torch_pbflow import _named, as_tuple, seeded_records, to_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(seed: int = 5, n: int = 40) -> list[precord.Record]:
    """Seeded records plus ICMP, DNS, TLS and network-event ones."""
    recs = seeded_records(seed, n) + _named()
    f = pflow.FlowFeatures(dns_id=7, dns_latency_ns=3_000_000,
                           dns_name="a.example", rtt_ns=5,
                           network_events=[bytes(range(1, 9))])
    recs.append(precord.Record(
        key=pflow.FlowKey.make("10.0.0.1", "10.0.0.9", 0, 0, 1, 8, 0),
        bytes_=84, packets=1, eth_protocol=0x0800, features=f,
        ssl_version=0x0304, tls_cipher_suite=0x1301, tls_key_share=0x1D,
        tls_types=0x0B, ssl_mismatch=True, interface="eth0"))
    return recs


# ---------------------------------------------------------------- stdout


@pytest.mark.parametrize("seed", [5, 6])
def test_json_objects_and_stdout_lines_equal_the_reference(seed):
    recs = _records(seed)
    assert [r.to_json_obj() for r in recs] == \
        [to_ref(r).to_json_obj() for r in recs]
    ours, theirs = io.StringIO(), io.StringIO()
    StdoutJSONExporter(stream=ours).export_batch(recs)
    RefStd(stream=theirs).export_batch([to_ref(r) for r in recs])
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().count("\n") == len(recs)
    assert '"TlsCipher":"TLS_AES_128_GCM_SHA256"' in ours.getvalue()
    assert '"NetworkEvents":[{' in ours.getvalue()


# ----------------------------------------------------------------- IPFIX


def _udp_rx():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(3)
    return rx


def _drain(rx) -> list[bytes]:
    out = []
    rx.settimeout(0.3)
    try:
        while True:
            out.append(rx.recvfrom(65535)[0])
    except socket.timeout:
        pass
    return out


def _ipfix_batches(kind: str) -> list[list[precord.Record]]:
    rec = _named()[2]
    v6 = _named()[3]
    mixed = precord.Record(key=pflow.FlowKey.make("10.0.0.1", "2001:db8::7",
                                                  1, 2, 6), bytes_=9)
    tagged = precord.Record(key=pflow.FlowKey.make("10.0.0.1", "10.0.0.2",
                                                   1, 2, 6),
                            eth_protocol=0x86DD, bytes_=9)
    if kind == "v4":
        return [[rec], [rec]]
    if kind == "v6":
        return [[v6, v6]]
    if kind == "mixed":
        return [[rec, mixed, tagged, v6]]
    return [seeded_records(21, 700)]  # splits into many datagrams


@pytest.mark.parametrize("kind", ["v4", "v6", "mixed", "split"])
def test_ipfix_udp_messages_equal_the_references(kind, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    streams = []
    for mod, conv in ((pipfix, lambda r: r), (ripfix, to_ref)):
        rx = _udp_rx()
        exp = mod.IPFIXExporter("127.0.0.1", rx.getsockname()[1],
                                transport="udp")
        try:
            for batch in _ipfix_batches(kind):
                exp.export_batch([conv(r) for r in batch])
            streams.append(_drain(rx))
        finally:
            exp.close()
            rx.close()
    assert streams[0] == streams[1]
    assert streams[0] and all(len(m) <= pipfix.IPFIXExporter.MAX_UDP_PAYLOAD
                              for m in streams[0])
    if kind == "split":
        assert len(streams[0]) > 10


def test_ipfix_tcp_stream_equals_the_references(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    streams = []
    for mod, conv in ((pipfix, lambda r: r), (ripfix, to_ref)):
        srv = socket.create_server(("127.0.0.1", 0))
        srv.settimeout(5)
        exp = mod.IPFIXExporter("127.0.0.1", srv.getsockname()[1],
                                transport="tcp")
        conn, _ = srv.accept()
        try:
            exp.export_batch([conv(r) for r in seeded_records(22, 500)])
            exp.close()
            conn.settimeout(5)
            data = b""
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                data += chunk
            streams.append(data)
        finally:
            conn.close()
            srv.close()
    assert streams[0] == streams[1] and len(streams[0]) > 32768


def test_ipfix_collector_example_decodes_the_ports_stream():
    """The twin of tests/test_exporters.py:254 on the port's exporter."""
    spec = importlib.util.spec_from_file_location(
        "ipfix_collector", os.path.join(ROOT, "examples",
                                        "ipfix_collector.py"))
    col = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(col)
    rx = _udp_rx()
    exp = pipfix.IPFIXExporter("127.0.0.1", rx.getsockname()[1])
    exp.export_batch([precord.Record(
        key=pflow.FlowKey.make("10.1.2.3", "10.4.5.6", 47000, 7777, 17),
        bytes_=4321, packets=7)])
    templates: dict = {}
    lines: list[str] = []
    msg, _ = rx.recvfrom(65535)
    off = 16
    while off + 4 <= len(msg):
        set_id, set_len = struct.unpack(">HH", msg[off:off + 4])
        payload = msg[off + 4:off + set_len]
        if set_id == 2:
            col.parse_templates(payload, templates)
        elif set_id in templates:
            lines.extend(col.parse_data(payload, templates[set_id]))
        off += max(set_len, 4)
    exp.close()
    rx.close()
    kv = dict(p.split("=", 1) for p in lines[0].split() if "=" in p)
    assert kv["srcV4"] == "10.1.2.3" and kv["dstV4"] == "10.4.5.6"
    assert kv["dstPort"] == "7777" and kv["bytes"] == "4321"


# ----------------------------------------------------------------- Kafka


@pytest.mark.parametrize("env", [{}, {"KAFKA_ASYNC": "false",
                                      "KAFKA_BATCH_MESSAGES": "7"}],
                         ids=["async", "acks_batches"])
def test_kafka_messages_equal_the_references(env):
    recs = _records(8, 30)
    out = []
    for cfg_mod, exp_cls, conv in ((tcfg, pkafka.KafkaExporter, lambda r: r),
                                   (jcfg, rkafka.KafkaExporter, to_ref)):
        broker = FakeBroker()
        broker.start()
        try:
            cfg = cfg_mod.load_config({
                "EXPORT": "kafka",
                "KAFKA_BROKERS": f"127.0.0.1:{broker.port}", **env})
            exp = exp_cls.from_config(cfg)
            exp.export_batch([conv(r) for r in recs])
            want = -(-len(recs) // cfg.kafka_batch_messages)
            deadline = time.monotonic() + 10
            while len(broker.produced) < want and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            exp.close()
            out.append([(pid, _batch_records(b))
                        for pid, b in broker.produced])
        finally:
            broker.stop()
    assert [(pid, len(b)) for pid, b in out[0]] == \
        [(pid, len(b)) for pid, b in out[1]]
    flat = [kv for _, batch in out[0] for kv in batch]
    ref_flat = [kv for _, batch in out[1] for kv in batch]
    assert len(flat) == len(recs)
    assert [k for k, _ in flat] == [k for k, _ in ref_flat]
    assert sorted(k for k, _ in flat) == sorted(pkafka.partition_key(r)
                                                for r in recs)
    # the values: protobuf's deterministic bytes; the reference's
    # non-deterministic ones order a network event's map otherwise
    # (ROADMAP C5), so those parse equal and the rest are equal bytes
    assert sorted(v for _, v in flat) == sorted(
        rconv.record_to_pb(to_ref(r)).SerializeToString(deterministic=True)
        for r in recs)
    for (_, ours), (_, theirs) in zip(flat, ref_flat):
        msg = flow_pb2.Record.FromString(ours)
        assert msg == flow_pb2.Record.FromString(theirs)
        if not msg.network_events_metadata:
            assert ours == theirs


def test_partition_key_is_direction_normalized():
    a = precord.Record(key=pflow.FlowKey.make("10.0.0.1", "10.0.0.2"))
    b = precord.Record(key=pflow.FlowKey.make("10.0.0.2", "10.0.0.1"))
    assert pkafka.partition_key(a) == pkafka.partition_key(b) == \
        rkafka.partition_key(to_ref(a))


# --------------------------------------------------------- build_exporter


@pytest.mark.parametrize("export", ["stdout", "grpc", "ipfix+udp",
                                    "ipfix+tcp", "kafka", "direct-flp"])
def test_build_exporter_builds_what_the_reference_builds(export, tmp_path):
    env = {"EXPORT": export, "TARGET_HOST": "127.0.0.1", "TARGET_PORT": "9"}
    srv = broker = None
    if export == "ipfix+tcp":  # the TCP exporter connects when made
        srv = socket.create_server(("127.0.0.1", 0))
        env["TARGET_PORT"] = str(srv.getsockname()[1])
    if export == "kafka":
        broker = FakeBroker()
        broker.start()
        env["KAFKA_BROKERS"] = f"127.0.0.1:{broker.port}"
    if export == "direct-flp":
        env["FLP_CONFIG"] = ('{"pipeline": [{"name": "g"}], "parameters": '
                             '[{"name": "g", "transform": {"type": '
                             '"generic", "generic": {"rules": []}}}]}')
    try:
        ours = build_exporter(tcfg.load_config(env))
        ref = ref_build(jcfg.load_config(env))
        try:
            assert type(ours).__name__ == type(ref).__name__
            assert ours.name == ref.name
            assert ours.supports_columnar is False
            if export.startswith("ipfix"):
                assert ours._transport == ref._transport
                assert ours._addr == ref._addr
            if export == "direct-flp":  # FLP_CONFIG as JSON, which is YAML
                assert len(ours._stages) == len(ref._stages) == 1
                assert ours._writer is ref._writer is None
        finally:
            ours.close()
            ref.close() if hasattr(ref, "close") else None
    finally:
        if srv is not None:
            srv.close()
        if broker is not None:
            broker.stop()


# ------------------------------------------------------------------- gRPC


@pytest.mark.parametrize("server", ["port", "reference"])
def test_grpc_exporter_chunks_to_either_collector(server):
    """The twin of tests/test_exporters.py:70: 5 records at 2 a message
    are 3 messages, and each arrives whole."""
    start = (pgflow if server == "port" else rgflow).start_flow_collector
    srv, port, out = start(0)
    try:
        exp = GRPCFlowExporter("127.0.0.1", port, max_flows_per_message=2)
        recs = seeded_records(31, 5)
        exp.export_batch(recs)
        msgs = [out.get(timeout=5) for _ in range(3)]
        assert sorted(len(m.entries) for m in msgs) == [1, 2, 2]
        convert = (pconv if server == "port" else rconv).pb_to_record
        got = [convert(e) for m in msgs for e in m.entries]
        want = [as_tuple(pconv.pb_to_record(pconv.record_to_pb(r)))
                for r in recs]
        assert sorted(as_tuple(r) for r in got) == sorted(want)
        exp.close()
    finally:
        srv.stop(None)


def test_grpc_exporter_reconnects_periodically():
    """The twin of tests/test_exporters.py:86."""

    class CountingClient:
        def __init__(self):
            self.connects = 0
            self.sent = 0

        def connect(self):
            self.connects += 1

        def send(self, records, timeout_s=10.0):
            self.sent += len(records.entries)

        def close(self):
            pass

    rec = _named()[0]
    for cls in (GRPCFlowExporter, RefGRPC):
        client = CountingClient()
        exp = cls("h", 1, client=client, reconnect_every_s=60.0,
                  reconnect_randomization_s=0.0)
        exp.export_batch([rec])
        assert client.connects == 0
        exp._next_reconnect = time.monotonic() - 1
        exp.export_batch([rec])
        assert client.connects == 1
        assert exp._next_reconnect > time.monotonic() + 30
        exp.export_batch([rec])
        assert client.connects == 1 and client.sent == 3


def test_grpc_exporter_raises_on_a_dead_target():
    """The twin of tests/test_exporters.py:118: made on port 1 without a
    raise (the channel connects lazily), it raises UNAVAILABLE on send."""
    exp = GRPCFlowExporter("127.0.0.1", 1, max_flows_per_message=10)
    with pytest.raises(RpcError) as err:
        exp.export_batch([_named()[0]])
    assert err.value.code() == StatusCode.UNAVAILABLE
    exp.close()


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("PATH", "HOME", "LANG", "LD_", "PYTHON",
                            "TMPDIR", "VIRTUAL_ENV"))}
    env.update(AGENT_IP="127.0.0.1", LOG_LEVEL="info", **extra)
    return env


def test_cli_exports_records_over_grpc_to_the_ports_collector():
    """EXPORT=grpc, the DaemonSet's setting, as a child on synthetic
    replay: records reach the port's collector, SIGTERM exits 0."""
    srv, port, out = pgflow.start_flow_collector(0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "netobserv_tpu_torch"], cwd=ROOT,
        env=_child_env(EXPORT="grpc", TARGET_HOST="127.0.0.1",
                       TARGET_PORT=str(port), DATAPATH="synthetic",
                       CACHE_ACTIVE_TIMEOUT="200ms"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        msg = out.get(timeout=60)
        assert len(msg.entries) > 0
        rec = pconv.pb_to_record(msg.entries[0])
        assert rec.packets > 0 and rec.agent_ip == "127.0.0.1"
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err.decode()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
        srv.stop(None)


def test_collector_queue_is_the_callers():
    q: queue.Queue = queue.Queue()
    srv, port, out = pgflow.start_flow_collector(0, out=q)
    try:
        assert out is q
        client = pgflow.FlowClient("127.0.0.1", port)
        client.send(pconv.records_to_pb(_named()))
        assert len(q.get(timeout=5).entries) == len(_named())
        client.close()
    finally:
        srv.stop(None)


def _ipfix_data_records(msgs: list) -> int:
    """Data records in IPFIX messages, by their templates' sizes."""
    sizes = {pipfix.TEMPLATE_V4: sum(n for _, n in pipfix._V4_FIELDS),
             pipfix.TEMPLATE_V6: sum(n for _, n in pipfix._V6_FIELDS)}
    count = 0
    for m in msgs:
        off = 16
        while off + 4 <= len(m):
            sid, slen = struct.unpack(">HH", m[off:off + 4])
            if sid in sizes:
                count += (slen - 4) // sizes[sid]
            off += slen
    return count


@pytest.mark.parametrize("export", ["stdout", "grpc", "ipfix+udp",
                                    "ipfix+tcp", "kafka"])
def test_agent_record_path_reaches_each_backend(export):
    """The agent's record path (map tracer, limiter, terminal stage) into
    each record exporter that `build_exporter` makes: every injected row
    arrives, and SIGTERM's path (stop) closes the exporter."""
    from netobserv_tpu_torch.agent import FlowsAgent
    from netobserv_tpu_torch.datapath import fetcher as tfetch
    from tests.test_torch_agent import FAST_SUP, _feed_then_stop, _start
    env = {"EXPORT": export, "TARGET_HOST": "127.0.0.1", "TARGET_PORT": "9",
           "CACHE_ACTIVE_TIMEOUT": "60s", **FAST_SUP}
    got, cleanup = (lambda: 0), []
    if export == "grpc":
        srv, port, out = pgflow.start_flow_collector(0)
        cleanup.append(lambda: srv.stop(None))
        env["TARGET_PORT"] = str(port)
        msgs = []

        def got():
            while not out.empty():
                msgs.append(out.get_nowait())
            return sum(len(m.entries) for m in msgs)
    elif export.startswith("ipfix"):
        rx = (_udp_rx() if export == "ipfix+udp"
              else socket.create_server(("127.0.0.1", 0)))
        cleanup.append(rx.close)
        env["TARGET_PORT"] = str(rx.getsockname()[1])
    elif export == "kafka":
        broker = FakeBroker()
        broker.start()
        cleanup.append(broker.stop)
        env["KAFKA_BROKERS"] = f"127.0.0.1:{broker.port}"

        def got():
            return sum(len(_batch_records(b)) for _, b in broker.produced)
    try:
        cfg = tcfg.load_config(env)
        exp = build_exporter(cfg)
        conn = None
        if export == "ipfix+tcp":
            conn, _ = rx.accept()
            cleanup.append(conn.close)
        if export == "stdout":
            exp._stream = buf = io.StringIO()

            def got():
                return buf.getvalue().count("\n")
        agent = FlowsAgent(cfg, tfetch.FakeFetcher(), exp)
        stop, t = _start(agent)
        sizes = (17, 1, 25)
        _feed_then_stop(agent, stop, t, sizes, seed=9)
        if export.startswith("ipfix"):
            sock = rx if conn is None else conn
            sock.settimeout(2.0)
            data = []
            try:
                while True:
                    chunk = sock.recv(65536)
                    if not chunk:
                        break
                    data.append(chunk)
            except socket.timeout:
                pass
            if conn is not None:  # one stream: split it into messages
                stream, data, off = b"".join(data), [], 0
                while off < len(stream):
                    n = struct.unpack(">H", stream[off + 2:off + 4])[0]
                    data.append(stream[off:off + n])
                    off += n

            def got():
                return _ipfix_data_records(data)
        deadline = time.monotonic() + 10
        while got() < sum(sizes) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert got() == sum(sizes)
    finally:
        for fn in reversed(cleanup):
            fn()
