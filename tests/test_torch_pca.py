"""The port's packet capture (PCA) against the JAX package's, on the CPU:
`model/packet_record.py`, `pb/packet.py`, `grpc/packet.py`,
`exporter/grpc_packets.py`, `flow/perf_buffer.py`,
`agent/packets_agent.py`, `datapath/replay.PcapPacketFetcher`, the packet
fetchers of `datapath/loader.py` and the ENABLE_PCA branch of
`python -m netobserv_tpu_torch`.

- Twins of the four tests of `tests/test_pca.py`; the TLS ones with a
  certificate made by `openssl` (they skip where it is missing), where
  the reference's need `cryptography`.
- `pb/packet.py` against `packet_pb2`'s deterministic bytes, both ways.
- `packets_from_events`, `frame_packet` and `PcapPacketFetcher`'s events
  against the reference's on seeded inputs under one patched clock.
- A port `PacketsAgent`'s collected stream, byte for byte, against the
  reference agent's on the same injected events, both clocks patched.
- The packet fetchers on the live kernel, which skip as the reference's
  (`tests/test_asm_flowpath.py:214-340`, `tests/test_libbpf_loader.py:
  238-270`) do: root, tc/ip, bpffs and CAP_BPF; the capture on the
  loopback device by TCX (kernel 6.6), where the reference's uses a
  veth pair in a namespace, so the twin makes no device.
- `load_packet_fetcher`'s ladder with its rungs forced, and a
  `python -m netobserv_tpu_torch` child with ENABLE_PCA and
  `DATAPATH=pcap:<file>` streaming to the port's collector.
"""

from __future__ import annotations

import glob
import os
import queue
import shutil
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from google.protobuf import any_pb2, wrappers_pb2

from netobserv_tpu.agent import packets_agent as ragent
from netobserv_tpu.config import load_config as jload
from netobserv_tpu.datapath import replay as rreplay
from netobserv_tpu.flow import perf_buffer as rperf
from netobserv_tpu.model import packet_record as rpr
from netobserv_tpu.model import record as rrecord
from netobserv_tpu.pb import packet_pb2
from netobserv_tpu_torch.agent import packets_agent as pagent
from netobserv_tpu_torch.config import load_config
from netobserv_tpu_torch.datapath import kernel, loader
from netobserv_tpu_torch.datapath import replay as preplay
from netobserv_tpu_torch.datapath import syscall_bpf as sb
from netobserv_tpu_torch.exporter.grpc_packets import (
    GRPCPacketExporter, PacketClient, start_packet_collector,
)
from netobserv_tpu_torch.federation.pbwire import WireError
from netobserv_tpu_torch.flow import perf_buffer as pperf
from netobserv_tpu_torch.grpc.h2 import RpcError
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model import packet_record as ppr
from netobserv_tpu_torch.model import record as precord
from netobserv_tpu_torch.pb import packet as pbpacket

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPFFS = "/sys/fs/bpf"

live = pytest.mark.skipif(
    not (os.geteuid() == 0 and shutil.which("tc") and shutil.which("ip")
         and os.path.ismount(BPFFS) and sb.bpf_available()),
    reason="needs root, tc/ip, bpffs, and CAP_BPF")
tcx = pytest.mark.skipif(not kernel.supports_tcx(),
                         reason="needs TCX (kernel 6.6)")

#: one (monotonic, wall) instant for both packages' clocks
MONO, WALL = 5_000_000_000, 1_700_000_000_000_000_000


def make_packet_event(payload=b"\xaa" * 60, if_index=3, ts=None) -> bytes:
    ev = np.zeros(1, dtype=binfmt.PACKET_EVENT_DTYPE)
    ev[0]["if_index"] = if_index
    ev[0]["pkt_len"] = len(payload)
    ev[0]["timestamp_ns"] = (time.clock_gettime_ns(time.CLOCK_MONOTONIC)
                             if ts is None else ts)
    n = min(len(payload), binfmt.MAX_PAYLOAD_SIZE)
    ev[0]["payload"][:n] = np.frombuffer(payload[:n], np.uint8)
    return ev.tobytes()


def _seeded_payloads(seed: int, n: int) -> list[bytes]:
    """Frames of 1 to 400 bytes (past the 256-byte capture cap)."""
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(1, 400))) for _ in range(n)]


# ------------------------------------------------------- tests/test_pca.py


def _run_agent(agent, fake, events, out, n_out: int) -> list:
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    try:
        for ev in events:
            fake.inject(ev)
        return [out.get(timeout=10) for _ in range(n_out)]
    finally:
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()


def test_packets_agent_end_to_end():
    server, port, out = start_packet_collector(0)
    try:
        cfg = load_config(environ={
            "EXPORT": "stdout", "ENABLE_PCA": "true",
            "TARGET_HOST": "127.0.0.1", "PCA_SERVER_PORT": str(port)})
        assert cfg.target_port == port  # deprecated-shim wiring
        fake = pagent.FakePacketFetcher()
        agent = pagent.PacketsAgent(
            cfg, fake, exporter=GRPCPacketExporter(
                "127.0.0.1", port, client=PacketClient("127.0.0.1", port)))
        header, pkt1 = _run_agent(agent, fake, [
            make_packet_event(b"\x01\x02\x03\x04" * 16),
            make_packet_event(b"\xff" * 80)], out, 2)
        assert struct.unpack("<I", header[:4])[0] == ppr.PCAP_MAGIC
        _ts, _us, incl, orig = struct.unpack("<IIII", pkt1[:16])
        assert incl == orig == 64
        assert pkt1[16:20] == b"\x01\x02\x03\x04"
    finally:
        server.stop(0)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not on PATH: no certificate to test TLS")
    d = tmp_path_factory.mktemp("tls")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(d / "key.pem"), "-out", str(d / "cert.pem"),
         "-days", "2", "-subj", "/CN=localhost", "-addext",
         "subjectAltName=IP:127.0.0.1,DNS:localhost"],
        check=True, capture_output=True, timeout=60)
    return {"cert": str(d / "cert.pem"), "key": str(d / "key.pem")}


@pytest.mark.parametrize("mtls", [False, True], ids=["tls", "mtls"])
def test_pca_export_over_tls(certs, mtls):
    """The packet client takes the flow client's TLS options (reference
    pkg/grpc/packet/client.go): the pcap stream over a secured channel
    arrives intact, with and without a client certificate."""
    server, port, out = start_packet_collector(
        0, tls_cert=certs["cert"], tls_key=certs["key"])
    try:
        kw = {"tls_ca": certs["cert"]}
        if mtls:
            kw.update(tls_cert=certs["cert"], tls_key=certs["key"])
        exp = GRPCPacketExporter("localhost", port,
                                 client=PacketClient("localhost", port, **kw))
        exp.export_packets([ppr.PacketRecord(
            if_index=1, timestamp_ns=123_000_000_000,
            payload=b"\xde\xad\xbe\xef" * 16)])
        header = out.get(timeout=10)
        assert header == ppr.pcap_file_header()
        pkt = out.get(timeout=10)
        assert pkt == ppr.pcap_packet_header(123_000_000_000, 64, 64) + \
            b"\xde\xad\xbe\xef" * 16
        exp.close()
    finally:
        server.stop(0)


def test_pca_export_plaintext_rejected_by_tls_collector(certs):
    server, port, _out = start_packet_collector(
        0, tls_cert=certs["cert"], tls_key=certs["key"])
    try:
        plain = PacketClient("localhost", port)
        with pytest.raises(RpcError):
            plain.send_bytes(b"x", timeout_s=5)
        plain.close()
    finally:
        server.stop(0)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_perf_buffer_batches_by_timeout(side):
    perf, pr = (pperf, ppr) if side == "port" else (rperf, rpr)
    inq, outq = queue.Queue(), queue.Queue()
    buf = perf.PerfBuffer(inq, outq, max_batch=100, timeout_s=0.2)
    buf.start()
    try:
        inq.put(pr.PacketRecord(1, 0, b"x"))
        inq.put(pr.PacketRecord(1, 0, b"y"))
        batch = outq.get(timeout=2)
        assert [p.payload for p in batch] == [b"x", b"y"]
    finally:
        buf.stop()
    assert not buf._thread.is_alive()


def test_perf_buffer_batches_by_size():
    inq, outq = queue.Queue(), queue.Queue()
    buf = pperf.PerfBuffer(inq, outq, max_batch=3, timeout_s=30.0)
    for i in range(7):
        inq.put(ppr.PacketRecord(1, i, bytes([i])))
    buf.start()
    try:
        sizes = [len(outq.get(timeout=2)), len(outq.get(timeout=2))]
    finally:
        buf.stop()
    assert sizes == [3, 3]
    assert [len(b) for b in list(outq.queue)] == [1]   # flushed at stop


# ------------------------------------------------------------ packet wire


@pytest.mark.parametrize("size", [0, 1, 24, 127, 128, 272, 70_000])
def test_packet_bytes_equal_packet_pb2(size):
    payload = np.random.default_rng(size).bytes(size)
    wrapped = any_pb2.Any()
    wrapped.Pack(wrappers_pb2.BytesValue(value=payload))
    ref = packet_pb2.Packet(pcap=wrapped)
    ours = pbpacket.wrap_pcap(payload)
    assert ours.SerializeToString() == ref.SerializeToString(
        deterministic=True)
    # each side parses the other's bytes
    assert pbpacket.unwrap_pcap(pbpacket.Packet.FromString(
        ref.SerializeToString())) == payload
    back = packet_pb2.Packet.FromString(ours.SerializeToString())
    val = wrappers_pb2.BytesValue()
    assert back.pcap.Unpack(val) and val.value == payload
    assert back.pcap.type_url == ours.pcap.type_url == \
        "type.googleapis.com/google.protobuf.BytesValue"


def test_packet_wire_corners():
    assert pbpacket.CollectorReply().SerializeToString() == \
        packet_pb2.CollectorReply().SerializeToString() == b""
    assert isinstance(pbpacket.CollectorReply.FromString(b""),
                      pbpacket.CollectorReply)
    # a Packet without pcap, and an Any holding another type
    assert pbpacket.Packet().SerializeToString() == b""
    with pytest.raises(ValueError, match="BytesValue"):
        pbpacket.unwrap_pcap(pbpacket.Packet.FromString(b""))
    other = any_pb2.Any()
    other.Pack(wrappers_pb2.StringValue(value="x"))
    msg = pbpacket.Packet.FromString(
        packet_pb2.Packet(pcap=other).SerializeToString())
    assert not msg.pcap.Is(pbpacket.BytesValue)
    with pytest.raises(ValueError, match="BytesValue"):
        pbpacket.unwrap_pcap(msg)
    # a custom prefix still names the type
    custom = pbpacket.Any(type_url="example.com/x/google.protobuf.BytesValue",
                          value=b"\x0a\x02hi")
    val = pbpacket.BytesValue()
    assert custom.Unpack(val) and bytes(val.value) == b"hi"
    with pytest.raises(WireError):
        pbpacket.Packet.FromString(b"\x0a\x05\x12\x03")


def test_collector_answers_internal_for_a_bad_packet():
    from netobserv_tpu_torch.grpc import h2

    server, port, out = start_packet_collector(0)
    ch = h2.Channel(f"127.0.0.1:{port}")
    try:
        call = ch.unary_unary("/pbpacket.Collector/Send")
        with pytest.raises(RpcError) as err:
            call(b"\x0a\x01", timeout=5)
        assert err.value.code() == h2.StatusCode.INTERNAL
        assert call(pbpacket.wrap_pcap(b"ok").SerializeToString(),
                    timeout=5) == b""
        assert out.get(timeout=5) == b"ok"
    finally:
        ch.close()
        server.stop(0)


# ----------------------------------------------------- records and pcaps


def test_packet_records_and_framing_equal_the_references():
    payloads = _seeded_payloads(3, 40)
    events = np.frombuffer(b"".join(
        make_packet_event(p, if_index=i, ts=10**9 * i + 7)
        for i, p in enumerate(payloads)), dtype=binfmt.PACKET_EVENT_DTYPE)
    ours = ppr.packets_from_events(events, 123_456_789)
    theirs = rpr.packets_from_events(events, 123_456_789)
    assert [vars(r) for r in ours] == [vars(r) for r in theirs]
    assert [len(r.payload) for r in ours] == [
        min(len(p), binfmt.MAX_PAYLOAD_SIZE) for p in payloads]
    assert [ppr.frame_packet(r) for r in ours] == [
        rpr.frame_packet(r) for r in theirs]
    assert ppr.pcap_file_header() == rpr.pcap_file_header()
    assert ppr.pcap_packet_header(1_999_999_999_999, 5, 9) == \
        rpr.pcap_packet_header(1_999_999_999_999, 5, 9)


def write_pcap(path, payloads, magic=0xA1B2C3D4, endian="<",
               t0_us=1_700_000_000_000_000, step_us=1_250) -> None:
    """A classic pcap of `payloads` (microsecond or nanosecond stamps by
    `magic`), frames `step_us` apart."""
    nano = magic == 0xA1B23C4D
    with open(path, "wb") as fh:
        fh.write(struct.pack(endian + "IHHiIII", magic, 2, 4, 0, 0, 65535,
                             1))
        for i, p in enumerate(payloads):
            t = t0_us + i * step_us
            sub = (t % 1_000_000) * (1000 if nano else 1)
            fh.write(struct.pack(endian + "IIII", t // 1_000_000, sub,
                                 len(p), len(p)) + p)


@pytest.mark.parametrize("magic,endian", [
    (0xA1B2C3D4, "<"), (0xA1B23C4D, "<"), (0xA1B2C3D4, ">")],
    ids=["usec", "nsec", "big_endian"])
def test_pcap_packet_fetcher_events_equal_the_references(
        magic, endian, tmp_path, monkeypatch):
    path = tmp_path / "p.pcap"
    write_pcap(path, _seeded_payloads(4, 60), magic, endian)
    monkeypatch.setattr(time, "clock_gettime_ns", lambda clk: MONO)
    ours = preplay.PcapPacketFetcher(str(path))
    theirs = rreplay.PcapPacketFetcher(str(path))
    monkeypatch.undo()
    got = []
    while not ours.exhausted():
        got.append(ours.read_packet(0.01))
    want = []
    while not theirs.exhausted():
        want.append(theirs.read_packet(0.01))
    assert got == want and len(got) == 60
    assert ours.read_packet(0.001) is None
    ours.close()


def test_pcap_packet_fetcher_refuses_what_is_no_pcap(tmp_path):
    short = tmp_path / "short"
    short.write_bytes(b"\xd4\xc3\xb2")
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00" * 40)
    with pytest.raises(ValueError, match="too short"):
        preplay.PcapPacketFetcher(str(short))
    with pytest.raises(ValueError, match="magic"):
        preplay.PcapPacketFetcher(str(bad))


def _fixed_clocks(monkeypatch):
    for mod in (precord, rrecord):
        monkeypatch.setattr(mod.MonotonicClock, "now_pair",
                            lambda self: (MONO, WALL))


def _agent_stream(mod, events) -> list:
    """One package's PacketsAgent over `events` into the port's
    collector; the collected byte strings in order."""
    server, port, out = start_packet_collector(0)
    try:
        env = {"ENABLE_PCA": "true", "TARGET_HOST": "127.0.0.1",
               "TARGET_PORT": str(port), "CACHE_ACTIVE_TIMEOUT": "100ms"}
        cfg = (load_config if mod is pagent else jload)(environ=env)
        fake = mod.FakePacketFetcher()
        agent = mod.PacketsAgent(cfg, fake)
        return _run_agent(agent, fake, events, out, len(events) + 1)
    finally:
        server.stop(0)


def test_agent_stream_equals_the_reference_agents(monkeypatch):
    """The same injected events through both agents (each over its own
    transport: the reference's grpcio client, the port's h2 one) reach
    the collector as the same bytes: the file header, then each frame,
    truncated at MAX_PAYLOAD_SIZE, stamped on one patched clock."""
    _fixed_clocks(monkeypatch)
    payloads = _seeded_payloads(5, 120)
    events = [make_packet_event(p, if_index=2, ts=MONO - 10**6 * (120 - i))
              for i, p in enumerate(payloads)]
    ours = _agent_stream(pagent, events)
    theirs = _agent_stream(ragent, events)
    assert ours == theirs
    assert ours[0] == ppr.pcap_file_header()
    for i, (chunk, p) in enumerate(zip(ours[1:], payloads)):
        n = min(len(p), binfmt.MAX_PAYLOAD_SIZE)
        assert chunk == ppr.pcap_packet_header(
            WALL - 10**6 * (120 - i), n, n) + p[:n]


def test_agent_drops_wrong_size_events_and_shuts_down():
    class Collect:
        def __init__(self):
            self.batches, self.closed = [], False

        def export_packets(self, batch):
            self.batches.append(batch)

        def close(self):
            self.closed = True

    cfg = load_config(environ={"ENABLE_PCA": "true", "TARGET_HOST": "x",
                               "TARGET_PORT": "1"})
    fake, out = pagent.FakePacketFetcher(), Collect()
    agent = pagent.PacketsAgent(cfg, fake, exporter=out)
    assert agent.iface_listener is None
    fake.inject(b"\x00" * 10)
    fake.inject(make_packet_event(b"ok"))
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while not out.batches and time.monotonic() < deadline:
        time.sleep(0.02)
    agent.stop()
    t.join(timeout=10)
    assert not t.is_alive() and out.closed
    assert [p.payload for b in out.batches for p in b] == [b"ok"]


# ------------------------------------------------------ live packet fetchers


def _pca_pins() -> list:
    return glob.glob(loader.MinimalPacketFetcher._PIN_PREFIX +
                     f"{os.getpid()}_*")


@live
@pytest.mark.parametrize("filters", [False, True], ids=["plain", "filters"])
def test_minimal_packet_fetcher_provisions_through_the_verifier(filters):
    from netobserv_tpu_torch.config import parse_filter_rules

    f = loader.MinimalPacketFetcher(enable_filters=filters)
    try:
        assert set(f._prog_fds) == {"ingress", "egress"}
        assert sorted(_pca_pins()) == sorted(set(f._pins.values()))
        assert len(set(f._prog_fds.values())) == (2 if filters else 1)
        assert f.read_packet(0.01) is None
        n = f.program_filters(parse_filter_rules(
            '[{"ip_cidr":"10.198.0.0/24","protocol":"UDP",'
            '"direction":"Egress","destination_port":7801}]'))
        assert n == (1 if filters else 0)
    finally:
        f.close()
    assert _pca_pins() == []


@live
def test_packet_fetcher_keeps_the_live_pins_of_another_process():
    done = subprocess.Popen([sys.executable, "-c", "pass"])
    done.wait()
    alive = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    prefix = loader.MinimalPacketFetcher._PIN_PREFIX
    theirs, stale = f"{prefix}{alive.pid}_pca", f"{prefix}{done.pid}_pca"
    try:
        first = loader.MinimalPacketFetcher()
        try:
            sb.obj_pin(first._prog_fds["ingress"], theirs)
            sb.obj_pin(first._prog_fds["ingress"], stale)
        finally:
            first.close()
        loader.MinimalPacketFetcher().close()
        assert os.path.exists(theirs) and not os.path.exists(stale)
    finally:
        alive.kill()
        alive.wait()
        for pin in (theirs, stale):
            if os.path.exists(pin):
                os.unlink(pin)
    assert _pca_pins() == []
    # neither package's sweep matches the other's prefix
    from netobserv_tpu.datapath import loader as jloader
    assert not prefix.startswith(jloader.MinimalPacketFetcher._PIN_PREFIX)


@live
@tcx
def test_pca_kernel_capture_on_loopback_to_parseable_pcap(tmp_path):
    """REAL capture: the hand-assembled PCA program attached by TCX to
    lo's egress streams each UDP datagram's frame through the ring; the
    records frame into a pcap that the port's replay parses back to the
    flow (`tests/test_asm_flowpath.py:214-266` on a veth pair)."""
    sport, dport, size = 44444, 7777, 64
    f = loader.MinimalPacketFetcher(attach_mode="tcx")
    try:
        f.attach(socket.if_nametoindex("lo"), "lo", "egress")
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", sport))
        for _ in range(5):
            s.sendto(b"q" * size, ("127.0.0.1", dport))
        s.close()
        events, deadline = [], time.monotonic() + 3
        while time.monotonic() < deadline and len(events) < 5:
            raw = f.read_packet(0.3)
            if raw is None:
                continue
            assert len(raw) == binfmt.PACKET_EVENT_DTYPE.itemsize
            ev = np.frombuffer(raw, dtype=binfmt.PACKET_EVENT_DTYPE)[0]
            payload = ev["payload"][:int(ev["pkt_len"])].tobytes()
            if payload[23:24] == b"\x11" and \
                    payload[36:38] == dport.to_bytes(2, "big"):
                events.append(ev)
        assert len(events) == 5, f"captured {len(events)}/5 packets"
        assert int(events[0]["pkt_len"]) == size + 8 + 20 + 14
        assert int(events[0]["if_index"]) == socket.if_nametoindex("lo")
        pcap = tmp_path / "capture.pcap"
        with open(pcap, "wb") as fh:
            fh.write(ppr.pcap_file_header())
            for e in ppr.packets_from_events(np.array(events), 0):
                fh.write(ppr.frame_packet(e))
        flows = preplay.PcapReplayFetcher(str(pcap)).lookup_and_delete()
        keys = {(int(k["src_port"]), int(k["dst_port"])): i
                for i, k in enumerate(flows.events["key"])}
        st = flows.events["stats"][keys[(sport, dport)]]
        assert int(st["packets"]) == 5
        assert int(st["bytes"]) == 5 * (size + 42)
    finally:
        f.close()
    assert _pca_pins() == []


@live
def test_libbpf_packet_fetcher_on_the_clang_object():
    """The twin of the reference's LibbpfPacketFetcher test: skipped
    without the clang-built object, as the reference's is."""
    if not os.path.exists(loader._OBJ_PATH):
        pytest.skip("no clang-built flowpath.bpf.o in this environment")
    cfg = load_config(environ={"ENABLE_PCA": "true", "TARGET_HOST": "x",
                               "TARGET_PORT": "1"})
    f = loader.LibbpfPacketFetcher(cfg)
    try:
        assert set(f._pins) == {"ingress", "egress"}
    finally:
        f.close()


def test_load_packet_fetcher_ladder(monkeypatch, caplog):
    """Not root raises; with root, no object takes the assembler rung,
    an object that fails to load falls back to it, and one that loads is
    taken (the rungs are stand-ins: nothing touches the kernel)."""
    cfg = load_config(environ={"ENABLE_PCA": "true", "TARGET_HOST": "x",
                               "TARGET_PORT": "1"})
    monkeypatch.setattr(os, "geteuid", lambda: 1000)
    with pytest.raises(RuntimeError, match="root"):
        loader.load_packet_fetcher(cfg)
    monkeypatch.setattr(os, "geteuid", lambda: 0)
    monkeypatch.setattr(loader.MinimalPacketFetcher, "load",
                        classmethod(lambda cls, c: "assembler"))
    monkeypatch.setattr(loader, "_OBJ_PATH", "/nonexistent/flowpath.bpf.o")
    assert loader.load_packet_fetcher(cfg) == "assembler"
    from netobserv_tpu_torch.datapath import libbpf as lb

    monkeypatch.setattr(loader, "_OBJ_PATH", __file__)
    monkeypatch.setattr(lb, "available", lambda: True)

    def refuse(self, c, obj_path=None, ring_bytes=0):
        raise OSError("verifier refused")
    monkeypatch.setattr(loader.LibbpfPacketFetcher, "__init__", refuse)
    with caplog.at_level("WARNING"):
        assert loader.load_packet_fetcher(cfg) == "assembler"
    assert "verifier refused" in caplog.text
    monkeypatch.setattr(loader.LibbpfPacketFetcher, "__init__",
                        lambda self, c, obj_path=None: None)
    assert isinstance(loader.load_packet_fetcher(cfg),
                      loader.LibbpfPacketFetcher)


# ---------------------------------------------------------------- the CLI


def _child_env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SKETCH_", "DATAPATH", "EXPORT", "METRICS_",
                                "TARGET_", "ENABLE_"))}
    env.update(PYTHONPATH=ROOT, AGENT_IP="127.0.0.1", **kw)
    return env


def test_cli_pca_child_streams_a_pcap(tmp_path):
    """`python -m netobserv_tpu_torch` with ENABLE_PCA and
    `DATAPATH=pcap:<file>`: the collector gets the file header, then each
    frame truncated at MAX_PAYLOAD_SIZE, its stamp the file's offset
    rebased to the wall clock when it is read (each base between the
    child's start and the end; the tracer reads its two clocks one after
    the other, so a thread switch shifts one stamp); SIGTERM exits 0."""
    payloads = _seeded_payloads(6, 50)
    path = tmp_path / "c.pcap"
    write_pcap(path, payloads, step_us=2_000)
    server, port, out = start_packet_collector(0)
    wall0 = time.time_ns() // 1000
    proc = subprocess.Popen(
        [sys.executable, "-m", "netobserv_tpu_torch"], cwd=ROOT,
        env=_child_env(ENABLE_PCA="true", TARGET_HOST="127.0.0.1",
                       TARGET_PORT=str(port), DATAPATH=f"pcap:{path}"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        got = [out.get(timeout=30) for _ in range(len(payloads) + 1)]
        wall1 = time.time_ns() // 1000
        proc.send_signal(signal.SIGTERM)
        _o, err = proc.communicate(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        server.stop(0)
    assert proc.returncode == 0, err.decode()[-2000:]
    assert got[0] == ppr.pcap_file_header()
    bases = []
    for i, (chunk, p) in enumerate(zip(got[1:], payloads)):
        n = min(len(p), binfmt.MAX_PAYLOAD_SIZE)
        sec, usec, incl, orig = struct.unpack("<IIII", chunk[:16])
        assert (incl, orig) == (n, n) and chunk[16:] == p[:n]
        bases.append(sec * 10**6 + usec - 2_000 * i)
    assert wall0 <= min(bases) and max(bases) <= wall1, (wall0, bases,
                                                          wall1)
