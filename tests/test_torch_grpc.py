"""The port's gRPC transport (netobserv_tpu_torch/grpc/h2.py, flow.py,
federation.py) and its federation sink (exporter/federation.py) against
grpcio and the JAX package's gRPC modules, on the CPU.

- The port's clients against the reference's servers and the reference's
  clients against the port's, for Collector.Send and Federation.Push:
  equal replies byte for byte, message sizes from 0 B to 4 MiB + 1
  (RESOURCE_EXHAUSTED past grpc's 4 MiB receive limit, from either
  server), a deadline that a sleeping handler exceeds, connection refused,
  an unknown method, `classify_rpc_error` on every code, concurrent calls
  on one connection, TLS and mTLS with a certificate made by `openssl`.
- HPACK on RFC 7541's Appendix C examples and on what grpc sends.
- The sink's tests (tests/test_federation.py:371-413 and
  tests/test_federation_chaos.py:585-785) with the port's sink and
  aggregator over the port's transport, and the exporter built with
  FEDERATION_TARGET against the JAX exporter's.
- Every socket and thread closed; every wait has its own timeout.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import grpc
import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.federation import delta as rd
from netobserv_tpu.grpc import federation as rgfed
from netobserv_tpu.grpc import flow as rgflow
from netobserv_tpu.pb import flow_pb2
from netobserv_tpu.pb import sketch_delta_pb2 as spb
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter import pb_convert as pconv
from netobserv_tpu_torch.exporter.federation import FederationDeltaSink
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.federation.aggregator import FederationAggregator
from netobserv_tpu_torch.federation.delta import ACK_REASON_STALE
from netobserv_tpu_torch.federation.pbwire import DeltaAck
from netobserv_tpu_torch.grpc import federation as pgfed
from netobserv_tpu_torch.grpc import flow as pgflow
from netobserv_tpu_torch.grpc import h2
from netobserv_tpu_torch.grpc.h2 import RpcError, StatusCode
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject
from tests.test_federation import agent_frames_and_union
from tests.test_federation_chaos import build_streams
from tests.test_torch_config import _SMALL_ENV, one_device_reference
from tests.test_torch_pbflow import _named, seeded_records
from tests.test_torch_staging import _feed

#: the port's twin of tests/test_federation.py's CFG
PCFG = ts.SketchConfig(cm_depth=3, cm_width=1024, hll_precision=8,
                       perdst_buckets=64, perdst_precision=5,
                       persrc_buckets=64, persrc_precision=5, topk=64,
                       hist_buckets=128, ewma_buckets=64)
PUSH, SEND = "/pbsketch.Federation/Push", "/pbflow.Collector/Send"
LIMIT = h2.MAX_MESSAGE
SIZES = [0, 1, 16383, 16384, 65535, 65536, 1 << 20, LIMIT, LIMIT + 1]


@pytest.fixture(autouse=True)
def _clean():
    yield
    faultinject.clear()


def _echo_port(frame: bytes) -> DeltaAck:
    return DeltaAck(accepted=1, version=3, reason=str(len(frame)),
                    duplicate=len(frame) % 2)


def _echo_ref(frame: bytes):
    return spb.DeltaAck(accepted=1, version=3, reason=str(len(frame)),
                        duplicate=len(frame) % 2)


def _start(kind: str, service: str, **kw):
    """(server, port, queue) of one side's collector."""
    if service == "push":
        mod, echo = ((pgfed, _echo_port) if kind == "port"
                     else (rgfed, _echo_ref))
        kw.setdefault("handler", echo)
        return mod.start_federation_collector(0, **kw)
    return (pgflow if kind == "port" else rgflow).start_flow_collector(
        0, **kw)


class _RefRaw:
    """grpcio's raw-bytes unary client: the reference's transport."""

    def __init__(self, target: str, creds=None):
        self.ch = (grpc.secure_channel(target, creds) if creds
                   else grpc.insecure_channel(target))

    def call(self, path: str, data: bytes, timeout: float = 20.0) -> bytes:
        try:
            return self.ch.unary_unary(path)(data, timeout=timeout)
        except grpc.RpcError as exc:
            raise _Verdict(exc.code().name, exc.details()) from None

    def close(self):
        self.ch.close()


class _PortRaw:
    def __init__(self, target: str, ctx=None):
        self.ch = h2.Channel(target, ctx)

    def call(self, path: str, data: bytes, timeout: float = 20.0) -> bytes:
        try:
            return self.ch.call(path.encode(), data, timeout)
        except RpcError as exc:
            raise _Verdict(exc.code().name, exc.details()) from None

    def close(self):
        self.ch.close()


class _Verdict(Exception):
    def __init__(self, code: str, details: str):
        super().__init__(code, details)
        self.code, self.details = code, details


def _client(kind: str, port: int, tls: dict | None = None):
    target = f"127.0.0.1:{port}"
    if kind == "port":
        return _PortRaw(target, h2.client_ssl_context(**tls) if tls
                        else None)
    creds = None
    if tls:
        creds = rgflow._channel_credentials(
            tls["ca_path"], tls.get("cert_path", ""),
            tls.get("key_path", ""))
    return _RefRaw(target, creds)


def _outcome(client, path: str, data: bytes, timeout: float = 20.0):
    try:
        return "ok", client.call(path, data, timeout)
    except _Verdict as v:
        return v.code, v.details


@pytest.fixture(scope="module")
def push_servers():
    servers = {k: _start(k, "push") for k in ("port", "reference")}
    yield {k: v[1] for k, v in servers.items()}
    for srv, _, _ in servers.values():
        srv.stop(None)


# ------------------------------------------------------------------ interop


@pytest.mark.parametrize("size", SIZES)
def test_push_sizes_answer_alike_on_every_pair(size, push_servers):
    data = bytes(np.random.default_rng(size).integers(0, 256, size,
                                                      dtype=np.uint8))
    got = {}
    for ck in ("port", "reference"):
        for sk, port in push_servers.items():
            client = _client(ck, port)
            try:
                got[(ck, sk)] = _outcome(client, PUSH, data)
            finally:
                client.close()
    want = ("ok", _echo_ref(data).SerializeToString(deterministic=True))
    if size > LIMIT:
        want = ("RESOURCE_EXHAUSTED", f"SERVER: Received message larger "
                f"than max ({size} vs. {LIMIT})")
    assert got == {k: want for k in got}, got


@pytest.mark.parametrize("client_kind", ["port", "reference"])
def test_send_delivers_records_to_either_server(client_kind):
    recs = seeded_records(3, 25) + _named()
    data = pconv.records_to_pb(recs).SerializeToString()
    replies = {}
    for server_kind in ("port", "reference"):
        srv, port, out = _start(server_kind, "send")
        client = _client(client_kind, port)
        try:
            replies[server_kind] = _outcome(client, SEND, data)
            msg = out.get(timeout=10)
            raw = (msg.SerializeToString() if server_kind == "port"
                   else msg.SerializeToString(deterministic=True))
            assert raw == data
        finally:
            client.close()
            srv.stop(None)
    assert replies["port"] == replies["reference"] == ("ok", b"")


def test_port_flow_client_and_collector_speak_records():
    srv, port, out = pgflow.start_flow_collector(0)
    try:
        client = pgflow.FlowClient("127.0.0.1", port)
        reply = client.send(pconv.records_to_pb(_named()), timeout_s=10)
        assert reply.SerializeToString() == b""
        got = out.get(timeout=10)
        assert [pconv.pb_to_record(e) for e in got.entries] == [
            pconv.pb_to_record(pconv.record_to_pb(r)) for r in _named()]
        client.close()
    finally:
        srv.stop(None)


@pytest.mark.parametrize("server_kind", ["port", "reference"])
def test_unknown_method_and_refused_connection(server_kind):
    srv, port, _ = _start(server_kind, "push")
    try:
        for ck in ("port", "reference"):
            client = _client(ck, port)
            try:
                assert _outcome(client, "/x.Y/Z", b"abc", 10) == (
                    "UNIMPLEMENTED", "Method not found!")
            finally:
                client.close()
    finally:
        srv.stop(None)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    for ck in ("port", "reference"):
        client = _client(ck, dead)
        try:
            assert _outcome(client, PUSH, b"x", 5)[0] == "UNAVAILABLE"
        finally:
            client.close()


def test_deadline_exceeded_on_both_clients():
    release = threading.Event()

    def slow(frame):
        release.wait(5.0)
        return DeltaAck(accepted=1)
    srv, port, _ = pgfed.start_federation_collector(0, handler=slow)
    try:
        for ck in ("port", "reference"):
            client = _client(ck, port)
            t0 = time.monotonic()
            try:
                assert _outcome(client, PUSH, b"x", 0.3)[0] == \
                    "DEADLINE_EXCEEDED"
                assert time.monotonic() - t0 < 3.0
            finally:
                client.close()
        release.set()
        client = _client("port", port)
        try:
            assert _outcome(client, PUSH, b"x", 5)[0] == "ok"
        finally:
            client.close()
    finally:
        release.set()
        srv.stop(None)


def _ref_error(code):
    class _Err(grpc.RpcError):
        def code(self):
            return code
    return _Err(code.name)


@pytest.mark.parametrize("name", [c.name for c in StatusCode])
def test_classify_rpc_error_agrees_with_the_reference(name):
    ours = pgfed.classify_rpc_error(RpcError(StatusCode[name], "x"))
    assert ours == rgfed.classify_rpc_error(
        _ref_error(getattr(grpc.StatusCode, name)))
    assert StatusCode[name].value == getattr(grpc.StatusCode,
                                             name).value[0]
    assert pgfed.classify_rpc_error(TypeError("x")) == \
        rgfed.classify_rpc_error(TypeError("x")) == "terminal"


@pytest.mark.parametrize("server_kind", ["port", "reference"])
def test_concurrent_calls_share_one_connection(server_kind):
    srv, port, _ = _start(server_kind, "push")
    ch = h2.Channel(f"127.0.0.1:{port}")
    results, errors = {}, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # threads switch often: races show

    def worker(i):
        try:
            data = bytes([i]) * (1000 + 37_000 * i)
            results[i] = ch.call(PUSH.encode(), data, 20.0)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)
    try:
        ch.call(PUSH.encode(), b"warm", 10.0)
        conn = ch._conn
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors and len(results) == 12
        for i, raw in results.items():
            assert raw == _echo_ref(bytes(1000 + 37_000 * i)
                                    ).SerializeToString(deterministic=True)
        assert ch._conn is conn and conn.next_id == 1 + 2 * 13
    finally:
        sys.setswitchinterval(interval)
        ch.close()
        srv.stop(None)


# ---------------------------------------------------------------------- TLS


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
def test_tls_on_every_pair(certs, mtls):
    tls = {"ca_path": certs["cert"]}
    if mtls:
        tls.update(cert_path=certs["cert"], key_path=certs["key"])
    for sk in ("port", "reference"):
        srv, port, _ = _start(sk, "push", tls_cert=certs["cert"],
                              tls_key=certs["key"])
        try:
            for ck in ("port", "reference"):
                for size in (3, 70_000, 1 << 20):
                    client = _client(ck, port, tls)
                    try:
                        got = _outcome(client, PUSH, b"t" * size)
                    finally:
                        client.close()
                    assert got == ("ok", _echo_ref(b"t" * size)
                                   .SerializeToString(deterministic=True)
                                   ), (sk, ck, size, got)
        finally:
            srv.stop(None)


def test_port_clients_refuse_a_plain_server_under_tls(certs):
    srv, port, _ = _start("port", "push")
    try:
        client = _client("port", port, {"ca_path": certs["cert"]})
        try:
            assert _outcome(client, PUSH, b"x", 5)[0] == "UNAVAILABLE"
        finally:
            client.close()
    finally:
        srv.stop(None)


# -------------------------------------------------------------------- HPACK


def _hdrs(*pairs):
    return [(a.encode(), b.encode()) for a, b in pairs]


_C3 = [("828684410f7777772e6578616d706c652e636f6d",
        _hdrs((":method", "GET"), (":scheme", "http"), (":path", "/"),
              (":authority", "www.example.com"))),
       ("828684be58086e6f2d6361636865",
        _hdrs((":method", "GET"), (":scheme", "http"), (":path", "/"),
              (":authority", "www.example.com"),
              ("cache-control", "no-cache"))),
       ("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
        _hdrs((":method", "GET"), (":scheme", "https"),
              (":path", "/index.html"), (":authority", "www.example.com"),
              ("custom-key", "custom-value")))]
_C4 = [("828684418cf1e3c2e5f23a6ba0ab90f4ff", _C3[0][1]),
       ("828684be5886a8eb10649cbf", _C3[1][1]),
       ("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf", _C3[2][1])]
_DATE1, _DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
_C6 = [("488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d"
        "1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3",
        _hdrs((":status", "302"), ("cache-control", "private"),
              ("date", _DATE1), ("location", "https://www.example.com"))),
       ("4883640effc1c0bf",
        _hdrs((":status", "307"), ("cache-control", "private"),
              ("date", _DATE1), ("location", "https://www.example.com"))),
       ("88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab"
        "77ad94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f"
        "9587316065c003ed4ee5b1063d5007",
        _hdrs((":status", "200"), ("cache-control", "private"),
              ("date", _DATE2), ("location", "https://www.example.com"),
              ("content-encoding", "gzip"),
              ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; "
               "max-age=3600; version=1")))]


@pytest.mark.parametrize("case,table", [("C3", 4096), ("C4", 4096),
                                        ("C6", 256)])
def test_hpack_decodes_rfc7541_appendix_c(case, table):
    dec = h2.HpackDecoder(table)
    for raw, want in {"C3": _C3, "C4": _C4, "C6": _C6}[case]:
        assert dec.decode(bytes.fromhex(raw)) == want
    if case == "C6":  # the table was evicted down to its 256 bytes
        assert dec._size <= 256 and len(dec._table) == 3


def _huffman_encode(data: bytes) -> bytes:
    """RFC 7541 5.2 over the port's canonical code: the codes, padded
    with the EOS prefix (ones)."""
    acc = nbits = 0
    for b in data:
        n = h2._HUFFMAN_LENGTHS[b]
        acc, nbits = (acc << n) | h2.HUFFMAN_CODES[b], nbits + n
    pad = -nbits % 8
    return ((acc << pad) | ((1 << pad) - 1)).to_bytes((nbits + pad) // 8,
                                                      "big")


def test_hpack_literal_forms_and_huffman_round_trip():
    dec = h2.HpackDecoder()
    assert dec.decode(bytes.fromhex(
        "400a637573746f6d2d6b65790d637573746f6d2d686561646572")) == \
        _hdrs(("custom-key", "custom-header"))
    assert dec._size == 55
    assert dec.decode(bytes.fromhex("040c2f73616d706c652f70617468")) == \
        _hdrs((":path", "/sample/path"))
    assert dec.decode(bytes.fromhex("100870617373776f726406736563726574")) \
        == _hdrs(("password", "secret"))
    assert dec.decode(b"\x82") == _hdrs((":method", "GET"))
    assert _huffman_encode(b"www.example.com").hex() == \
        "f1e3c2e5f23a6ba0ab90f4ff"
    for data in (bytes(range(256)), b"", b"grpc-status", "é".encode()):
        assert h2.huffman_decode(_huffman_encode(data)) == data
    for bad in (b"\xff\xff\xff\xff", b"\x00"):  # EOS / bad padding
        with pytest.raises(h2.HpackError):
            h2.huffman_decode(bad)
    with pytest.raises(h2.HpackError):
        h2.HpackDecoder().decode(b"\xbe")  # past the empty dynamic table
    block = h2.encode_headers(_hdrs(("grpc-message", "a b%c")))
    assert h2.HpackDecoder().decode(block) == _hdrs(("grpc-message",
                                                     "a b%c"))
    assert h2.decode_grpc_message(h2.encode_grpc_message("ünï %ok\n")) == \
        "ünï %ok\n"


def test_grpc_clients_header_blocks_decode(push_servers):
    """What grpc sends: Huffman strings and dynamic-table entries."""
    seen = []
    orig = h2.HpackDecoder.decode

    def spy(self, block):
        out = orig(self, block)
        seen.append((self, dict(out)))
        return out
    h2.HpackDecoder.decode = spy
    try:
        client = _client("reference", push_servers["port"])
        try:
            for _ in range(3):
                assert _outcome(client, PUSH, b"abc", 5)[0] == "ok"
        finally:
            client.close()
    finally:
        h2.HpackDecoder.decode = orig
    requests = [h for _, h in seen if b":path" in h]
    assert len(requests) == 3
    for h in requests:
        assert h[b":path"] == PUSH.encode() and h[b"te"] == b"trailers"
        assert h[b"content-type"] == b"application/grpc"
        assert h[b"grpc-timeout"][-1:] in b"HMSmun"
    assert seen[0][0]._table, "grpc indexed nothing: no dynamic table used"


# ------------------------------------------------------ threads and sockets


def _h2_threads(old=frozenset()) -> list[str]:
    """The transport's threads, less those in `old` (another test's)."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith("h2-") and t not in old]


def _fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_every_socket_and_thread_is_closed():
    before_fds = _fds()
    old = frozenset(threading.enumerate())
    srv, port, _ = _start("port", "push")
    chans = [h2.Channel(f"127.0.0.1:{port}") for _ in range(3)]
    for ch in chans:
        ch.call(PUSH.encode(), b"x" * 70_000, 10.0)
    assert len(_h2_threads(old)) >= 4
    for ch in chans:
        ch.close()
    assert srv.stop(None).wait(10.0)
    deadline = time.monotonic() + 10.0
    while (_h2_threads(old) or _fds() > before_fds) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert _h2_threads(old) == [] and _fds() <= before_fds


def test_stop_with_grace_lets_a_call_finish():
    release = threading.Event()

    def slow(frame):
        release.wait(5.0)
        return DeltaAck(accepted=1, reason="late")
    srv, port, _ = pgfed.start_federation_collector(0, handler=slow)
    client = pgfed.FederationClient("127.0.0.1", port)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "ack", client.send(b"x", timeout_s=10)))
    t.start()
    time.sleep(0.2)
    stopped = srv.stop(grace=5.0)
    time.sleep(0.1)
    release.set()
    t.join(timeout=10)
    assert stopped.wait(10.0) and out["ack"].reason == "late"
    client.close()


# ------------------------------------------------- the sink over the wire


def _wire(metrics=None, **sink_kw):
    agg = FederationAggregator(PCFG, window_s=3600.0, metrics=metrics,
                               sink=lambda obj: None, device="cpu")
    server, port, _ = pgfed.start_federation_collector(
        port=0, handler=agg.ingest_frame)
    sink = FederationDeltaSink("127.0.0.1", port, metrics=metrics,
                               **sink_kw)
    return agg, server, sink, port


def test_grpc_push_end_to_end():
    """The twin of tests/test_federation.py:373."""
    agg, server, sink, _ = _wire()
    try:
        frames, _ = agent_frames_and_union(seed=4, n_batches=1)
        assert sink(frames[0]) is True
        assert agg.status()["frames_total"] == 1
    finally:
        sink.close()
        server.stop(grace=None)
        agg.close()


def test_sink_swallows_dead_aggregator():
    """The twin of tests/test_federation.py:389."""
    m = Metrics()
    sink = FederationDeltaSink("127.0.0.1", 1, retries=2,
                               backoff_initial_s=0.01, timeout_s=0.2,
                               metrics=m)
    assert sink(b"frame") is False
    assert m.registry.get_sample_value(
        "ebpf_agent_federation_deltas_sent_total", {"result": "error"}) == 1
    assert m.registry.get_sample_value(
        "ebpf_agent_export_errors_total",
        {"exporter": "federation", "error": "delta_push"}) == 1
    sink.close()


def test_bad_frame_acked_not_crash():
    """The twin of tests/test_federation.py:401."""
    agg, server, sink, port = _wire()
    sink.close()
    try:
        client = pgfed.FederationClient("127.0.0.1", port)
        assert client.send(b"\x00garbage").accepted == 0
        frames, _ = agent_frames_and_union(seed=5, n_batches=1)
        assert client.send(frames[0]).accepted == 1
        client.close()
    finally:
        server.stop(grace=None)
        agg.close()


def test_ambiguous_deadline_applies_exactly_once():
    """The twin of tests/test_federation_chaos.py:585."""
    m = Metrics()
    agg, server, sink, _ = _wire(metrics=m, retries=3, backoff_initial_s=0.05,
                              timeout_s=0.3)
    try:
        frames = build_streams(n_agents=1, n_windows=1, seed=41)
        faultinject.arm("federation.delta_ingest", "delay", arg=1.0,
                        times=1)
        assert sink(frames[(0, 0)][0]) is True
        get = m.registry.get_sample_value
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if (get("ebpf_agent_federation_deltas_total",
                    {"result": "ok"}) or 0) + (get(
                    "ebpf_agent_federation_deltas_total",
                    {"result": "duplicate"}) or 0) >= 2:
                break
            time.sleep(0.02)
        assert get("ebpf_agent_federation_deltas_total",
                   {"result": "ok"}) == 1
        assert get("ebpf_agent_federation_deltas_total",
                   {"result": "duplicate"}) == 1
        assert agg.status()["frames_total"] >= 1
    finally:
        faultinject.clear()
        sink.close()
        server.stop(grace=None)
        agg.close()


def test_cold_start_sink_recovers_after_server_appears():
    """The twin of tests/test_federation_chaos.py:645."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    sink = FederationDeltaSink("127.0.0.1", port, retries=2,
                               backoff_initial_s=0.01, timeout_s=2.0)
    frames = build_streams(n_agents=1, n_windows=2, seed=43)
    assert sink(frames[(0, 0)][0]) is False
    agg = FederationAggregator(PCFG, window_s=3600.0, sink=lambda o: None,
                               device="cpu")
    server, bound, _ = pgfed.start_federation_collector(
        port=port, handler=agg.ingest_frame)
    try:
        assert bound == port
        assert sink(frames[(0, 1)][0]) is True
    finally:
        server.stop(grace=None)
        sink.close()
        agg.close()


class _FakeClient:
    """Scripted FederationClient: one behavior a send()."""

    def __init__(self, script):
        self.script = list(script)
        self.sends = 0

    def send(self, frame, timeout_s=0):
        self.sends += 1
        step = self.script.pop(0)
        if isinstance(step, Exception):
            raise step
        return step

    def connect(self):
        pass

    def close(self):
        pass


def _sink(script, **kw):
    m = Metrics()
    return FederationDeltaSink("unused", 0, metrics=m,
                               client=_FakeClient(script),
                               sleep=lambda s: None, **kw), m


def _sent(m, result):
    return m.registry.get_sample_value(
        "ebpf_agent_federation_deltas_sent_total", {"result": result})


def test_terminal_code_fails_fast():
    sink, m = _sink([RpcError(StatusCode.INVALID_ARGUMENT)], retries=3)
    assert sink(b"frame") is False
    assert sink._client.sends == 1 and _sent(m, "terminal") == 1


def test_terminal_unimplemented_over_the_wire():
    """A server without Push: UNIMPLEMENTED, one attempt, `terminal`."""
    srv = h2.Server(max_workers=1)
    port = srv.add_port("127.0.0.1:0")
    srv.start()
    m = Metrics()
    sink = FederationDeltaSink("127.0.0.1", port, retries=3,
                               backoff_initial_s=0.01, metrics=m)
    sends = []
    orig = sink._client.send
    sink._client.send = lambda f, timeout_s=0: (sends.append(1),
                                                orig(f, timeout_s))[1]
    try:
        assert sink(b"frame") is False
        assert len(sends) == 1 and _sent(m, "terminal") == 1
        assert sink.last_ladder == []
    finally:
        sink.close()
        srv.stop(None)


def test_retry_safe_code_walks_ladder_then_succeeds():
    sink, m = _sink([RpcError(StatusCode.UNAVAILABLE),
                     RpcError(StatusCode.DEADLINE_EXCEEDED),
                     DeltaAck(accepted=1)], retries=3)
    assert sink(b"frame") is True
    assert sink._client.sends == 3 and _sent(m, "ok") == 1


def test_oversized_frame_is_resource_exhausted_and_retried():
    """A raw frame over 4 MiB: RESOURCE_EXHAUSTED, classified `retry`
    (as the reference classifies it), so it walks the whole ladder."""
    agg, server, sink, _ = _wire(metrics=Metrics(), retries=2,
                              backoff_initial_s=0.01)
    try:
        with pytest.raises(RpcError) as err:
            sink._client.send(b"\x00" * (LIMIT + 1), timeout_s=20)
        assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
        assert pgfed.classify_rpc_error(err.value) == "retry"
        assert sink(b"\x00" * (LIMIT + 1)) is False
        assert sink.last_ladder == [0.01]
        assert agg.status()["frames_total"] == 0
    finally:
        sink.close()
        server.stop(grace=None)
        agg.close()


def test_duplicate_ack_counts_as_duplicate():
    sink, m = _sink([DeltaAck(accepted=1, duplicate=1)])
    assert sink(b"frame") is True and _sent(m, "duplicate") == 1


def test_stale_ack_not_counted_as_benign_duplicate():
    sink, m = _sink([DeltaAck(accepted=1, duplicate=1,
                              reason=ACK_REASON_STALE)])
    assert sink(b"frame") is True
    assert _sent(m, "stale") == 1 and _sent(m, "duplicate") is None


def test_backoff_resets_between_windows():
    err = lambda: RpcError(StatusCode.UNAVAILABLE)  # noqa: E731
    sink, _ = _sink([err() for _ in range(6)], retries=3,
                    backoff_initial_s=0.2, backoff_max_s=10.0)
    assert sink(b"w0") is False
    first = list(sink.last_ladder)
    assert sink(b"w1") is False
    assert sink.last_ladder == first == sorted(first)
    assert first[0] == pytest.approx(0.2)


def test_exporter_with_federation_target_pushes_the_references_frames():
    """FEDERATION_TARGET builds the sink in both packages; the same
    evictions through each exporter reach a collector as frames whose
    headers and tables agree (the RTT and DNS histograms in their mass,
    as tests/test_torch_federation.py bounds their buckets), and every
    frame the port's sink was handed arrives whole."""
    rsrv, rport, rout = rgfed.start_federation_collector(0)
    psrv, pport, pout = pgfed.start_federation_collector(0)
    env = {**_SMALL_ENV, "SKETCH_FEED": "dense",
           "FEDERATION_AGENT_ID": "edge-1"}
    ref = one_device_reference(jcfg.load_config(
        {**env, "FEDERATION_TARGET": f"127.0.0.1:{rport}"}),
        sink=lambda o: None)
    ours = TorchSketchExporter.from_config(tcfg.load_config(
        {**env, "FEDERATION_TARGET": f"127.0.0.1:{pport}"}),
        sink=lambda o: None)
    handed = []
    real = ours._delta_sink

    class Recorder:
        def __call__(self, frame):
            handed.append(frame)
            return real(frame)

        def close(self):
            real.close()
    assert type(real).__name__ == type(ref._delta_sink).__name__
    ours._delta_sink = Recorder()
    try:
        rng = np.random.default_rng(7)
        from netobserv_tpu.datapath import fetcher as jfetch
        for _ in range(2):
            ev, f = _feed(rng, 300, n_distinct=200)
            ours.export_evicted(EvictedFlows(ev, **f))
            ref.export_evicted(jfetch.EvictedFlows(ev, **f))
            ours.flush()
            ref.flush()
        got = [pout.get(timeout=10) for _ in range(2)]
        want = [rout.get(timeout=10) for _ in range(2)]
    finally:
        ours.close()
        ref.close()
        psrv.stop(None)
        rsrv.stop(None)
    assert got == handed[:2]
    for data, jdata in zip(got, want):
        a, b = rd.decode_frame(data), rd.decode_frame(jdata)
        for k in ("version", "agent_id", "window", "dims", "window_seq"):
            assert getattr(a, k) == getattr(b, k), k
        assert a.agent_id == "edge-1"
        assert sorted(a.tables) == sorted(b.tables)
        for k, v in b.tables.items():
            if k in ("hist_rtt", "hist_dns"):  # one bucket apart at most
                assert a.tables[k].sum() == v.sum(), k
                continue
            np.testing.assert_array_equal(a.tables[k], v, err_msg=k)


def test_records_reach_the_reference_collector_from_the_port_exporter():
    """Map entries written in protobuf's deterministic order parse as
    the reference's (the reference's own bytes may order them otherwise,
    ROADMAP C5)."""
    from netobserv_tpu_torch.exporter.grpc_flow import GRPCFlowExporter
    srv, port, out = rgflow.start_flow_collector(0)
    try:
        exp = GRPCFlowExporter("127.0.0.1", port)
        recs = seeded_records(12, 30)
        exp.export_batch(recs)
        msg = out.get(timeout=10)
        exp.close()
    finally:
        srv.stop(None)
    assert isinstance(msg, flow_pb2.Records)
    assert msg.SerializeToString(deterministic=True) == \
        pconv.records_to_pb(recs).SerializeToString()


def _read_frames(sock, until, timeout: float = 5.0) -> list:
    """(type, flags, stream, payload) frames from a raw socket until
    `until(frames)` holds."""
    sock.settimeout(timeout)
    buf, frames = b"", []
    deadline = time.monotonic() + timeout
    while not until(frames) and time.monotonic() < deadline:
        chunk = sock.recv(65536)
        if not chunk:
            break
        buf += chunk
        while len(buf) >= 9 and len(buf) >= 9 + int.from_bytes(buf[:3],
                                                               "big"):
            n = int.from_bytes(buf[:3], "big")
            frames.append((buf[3], buf[4],
                           int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF,
                           buf[9:9 + n]))
            buf = buf[9 + n:]
    return frames


def test_server_takes_padding_priority_continuation_and_pings():
    """A hand-made client: unknown SETTINGS, a PING, a PRIORITY frame,
    HEADERS padded with a priority block and split by CONTINUATION, and
    DATA padded; the port's server acks the SETTINGS and the PING and
    answers the call."""
    srv, port, _ = _start("port", "push")
    sock = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        block = h2.encode_headers([
            (b":method", b"POST"), (b":scheme", b"http"),
            (b":path", PUSH.encode()), (b":authority", b"x"),
            (b"content-type", b"application/grpc"), (b"te", b"trailers")])
        pad = b"\x03"
        headers = pad + b"\x00\x00\x00\x00\x10" + block[:20] + b"\x00" * 3
        msg = b"\x00" + (5).to_bytes(4, "big") + b"hello"
        sock.sendall(
            h2.PREFACE
            + h2._frame(h2.SETTINGS, 0, 0, (0xFE03).to_bytes(2, "big")
                        + (1).to_bytes(4, "big"))
            + h2._frame(h2.PING, 0, 0, b"12345678")
            + h2._frame(h2.PRIORITY, 0, 1, b"\x00\x00\x00\x00\x10")
            + h2._frame(h2.HEADERS, h2.PADDED | h2.PRIORITY_FLAG, 1,
                        headers)
            + h2._frame(h2.CONTINUATION, h2.END_HEADERS, 1, block[20:])
            + h2._frame(h2.DATA, h2.PADDED | h2.END_STREAM, 1,
                        b"\x02" + msg + b"\x00\x00"))
        frames = _read_frames(sock, lambda fs: any(
            t == h2.HEADERS and f & h2.END_STREAM for t, f, _, _ in fs))
    finally:
        sock.close()
        srv.stop(None)
    assert (h2.SETTINGS, h2.ACK, 0, b"") in frames
    assert (h2.PING, h2.ACK, 0, b"12345678") in frames
    dec = h2.HpackDecoder()
    blocks = [dict(dec.decode(p)) for t, _, s, p in frames
              if t == h2.HEADERS and s == 1]
    assert blocks[0][b":status"] == b"200"
    assert blocks[-1][b"grpc-status"] == b"0"
    data = b"".join(p for t, _, s, p in frames if t == h2.DATA and s == 1)
    assert data[5:] == _echo_port(b"hello").SerializeToString()
