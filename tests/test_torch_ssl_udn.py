"""The port's SSL tracer and correlator and its UDN mapping
(netobserv_tpu_torch/flow/ssl_tracer.py, ssl_correlator.py, ifaces/udn.py,
the map tracer's and the agent's branches) against the JAX package's, a
twin of `tests/test_ssl_udn.py`.

- `decode_ssl_event` decodes seeded events, a wrong size and lengths out
  of range as the reference's; `SSLTracer` hands each event to its
  handler.
- `SSLCorrelator` over a scripted resolver credits and gives back the
  same counts as the reference's on one seeded event sequence, its key
  bound included; `procfs_resolver` finds this process's live TCP pair as
  the reference's does.
- `UdnMapper` reads a mapping file as the reference's, and the map
  tracer names each record's UDN and its dup list's alike.
- The agent: ENABLE_OPENSSL_TRACKING builds the `ssl-tracer` stage and a
  correlator on the record path, whose credits reach the exported record
  and the accounter, as in the reference's agent; on the columnar path
  it only warns; by default neither is built.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import threading
import time

import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.agent.agent import FlowsAgent as JAgent
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.flow import map_tracer as jmt
from netobserv_tpu.flow import ssl_correlator as jsc
from netobserv_tpu.flow import ssl_tracer as jst
from netobserv_tpu.ifaces import udn as judn
from netobserv_tpu.model import record as jrecord
from netobserv_tpu.utils import retrace as jretrace
from netobserv_tpu.utils import tracing as jtracing
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.agent import FlowsAgent
from netobserv_tpu_torch.datapath import fetcher as tfetch
from netobserv_tpu_torch.flow import map_tracer as tmt
from netobserv_tpu_torch.flow import ssl_correlator as tsc
from netobserv_tpu_torch.flow import ssl_tracer as tst
from netobserv_tpu_torch.ifaces import udn as tudn
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model import record as trecord
from netobserv_tpu_torch.model.flow import FlowKey, ip_to_16
from netobserv_tpu_torch.utils import retrace, tracing
from tests.test_model import make_event
from tests.test_pipeline import make_events


@pytest.fixture(autouse=True)
def _restore_hooks():
    yield
    for mod in (tracing, retrace, jtracing, jretrace):
        mod.set_metrics(None)


def make_ssl_event(data=b"GET / HTTP/1.1\r\n", pid=1234, tid=77,
                   direction=1, data_len=None):
    ev = np.zeros(1, dtype=binfmt.SSL_EVENT_DTYPE)
    ev[0]["timestamp_ns"] = 42
    ev[0]["pid_tgid"] = (pid << 32) | tid
    ev[0]["data_len"] = len(data) if data_len is None else data_len
    ev[0]["ssl_type"] = direction
    ev[0]["data"][:len(data)] = np.frombuffer(data, np.uint8)
    return ev.tobytes()


def _seeded_ssl_events(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(0, 300))
        out.append(make_ssl_event(
            rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
            pid=int(rng.integers(1, 1 << 22)),
            tid=int(rng.integers(0, 1 << 32)),
            direction=int(rng.integers(0, 2)),
            data_len=int(rng.choice([size, -5, binfmt.MAX_SSL_DATA + 9]))))
    return out


def _fields(ev):
    if ev is None:
        return None
    return (ev.timestamp_ns, ev.pid, ev.tid, ev.direction, ev.data)


def test_decode_matches_the_reference():
    raws = _seeded_ssl_events(231, 200) + [b"\x00" * 10, b""]
    got = [_fields(tst.decode_ssl_event(r)) for r in raws]
    assert got == [_fields(jst.decode_ssl_event(r)) for r in raws]
    assert got[-1] is None and got[-2] is None
    first = tst.decode_ssl_event(make_ssl_event())
    assert (first.pid, first.tid, first.direction,
            first.data) == (1234, 77, 1, b"GET / HTTP/1.1\r\n")


def test_tracer_drains_to_its_handler():
    q = queue.Queue()

    class F:
        def read_ssl(self, timeout_s):
            try:
                return q.get(timeout=timeout_s)
            except queue.Empty:
                return None

    got = []
    tracer = tst.SSLTracer(F(), got.append, poll_timeout_s=0.05)
    tracer.start()
    try:
        q.put(b"\x00" * 7)                     # wrong size: skipped
        q.put(make_ssl_event(b"hello"))
        deadline = time.monotonic() + 2
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [e.data for e in got] == [b"hello"]
    finally:
        tracer.stop()


def _resolver(seed: int):
    """pid -> a fixed list of (laddr, lport, raddr, rport) tuples."""
    rng = np.random.default_rng(seed)
    table = {}
    for pid in range(1, 40):
        tuples = []
        for _ in range(int(rng.integers(0, 4))):
            tuples.append((ip_to_16(f"10.{pid}.0.{int(rng.integers(1, 250))}"),
                           int(rng.integers(1024, 65535)),
                           ip_to_16(f"10.200.0.{int(rng.integers(1, 250))}"),
                           int(rng.choice([443, 8443]))))
        table[pid] = tuples
    return lambda pid: list(table.get(pid, []))


@pytest.mark.parametrize("max_keys", [8192, 16])
def test_correlator_credits_as_the_reference(max_keys):
    rng = np.random.default_rng(232)
    events = [make_ssl_event(b"x" * int(rng.integers(1, 64)),
                             pid=int(rng.integers(1, 45)))
              for _ in range(300)]
    ours = tsc.SSLCorrelator(resolver=_resolver(7), max_keys=max_keys)
    ref = jsc.SSLCorrelator(resolver=_resolver(7), max_keys=max_keys)
    credited = [(ours.observe(tst.decode_ssl_event(r)),
                 ref.observe(jst.decode_ssl_event(r))) for r in events]
    assert all(a == b for a, b in credited)
    assert ours.pending() == ref.pending()
    assert list(ours._counters) == list(ref._counters)
    for kb in list(ref._counters):
        key = FlowKey(kb[:16], kb[16:32], int.from_bytes(kb[32:34], "little"),
                      int.from_bytes(kb[34:36], "little"), kb[36])
        assert ours.take(key) == ref._counters.pop(kb)
    assert ours.pending() == 0


def test_procfs_resolver_finds_this_process_like_the_reference():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.socket()
    cli.connect(srv.getsockname())
    conn, _ = srv.accept()
    try:
        port = cli.getsockname()[1]
        got = sorted(tsc.procfs_resolver(os.getpid()))
        assert got == sorted(jsc.procfs_resolver(os.getpid()))
        assert (ip_to_16("127.0.0.1"), port, ip_to_16("127.0.0.1"),
                srv.getsockname()[1]) in got
        assert tsc.procfs_resolver(-1) == [] == jsc.procfs_resolver(-1)
    finally:
        conn.close()
        cli.close()
        srv.close()


def test_udn_file_mapping_as_the_reference(tmp_path, caplog):
    path = tmp_path / "udn.json"
    path.write_text(json.dumps({"eth0": "tenant-blue", "eth1": "tenant-red",
                                "7": 7}))
    for mod in (tudn, judn):
        mapper = mod.UdnMapper(mapping_file=str(path))
        assert [mapper.udn_for(n) for n in ("eth0", "eth1", "7", "x")] == [
            "tenant-blue", "tenant-red", "7", ""]
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with caplog.at_level(logging.WARNING):
        assert tudn.UdnMapper(mapping_file=str(bad)).udn_for("eth0") == ""
    assert "UDN mapping file unreadable" in caplog.text


def _udn_records(mt_mod, fetch_mod, udn_mod, path, events):
    out = queue.Queue()
    fake = fetch_mod.FakeFetcher()
    tracer = mt_mod.MapTracer(fake, out, active_timeout_s=0.1,
                              udn_mapper=udn_mod.UdnMapper(
                                  mapping_file=str(path)))
    fake.inject_events(events)
    tracer._evict_once()
    return [(r.interface, r.udn, r.dup_list) for r in out.get(timeout=3)]


def test_map_tracer_names_udns_as_the_reference(tmp_path):
    path = tmp_path / "udn.json"
    path.write_text(json.dumps({"1": "tenant-x", "3": "tenant-z"}))
    events = make_events(4)
    events["stats"]["if_index_first"] = [1, 2, 3, 1]
    got = _udn_records(tmt, tfetch, tudn, path, events)
    assert got == _udn_records(jmt, jfetch, judn, path, events)
    assert [u for _i, u, _d in got] == ["tenant-x", "", "tenant-z",
                                        "tenant-x"]


class _Collect:
    name = "collect"

    def __init__(self):
        self.batches = queue.Queue()

    def export_batch(self, records):
        self.batches.put(records)

    def close(self):
        pass


def _ssl_agent_run(pkg: str) -> tuple:
    """One agent of `pkg` on the record path with OpenSSL tracking: three
    SSL writes of pid 555, whose socket is the flow's, then the flow; the
    exported record's plaintext counters."""
    laddr, raddr = ip_to_16("10.9.0.1"), ip_to_16("10.9.0.2")
    env = {"EXPORT": "tpu-sketch", "CACHE_ACTIVE_TIMEOUT": "100ms",
           "ENABLE_OPENSSL_TRACKING": "true",
           "ENABLE_FLOWS_RINGBUF_FALLBACK": "true"}
    if pkg == "port":
        cfg, fake, cls = tcfg.load_config(env), tfetch.FakeFetcher(), FlowsAgent
    else:
        cfg, fake, cls = jcfg.load_config(env), jfetch.FakeFetcher(), JAgent
    cfg.validate()
    out = _Collect()
    agent = cls(cfg, fake, out)
    assert agent.accounter._ssl_correlator is agent.ssl_correlator
    stages = sorted(agent.supervisor.snapshot())
    agent.ssl_correlator._resolver = lambda pid: (
        [(laddr, 51000, raddr, 443)] if pid == 555 else [])
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    try:
        for size in (10, 20, 30):
            fake.inject_ssl(make_ssl_event(b"p" * size, pid=555))
        deadline = time.monotonic() + 3
        while (time.monotonic() < deadline
               and agent.ssl_correlator.pending() < 2):
            time.sleep(0.02)
        time.sleep(0.2)
        ev = np.zeros(1, dtype=binfmt.FLOW_EVENT_DTYPE)
        ev[0] = make_event(src="10.9.0.1", dst="10.9.0.2", sport=51000,
                           dport=443, proto=6, nbytes=5000, pkts=4)
        fake.inject_events(ev)
        got = None
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and got is None:
            try:
                batch = out.batches.get(timeout=0.5)
            except queue.Empty:
                continue
            for r in batch:
                if r.key.src_port == 51000:
                    got = (r.features.ssl_plaintext_events,
                           r.features.ssl_plaintext_bytes)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    return got, stages, agent.ssl_correlator.pending()


def test_the_agent_correlates_ssl_as_the_reference():
    got = _ssl_agent_run("port")
    assert got == _ssl_agent_run("reference")
    (events, nbytes), stages, pending = got
    assert (events, nbytes) == (3, 60)
    assert "ssl-tracer" in stages and pending == 1


@pytest.mark.parametrize("case", ["default", "columnar"])
def test_the_agent_builds_no_correlator_by_default_or_on_columnar(
        case, caplog):
    env = {"EXPORT": "tpu-sketch"}
    if case == "columnar":
        env["ENABLE_OPENSSL_TRACKING"] = "true"

    class Columnar(_Collect):
        supports_columnar = True

        def export_evicted(self, evicted):
            pass

    exp = Columnar() if case == "columnar" else _Collect()
    with caplog.at_level(logging.WARNING):
        agent = FlowsAgent(tcfg.load_config(env), tfetch.FakeFetcher(), exp)
        ref = JAgent(jcfg.load_config(env), jfetch.FakeFetcher(), exp)
    assert agent.ssl_correlator is None and ref.ssl_correlator is None
    assert (agent.ssl_tracer is None) == (ref.ssl_tracer is None)
    assert (agent.ssl_tracer is None) == (case == "default")
    warned = [r for r in caplog.records
              if "no-op on the columnar fast path" in r.getMessage()]
    assert len(warned) == (2 if case == "columnar" else 0)


def test_ssl_tracking_without_read_ssl_builds_nothing():
    class NoSsl:
        def lookup_and_delete(self):
            return tfetch.FakeFetcher().lookup_and_delete()

        def read_global_counters(self):
            return {}

        def close(self):
            pass

    agent = FlowsAgent(tcfg.load_config({"EXPORT": "tpu-sketch",
                                         "ENABLE_OPENSSL_TRACKING": "true"}),
                       NoSsl(), _Collect())
    assert agent.ssl_tracer is None and agent.ssl_correlator is None
    assert trecord.interface_namer() is trecord.default_namer
    assert jrecord.interface_namer() is jrecord.default_namer
