"""The port's agent entry (`python -m netobserv_tpu_torch`,
netobserv_tpu_torch/__main__.py; agent/agent.py `FlowsAgent.from_config`,
`build_fetcher`) on the CPU.

- The CLI with SKETCH_DEVICES=cpu replays a pcap of a spoofed SYN flood
  (DATAPATH=pcap:...) and the flood surfaces in a window report's
  SynFloodSuspectBuckets with its victim named, as
  tests/test_e2e_replay.py:141-215 requires of the JAX package's binary;
  `/healthz` answers Started meanwhile, and SIGTERM ends it with exit 0
  after it published its last window, whose records sum with the others
  to the pcap's packets.
- An unported EXPORT exits 2 (a child process); an unported DATAPATH,
  FEDERATION_MODE=aggregator and ENABLE_PCA exit 2 from `main()` in
  process, each naming its ROADMAP item.
- In process, both packages' `FlowsAgent.from_config` over the same pcap
  (one replay fetcher each, one clock) are driven eviction by eviction
  through their map tracer, limiter and terminal, rolled after the same
  evictions and closed: their window reports' Records, Bytes and suspect
  lists are equal, and their pre-roll `state_tables` equal bit for bit
  (the histograms within the edge-move bound of
  tests/test_torch_staging.py, ROADMAP C5).
"""

import json
import logging
import os
import re
import selectors
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu import config as jcfg
from netobserv_tpu.agent.agent import FlowsAgent as JAgent
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch import __main__ as cli
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.agent.agent import FlowsAgent
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.scenarios import synth
from netobserv_tpu_torch.sketch import state as ts
from tests.test_torch_agent import _pin_clocks, _scenario_pcap
from tests.test_torch_staging import _Samples

ROOT = Path(__file__).resolve().parents[1]


def flood_pcap(path) -> "synth.PcapBuilder":
    """300 spoofed sources SYN one victim, never answered
    (tests/test_e2e_replay.py's flood, built with the port's synth)."""
    b = synth.PcapBuilder()
    for i in range(300):
        b.add(i * 1000, f"172.16.{i % 250}.{i // 250 + 1}", "10.0.0.80", 6,
              synth.tcp(1024 + i, 80, 0x02), sport=1024 + i, dport=80)
    b.write(str(path))
    return b


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(**env) -> dict:
    out = {k: v for k, v in os.environ.items()
           if not k.startswith(("SKETCH_", "DATAPATH", "EXPORT"))}
    out.update(PYTHONPATH=str(ROOT), AGENT_IP="127.0.0.1",
               JAX_PLATFORMS="cpu", **env)
    return out


def _get(url: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_cli_replays_a_syn_flood_on_the_cpu_and_stops_on_sigterm(tmp_path):
    pcap = tmp_path / "flood.pcap"
    flood_pcap(pcap)
    port = _free_port()
    env = _child_env(SKETCH_DEVICES="cpu", DATAPATH=f"pcap:{pcap}",
                     EXPORT="tpu-sketch", CACHE_ACTIVE_TIMEOUT="100ms",
                     SKETCH_BATCH_SIZE="512", SKETCH_WINDOW="3s",
                     SKETCH_SYNFLOOD_MIN="128", METRICS_ENABLE="true",
                     METRICS_SERVER_ADDRESS="127.0.0.1",
                     METRICS_SERVER_PORT=str(port))
    proc = subprocess.Popen([sys.executable, "-m", "netobserv_tpu_torch"],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        os.set_blocking(proc.stdout.fileno(), False)
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        buf, reports, health = b"", [], None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and proc.poll() is None:
            if sel.select(timeout=0.2):
                buf += proc.stdout.read() or b""
            *lines, buf = buf.split(b"\n")
            reports += [json.loads(x) for x in lines if x.strip()]
            if health is None:
                try:
                    health = _get(f"http://127.0.0.1:{port}/healthz")
                except OSError:
                    pass
            if any(r["SynFloodSuspectBuckets"] for r in reports) \
                    and health is not None:
                break
        sel.close()
        assert health is not None and health[0] == 200, health
        assert health[1]["status"] == "Started"
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=15)
        stop_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err.decode()[-2000:]
    reports += [json.loads(x) for x in (buf + out).split(b"\n") if x.strip()]
    suspects = next(r["SynFloodSuspectBuckets"] for r in reports
                    if r["SynFloodSuspectBuckets"])
    assert suspects[0]["syn"] >= 250 and suspects[0]["synack"] == 0
    assert "10.0.0.80" in suspects[0]["probable_victims"]
    # every packet's flow in some window, the last one published at exit
    assert sum(r["Records"] for r in reports) == 300.0
    assert [r["Window"] for r in reports] == list(range(len(reports)))
    assert stop_s < 15
    assert b"agent stopped" in err


def test_cli_exits_2_for_an_unported_exporter():
    proc = subprocess.run(
        [sys.executable, "-m", "netobserv_tpu_torch"], cwd=str(ROOT),
        env=_child_env(EXPORT="kafka", KAFKA_BROKERS="127.0.0.1:1",
                       DATAPATH="synthetic", SKETCH_DEVICES="cpu"),
        capture_output=True, timeout=60)
    assert proc.returncode == 2
    assert b"A8" in proc.stderr and proc.stdout == b""


@pytest.mark.parametrize("env,item", [
    ({"DATAPATH": None}, "DATAPATH='auto'.*A8"),
    ({"DATAPATH": "kernel"}, "A8"), ({"DATAPATH": "grpc:9000"}, "A8"),
    ({"FEDERATION_MODE": "aggregator"}, "aggregator.*A8"),
    ({"ENABLE_PCA": "true"}, "ENABLE_PCA.*A8"),
    ({"ENABLE_OPENSSL_TRACKING": "true"}, "ENABLE_OPENSSL_TRACKING.*A8"),
    ({"SKETCH_TENANTS": "2"}, "A5")],
    ids=["unset", "kernel", "grpc", "aggregator", "pca", "openssl",
         "tenants"])
def test_main_exits_2_for_unported_settings(env, item, monkeypatch, caplog):
    base = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
            "DATAPATH": "synthetic", "AGENT_IP": "127.0.0.1",
            "SKETCH_CM_WIDTH": "1024", "SKETCH_TOPK": "64"}
    for k, v in {**base, **env}.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    with caplog.at_level(logging.ERROR, logger="netobserv_tpu_torch"):
        assert cli.main() == 2
    assert caplog.records
    assert re.search(item, caplog.records[-1].getMessage())


#: the in-process comparison: a small geometry, one ladder entry, 100 ms
#: of capture an eviction
AGENT_ENV = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
             "SKETCH_BATCH_SIZE": "256", "SKETCH_CM_WIDTH": "4096",
             "SKETCH_TOPK": "256", "SKETCH_HLL_PRECISION": "10",
             "SKETCH_SUPERBATCH": "1", "SKETCH_WINDOW": "1h",
             "SKETCH_RESIDENT_SLOTS": "4096", "CACHE_ACTIVE_TIMEOUT": "100ms",
             "SKETCH_SYNFLOOD_MIN": "64", "SKETCH_SCAN_FANOUT": "64",
             "AGENT_IP": "127.0.0.1", "BUFFERS_LENGTH": "64"}
#: evictions after which both agents roll (the last window closes at
#: shutdown)
ROLL_AFTER = (3, 8)
SIGNALS = ("SynFloodSuspectBuckets", "PortScanSuspectBuckets",
           "DdosSuspectBuckets", "DropAnomalyBuckets",
           "AsymmetricConversationBuckets")


def _drive(agent, n_evictions: int, sink_attr: str, tables_of) -> tuple:
    """Drive `agent` eviction by eviction (its map tracer's drain, its
    limiter's and terminal's threads), rolling after each of ROLL_AFTER;
    (reports, pre-roll tables, evicted rows). The exporter's sink is its
    attribute `sink_attr`."""
    reports = []
    setattr(agent.exporter, sink_attr, reports.append)
    agent.limiter.start()
    agent.terminal.start()
    tables, rows = [], 0
    try:
        for i in range(1, n_evictions + 1):
            before = agent.fetcher._idx
            agent.map_tracer._evict_once()
            assert agent.fetcher._idx == before + 1
            rows += len(agent.fetcher._windows[before][0])
            deadline = time.monotonic() + 30
            while _exported(agent) < rows and time.monotonic() < deadline:
                time.sleep(0.005)
            assert _exported(agent) == rows
            if i in ROLL_AFTER or i == n_evictions:
                tables.append(tables_of(agent.exporter))
                if i != n_evictions:
                    agent.exporter.flush()
    finally:
        agent.shutdown()
    return reports, tables, rows


def _exported(agent) -> float:
    return agent.metrics.exported_flows_total.labels(
        "tpu-sketch")._value.get()


def _port_tables(exp):
    with exp._lock:
        exp._drain_pending()
        return ts.state_tables(exp.state)


def _ref_tables(exp):
    with exp._lock:
        exp._drain_pending_locked()
        return exp._state


def test_both_agents_agree_over_one_pcap(tmp_path, monkeypatch):
    b = _scenario_pcap(synth, tmp_path / "s.pcap")
    monkeypatch.setenv("DATAPATH", f"pcap:{tmp_path / 's.pcap'}")
    _pin_clocks(monkeypatch)
    ours = FlowsAgent.from_config(tcfg.load_config(AGENT_ENV))
    _pin_clocks(monkeypatch)
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        ref = JAgent.from_config(jcfg.load_config(AGENT_ENV))
    finally:
        jax.devices = devices
    n = ours.fetcher.n_windows
    assert n == ref.fetcher.n_windows and n > max(ROLL_AFTER)
    got = _drive(ours, n, "sink", _port_tables)
    want = _drive(ref, n, "_sink", _ref_tables)
    (reps, tabs, rows), (jreps, jtabs, jrows) = got, want
    assert rows == jrows == sum(len(w[0]) for w in ours.fetcher._windows)
    assert len(reps) == len(jreps) == len(ROLL_AFTER) + 1
    for r, j in zip(reps, jreps):
        assert (r["Window"], r["Records"], r["Bytes"]) == (
            j["Window"], j["Records"], j["Bytes"])
        for sig in SIGNALS:
            assert r[sig] == j[sig], sig
    assert sum(r["Records"] for r in reps) == rows
    assert sum(r["Bytes"] for r in reps) == float(sum(b.flow_bytes.values()))
    assert any(r["SynFloodSuspectBuckets"] for r in reps)
    assert any(r["PortScanSuspectBuckets"] for r in reps)
    samples = _Samples()
    for events, dns, _quic in ours.fetcher._windows:
        n_ev = len(events)
        samples.add({"dns": (dns if dns is not None
                             else np.zeros(n_ev, binfmt.DNS_REC_DTYPE)),
                     "extra": np.zeros(n_ev, binfmt.EXTRA_REC_DTYPE)})
    for i, (t, j) in enumerate(zip(tabs, jtabs)):
        _assert_tables_from(t, j, f"window {i}", samples)


def _assert_tables_from(got: dict, jstate, where, samples):
    """`_assert_tables` on a port table dict and a JAX state."""
    want = {k: np.asarray(v) for k, v in js.state_tables(jstate).items()}
    assert got.keys() == want.keys()
    for k in want:
        if k in samples.us:
            assert got[k].sum() == want[k].sum(), (k, where)
            moved = np.abs(np.cumsum(got[k].astype(np.float64) - want[k]))
            assert moved.sum() <= samples.edge_prone(k, len(want[k])), (
                k, where)
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")
