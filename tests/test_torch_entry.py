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
- An EXPORT outside the reference's list exits 2, and EXPORT=direct-flp
  (ported since) runs its embedded pipeline and exits 0 on SIGTERM (child
  processes); ENABLE_PCA without a target exits 2 from `main()` in
  process with the reference's message. DATAPATH=grpc:0 (ported since)
  starts a collector-tier worker on a `GrpcIngestFetcher`, and
  FEDERATION_MODE=aggregator (ported since) starts the aggregator
  process with METRICS_ENABLE; each exits 0 on SIGTERM. With both kernel
  rungs forced to fail, DATAPATH=kernel exits 2 with the last rung's
  error, and no DATAPATH falls back to synthetic replay with the
  reference's warning: `main()` starts, and exits 0 on SIGTERM.
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


def run_tenant_child(pcap, tenants: int, until_reports: int,
                     timeout_s: float = 60.0, **extra_env) -> tuple:
    """`python -m netobserv_tpu_torch` on `pcap` with SKETCH_TENANTS (and
    `extra_env`) on the CPU, stopped by SIGTERM once it printed
    `until_reports` reports: (exit code, every report printed, standard
    error)."""
    env = _child_env(SKETCH_DEVICES="cpu", DATAPATH=f"pcap:{pcap}",
                     EXPORT="tpu-sketch", CACHE_ACTIVE_TIMEOUT="100ms",
                     SKETCH_BATCH_SIZE="128", SKETCH_WINDOW="2s",
                     SKETCH_TENANTS=str(tenants), **extra_env)
    proc = subprocess.Popen([sys.executable, "-m", "netobserv_tpu_torch"],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        os.set_blocking(proc.stdout.fileno(), False)
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        buf, reports = b"", []
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and proc.poll() is None \
                and len(reports) < until_reports:
            if sel.select(timeout=0.2):
                buf += proc.stdout.read() or b""
            *lines, buf = buf.split(b"\n")
            reports += [json.loads(x) for x in lines if x.strip()]
        sel.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    reports += [json.loads(x) for x in (buf + out).split(b"\n") if x.strip()]
    return proc.returncode, reports, err



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
            if health is None or health[1].get("status") != "Started":
                # the metrics server answers from before `run` sets
                # Started: ask again until it says so (or the deadline)
                try:
                    health = _get(f"http://127.0.0.1:{port}/healthz")
                except OSError:
                    pass
            if any(r["SynFloodSuspectBuckets"] for r in reports) \
                    and health is not None \
                    and health[1].get("status") == "Started":
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


#: FLP_CONFIG of the direct-flp child: a filter, a network transform and
#: the stdout writer
FLP_CHILD_CFG = """
pipeline: [{name: f}, {name: n, follows: f}, {name: w, follows: n}]
parameters:
  - name: f
    transform:
      type: filter
      filter:
        rules: [{type: remove_field, removeField: SrcMac}]
  - name: n
    transform:
      type: network
      network:
        rules:
          - type: add_subnet
            add_subnet: {input: SrcAddr, output: SrcSubnet, parameters: /16}
  - name: w
    write: {type: stdout}
"""


def test_cli_exits_2_for_an_unported_exporter():
    """Every EXPORT of the reference is ported: one outside its list exits
    2 naming the list, and EXPORT=direct-flp (which exited 2 naming
    ROADMAP A8.7b before it was ported) runs its pipeline over synthetic
    replay, writing FLP entries to stdout, and exits 0 on SIGTERM."""
    proc = subprocess.run(
        [sys.executable, "-m", "netobserv_tpu_torch"], cwd=str(ROOT),
        env=_child_env(EXPORT="no-such-export", DATAPATH="synthetic",
                       SKETCH_DEVICES="cpu"),
        capture_output=True, timeout=60)
    assert proc.returncode == 2
    assert b"direct-flp" in proc.stderr and proc.stdout == b""
    child = subprocess.Popen(
        [sys.executable, "-m", "netobserv_tpu_torch"], cwd=str(ROOT),
        env=_child_env(EXPORT="direct-flp", DATAPATH="synthetic",
                       FLP_CONFIG=FLP_CHILD_CFG,
                       CACHE_ACTIVE_TIMEOUT="200ms"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        first = child.stdout.readline()     # blocks until an eviction
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err.decode()[-2000:]
    entries = [json.loads(x) for x in (first + out).splitlines()]
    assert len(entries) >= 100              # one synthetic eviction at least
    assert all("SrcMac" not in e and e["SrcSubnet"].endswith("/16")
               for e in entries)
    assert b"agent stopped" in err


def _forced_rungs(monkeypatch):
    """Both kernel rungs of both packages' ladders fail, so no test agent
    loads a datapath or attaches to an interface."""
    from netobserv_tpu.datapath import loader as jloader
    from netobserv_tpu_torch.datapath import loader as tloader

    def refuse(cls, cfg):
        raise RuntimeError(f"{cls.__name__} refused by the test")

    for mod in (tloader, jloader):
        for name in ("KernelFetcher", "MinimalKernelFetcher"):
            monkeypatch.setattr(getattr(mod, name), "load",
                                classmethod(refuse))


def _main_until_started(monkeypatch) -> tuple[int, object]:
    """`main()` in this process, SIGTERM sent to it once its agent (a
    `FlowsAgent` or the aggregator process) is Started; the exit code and
    the agent. The signal handlers it installs are put back."""
    import threading

    from netobserv_tpu_torch.agent import agent as tagent
    from netobserv_tpu_torch.federation import service as tservice

    made = []
    real = tagent.FlowsAgent.from_config.__func__

    def from_config(cls, cfg):
        made.append(real(cls, cfg))
        return made[-1]

    monkeypatch.setattr(tagent.FlowsAgent, "from_config",
                        classmethod(from_config))

    class Service(tservice.FederationAggregatorService):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tservice, "FederationAggregatorService", Service)

    def terminate_once_started():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if made and made[0].health_snapshot()["status"] == "Started":
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    saved = {sig: signal.getsignal(sig)
             for sig in (signal.SIGTERM, signal.SIGINT)}
    t = threading.Thread(target=terminate_once_started, daemon=True)
    t.start()
    try:
        rc = cli.main()
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    t.join(timeout=5)
    return rc, (made[0] if made else None)


@pytest.mark.parametrize("env,item", [
    ({"DATAPATH": None}, "start"),
    ({"DATAPATH": "kernel"}, "MinimalKernelFetcher refused"),
    ({"DATAPATH": "grpc:0"}, "worker"),
    ({"FEDERATION_MODE": "aggregator", "FEDERATION_LISTEN_PORT": "0",
      "FEDERATION_QUERY_PORT": "0", "METRICS_ENABLE": "true",
      "METRICS_SERVER_ADDRESS": "127.0.0.1", "METRICS_SERVER_PORT": "0"},
     "aggregator"),
    ({"ENABLE_PCA": "true", "TARGET_HOST": None, "TARGET_PORT": None,
      "PCA_SERVER_PORT": None},
     r"ENABLE_PCA: TARGET_HOST and TARGET_PORT \(or PCA_SERVER_PORT\) "
     "are required"),
    ({"ENABLE_OPENSSL_TRACKING": "true"}, "start"),
    ({"SKETCH_TENANTS": "2"}, None)],
    ids=["unset", "kernel", "grpc", "aggregator", "pca", "openssl",
         "tenants"])
def test_main_exits_2_for_unported_settings(env, item, monkeypatch, caplog,
                                            tmp_path):
    """ENABLE_PCA (ported since) without TARGET_HOST and TARGET_PORT
    exits 2 with the reference's message. DATAPATH=grpc:0 and
    FEDERATION_MODE=aggregator (exits 2 naming ROADMAP A8.9 before they
    were ported) start: a worker whose fetcher is a `GrpcIngestFetcher`
    on a bound port, and the aggregator process with its collector, query
    and metrics servers (METRICS_ENABLE, which needs no `query_routes`);
    each exits 0 on SIGTERM, Stopped. With
    the kernel rungs forced to fail, DATAPATH=kernel exits 2 with the last
    rung's error, and no DATAPATH falls back to synthetic replay, as the
    reference's ladder does: it starts and exits 0 on SIGTERM, as does
    ENABLE_OPENSSL_TRACKING (ported since, over synthetic replay, which
    reads no SSL events). The tenants case (item None, ported since)
    starts a child with SKETCH_TENANTS=2, which publishes its first
    window's two reports and stops with exit 0 on SIGTERM."""
    if item is None:
        flood_pcap(tmp_path / "flood.pcap")
        rc, reports, err = run_tenant_child(tmp_path / "flood.pcap",
                                            int(env["SKETCH_TENANTS"]), 2)
        assert rc == 0, err.decode()[-2000:]
        assert [r["Tenant"] for r in reports[:2]] == [0, 1]
        return
    _forced_rungs(monkeypatch)
    base = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
            "DATAPATH": "synthetic", "AGENT_IP": "127.0.0.1",
            "SKETCH_CM_WIDTH": "1024", "SKETCH_TOPK": "64",
            "SKETCH_BATCH_SIZE": "256", "SKETCH_RESIDENT_SLOTS": "1024",
            "SKETCH_REPORT_SINK": "stdout"}
    for k, v in {**base, **env}.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    if item in ("worker", "aggregator"):
        rc, agent = _main_until_started(monkeypatch)
        assert rc == 0
        assert agent.health_snapshot()["status"] == "Stopped"
        if item == "worker":
            from netobserv_tpu_torch.datapath.grpc_ingest import (
                GrpcIngestFetcher,
            )
            assert isinstance(agent.fetcher, GrpcIngestFetcher)
            assert agent.fetcher.port > 0
        else:
            assert agent.grpc_port > 0 and agent.query_port > 0
        return
    if item == "start":
        from netobserv_tpu_torch.datapath.replay import SyntheticFetcher

        with caplog.at_level(logging.INFO, logger="netobserv_tpu_torch"):
            rc, agent = _main_until_started(monkeypatch)
        assert rc == 0
        assert isinstance(agent.fetcher, SyntheticFetcher)
        assert agent.status.value == "Stopped"
        warned = [r.getMessage() for r in caplog.records
                  if "using synthetic replay" in r.getMessage()]
        assert len(warned) == (1 if env.get("DATAPATH", "") is None else 0)
        if warned:
            assert "MinimalKernelFetcher refused" in warned[0]
        return
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
