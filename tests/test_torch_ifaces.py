"""The port's interface discovery (netobserv_tpu_torch/ifaces/ and
agent/interfaces_listener.py) against the JAX package's, a twin of
`tests/test_ifaces.py`.

- The netlink link and address dumps equal the reference's on this host,
  and `/sys/class/net`'s names and indices; `links_in` and
  `subscribe_links_in` of a namespace that does not exist raise as the
  reference's do (no namespace is made).
- Both packages' `Poller` report the same interfaces on their first dump.
- A table of filter cases (allow and deny lists, regexes, CIDRs, the
  mutual exclusion) gives the same verdicts; `Registerer` names the same.
- The listener over a scripted informer: each package's listener, fed the
  same events through its own `FakeFetcher`, makes the same attach calls
  (the filter, a retry 300 ms times the attempt apart, a `DoNotRetryError`
  tried once, detach on removal) and the same `interface_events_total`
  samples at each METRICS_LEVEL; the namer is installed on start and
  `default_namer` restored on stop.
- The agent builds the listener when the fetcher asks or an informer is
  injected, registers it as `iface-listener`, starts it first and stops
  it first.
- Live (root, tc/ip, bpffs, CAP_BPF and TCX, as tests/test_torch_prog_load.py
  needs): the port's agent with DATAPATH=kernel, INTERFACES=lo and no
  EXCLUDE_INTERFACES (whose default is lo) reaches
  `MinimalKernelFetcher`, its listener attaches it to `lo` alone by TCX,
  and loopback UDP on ports of its own is evicted with the packets and
  bytes sent, into a sketch exporter on the CPU.
"""

from __future__ import annotations

import errno
import os
import queue
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.agent import interfaces_listener as jil
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu import ifaces as jif
from netobserv_tpu.ifaces import netlink as jnl
from netobserv_tpu.ifaces import netns as jns
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.model import record as jrecord
from netobserv_tpu.utils import retrace as jretrace
from netobserv_tpu.utils import tracing as jtracing
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch import ifaces as tif
from netobserv_tpu_torch.agent import interfaces_listener as til
from netobserv_tpu_torch.datapath import fetcher as tfetch
from netobserv_tpu_torch.datapath import kernel
from netobserv_tpu_torch.datapath import syscall_bpf as sb
from netobserv_tpu_torch.ifaces import netlink as tnl
from netobserv_tpu_torch.ifaces import netns as tns
from netobserv_tpu_torch.metrics import registry as treg
from netobserv_tpu_torch.model import record as trecord
from netobserv_tpu_torch.utils import retrace, tracing


@pytest.fixture(autouse=True)
def _restore_hooks():
    """Every process-global hook an agent or a listener sets goes back."""
    yield
    for rec in (trecord, jrecord):
        rec.set_interface_namer(rec.default_namer)
    for mod in (tracing, retrace, jtracing, jretrace):
        mod.set_metrics(None)


def _links(mod) -> list:
    return sorted((lk.index, lk.name, lk.mac, lk.up)
                  for lk in mod.dump_links())


def test_link_dumps_equal_the_reference_and_sysfs():
    got = _links(tnl)
    assert got == _links(jnl)
    sysfs = {}
    for name in os.listdir("/sys/class/net"):
        with open(f"/sys/class/net/{name}/ifindex") as fh:
            sysfs[name] = int(fh.read())
    assert {name: idx for idx, name, _m, _u in got} == sysfs
    assert any(name == "lo" and up for _i, name, _m, up in got)


def test_address_dumps_equal_the_reference():
    got = sorted(tnl.dump_addrs())
    assert got == sorted(jnl.dump_addrs())
    assert any(raw == b"\x7f\x00\x00\x01" for _idx, raw in got)


def test_a_missing_namespace_raises_as_the_reference(tmp_path):
    for fn in ("links_in", "subscribe_links_in"):
        errs = []
        for mod in (tns, jns):
            with pytest.raises(OSError) as exc:
                getattr(mod, fn)("absent", str(tmp_path))
            errs.append(exc.value.errno)
        assert errs == [errno.ENOENT, errno.ENOENT]
    assert tns.list_netns(str(tmp_path)) == jns.list_netns(str(tmp_path))


def _first_dump(mod) -> set:
    p = mod.Poller(period_s=60)
    events = p.subscribe()
    try:
        out = set()
        ev = events.get(timeout=3)
        while True:
            assert ev.type == mod.EventType.ADDED
            out.add((ev.interface.index, ev.interface.name, ev.interface.mac,
                     ev.interface.netns))
            try:
                ev = events.get(timeout=0.2)
            except queue.Empty:
                return out
    finally:
        p.stop()


def test_pollers_report_the_same_interfaces():
    got = _first_dump(tif)
    assert got == _first_dump(jif)
    assert any(name == "lo" for _i, name, _m, _n in got)


_MAC = b"\x02\x00\x00\x00\x00\x01"

#: (allowed, excluded, ip_cidrs, interface name, verdict); None = raises
FILTER_CASES = [
    (None, ["lo"], None, "lo", False),
    (None, ["lo"], None, "eth0", True),
    (["eth0", "/^veth/"], None, None, "eth0", True),
    (["eth0", "/^veth/"], None, None, "veth1234", True),
    (["eth0", "/^veth/"], None, None, "docker0", False),
    (["/eth/"], ["eth9"], None, "eth0", True),
    (["/eth/"], ["eth9"], None, "eth9", False),
    (None, ["/^br-/", "cni0"], None, "br-1f2e", False),
    (None, ["/^br-/", "cni0"], None, "ens5", True),
    ([" eth0 "], None, None, "eth0", True),
    (["/"], None, None, "/", True),
    (None, None, None, "anything", True),
    (["eth0"], None, ["10.0.0.0/8"], "eth0", None),
    (None, ["lo"], ["10.0.0.0/8"], "lo", None),
    (None, None, ["127.0.0.0/8"], "lo", True),
    (None, None, ["203.0.113.0/24"], "lo", False),
    (None, None, ["::1/128", "127.0.0.1/32"], "lo", True),
]


@pytest.mark.parametrize("allowed,excluded,cidrs,name,verdict",
                         FILTER_CASES)
def test_filter_verdicts_equal_the_reference(allowed, excluded, cidrs,
                                             name, verdict):
    idx = socket.if_nametoindex("lo") if name == "lo" else 1000
    out = []
    for mod in (tif, jif):
        try:
            f = mod.InterfaceFilter(allowed=allowed, excluded=excluded,
                                    ip_cidrs=cidrs)
        except ValueError:
            out.append(None)
            continue
        out.append(f.allowed(mod.Interface(idx, name, _MAC)))
    assert out == [verdict, verdict]


def test_registerer_names_as_the_reference():
    prefs = "0a:58=eth,02:42=docker,zz=bad,nopair"
    mac_a, mac_b = b"\x02\x00\x00\x00\x00\x0a", b"\x02\x00\x00\x00\x00\x0b"
    mac_k = b"\x0a\x58\x00\x00\x00\x01"
    events = [("ADDED", 4, "eth-a", mac_a), ("ADDED", 4, "eth-b", mac_b),
              ("ADDED", 4, "eth-b", mac_b), ("ADDED", 7, "veth7", mac_k),
              ("ADDED", 7, "eth7", mac_k), ("ADDED", 7, "zz7", mac_k),
              ("REMOVED", 4, "eth-a", mac_a)]
    asks = [(4, mac_a), (4, mac_b), (4, b"\x00" * 6), (9, b"\x00" * 6),
            (7, mac_k)]
    names = []
    for mod in (tif, jif):
        r = mod.Registerer(prefs)
        for kind, idx, name, mac in events:
            r.observe(mod.Event(getattr(mod.EventType, kind),
                                mod.Interface(idx, name, mac)))
        names.append([r.name_for(i, m) for i, m in asks])
    assert names[0] == names[1]
    assert names[0] == ["eth-a", "eth-b", "eth-b", "9", "eth7"]


class _Informer:
    """Scripted informer: hands the listener its events at subscribe."""

    def __init__(self, events):
        self.q = queue.Queue()
        self.events = events
        self.stopped = False

    def subscribe(self):
        for e in self.events:
            self.q.put(e)
        return self.q

    def stop(self):
        self.stopped = True


#: the scripted events: lo (excluded by default), eth0, eth5 (two
#: transient failures, then attached), eth6 (permanent failure), then
#: eth0 removed, and an interface in a namespace
SCRIPT = [("ADDED", 1, "lo", b"\x00" * 6, ""),
          ("ADDED", 2, "eth0", b"\x02" * 6, ""),
          ("ADDED", 5, "eth5", b"\x05" * 6, ""),
          ("ADDED", 6, "eth6", b"\x06" * 6, ""),
          ("REMOVED", 2, "eth0", b"\x02" * 6, ""),
          ("ADDED", 3, "veth3", b"\x03" * 6, "ns1")]


def _listener_run(pkg: str, level: str):
    if pkg == "port":
        cfgm, ifm, ilm, fm, regm, recm = tcfg, tif, til, tfetch, treg, trecord
    else:
        cfgm, ifm, ilm, fm, regm, recm = jcfg, jif, jil, jfetch, jreg, jrecord
    cfg = cfgm.load_config(environ={"EXPORT": "tpu-sketch",
                                    "TC_ATTACH_RETRIES": "3"})
    fake = fm.FakeFetcher()
    calls = []
    fails = {"eth5": 2}

    def attach(idx, name, direction, netns=""):
        calls.append(("attach", name, direction, netns))
        if name == "eth6":
            raise ilm.DoNotRetryError("unsupported kernel")
        if fails.get(name):
            fails[name] -= 1
            raise OSError("transient")
        fake.attached[(netns, idx) if netns else idx] = name

    def detach(idx, name, netns=""):
        calls.append(("detach", name, netns))
        fake.attached.pop((netns, idx) if netns else idx, None)

    fake.attach, fake.detach = attach, detach
    metrics = regm.Metrics(regm.MetricsSettings(level=level))
    informer = _Informer([ifm.Event(getattr(ifm.EventType, k),
                                    ifm.Interface(i, n, m, ns))
                          for k, i, n, m, ns in SCRIPT])
    listener = ilm.InterfaceListener(cfg, fake, metrics=metrics,
                                     informer=informer)
    listener.start()
    try:
        assert recm.interface_namer() == listener._registerer.name_for
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not (
                ("ns1", 3) in fake.attached and 5 in fake.attached
                and ("detach", "eth0", "") in calls
                and ("attach", "eth6", "both", "") in calls):
            time.sleep(0.02)
        time.sleep(0.1)
    finally:
        listener.stop()
    assert recm.interface_namer() is recm.default_namer
    assert informer.stopped
    samples = sorted(
        (tuple(sorted(s.labels.items())), s.value)
        for fam in metrics.interface_events_total.collect()
        for s in fam.samples if s.name.endswith("_total"))
    return calls, dict(fake.attached), sorted(listener.attached), samples


@pytest.mark.parametrize("level", ["info", "debug", "trace"])
def test_listener_attaches_retries_and_counts_as_the_reference(level):
    got = _listener_run("port", level)
    want = _listener_run("reference", level)
    assert got == want
    calls, attached, listened, samples = got
    assert attached == {5: "eth5", ("ns1", 3): "veth3"}
    assert [c for c in calls if c[1] == "eth5"] == [
        ("attach", "eth5", "both", "")] * 3
    assert [c for c in calls if c[1] == "eth6"] == [
        ("attach", "eth6", "both", "")]
    assert not [c for c in calls if c[1] == "lo"]
    assert listened == [("", 5), ("ns1", 3)]
    by_type = {}
    for labels, value in samples:
        kind = dict(labels)["type"]
        by_type[kind] = by_type.get(kind, 0) + value
    assert by_type == {"added": 5, "removed": 1, "attach": 3,
                       "attach_fail": 3}


def test_the_family_equals_the_reference():
    got = treg.Metrics().interface_events_total
    want = jreg.Metrics(jreg.MetricsSettings()).interface_events_total
    for attr in ("_name", "_documentation", "_labelnames", "_type"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_trace_series_expire_after_their_ttl():
    """At the trace level each interface's series goes trace_ttl_s after
    its last increment, as the reference's janitor removes it."""
    for regm in (treg, jreg):
        m = regm.Metrics(regm.MetricsSettings(level="trace",
                                              trace_ttl_s=0.2))
        m.count_interface_event("attach", ifname="eth0", ifindex=2,
                                mac="02:02:02:02:02:02", retries=1)

        def series():
            return [s for fam in m.interface_events_total.collect()
                    for s in fam.samples if s.name.endswith("_total")]

        assert len(series()) == 1
        deadline = time.monotonic() + 5
        while series() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert series() == []


class _Collect:
    name = "collect"

    def export_batch(self, records):
        pass

    def close(self):
        pass


class _Discovering(tfetch.FakeFetcher):
    needs_iface_discovery = True


@pytest.mark.parametrize("case", ["fetcher_asks", "informer", "neither"])
def test_the_agent_builds_and_orders_the_listener(case):
    from netobserv_tpu.agent.agent import FlowsAgent as JAgent
    from netobserv_tpu_torch.agent import FlowsAgent

    env = {"EXPORT": "tpu-sketch", "INTERFACES": "eth5"}
    fetcher = _Discovering() if case == "fetcher_asks" else \
        tfetch.FakeFetcher()
    informer = _Informer([tif.Event(tif.EventType.ADDED,
                                    tif.Interface(5, "eth5", b"\x05" * 6))])
    agent = FlowsAgent(tcfg.load_config(env), fetcher, _Collect(),
                       iface_informer=(informer if case != "neither"
                                       else None))
    jfetcher = jfetch.FakeFetcher()
    if case == "fetcher_asks":
        jfetcher.needs_iface_discovery = True
    jagent = JAgent(jcfg.load_config(env), jfetcher, _Collect(),
                    iface_informer=(_Informer([]) if case != "neither"
                                    else None))
    assert set(agent.supervisor.snapshot()) == set(
        jagent.supervisor.snapshot())
    if case == "neither":
        assert agent.iface_listener is None
        return
    if case == "fetcher_asks":
        agent.iface_listener._informer = informer
    assert "iface-listener" in agent.supervisor.snapshot()
    order = []
    for name in ("iface_listener", "terminal", "map_tracer"):
        stage = getattr(agent, name)
        for verb in ("start", "stop"):
            real = getattr(stage, verb)

            def wrapped(*a, _real=real, _tag=(verb, name), **kw):
                order.append(_tag)
                return _real(*a, **kw)

            setattr(stage, verb, wrapped)
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and 5 not in fetcher.attached:
            time.sleep(0.02)
        assert fetcher.attached == {5: "eth5"}
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    starts = [n for v, n in order if v == "start"]
    stops = [n for v, n in order if v == "stop"]
    assert starts[0] == "iface_listener" and stops[0] == "iface_listener"
    assert trecord.interface_namer() is trecord.default_namer


# ------------------------------------------------------------------- live

live = pytest.mark.skipif(
    not (os.geteuid() == 0 and shutil.which("tc") and shutil.which("ip")
         and os.path.ismount("/sys/fs/bpf") and sb.bpf_available()),
    reason="needs root, tc/ip, bpffs, and CAP_BPF")


class _Tap:
    """A columnar exporter that keeps each eviction's events and hands
    it on to the sketch exporter."""

    supports_columnar = True
    name = "tap"

    def __init__(self, inner):
        self.inner = inner
        self.events = []

    def export_evicted(self, evicted):
        self.events.append(np.array(evicted.events, copy=True))
        self.inner.export_evicted(evicted)

    def export_batch(self, records):
        self.inner.export_batch(records)

    def close(self):
        self.inner.close()


@live
def test_the_agent_attaches_the_minimal_datapath_to_lo(monkeypatch):
    from netobserv_tpu_torch.agent import FlowsAgent, build_fetcher
    from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher
    from netobserv_tpu_torch.exporter import build_exporter

    if not kernel.supports_tcx():
        pytest.skip("needs TCX (kernel 6.6)")
    monkeypatch.setenv("DATAPATH", "kernel")
    cfg = tcfg.load_config(environ={
        "EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
        "SKETCH_BATCH_SIZE": "256", "SKETCH_CM_WIDTH": "4096",
        "SKETCH_TOPK": "256", "SKETCH_HLL_PRECISION": "10",
        "SKETCH_SUPERBATCH": "1", "SKETCH_WINDOW": "1h",
        "SKETCH_RESIDENT_SLOTS": "4096", "SKETCH_REPORT_SINK": "stdout",
        "CACHE_ACTIVE_TIMEOUT": "200ms", "CACHE_MAX_FLOWS": "4096",
        "INTERFACES": "lo", "EXCLUDE_INTERFACES": "",
        "LISTEN_INTERFACES": "poll",
        "TC_ATTACH_MODE": "tcx", "AGENT_IP": "127.0.0.1"})
    cfg.validate()
    fetcher = build_fetcher(cfg)
    assert isinstance(fetcher, MinimalKernelFetcher)
    tap = _Tap(build_exporter(cfg))
    agent = FlowsAgent(cfg, fetcher, tap)
    lo = socket.if_nametoindex("lo")
    sport, ports, per_port, size = 45_321, range(47_400, 47_420), 3, 96
    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and ("", lo) not in \
                agent.iface_listener.attached:
            time.sleep(0.02)
        assert agent.iface_listener.attached == {("", lo)}
        assert set(fetcher._attached) == {("", lo)}
        assert {a.kind for a in fetcher._attached[("", lo)][1].values()} \
            == {"tcx"}
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", sport))
        try:
            for port in ports:
                for _ in range(per_port):
                    s.sendto(b"u" * size, ("127.0.0.1", port))
        finally:
            s.close()
        time.sleep(0.6)
    finally:
        stop.set()
        t.join(timeout=15)
    assert not t.is_alive()
    flows = {}
    for ev in tap.events:
        for row in ev:
            k = row["key"]
            if int(k["proto"]) == 17 and int(k["src_port"]) == sport:
                p, b = flows.get(int(k["dst_port"]), (0, 0))
                flows[int(k["dst_port"])] = (
                    p + int(row["stats"]["packets"]),
                    b + int(row["stats"]["bytes"]))
    # both hooks of lo see each datagram once (the interface that first
    # saw the flow), 8 UDP + 20 IP + 14 Ethernet bytes a datagram
    assert flows == {p: (2 * per_port, 2 * per_port * (size + 42))
                     for p in ports}
    assert fetcher._attached == {}
    assert not [p for p in os.listdir("/sys/fs/bpf") if p.startswith(
        os.path.basename(MinimalKernelFetcher._PIN_PREFIX)
        + f"{os.getpid()}_")]
