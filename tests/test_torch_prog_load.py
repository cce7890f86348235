"""The port's bpf(2) program layer on the live kernel (netobserv_tpu_torch/
datapath/syscall_bpf.py, tc_attach.py, loader.py `MinimalKernelFetcher`):
a twin of the reference's `tests/test_prog_load.py` over the port's
modules, and the hand-assembled datapath through the kernel verifier.

- The verifier takes the packet-counter program and rejects a bad one
  with its log.
- A counter program attached by TCX (`tc_attach.attach_mode`, mode tcx)
  to the loopback device's egress counts real datagrams sent to
  127.0.0.1, and detaches when its link closes. Where the reference
  builds a veth pair in a namespace and attaches through tc's clsact
  qdisc, the twin creates no device and changes no qdisc: a TCX link is
  the process's own and goes with its fd. It therefore also needs TCX
  (kernel 6.6).
- Batched eviction (BPF_MAP_LOOKUP_AND_DELETE_BATCH) against the live
  kernel and its fallbacks, the reference's `TestDrainBatched` on the
  port's `BpfMap`, with every drained pair also held against the
  reference's `BpfMap` over the same content.
- `MinimalKernelFetcher` provisions through the verifier with no feature
  and with the DNS, RTT handshake, filter, QUIC, TLS, sampling and
  ring-buffer features (no tracepoint, uprobe or attach), pins its two
  programs under its own prefix, programs its filter tries, and leaves
  no pin and no fd when closed; a provisioning that fails closes what it
  made.
- The live capture on the loopback device (slow, as the reference's
  `tests/test_asm_flowpath.py`): `MinimalKernelFetcher` attached by TCX
  on both directions, UDP datagrams to 127.0.0.1 over distinct ports,
  each flow's packets and bytes as the reference's
  `test_kernel_flow_capture_and_eviction` counts them, once a pass of a
  hook on the one interface that first saw it.

Skipped without root, tc/ip, bpffs and CAP_BPF, the reference's
condition (`tests/test_prog_load.py:25-28`).
"""

from __future__ import annotations

import errno
import glob
import os
import shutil
import socket
import struct
import time

import pytest

from netobserv_tpu.datapath import syscall_bpf as jsb
from netobserv_tpu_torch.datapath import kernel
from netobserv_tpu_torch.datapath import syscall_bpf as sb
from netobserv_tpu_torch.datapath import tc_attach

BPFFS = "/sys/fs/bpf"

pytestmark = pytest.mark.skipif(
    not (os.geteuid() == 0 and shutil.which("tc") and shutil.which("ip")
         and os.path.ismount(BPFFS) and sb.bpf_available()),
    reason="needs root, tc/ip, bpffs, and CAP_BPF")

tcx = pytest.mark.skipif(not kernel.supports_tcx(),
                         reason="needs TCX (kernel 6.6)")


def _lo_index() -> int:
    return socket.if_nametoindex("lo")


def test_verifier_accepts_counter_program():
    counter = sb.BpfMap.create(2, 4, 8, 1, b"cnt")
    try:
        fd = sb.prog_load(sb.packet_counter_prog(counter.fd))
        assert fd > 0
        os.close(fd)
    finally:
        counter.close()


def test_verifier_rejects_bad_program():
    bad = b"".join([sb.insn(0x79, 0, 1, 0, 0), sb.insn(0x95)])
    with pytest.raises(OSError) as ours:
        sb.prog_load(bad)
    assert "verifier log" in str(ours.value)
    with pytest.raises(OSError) as ref:
        jsb.prog_load(bad)
    assert ours.value.errno == ref.value.errno


@tcx
def test_count_real_packets_over_loopback_by_tcx():
    counter = sb.BpfMap.create(2, 4, 8, 1, b"cnt")
    prog_fd = sb.prog_load(sb.packet_counter_prog(counter.fd))
    pin = os.path.join(BPFFS, f"nv_torch_counter_{os.getpid()}")
    try:
        sb.obj_pin(prog_fd, pin)
        att = tc_attach.attach_mode(prog_fd, pin, "lo", _lo_index(),
                                    "egress", mode="tcx")
        assert att.kind == "tcx" and att.link_fd >= 0
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for _ in range(5):
                s.sendto(b"x" * 64, ("127.0.0.1", 9))
            s.close()
            time.sleep(0.1)
            count = struct.unpack(
                "<Q", counter.lookup(struct.pack("<I", 0))[:8])[0]
            assert count >= 5, f"program counted {count} packets"
            # the running link is found by its program, as EEXIST adoption
            # does
            fd = sb.find_tcx_link(_lo_index(), "egress",
                                  prog_id=sb.prog_id_of(prog_fd))
            assert fd is not None
            os.close(fd)
        finally:
            att.detach()
        before = struct.unpack(
            "<Q", counter.lookup(struct.pack("<I", 0))[:8])[0]
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"y", ("127.0.0.1", 9))
        s.close()
        time.sleep(0.05)
        after = struct.unpack(
            "<Q", counter.lookup(struct.pack("<I", 0))[:8])[0]
        assert after == before  # detached: no more counting
    finally:
        os.close(prog_fd)
        counter.close()
        if os.path.exists(pin):
            os.unlink(pin)


class TestDrainBatched:
    """Batched eviction against the live kernel, plus the capability
    fallbacks (`tests/test_prog_load.py:101-232`), on the port's `BpfMap`."""

    def _filled_hash(self, n=300, mod=sb):
        m = mod.BpfMap.create(1, 4, 8, 1024, b"dr")
        for i in range(n):
            m.update(struct.pack("<I", i), struct.pack("<Q", i * 7))
        return m

    def test_batched_drain_evicts_all(self):
        m = self._filled_hash()
        try:
            got = m.drain()
            assert not m._no_batch_ops
            assert len(got) == 300
            pairs = {struct.unpack("<I", k)[0]: struct.unpack("<Q", v)[0]
                     for k, v in got}
            assert pairs == {i: i * 7 for i in range(300)}
            assert m.keys() == []
        finally:
            m.close()

    def test_drain_pairs_match_the_reference(self):
        """Two maps hash with seeds of their own: the pairs compare as
        sets."""
        ours, ref = self._filled_hash(), self._filled_hash(mod=jsb)
        try:
            assert sorted(ours.drain()) == sorted(ref.drain())
        finally:
            ours.close()
            ref.close()

    def test_small_chunk_multiple_rounds(self):
        m = self._filled_hash()
        try:
            got = m.drain_batched(chunk=16)
            assert got is not None and len(got) == 300
            assert m.keys() == []
        finally:
            m.close()

    def test_enotsupp_524_latches_and_falls_back(self, monkeypatch):
        m = self._filled_hash(50)
        try:
            def deny(cmd, attr):
                raise OSError(sb.ENOTSUPP_KERNEL, "Unknown error 524")
            monkeypatch.setattr(sb, "_bpf_inout", deny)
            got = m.drain()
            assert m._no_batch_ops
            assert len(got) == 50
            assert m.keys() == []
        finally:
            m.close()

    def test_batched_drain_percpu(self):
        ncpu = sb.n_possible_cpus()
        m = sb.BpfMap.create(5, 4, 8, 256, b"drp")
        try:
            assert m.percpu and m.n_cpus == ncpu
            for i in range(40):
                m.update(struct.pack("<I", i), b"".join(
                    struct.pack("<Q", i * 100 + c) for c in range(ncpu)))
            got = m.drain()
            assert not m._no_batch_ops and len(got) == 40
            for k, v in got:
                i = struct.unpack("<I", k)[0]
                assert [struct.unpack_from("<Q", v, c * 8)[0]
                        for c in range(ncpu)] == [i * 100 + c
                                                  for c in range(ncpu)]
            assert m.keys() == []
        finally:
            m.close()

    def test_percpu_unaligned_value_roundtrip(self, monkeypatch):
        ncpu = sb.n_possible_cpus()
        for deny_batch in (False, True):
            m = sb.BpfMap.create(5, 4, 12, 64, b"dru")
            try:
                assert m._pad_vs == 16
                if deny_batch:
                    monkeypatch.setattr(
                        sb, "_bpf_inout",
                        lambda cmd, attr: (_ for _ in ()).throw(
                            OSError(sb.ENOTSUPP_KERNEL, "no batch ops")))
                vals = {}
                for i in range(20):
                    val = b"".join(struct.pack("<QI", i * 100 + c, i)
                                   for c in range(ncpu))
                    m.update(struct.pack("<I", i), val)
                    vals[i] = val
                assert m.lookup(struct.pack("<I", 7)) == vals[7]
                got = m.drain()
                assert m._no_batch_ops == deny_batch
                assert len(got) == 20
                for k, v in got:
                    assert v == vals[struct.unpack("<I", k)[0]]
                assert m.keys() == []
            finally:
                monkeypatch.undo()
                m.close()

    def test_mid_iteration_error_returns_partial(self, monkeypatch):
        m = self._filled_hash(200)
        real = sb._bpf_inout
        calls = {"n": 0}

        def flaky(cmd, attr):
            calls["n"] += 1
            if calls["n"] >= 3:
                raise OSError(errno.ENOMEM, "kernel copy buffer alloc failed")
            return real(cmd, attr)

        monkeypatch.setattr(sb, "_bpf_inout", flaky)
        got = m.drain_batched(chunk=16)
        assert got is not None and 16 <= len(got) < 200
        assert not m._no_batch_ops
        assert len(m.keys()) == 200 - len(got)
        m.close()

    def test_open_pinned_checks_the_layout(self):
        pin = os.path.join(BPFFS, f"nv_torch_layout_{os.getpid()}")
        m = sb.BpfMap.create(5, 40, 32, 64, b"lay")
        try:
            m.pin(pin)
            got = sb.BpfMap.open_pinned(pin, key_size=40, value_size=32)
            assert got.percpu and got.n_cpus == sb.n_possible_cpus()
            assert got.max_entries == 64
            assert sb.BpfMap.get_info(got.fd) == jsb.BpfMap.get_info(got.fd)
            got.close()
            with pytest.raises(ValueError) as ours:
                sb.BpfMap.open_pinned(pin, key_size=40, value_size=24)
            with pytest.raises(ValueError) as ref:
                jsb.BpfMap.open_pinned(pin, key_size=40, value_size=24)
            assert str(ours.value) == str(ref.value)
        finally:
            m.close()
            if os.path.exists(pin):
                os.unlink(pin)


FEATURES = {
    "none": {},
    "dns_rtt_filters": {"enable_dns": True, "dns_port": 5353,
                        "enable_rtt": False, "enable_filters": True,
                        "has_filter_sampling": True},
    "quic_tls_sampled": {"quic_mode": 2, "enable_tls": True,
                         "sampling": 50},
    "no_ringbuf": {"enable_ringbuf_fallback": False, "quic_mode": 1},
}


def _fetcher_pins():
    from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher
    return glob.glob(MinimalKernelFetcher._PIN_PREFIX + f"{os.getpid()}_*")


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_minimal_fetcher_provisions_through_the_verifier(feature):
    from netobserv_tpu import config as jcfg
    from netobserv_tpu_torch import config as tcfg
    from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher

    kw = FEATURES[feature]
    f = MinimalKernelFetcher(cache_max_flows=1024, native_pipeline=True,
                             **kw)
    try:
        assert set(f._prog_fds) == {"ingress", "egress"}
        assert sorted(_fetcher_pins()) == sorted(f._pins.values())
        assert all(p.startswith("/sys/fs/bpf/netobserv_torch_minflow_")
                   for p in f._pins.values())
        want = {"dns"} if kw.get("enable_dns") else set()
        if kw.get("quic_mode"):
            want.add("quic")
        assert set(f._features) == want
        assert (f._native_gate is not None) == bool(want)
        assert (f._ringbuf is not None) == kw.get(
            "enable_ringbuf_fallback", True)
        assert f.map_capacity() == 1024
        assert len(f.lookup_and_delete()) == 0
        assert f.read_global_counters() == {}
        rules = ('[{"ip_cidr":"10.0.0.0/8","protocol":"TCP","sample":2},'
                 '{"ip_cidr":"10.1.1.1/32","action":"Reject"}]')
        n = f.program_filters(tcfg.parse_filter_rules(rules))
        assert n == (2 if kw.get("enable_filters") else 0)
        if n:
            assert len(f._filter_rules.keys()) == 2
            jcfg.parse_filter_rules(rules)  # the reference reads it alike
    finally:
        f.close()
    assert _fetcher_pins() == []


def test_a_fetcher_keeps_the_live_pins_of_another_process():
    """A new fetcher's stale sweep leaves a pin whose process runs (another
    agent's or test's) and removes one whose process is gone."""
    import subprocess
    import sys
    from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher

    done = subprocess.Popen([sys.executable, "-c", "pass"])
    done.wait()
    live = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    prefix = MinimalKernelFetcher._PIN_PREFIX
    theirs = f"{prefix}{live.pid}_ingress"
    stale = f"{prefix}{done.pid}_ingress"
    try:
        first = MinimalKernelFetcher(cache_max_flows=256)
        try:
            sb.obj_pin(first._prog_fds["ingress"], theirs)
            sb.obj_pin(first._prog_fds["egress"], stale)
        finally:
            first.close()
        second = MinimalKernelFetcher(cache_max_flows=256)
        second.close()
        assert os.path.exists(theirs)
        assert not os.path.exists(stale)
    finally:
        live.kill()
        live.wait()
        for pin in (theirs, stale):
            if os.path.exists(pin):
                os.unlink(pin)
    assert _fetcher_pins() == []


def test_a_failed_provisioning_closes_what_it_made(monkeypatch):
    from netobserv_tpu_torch.datapath import asm_flowpath, loader

    def refuse(*a, **k):
        raise RuntimeError("refused")

    monkeypatch.setattr(asm_flowpath, "build_flow_program", refuse)
    fds_before = set(os.listdir("/proc/self/fd"))
    with pytest.raises(RuntimeError, match="refused"):
        loader.MinimalKernelFetcher(cache_max_flows=256, enable_dns=True)
    assert _fetcher_pins() == []
    leaked = set(os.listdir("/proc/self/fd")) - fds_before
    assert not [fd for fd in leaked if os.path.exists(f"/proc/self/fd/{fd}")
                and "bpf" in os.readlink(f"/proc/self/fd/{fd}")]


def _send_udp(ports, per_port: int, size: int, sport: int) -> None:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", sport))
    try:
        for port in ports:
            for _ in range(per_port):
                s.sendto(b"z" * size, ("127.0.0.1", port))
    finally:
        s.close()


@pytest.mark.slow
@tcx
def test_kernel_flow_capture_on_loopback():
    """Each UDP flow sent to 127.0.0.1 is captured with its packets and
    bytes: payload + 8 UDP + 20 IP + 14 Ethernet a datagram (skb->len,
    as `tests/test_asm_flowpath.py:76-116` counts), and on the loopback
    device both hooks see each datagram on the interface that first saw
    the flow, so each pass counts once: twice a datagram."""
    from netobserv_tpu_torch.datapath.loader import MinimalKernelFetcher

    sport, ports, per_port, size = 45123, range(47000, 47060), 3, 120
    f = MinimalKernelFetcher(cache_max_flows=4096, attach_mode="tcx")
    try:
        f.attach(_lo_index(), "lo", "both")
        assert {a.kind for a in f._attached[("", _lo_index())][1].values()} \
            == {"tcx"}
        _send_udp(ports, per_port, size, sport)
        time.sleep(0.3)
        ev = f.lookup_and_delete()
        flows = {}
        for i in range(len(ev)):
            k = ev.events["key"][i]
            if int(k["proto"]) == 17 and int(k["src_port"]) == sport:
                flows[int(k["dst_port"])] = ev.events["stats"][i]
        assert set(flows) == set(ports)
        for st in flows.values():
            assert int(st["packets"]) == 2 * per_port
            assert int(st["bytes"]) == 2 * per_port * (size + 42)
            assert int(st["n_observed_intf"]) == 1
            assert int(st["if_index_first"]) == _lo_index()
    finally:
        f.close()
    assert _fetcher_pins() == []
