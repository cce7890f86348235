"""The port's libbpf load path (netobserv_tpu_torch/datapath/libbpf.py,
bpf_build.py and loader.py's `LibbpfKernelFetcher`, `KernelFetcher` and
`_load_clang_or_fallback`) against the JAX package's, a twin of
`tests/test_libbpf_loader.py`.

- The twelve eBPF C sources under `datapath/bpf/` are the reference's byte
  for byte, and the build names clang where there is none.
- `libbpf.available()` and the library's version string are the
  reference's; a minimal relocatable ELF (built as
  `tests/test_libbpf_loader.py:386-431` builds it) opens in both with the
  same programs, sections and types; `rodata_symbols` reads the same
  `.rodata` symbols from a hand-built ELF.
- The tcx regression: libbpf 1.1 leaves a `tcx/ingress` section UNSPEC,
  and the loader's `_libbpf_open_and_load` forces SCHED_CLS on it, so the
  verifier takes it (root, bpffs and libbpf, as the reference's
  `needs_kernel`).
- The probes object's fentry -> kprobe -> none ladder over a faked
  libbpf (`tests/test_libbpf_loader.py:457-654`) gives both loaders the
  same autoload, attach, teardown and close sequence.
- Each branch of `_load_clang_or_fallback` (not root, no object, an
  object without libbpf, the constructor raising) logs the reference's
  line and reaches the same rung.
- The own-object test loads a clang-built `flowpath.bpf.o` and captures
  loopback UDP by TCX; it skips, as the reference's does, where no object
  was built (a machine without clang has none).
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import socket
import struct
import time
from types import SimpleNamespace

import pytest

from netobserv_tpu.datapath import libbpf as jlb
from netobserv_tpu.datapath import loader as jloader
from netobserv_tpu_torch.datapath import bpf_build
from netobserv_tpu_torch.datapath import kernel
from netobserv_tpu_torch.datapath import libbpf as tlb
from netobserv_tpu_torch.datapath import loader as tloader
from netobserv_tpu_torch.datapath import syscall_bpf as sb
from tests.test_libbpf_loader import (
    _FakeProbeObj, _FakeProbeProg, _minimal_bpf_elf,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BPF = os.path.join(ROOT, "netobserv_tpu", "datapath", "bpf")
PORT_BPF = os.path.join(ROOT, "netobserv_tpu_torch", "datapath", "bpf")

needs_libbpf = pytest.mark.skipif(not tlb.available(),
                                  reason="needs libbpf.so.1")
needs_kernel = pytest.mark.skipif(
    not (os.geteuid() == 0 and tlb.available() and shutil.which("ip")
         and os.path.ismount("/sys/fs/bpf") and sb.bpf_available()),
    reason="needs root, bpffs, and libbpf")


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _sources(d: str) -> list[str]:
    return sorted(f for f in os.listdir(d) if f.endswith((".c", ".h")))


def test_bpf_sources_are_the_references_byte_for_byte():
    names = _sources(REF_BPF)
    assert len(names) == 12 and "flowpath.c" in names
    assert _sources(PORT_BPF) == names
    for name in names:
        assert _sha(os.path.join(PORT_BPF, name)) == _sha(
            os.path.join(REF_BPF, name)), name


def test_the_build_names_clang_where_there_is_none(monkeypatch, tmp_path):
    monkeypatch.setenv("CLANG", "no-such-clang-for-bpf")
    with pytest.raises(RuntimeError, match="clang"):
        bpf_build.build(str(tmp_path))
    assert os.listdir(tmp_path) == []
    assert bpf_build.main() == 1


@pytest.mark.parametrize("machine,want", [
    ("x86_64", "__TARGET_ARCH_x86"), ("aarch64", "__TARGET_ARCH_arm64"),
    ("arm64", "__TARGET_ARCH_arm64"), ("ppc64le", "__TARGET_ARCH_powerpc"),
    ("s390x", "__TARGET_ARCH_s390")])
def test_target_arch_follows_the_cmake_rules(machine, want):
    assert bpf_build.target_arch(machine) == want


def test_the_loader_looks_for_the_build_output():
    assert tloader._OBJ_PATH == os.path.join(PORT_BPF, "build",
                                             "flowpath.bpf.o")
    assert os.path.basename(tloader._OBJ_PATH) == os.path.basename(
        jloader._OBJ_PATH)


def test_availability_and_version_are_the_references():
    assert tlb.available() == jlb.available()
    if tlb.available():
        assert (tlb._load_lib().libbpf_version_string()
                == jlb._load_lib().libbpf_version_string())


def test_pin_prefixes_are_apart_and_resize_is_the_references():
    mine = tloader.LibbpfKernelFetcher._PIN_PREFIX
    theirs = jloader.LibbpfKernelFetcher._PIN_PREFIX
    assert not mine.startswith(theirs) and not theirs.startswith(mine)
    assert not mine.startswith(tloader.MinimalKernelFetcher._PIN_PREFIX)
    for cache in (512, 5000, 1 << 20):
        assert (tloader._libbpf_default_resize(cache)
                == jloader._libbpf_default_resize(cache))
    assert tloader.KernelFetcher.needs_iface_discovery
    assert tloader.LibbpfKernelFetcher.needs_iface_discovery


def _programs(mod, path: str) -> list:
    with mod.BpfObject(path) as obj:
        return [(p.name, p.section, p.type, p.autoload)
                for p in obj.programs()]


@pytest.mark.parametrize("fetcher", ["MinimalKernelFetcher",
                                     "LibbpfKernelFetcher"])
def test_the_stale_sweep_keeps_the_pins_of_live_processes(tmp_path,
                                                          fetcher):
    """A sweep unlinks the pins of processes that are gone and keeps those
    of processes that run, this one's and another's (the reference's sweep
    unlinks every pin under its prefix)."""
    import subprocess
    import sys
    cls = getattr(tloader, fetcher)
    prefix = str(tmp_path / os.path.basename(cls._PIN_PREFIX))
    done = subprocess.Popen([sys.executable, "-c", "pass"])
    done.wait()
    live = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])
    try:
        names = {"live": f"{live.pid}_ingress", "own": f"{os.getpid()}_egress",
                 "gone": f"{done.pid}_ingress", "nameless": "stray"}
        for name in names.values():
            open(prefix + name, "w").close()
        cls._sweep_stale_pins(SimpleNamespace(_PIN_PREFIX=prefix))
        kept = {k for k, name in names.items()
                if os.path.exists(prefix + name)}
    finally:
        live.kill()
        live.wait()
    assert kept == {"live", "own"}
    cls._sweep_stale_pins(SimpleNamespace(_PIN_PREFIX=prefix))
    assert os.listdir(tmp_path) == [os.path.basename(prefix + names["own"])]


@needs_libbpf
@pytest.mark.parametrize("section", ["tcx/ingress", "tc_ingress_flow",
                                     "tracepoint/skb/kfree_skb"])
def test_a_minimal_elf_opens_alike(tmp_path, section):
    path = tmp_path / "min.bpf.o"
    path.write_bytes(_minimal_bpf_elf(section))
    got = _programs(tlb, str(path))
    assert got == _programs(jlb, str(path))
    assert [(n, s) for n, s, _t, _a in got] == [("prog_main", section)]


def test_a_foreign_file_is_refused_alike(tmp_path):
    path = tmp_path / "not.o"
    path.write_bytes(b"\x7fELF\x01" + b"\x00" * 60)
    for mod in (tlb, jlb):
        with pytest.raises(ValueError, match="not an ELF64"):
            mod.rodata_symbols(str(path))


def _rodata_elf(symbols: dict, data: bytes) -> bytes:
    """A relocatable ELF64 with a `.rodata` of `data` and one global
    object symbol per name of `symbols` ({name: (offset, size)}), plus a
    `.bss` symbol that `rodata_symbols` must not report."""
    s = struct
    names = [b".rodata", b".bss", b".symtab", b".strtab"] + [
        n.encode() for n in symbols] + [b"in_bss"]
    strtab = b"\x00"
    offs = {}
    for n in names:
        offs[n] = len(strtab)
        strtab += n + b"\x00"
    syms = b"\x00" * 24
    for n, (off, size) in symbols.items():
        syms += s.pack("<IBBHQQ", offs[n.encode()], (1 << 4) | 1, 0, 1,
                       off, size)
    syms += s.pack("<IBBHQQ", offs[b"in_bss"], (1 << 4) | 1, 0, 2, 0, 4)
    ehsize = 64
    bodies = [data, b"", syms, strtab]           # sections 1..4
    layout, off = [], ehsize
    for b in bodies:
        layout.append((off, len(b)))
        off += len(b)
    shoff = (off + 7) & ~7
    sh = [s.pack("<IIQQQQIIQQ", 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)]
    sh.append(s.pack("<IIQQQQIIQQ", offs[b".rodata"], 1, 0x2, 0,
                     layout[0][0], layout[0][1], 0, 0, 8, 0))
    sh.append(s.pack("<IIQQQQIIQQ", offs[b".bss"], 8, 0x3, 0,
                     layout[1][0], 8, 0, 0, 8, 0))
    sh.append(s.pack("<IIQQQQIIQQ", offs[b".symtab"], 2, 0, 0,
                     layout[2][0], layout[2][1], 4, 1, 8, 24))
    sh.append(s.pack("<IIQQQQIIQQ", offs[b".strtab"], 3, 0, 0,
                     layout[3][0], layout[3][1], 0, 0, 1, 0))
    ehdr = s.pack("<4sBBBBB7xHHIQQQIHHHHHH", b"\x7fELF", 2, 1, 1, 0, 0,
                  1, 247, 1, 0, 0, shoff, 0, ehsize, 0, 0, 64, len(sh), 4)
    body = b"".join(bodies)
    return ehdr + body + b"\x00" * (shoff - ehsize - len(body)) + b"".join(sh)


def test_rodata_symbols_read_a_hand_built_elf_alike(tmp_path):
    want = {"cfg_sampling": (0, 4), "cfg_dns_port": (4, 2),
            "cfg_enable_rtt": (6, 1), "cfg_quic_mode": (8, 8)}
    path = tmp_path / "rodata.o"
    path.write_bytes(_rodata_elf(want, bytes(16)))
    assert tlb.rodata_symbols(str(path)) == want
    assert jlb.rodata_symbols(str(path)) == want
    assert tlb._Elf(str(path)).symbols_in(".bss") == {"in_bss": (0, 4)}
    assert tlb._Elf(str(path)).symbols_in(".data") == {}


@needs_kernel
def test_tcx_section_needs_explicit_type(tmp_path):
    """libbpf <= 1.2 leaves a `tcx/ingress` program UNSPEC and its load
    fails, in both bindings alike; the port's loader forces SCHED_CLS on
    every entry program, after which the verifier takes it."""
    path = tmp_path / "tcx.bpf.o"
    path.write_bytes(_minimal_bpf_elf("tcx/ingress"))
    for mod in (tlb, jlb):
        with mod.BpfObject(str(path)) as obj:
            prog = obj.program("prog_main")
            if prog.type != 0:
                pytest.skip("libbpf recognizes tcx sections here")
            with pytest.raises(OSError):
                obj.load()
    obj = tloader._libbpf_open_and_load(str(path), {}, {},
                                        {"ingress": "prog_main"})
    try:
        prog = obj.program("prog_main")
        assert prog.type == 3 and prog.fd > 0 and obj.loaded
    finally:
        obj.close()
    with pytest.raises(RuntimeError, match="lacks program tcx_egress"):
        tloader._libbpf_open_and_load(str(path), {}, {},
                                      {"egress": "tcx_egress_flow"})


# --------------------------------------------- the probes object's ladder

_REAL_ATTACH = _FakeProbeProg.attach


def _ladder(monkeypatch, lb, loader_mod, cfg_overrides):
    """`_load_probes` of one package over the faked libbpf
    (`tests/test_libbpf_loader._fake_probe_env`, here with the package's
    own libbpf module patched); what every pass did, in order."""
    _FakeProbeObj.instances = []
    monkeypatch.setattr(lb, "BpfObject", _FakeProbeObj)
    monkeypatch.setattr(lb, "rodata_symbols", lambda p: {})
    order = []

    def tracking_attach(self):
        order.append(self.section)
        return _REAL_ATTACH(self)

    monkeypatch.setattr(_FakeProbeProg, "attach", tracking_attach)
    shared = {"flows_extra": SimpleNamespace(fd=42)}
    fake_self = SimpleNamespace(
        _probe_wanted=loader_mod.LibbpfKernelFetcher._probe_wanted,
        _obj=SimpleNamespace(map=lambda name: shared.get(name)))
    cfg = SimpleNamespace(**{
        "enable_rtt": True, "enable_pkt_drops": False,
        "enable_network_events_monitoring": False,
        "enable_pkt_translation": False, "enable_ipsec_tracking": False,
        "cache_max_flows": 777, **cfg_overrides})
    with monkeypatch.context() as m:
        m.setattr(os.path, "isdir", lambda p: True)
        m.setattr(os.path, "exists", lambda p: True)
        try:
            loader_mod.LibbpfKernelFetcher._load_probes(
                fake_self, cfg, "/nonexistent/probes.bpf.o", {})
            raised = None
        except OSError as exc:
            raised = exc.errno
    passes = [{
        "closed": inst.closed, "loaded": inst.loaded,
        "progs": [(p.section, p.autoload, p.attached,
                   p.link is not None and p.link.destroyed)
                  for p in inst.programs()],
        "maps": [(mp.name, mp.reused_fd, mp.max_entries)
                 for mp in inst.maps()]}
        for inst in _FakeProbeObj.instances]
    kept = getattr(fake_self, "_probes_obj", None)
    return {"passes": passes, "order": order, "raised": raised,
            "kept": (_FakeProbeObj.instances.index(kept)
                     if kept is not None else None),
            "links": len(getattr(fake_self, "_probe_links", []))}


_ALL = ("tracepoint/skb/kfree_skb", "fentry/tcp_rcv_established",
        "kprobe/tcp_rcv_established", "kprobe/psample_sample_packet",
        "kprobe/nf_nat_manip_pkt", "kprobe/xfrm_input",
        "kretprobe/xfrm_output", "uprobe/SSL_write")

#: (sections, fentry attach fails, load fails on, config) of each case:
#: the reference's three (`:574-654`), a verifier refusing every tier,
#: nothing wanted, and every gate on
LADDER_CASES = {
    "fentry_attach_fails": (
        ("fentry/tcp_rcv_established", "kprobe/tcp_rcv_established"),
        ("fentry/tcp_rcv_established",), (), {}),
    "both_rtt_tiers_fail": (
        ("tracepoint/skb/kfree_skb", "fentry/tcp_rcv_established",
         "kprobe/tcp_rcv_established"),
        ("fentry/tcp_rcv_established",), ("kprobe/",),
        {"enable_pkt_drops": True}),
    "fentry_first": (
        ("tracepoint/skb/kfree_skb", "fentry/tcp_rcv_established",
         "kprobe/tcp_rcv_established"), (), (), {"enable_pkt_drops": True}),
    "every_tier_refused": (
        ("tracepoint/skb/kfree_skb", "fentry/tcp_rcv_established"), (),
        ("tracepoint/", "fentry/"), {"enable_pkt_drops": True}),
    "nothing_wanted": (_ALL, (), (), {"enable_rtt": False}),
    "every_gate": (_ALL, (), (), {
        "enable_pkt_drops": True, "enable_network_events_monitoring": True,
        "enable_pkt_translation": True, "enable_ipsec_tracking": True}),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_probe_ladder_runs_as_the_references(monkeypatch, case):
    sections, fail_attach, fail_load, over = LADDER_CASES[case]
    monkeypatch.setattr(_FakeProbeObj, "sections", sections)
    monkeypatch.setattr(_FakeProbeObj, "fail_attach_sections", fail_attach)
    monkeypatch.setattr(_FakeProbeObj, "fail_load_sections", fail_load)
    want = _ladder(monkeypatch, jlb, jloader, over)
    got = _ladder(monkeypatch, tlb, tloader, over)
    assert got == want
    if case == "fentry_attach_fails":
        assert len(got["passes"]) == 2 and got["kept"] == 1
    if case == "every_tier_refused":
        assert got["raised"] == 22 and got["kept"] is None
    if case == "nothing_wanted":
        assert got["passes"][0]["closed"] and not got["order"]


# ------------------------------------------------ _load_clang_or_fallback


def _branch(monkeypatch, caplog, loader_mod, lb, *, root=True, obj=None,
            available=True, ctor_raises=False):
    calls = []

    def clang(cfg):
        calls.append("clang")
        if ctor_raises:
            raise RuntimeError("object lacks program tcx_ingress_flow")
        return "clang-fetcher"

    def fallback(cfg):
        calls.append("fallback")
        return "assembler-fetcher"

    monkeypatch.setattr(os, "geteuid", lambda: 0 if root else 1000)
    monkeypatch.setattr(loader_mod, "_OBJ_PATH", obj or "/nonexistent.o")
    monkeypatch.setattr(lb, "available", lambda: available)
    caplog.clear()
    with caplog.at_level(logging.DEBUG):
        try:
            out = loader_mod._load_clang_or_fallback(None, clang, fallback,
                                                     "datapath")
        except RuntimeError as exc:
            out = f"raised: {exc}"
    lines = [(r.levelname, r.getMessage().replace(obj or "/nonexistent.o",
                                                  "<obj>"))
             for r in caplog.records
             if r.name.endswith("datapath.loader")]
    return out, calls, lines


@pytest.mark.parametrize("branch", ["not_root", "no_object",
                                    "no_libbpf", "ctor_raises", "loads"])
def test_each_branch_of_the_clang_ladder_is_the_references(
        monkeypatch, caplog, tmp_path, branch):
    obj = tmp_path / "flowpath.bpf.o"
    obj.write_bytes(b"stand-in")
    kw = {"not_root": dict(root=False, obj=str(obj)),
          "no_object": dict(),
          "no_libbpf": dict(obj=str(obj), available=False),
          "ctor_raises": dict(obj=str(obj), ctor_raises=True),
          "loads": dict(obj=str(obj))}[branch]
    want = _branch(monkeypatch, caplog, jloader, jlb, **kw)
    got = _branch(monkeypatch, caplog, tloader, tlb, **kw)
    assert got == want
    out, calls, lines = got
    assert {"not_root": "raised: kernel datapath requires root/CAP_BPF",
            "loads": "clang-fetcher"}.get(branch, "assembler-fetcher") == out
    assert calls == {"not_root": [], "loads": ["clang"],
                     "ctor_raises": ["clang", "fallback"]}.get(
                         branch, ["fallback"])
    assert len(lines) == (0 if branch == "not_root" else 1)


def test_kernel_fetcher_loads_through_the_ladder(monkeypatch):
    """`KernelFetcher.load` hands the ladder the libbpf fetcher on the
    port's object and `MinimalKernelFetcher.load` as its fallback."""
    seen = {}

    def ladder(cfg, clang_ctor, fallback, noun):
        seen.update(cfg=cfg, fallback=fallback, noun=noun)
        return "fetcher"

    monkeypatch.setattr(tloader, "_load_clang_or_fallback", ladder)
    assert tloader.KernelFetcher.load("cfg") == "fetcher"
    assert seen == {"cfg": "cfg", "noun": "datapath",
                    "fallback": tloader.MinimalKernelFetcher.load}


# ------------------------------------------------------- the own object


def _lo_index() -> int:
    return socket.if_nametoindex("lo")


@needs_kernel
def test_own_object_full_fetcher():
    """The whole `LibbpfKernelFetcher` lifecycle on a clang-built
    `flowpath.bpf.o` (`python -m netobserv_tpu_torch.datapath.bpf_build`):
    attached to `lo` by TCX, it captures loopback UDP with its packets and
    bytes. Skipped where no object was built, as the reference's
    `test_own_object_full_fetcher` is."""
    from netobserv_tpu_torch.config import load_config

    if not os.path.exists(tloader._OBJ_PATH):
        pytest.skip("no clang-built flowpath.bpf.o in this environment")
    if not kernel.supports_tcx():
        pytest.skip("needs TCX (kernel 6.6)")
    cfg = load_config(environ={
        "EXPORT": "tpu-sketch", "ENABLE_DNS_TRACKING": "true",
        "ENABLE_TLS_TRACKING": "true", "CACHE_MAX_FLOWS": "2048"})
    fetcher = tloader.LibbpfKernelFetcher(cfg)
    try:
        fetcher.attach(_lo_index(), "lo", "egress")
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 41415))
        for _ in range(5):
            s.sendto(b"c" * 100, ("127.0.0.1", 4547))
        s.close()
        time.sleep(0.3)
        ev = fetcher.lookup_and_delete()
        rows = [i for i in range(len(ev))
                if int(ev.events["key"][i]["src_port"]) == 41415
                and int(ev.events["key"][i]["dst_port"]) == 4547]
        assert rows, "no flow captured by the clang-built datapath"
        st = ev.events["stats"][rows[0]]
        assert int(st["packets"]) == 5
        assert int(st["bytes"]) == 5 * (100 + 8 + 20 + 14)
    finally:
        fetcher.close()
    assert not [p for p in os.listdir("/sys/fs/bpf")
                if p.startswith(os.path.basename(
                    tloader.LibbpfKernelFetcher._PIN_PREFIX)
                    + f"{os.getpid()}_")]
