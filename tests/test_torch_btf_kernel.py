"""The port's kernel readers and registries (netobserv_tpu_torch/datapath/
btf.py, kernel.py, maps.py, uprobe.py, syscall_bpf.py's pure parts)
against the JAX package's, on the CPU.

- The BTF reader: the sk_buff and sock offsets the drop program bakes in,
  and a wider set of struct members, equal to the reference reader's on
  the live /sys/kernel/btf/vmlinux (skipped without it); a file that is
  not BTF is refused alike.
- `kernel.py` on the cases of the reference's `tests/test_kernel.py`, and
  every helper equal to the reference's over a list of release strings.
- `maps.MAPS` equal to the reference's registry and to the map names that
  `netobserv_tpu/datapath/bpf/maps.h` defines.
- The tracepoint readers (`tracepoint_id`, `tracepoint_fields`) equal to
  the reference's where tracefs is mounted (skipped otherwise: the
  readers would try to mount it), and `elf_func_offset` on the system
  libssl where there is one.
- `syscall_bpf`: `insn`, `ld_map_fd`, `packet_counter_prog`,
  `parse_ringbuf_records` (the reference suite's normal, discarded and
  busy records), `n_possible_cpus` and the command and map-type numbers.

Tolerance: none; every comparison is exact.
"""

from __future__ import annotations

import os
import re
import struct
from pathlib import Path

import pytest

from netobserv_tpu.datapath import btf as jbtf
from netobserv_tpu.datapath import kernel as jkernel
from netobserv_tpu.datapath import maps as jmaps
from netobserv_tpu.datapath import syscall_bpf as jsb
from netobserv_tpu.datapath import uprobe as jup
from netobserv_tpu_torch.datapath import btf as tbtf
from netobserv_tpu_torch.datapath import kernel as tkernel
from netobserv_tpu_torch.datapath import maps as tmaps
from netobserv_tpu_torch.datapath import syscall_bpf as tsb
from netobserv_tpu_torch.datapath import uprobe as tup

BPF_DIR = (Path(__file__).resolve().parent.parent / "netobserv_tpu"
           / "datapath" / "bpf")

#: struct members the drop program reads, and more of the same kind
MEMBERS = [("sk_buff", "len"), ("sk_buff", "head"),
           ("sk_buff", "network_header"), ("sk_buff", "transport_header"),
           ("sk_buff", "sk"), ("sock", "__sk_common.skc_state"),
           ("sk_buff", "data"), ("sk_buff", "protocol"),
           ("sock", "__sk_common.skc_family"),
           ("sock", "__sk_common.skc_dport"), ("tcp_sock", "srtt_us"),
           ("net_device", "ifindex")]


@pytest.mark.skipif(not jbtf.available(), reason="no /sys/kernel/btf/vmlinux")
@pytest.mark.parametrize("struct_name,path", MEMBERS,
                         ids=[f"{s}.{p}" for s, p in MEMBERS])
def test_btf_offsets_match_the_reference_reader(struct_name, path):
    def outcome(reader):
        try:
            return ("ok", reader.offset_of(struct_name, path))
        except (KeyError, LookupError, ValueError) as exc:
            return (type(exc).__name__, str(exc))

    ref = outcome(jbtf.kernel_btf())
    assert outcome(tbtf.kernel_btf()) == ref
    if (struct_name, path) in MEMBERS[:6]:
        assert ref[0] == "ok"


@pytest.mark.skipif(not jbtf.available(), reason="no /sys/kernel/btf/vmlinux")
def test_btf_type_table_matches_the_reference_reader():
    ref, got = jbtf.kernel_btf(), tbtf.kernel_btf()
    assert len(got.types) == len(ref.types)
    assert got.struct_id("sk_buff") == ref.struct_id("sk_buff")
    assert got.types[:2000] == ref.types[:2000]


def test_a_file_that_is_not_btf_is_refused_alike(tmp_path):
    bad = tmp_path / "notbtf"
    bad.write_bytes(struct.pack("=HBBI", 0x1234, 1, 0, 24) + b"\0" * 40)
    with pytest.raises(ValueError) as ref:
        jbtf.BTF(str(bad))
    with pytest.raises(ValueError) as got:
        tbtf.BTF(str(bad))
    assert str(got.value) == str(ref.value)
    assert tbtf.available() == jbtf.available()


def test_version_code_ordering():
    assert tkernel.version_code("6.6.0") > tkernel.version_code("5.19.7")
    assert tkernel.version_code("5.10") > tkernel.version_code("5.6.3")
    assert tkernel.version_code("bogus") == 0


def test_is_kernel_older_than():
    assert tkernel.is_kernel_older_than("5.8", release="5.4.0-generic")
    assert not tkernel.is_kernel_older_than("5.8", release="6.1.0")
    assert not tkernel.is_kernel_older_than("5.8", release="weird")


def test_capability_ladder():
    assert tkernel.supports_tcx(release="6.6.1")
    assert not tkernel.supports_tcx(release="6.1.0")
    assert tkernel.supports_fentry(release="5.7.0")
    assert not tkernel.supports_fentry(release="5.4.0")
    assert tkernel.supports_ringbuf(release="5.8.0")
    assert not tkernel.supports_lookup_and_delete_batch(release="5.4.0")


def test_rt_detection():
    assert tkernel.is_realtime_kernel(release="5.14.0-rt21")
    assert not tkernel.is_realtime_kernel(release="6.1.0-generic")


def test_current_host_parses():
    assert tkernel.version_code(tkernel.current_release()) > 0
    assert tkernel.current_release() == jkernel.current_release()


RELEASES = ["6.6.0", "6.5.13", "5.19.7", "5.10", "5.6.3", "5.4.0-generic",
            "5.7.0", "5.8.0", "4.18.0-553.el8", "6.1.0-rt5", "6.18.44-fc",
            "6.6.300", "weird", ""]


@pytest.mark.parametrize("release", RELEASES)
def test_kernel_helpers_match_the_reference(release):
    for name in ("version_code",):
        assert getattr(tkernel, name)(release) == \
            getattr(jkernel, name)(release)
    for name in ("supports_tcx", "supports_fentry",
                 "supports_lookup_and_delete_batch", "supports_ringbuf"):
        assert getattr(tkernel, name)(release=release) == \
            getattr(jkernel, name)(release=release)
    assert tkernel.is_kernel_older_than("5.8", release=release) == \
        jkernel.is_kernel_older_than("5.8", release=release)
    if "-rt" in release:
        assert tkernel.is_realtime_kernel(release=release)


def test_map_registry_matches_the_reference_and_the_c_source():
    assert tmaps.MAPS == jmaps.MAPS
    src = (BPF_DIR / "maps.h").read_text()
    defined = set(re.findall(r"DEF_(?:MAP|RINGBUF)\((\w+)", src)) - {"_name"}
    assert defined == set(tmaps.MAPS)
    # the maps the fetchers open by name are in the registry
    from netobserv_tpu_torch.datapath.loader import _FEATURE_MAPS
    names = {n for n, _dt, _a in _FEATURE_MAPS} | {
        "aggregated_flows", "global_counters", "direct_flows", "ssl_events",
        "filter_rules", "filter_peers", "dns_inflight", "sampling_gate"}
    assert names <= set(tmaps.MAPS)


_TRACEFS_UP = os.path.isdir(os.path.join(jup._TRACEFS, "events"))


@pytest.mark.skipif(not _TRACEFS_UP, reason="tracefs is not mounted here")
@pytest.mark.parametrize("category,name", [("tcp", "tcp_probe"),
                                           ("skb", "kfree_skb")])
def test_tracepoint_readers_match_the_reference(category, name):
    try:
        ref = jup.tracepoint_fields(category, name)
        ref_id = jup.tracepoint_id(category, name)
    except OSError as exc:
        pytest.skip(f"tracepoint {category}/{name} unreadable: {exc}")
    assert tup.tracepoint_fields(category, name) == ref
    assert tup.tracepoint_id(category, name) == ref_id


def test_libssl_lookup_matches_the_reference():
    assert tup.find_libssl() == jup.find_libssl()
    path = jup.find_libssl()
    if path is None:
        pytest.skip("no libssl here")
    try:
        ref = jup.elf_func_offset(path, "SSL_write")
    except (OSError, ValueError, LookupError) as exc:
        with pytest.raises(type(exc)):
            tup.elf_func_offset(path, "SSL_write")
        return
    assert tup.elf_func_offset(path, "SSL_write") == ref
    assert tup.resolve_ssl_library("") == jup.resolve_ssl_library("")


def test_syscall_layer_encoders_match_the_reference():
    assert tsb.insn(0x79, 2, 1, -8, 0) == jsb.insn(0x79, 2, 1, -8, 0)
    assert tsb.insn(0x95) == jsb.insn(0x95)
    assert tsb.ld_map_fd(1, 77) == jsb.ld_map_fd(1, 77)
    assert tsb.packet_counter_prog(5) == jsb.packet_counter_prog(5)
    assert tsb.n_possible_cpus() == jsb.n_possible_cpus()
    for name in ("BPF_MAP_CREATE", "BPF_MAP_LOOKUP_AND_DELETE_BATCH",
                 "BPF_PROG_LOAD", "BPF_LINK_CREATE", "BPF_TCX_INGRESS",
                 "BPF_TCX_EGRESS", "BPF_PROG_TYPE_SCHED_CLS",
                 "BPF_PROG_TYPE_TRACEPOINT", "BPF_PROG_TYPE_KPROBE",
                 "ENOTSUPP_KERNEL", "PERCPU_MAP_TYPES", "_SYSCALL_NR",
                 "RINGBUF_BUSY_BIT", "RINGBUF_DISCARD_BIT"):
        assert getattr(tsb, name) == getattr(jsb, name), name


def _rec(mod, payload, busy=False, discard=False):
    hdr = len(payload)
    if busy:
        hdr |= mod.RINGBUF_BUSY_BIT
    if discard:
        hdr |= mod.RINGBUF_DISCARD_BIT
    body = struct.pack("<II", hdr, 0) + payload
    return body + b"\x00" * ((-len(body)) % 8)


def test_ringbuf_record_parser_matches_the_reference():
    """The reference suite's wire-format walk (`tests/test_bpfman.py:
    277-300`): normal, discarded and busy records, and a wrapped ring."""
    data = (_rec(tsb, b"AAAA") + _rec(tsb, b"BB", discard=True)
            + _rec(tsb, b"CCCCCCCC"))
    got = tsb.parse_ringbuf_records(memoryview(data), 0, len(data), 0xFFFF)
    assert got == ([b"AAAA", b"CCCCCCCC"], len(data))
    assert got == jsb.parse_ringbuf_records(memoryview(data), 0, len(data),
                                            0xFFFF)
    data2 = _rec(tsb, b"XX") + _rec(tsb, b"YY", busy=True) + _rec(tsb, b"ZZ")
    got2 = tsb.parse_ringbuf_records(memoryview(data2), 0, len(data2),
                                     0xFFFF)
    assert got2 == ([b"XX"], 16)
    assert got2 == jsb.parse_ringbuf_records(memoryview(data2), 0,
                                             len(data2), 0xFFFF)
    # consumer and producer past the ring's size: offsets wrap by the mask
    ring = bytearray(64)
    one = _rec(tsb, b"WRAPPED!")
    ring[16:16 + len(one)] = one
    args = (memoryview(bytes(ring)), 80, 80 + len(one), 63)
    assert tsb.parse_ringbuf_records(*args) == \
        jsb.parse_ringbuf_records(*args) == ([b"WRAPPED!"], 80 + len(one))
