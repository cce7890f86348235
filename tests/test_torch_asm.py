"""The port's hand-assembled BPF programs (netobserv_tpu_torch/datapath/
asm.py, asm_flowpath.py, asm_probes.py, asm_ssl.py, asm_pca.py) against
the JAX package's builders, on the CPU: no kernel and no root.

- `build_flow_program` byte for byte over a parametrised grid: both
  directions, sampling 0 and 50, each optional map fd absent and set, alone
  and in its feature's group, QUIC modes 0-2, TLS and filter sampling. Map
  fds are immediates in the bytecode, so both builders get the same
  integers. A set of arguments that one builder refuses, the other must
  refuse with the same exception.
- The RTT tracepoint, drop, SSL-write and PCA programs byte for byte. The
  tracepoint field offsets are a fixed table, and where tracefs is
  readable also the live kernel's, read once by the reference's
  `uprobe.tracepoint_fields` and given to both builders; the drop program
  takes the skb offsets of a fixed stand-in, and where
  /sys/kernel/btf/vmlinux exists also each package's own BTF reader.
- `encode`, `encode_ld_map_fd` and an `Asm` with forward and backward
  labels and a fix-up.
- The reference's two bytecode checks (`tests/test_asm_bytecode.py`) on
  the port's module: the atomics of the lock-free hit path, and the
  staging shifts under a simulated big-endian host (the module reloaded
  under a patched `sys.byteorder`, then reloaded under the true one).

Tolerance: none; every comparison is of bytes.
"""

from __future__ import annotations

import os
import sys

import pytest

import chip_smoke
from netobserv_tpu.datapath import asm as jasm
from netobserv_tpu.datapath import asm_flowpath as jflow
from netobserv_tpu.datapath import asm_pca as jpca
from netobserv_tpu.datapath import asm_probes as jprobes
from netobserv_tpu.datapath import asm_ssl as jssl
from netobserv_tpu.datapath import btf as jbtf
from netobserv_tpu.datapath import uprobe as juprobe
from netobserv_tpu_torch.datapath import asm as tasm
from netobserv_tpu_torch.datapath import asm_flowpath as tflow
from netobserv_tpu_torch.datapath import asm_pca as tpca
from netobserv_tpu_torch.datapath import asm_probes as tprobes
from netobserv_tpu_torch.datapath import asm_ssl as tssl
from netobserv_tpu_torch.datapath import btf as tbtf

#: map fds of every optional feature, one integer each (the table the
#: card's kernel_datapath phase builds with)
FDS = chip_smoke.KD_FDS

#: feature groups: each fd alone, each feature's fds together, and all
FEATURES = {"none": {}}
FEATURES.update({name[:-3]: {name: fd} for name, fd in FDS.items()})
#: an fd alone whose feature wants its pair: a builder may refuse it
#: (the same refusal from both)
HALF_WIRED = {"filter_rules", "filter_peers"}
FEATURES.update({
    "dns": {"dns_inflight_fd": 13, "flows_dns_fd": 14, "dns_port": 5353},
    "rtt": {"rtt_inflight_fd": 15, "flows_extra_fd": 16},
    "filters": {"filter_rules_fd": 17, "filter_peers_fd": 18},
    "filters_sampled": {"filter_rules_fd": 17, "filter_peers_fd": 18,
                        "has_filter_sampling": True,
                        "sampling_gate_fd": 20},
    "filter_sampling_no_trie": {"has_filter_sampling": True},
    "quic1": {"flows_quic_fd": 19, "quic_mode": 1},
    "quic2": {"flows_quic_fd": 19, "quic_mode": 2},
    "quic2_no_map": {"quic_mode": 2},
    "tls": {"enable_tls": True},
    "all": {**FDS, "dns_port": 53, "quic_mode": 2, "enable_tls": True,
            "has_filter_sampling": True},
})


def _both(ref_fn, port_fn, *args, **kwargs):
    """Each builder's program, or each one's exception: equal bytes, or
    the same exception type and message."""
    out = []
    for fn in (ref_fn, port_fn):
        try:
            out.append(("ok", fn(*args, **kwargs)))
        except Exception as exc:  # compared, never swallowed
            out.append(("raise", type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("feature", sorted(FEATURES))
@pytest.mark.parametrize("sampling", [0, 50])
@pytest.mark.parametrize("direction", [0, 1])
def test_flow_program_byte_for_byte(direction, sampling, feature):
    ref, port = _both(jflow.build_flow_program, tflow.build_flow_program,
                      3, direction=direction, sampling=sampling,
                      **FEATURES[feature])
    assert port == ref
    if feature not in HALF_WIRED:
        assert ref[0] == "ok", ref
        assert len(port[1]) % 8 == 0 and len(port[1]) > 8


def test_flow_program_with_positional_arguments_byte_for_byte():
    args = (7, 1, 4, 11, 12, 13, 14, 53, 15, 16, 17, 18, 19, 1, True, 20,
            True)
    assert tflow.build_flow_program(*args) == jflow.build_flow_program(*args)


#: tracepoint context offsets of the shape `uprobe.tracepoint_fields`
#: returns (tcp/tcp_probe and skb/kfree_skb), and a stand-in BTF reader
RTT_FIELDS = chip_smoke.KD_RTT_FIELDS
DROP_FIELDS = chip_smoke.KD_DROP_FIELDS
_Offsets = chip_smoke.KdOffsets


def _live_fields(category, name):
    """The live kernel's tracepoint offsets; skips where tracefs is not
    mounted (the reader would try to mount it)."""
    if not os.path.isdir(os.path.join(juprobe._TRACEFS, "events")):
        pytest.skip("tracefs is not mounted here")
    try:
        return juprobe.tracepoint_fields(category, name)
    except OSError as exc:
        pytest.skip(f"tracefs unreadable here: {exc}")


@pytest.mark.parametrize("gate", [None, 20])
@pytest.mark.parametrize("fields", ["fixed", "live"])
def test_rtt_tracepoint_program_byte_for_byte(fields, gate):
    f = (RTT_FIELDS if fields == "fixed"
         else _live_fields("tcp", "tcp_probe"))
    ref = jprobes.build_rtt_tracepoint_program(dict(f), 16, gate)
    assert tprobes.build_rtt_tracepoint_program(dict(f), 16, gate) == ref


@pytest.mark.parametrize("min_reason", [3, 0])
@pytest.mark.parametrize("gate", [None, 20])
@pytest.mark.parametrize("fields", ["fixed", "live"])
def test_drops_program_byte_for_byte(fields, gate, min_reason):
    f = (DROP_FIELDS if fields == "fixed"
         else _live_fields("skb", "kfree_skb"))
    ref = jprobes.build_drops_program(_Offsets(), 21, dict(f),
                                      min_reason=min_reason,
                                      sampling_gate_fd=gate)
    got = tprobes.build_drops_program(_Offsets(), 21, dict(f),
                                      min_reason=min_reason,
                                      sampling_gate_fd=gate)
    assert got == ref


@pytest.mark.skipif(not jbtf.available(), reason="no /sys/kernel/btf/vmlinux")
def test_drops_program_on_each_packages_btf_reader():
    """Each builder reads the live kernel's offsets with its own package's
    BTF reader: equal programs mean equal offsets."""
    fields = dict(DROP_FIELDS)
    ref = jprobes.build_drops_program(jbtf.kernel_btf(), 21, fields)
    assert tprobes.build_drops_program(tbtf.kernel_btf(), 21, fields) == ref


def test_ssl_write_program_byte_for_byte():
    for fd in (3, 40, 1 << 20):
        assert tssl.build_ssl_write_program(fd) == \
            jssl.build_ssl_write_program(fd)


@pytest.mark.parametrize("kwargs", [
    {}, {"sampling": 10}, {"direction": 1},
    {"filter_rules_fd": 17, "filter_peers_fd": 18},
    {"counters_fd": 12},
    {"sampling": 4, "direction": 1, "filter_rules_fd": 17,
     "filter_peers_fd": 18, "counters_fd": 12}],
    ids=["plain", "sampled", "egress", "filters", "counters", "all"])
def test_pca_program_byte_for_byte(kwargs):
    ref, port = _both(jpca.build_pca_program, tpca.build_pca_program, 9,
                      **kwargs)
    assert ref[0] == "ok", ref
    assert port == ref


def test_encoders_and_labels_byte_for_byte():
    cases = [(0xB7, 1, 0, 0, 5), (0x79, 2, 1, -8, 0), (0xDB, 0, 1, 0, 0x40),
             (0x95, 0, 0, 0, 0), (0x18, 10, 1, 32767, -(1 << 31))]
    for c in cases:
        assert tasm.encode(*c) == jasm.encode(*c)
    for dst, fd in ((1, 3), (2, 4096), (9, (1 << 31) - 1)):
        assert tasm.encode_ld_map_fd(dst, fd) == jasm.encode_ld_map_fd(dst, fd)

    def program(mod):
        a = mod.Asm()
        a.mov_imm(mod.R0, 0)
        a.jmp_imm(0x15, mod.R1, 0, "out")      # forward
        a.label("loop")
        a.alu_imm(0x07, mod.R0, 1)
        a.jmp_imm(0x55, mod.R0, 4, "loop")     # backward
        a.ld_map_fd(mod.R1, 5)
        a.label("out")
        a.exit()
        return a.assemble()

    assert program(tasm) == program(jasm)


def test_datapath_emits_atomic_concurrency_ops():
    """The reference's bytecode-level check of the lock-free hit path
    (`tests/test_asm_bytecode.py:9-31`) on the port's program: atomic adds
    for bytes and packets, an atomic OR for tcp_flags and an atomic
    fetch-add for the observed-slot reservation."""
    prog = tflow.build_flow_program(map_fd=3)
    ops = [(prog[i], prog[i + 1] & 0x0F,
            int.from_bytes(prog[i + 4:i + 8], sys.byteorder, signed=True))
           for i in range(0, len(prog), 8)]
    atomics = [(op, imm) for op, _dst, imm in ops if op in (0xC3, 0xDB)]
    assert any(op == 0xDB and imm == 0 for op, imm in atomics), \
        "no 64-bit atomic add (bytes)"
    assert any(op == 0xC3 and imm == 0 for op, imm in atomics), \
        "no 32-bit atomic add (packets)"
    assert any(op == 0xC3 and imm == 0x40 for op, imm in atomics), \
        "no atomic OR (tcp_flags accumulation)"
    assert any(op == 0xC3 and imm == 0x01 for op, imm in atomics), \
        "no atomic fetch-add (observed-slot reservation)"


def test_staging_shifts_follow_host_byte_order(monkeypatch):
    """The reference's big-endian check (`tests/test_asm_bytecode.py:
    34-72`) on the port's module: reloaded under a simulated big-endian
    host, the staging shifts collapse to 0 and the old-slot extraction
    switches from a >>24 to an &0xFF; the big-endian build also equals the
    reference module's, reloaded the same way. Both modules are reloaded
    under the true byte order after."""
    import importlib

    host_order = sys.byteorder
    monkeypatch.setattr(sys, "byteorder", "big")
    try:
        be = importlib.reload(tflow)
        ref_be = importlib.reload(jflow)
        assert be._FLAGS_SHIFT == 0 and be._NOBS_SHIFT == 0
        prog = be.build_flow_program(map_fd=3)
        assert prog == ref_be.build_flow_program(map_fd=3)
        ops = [(prog[i], int.from_bytes(prog[i + 4:i + 8], host_order,
                                        signed=True))
               for i in range(0, len(prog), 8)]
        assert any(op == 0x57 and imm == 0xFF for op, imm in ops)
        assert not any(op == 0x77 and imm == 24 for op, imm in ops)
    finally:
        monkeypatch.setattr(sys, "byteorder", host_order)
        host = importlib.reload(tflow)
        importlib.reload(jflow)
    if host_order == "little":
        assert host._FLAGS_SHIFT == 16 and host._NOBS_SHIFT == 24
    else:
        assert host._FLAGS_SHIFT == 0 and host._NOBS_SHIFT == 0
    assert host.build_flow_program(map_fd=3) == \
        jflow.build_flow_program(map_fd=3)


def test_builders_import_no_jax_package():
    """The builders run where the JAX package is absent: a child imports
    every one of them with `netobserv_tpu` made unimportable."""
    import subprocess
    import textwrap

    code = textwrap.dedent("""
        import sys
        sys.modules["netobserv_tpu"] = None
        sys.modules["jax"] = None
        from netobserv_tpu_torch.datapath import (
            asm_flowpath, asm_pca, asm_probes, asm_ssl, filter_compile)
        assert asm_flowpath.build_flow_program(3)
        assert asm_ssl.build_ssl_write_program(3)
        assert asm_pca.build_pca_program(3)
        print("OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def test_chip_smoke_program_digests_are_the_reference_builders():
    """`chip_smoke.py`'s kernel_datapath phase holds the port's programs
    on the card against KD_PROGRAM_SHA256: each digest is the reference
    builder's program at the same fixed arguments, and the port's."""
    import hashlib
    import importlib

    table = chip_smoke.KD_PROGRAM_SHA256
    args = chip_smoke.kd_program_args()
    assert set(table) == {a[0] for a in args}
    for name, mod, fn, a, kw in args:
        ref = getattr(importlib.import_module(
            f"netobserv_tpu.datapath.{mod}"), fn)(*a, **kw)
        port = getattr(importlib.import_module(
            f"netobserv_tpu_torch.datapath.{mod}"), fn)(*a, **kw)
        assert hashlib.sha256(ref).hexdigest() == table[name], name
        assert port == ref, name
    progs = chip_smoke._kd_builders()
    assert {n: p["sha256"] for n, p in progs.items() if n in table} == table
