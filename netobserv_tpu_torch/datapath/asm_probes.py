"""Hand-assembled tracepoint trackers (drops + smoothed RTT), no compiler.

This kernel compiles out kprobes (CONFIG_KPROBES unset) but exposes the
tracepoint PMU, which is also what the C twin uses for drops
(flowpath_probes.c SEC("tracepoint/skb/kfree_skb")). Two layers of runtime
resolution replace CO-RE:

- tracepoint context offsets come from the live tracefs format files
  (uprobe.tracepoint_fields) — 6.18 inserted rx_sk into skb/kfree_skb, so
  hardcoded layouts would silently read the wrong fields;
- kernel struct offsets (walking the dropped skb's headers) come from
  /sys/kernel/btf/vmlinux (datapath/btf.py), baked into the assembled
  program as immediates — the same relocation libbpf performs at load time.

Programs:
- build_rtt_tracepoint_program — tcp/tcp_probe: smoothed RTT and the
  receive-path tuple straight from the tracepoint context
  (flowpath_probes.c:60-155 handle_rtt/key_from_sock_rx analog)
- build_drops_program — skb/kfree_skb: packet drops re-keyed from the skb's
  network/transport headers via bpf_probe_read_kernel
  (flowpath_probes.c:172-208 twin)

The port's copy of `netobserv_tpu/datapath/asm_probes.py`, kept so that
the port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

from netobserv_tpu_torch.datapath.asm import (
    Asm, BPF_B, BPF_DW, BPF_H, BPF_W, HELPER_KTIME_GET_NS, HELPER_MAP_LOOKUP,
    HELPER_MAP_UPDATE, R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10,
)
from netobserv_tpu_torch.model import binfmt

HELPER_PROBE_READ_KERNEL = 113

# struct sockaddr_in / sockaddr_in6 member offsets (uapi, stable)
SA_V4_ADDR = 4
SA_V6_ADDR = 8

AF_INET = 2
AF_INET6 = 10

KEY_SIZE = binfmt.FLOW_KEY_DTYPE.itemsize


def _ky(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_probes.py:44`."""
    return binfmt.FLOW_KEY_DTYPE.fields[field][1]


def _xr(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_probes.py:48`."""
    return binfmt.EXTRA_REC_DTYPE.fields[field][1]


def _dp(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_probes.py:52`."""
    return binfmt.DROPS_REC_DTYPE.fields[field][1]


# stack layout (shared by both programs; all 8-aligned)
KEY = -KEY_SIZE            # no_flow_key build slot (40B)
REC = KEY - 64             # -104: record build slot (extra 32B / drops 32B)
SCR = REC - 48             # -152: probe_read scratch (headers, fields)
NOW = SCR - 8              # -160: timestamp


class _Probe:
    """Reference: `netobserv_tpu/datapath/asm_probes.py:63`."""
    def __init__(self):
        """Reference: `netobserv_tpu/datapath/asm_probes.py:64`."""
        self.a = Asm()

    def read_kernel(self, src_reg: int, src_off: int, dst_off: int,
                    n: int, fail: str) -> None:
        """bpf_probe_read_kernel(r10+dst_off, n, src_reg+src_off); jumps to
        `fail` on error. Clobbers r0-r5.

        Reference: `netobserv_tpu/datapath/asm_probes.py:67`."""
        a = self.a
        a.mov_reg(R1, R10)
        a.alu_imm(0x07, R1, dst_off)
        a.mov_imm(R2, n)
        a.mov_reg(R3, src_reg)
        if src_off:
            a.alu_imm(0x07, R3, src_off)
        a.call(HELPER_PROBE_READ_KERNEL)
        a.jmp_imm(0x55, R0, 0, fail)

    def zero_key(self) -> None:
        """Reference: `netobserv_tpu/datapath/asm_probes.py:81`."""
        for off in range(KEY, 0, 8):
            self.a.st_imm(BPF_DW, R10, off, 0)

    def gate_sampling(self, gate_fd) -> None:
        """Exit unless the TC path's latest per-CPU sampling decision was
        'sampled' (sampling_gate map; reference do_sampling gate,
        flowpath_probes.c aux-hook pattern).

        Reference: `netobserv_tpu/datapath/asm_probes.py:85`."""
        if gate_fd is None:
            return
        a = self.a
        a.st_imm(BPF_W, R10, SCR, 0)
        a.ld_map_fd(R1, gate_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, SCR)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, "out")           # gate absent: skip
        a.ldx(BPF_B, R3, R0, 0)
        a.jmp_imm(0x15, R3, 0, "out")           # last packet unsampled


def build_rtt_tracepoint_program(fields: dict[str, int], flows_extra_fd: int,
                                 sampling_gate_fd=None) -> bytes:
    """tcp/tcp_probe fires in tcp_rcv_established with the socket tuple and
    the smoothed RTT already in the context. `fields` comes from
    uprobe.tracepoint_fields("tcp", "tcp_probe"): saddr/daddr are sockaddr
    blobs (LOCAL/REMOTE respectively), sport/dport host-order. The
    receive-path key maps remote->src, local->dst (key_from_sock_rx).

    Reference: `netobserv_tpu/datapath/asm_probes.py:102`."""
    p = _Probe()
    a = p.a
    f_saddr, f_daddr = fields["saddr"], fields["daddr"]
    f_sport, f_dport = fields["sport"], fields["dport"]
    f_family, f_srtt = fields["family"], fields["srtt"]

    a.mov_reg(R6, R1)                           # r6 = tracepoint ctx
    p.gate_sampling(sampling_gate_fd)
    p.zero_key()
    a.st_imm(BPF_B, R10, KEY + _ky("proto"), 6)
    a.ldx(BPF_H, R3, R6, f_family)
    a.jmp_imm(0x15, R3, AF_INET, "v4")
    a.jmp_imm(0x55, R3, AF_INET6, "out")
    # v6: remote (daddr) -> src, local (saddr) -> dst
    for i in range(0, 16, 4):
        a.ldx(BPF_W, R3, R6, f_daddr + SA_V6_ADDR + i)
        a.stx(BPF_W, R10, R3, KEY + _ky("src_ip") + i)
        a.ldx(BPF_W, R3, R6, f_saddr + SA_V6_ADDR + i)
        a.stx(BPF_W, R10, R3, KEY + _ky("dst_ip") + i)
    a.jmp("ports")
    a.label("v4")
    a.st_imm(BPF_H, R10, KEY + _ky("src_ip") + 10, 0xFFFF)
    a.ldx(BPF_W, R3, R6, f_daddr + SA_V4_ADDR)
    a.stx(BPF_W, R10, R3, KEY + _ky("src_ip") + 12)
    a.st_imm(BPF_H, R10, KEY + _ky("dst_ip") + 10, 0xFFFF)
    a.ldx(BPF_W, R3, R6, f_saddr + SA_V4_ADDR)
    a.stx(BPF_W, R10, R3, KEY + _ky("dst_ip") + 12)
    a.label("ports")
    a.ldx(BPF_H, R3, R6, f_dport)               # remote port (host order)
    a.stx(BPF_H, R10, R3, KEY + _ky("src_port"))
    a.ldx(BPF_H, R3, R6, f_sport)               # local port
    a.stx(BPF_H, R10, R3, KEY + _ky("dst_port"))
    # rtt_ns = srtt_us * 1000 (tcp_probe reports srtt_us>>3 already)
    a.ldx(BPF_W, R8, R6, f_srtt)
    a.alu_imm(0x27, R8, 1000)                   # r8 = rtt_ns
    a.jmp_imm(0x15, R8, 0, "out")               # unmeasured connection
    a.call(HELPER_KTIME_GET_NS)
    a.stx(BPF_DW, R10, R0, NOW)
    a.ld_map_fd(R1, flows_extra_fd)
    a.mov_reg(R2, R10)
    a.alu_imm(0x07, R2, KEY)
    a.call(HELPER_MAP_LOOKUP)
    a.jmp_imm(0x15, R0, 0, "miss")
    a.ldx(BPF_DW, R3, R10, NOW)
    a.stx(BPF_DW, R0, R3, _xr("last_seen_ns"))
    a.ldx(BPF_DW, R3, R0, _xr("rtt_ns"))        # max-merge (handle_rtt)
    a.jmp_reg(0x3D, R3, R8, "out")
    a.stx(BPF_DW, R0, R8, _xr("rtt_ns"))
    a.jmp("out")
    a.label("miss")
    for off in range(REC, REC + 32, 8):
        a.st_imm(BPF_DW, R10, off, 0)
    a.ldx(BPF_DW, R3, R10, NOW)
    a.stx(BPF_DW, R10, R3, REC + _xr("first_seen_ns"))
    a.stx(BPF_DW, R10, R3, REC + _xr("last_seen_ns"))
    a.stx(BPF_DW, R10, R8, REC + _xr("rtt_ns"))
    a.ld_map_fd(R1, flows_extra_fd)
    a.mov_reg(R2, R10)
    a.alu_imm(0x07, R2, KEY)
    a.mov_reg(R3, R10)
    a.alu_imm(0x07, R3, REC)
    a.mov_imm(R4, 0)
    a.call(HELPER_MAP_UPDATE)
    a.label("out")
    a.mov_imm(R0, 0)
    a.exit()
    return a.assemble()


def build_drops_program(offs, flows_drops_fd: int, fields: dict[str, int],
                        min_reason: int = 3,
                        sampling_gate_fd=None) -> bytes:
    """Tracepoint skb/kfree_skb: re-key the dropped packet from its
    network/transport headers and record cause/state (drops_tp twin —
    reasons below `min_reason` are routine teardown and skipped). `offs` is
    the BTF reader (skb walking), `fields` the tracepoint context offsets
    (skbaddr/reason moved between kernel versions).

    Reference: `netobserv_tpu/datapath/asm_probes.py:178`."""
    p = _Probe()
    a = p.a
    skb_ctx_off = fields["skbaddr"]
    reason_ctx_off = fields["reason"]
    o_len = offs.offset_of("sk_buff", "len")
    o_head = offs.offset_of("sk_buff", "head")
    o_nh = offs.offset_of("sk_buff", "network_header")
    o_th = offs.offset_of("sk_buff", "transport_header")
    o_sk = offs.offset_of("sk_buff", "sk")
    o_state = offs.offset_of("sock", "__sk_common.skc_state")

    a.mov_reg(R6, R1)                           # r6 = tracepoint ctx
    a.ldx(BPF_DW, R7, R6, skb_ctx_off)          # r7 = skb
    a.ldx(BPF_W, R9, R6, reason_ctx_off)        # r9 = reason
    a.jmp_imm(0xA5, R9, min_reason, "out")      # routine teardown: skip
    p.gate_sampling(sampling_gate_fd)
    p.zero_key()
    for off in range(REC, REC + 32, 8):         # parse pre-fills REC fields
        a.st_imm(BPF_DW, R10, off, 0)
    # head + network_header -> r8 = network header address
    p.read_kernel(R7, o_head, SCR, 8, "out")
    p.read_kernel(R7, o_nh, SCR + 8, 2, "out")
    a.ldx(BPF_DW, R8, R10, SCR)
    a.ldx(BPF_H, R3, R10, SCR + 8)
    a.jmp_imm(0x15, R3, 0xFFFF, "out")          # header never set
    a.alu_reg(0x0F, R8, R3)
    # IP version nibble picks the parse (key_from_skb:84-110)
    p.read_kernel(R8, 0, SCR, 1, "out")
    a.ldx(BPF_B, R3, R10, SCR)
    a.alu_imm(0x77, R3, 4)
    a.jmp_imm(0x15, R3, 4, "v4")
    a.jmp_imm(0x55, R3, 6, "out")
    # v6: fixed header at r8; addresses at +8/+24
    p.read_kernel(R8, 8, KEY + _ky("src_ip"), 16, "out")
    p.read_kernel(R8, 24, KEY + _ky("dst_ip"), 16, "out")
    p.read_kernel(R8, 6, SCR, 1, "out")         # next header
    a.st_imm(BPF_H, R10, REC + _dp("eth_protocol"), 0x86DD)
    a.jmp("l4")
    a.label("v4")
    p.read_kernel(R8, 9, SCR, 1, "out")         # protocol
    a.st_imm(BPF_H, R10, KEY + _ky("src_ip") + 10, 0xFFFF)
    a.st_imm(BPF_H, R10, KEY + _ky("dst_ip") + 10, 0xFFFF)
    p.read_kernel(R8, 12, KEY + _ky("src_ip") + 12, 4, "out")
    p.read_kernel(R8, 16, KEY + _ky("dst_ip") + 12, 4, "out")
    a.st_imm(BPF_H, R10, REC + _dp("eth_protocol"), 0x0800)
    a.label("l4")
    a.ldx(BPF_B, R3, R10, SCR)
    a.stx(BPF_B, R10, R3, KEY + _ky("proto"))
    # transport header -> r8 (head must be re-read: SCR was reused)
    p.read_kernel(R7, o_th, SCR + 8, 2, "out")
    p.read_kernel(R7, o_head, SCR, 8, "out")
    a.ldx(BPF_DW, R8, R10, SCR)
    a.ldx(BPF_H, R4, R10, SCR + 8)
    a.jmp_imm(0x15, R4, 0xFFFF, "rec")          # no transport header
    a.alu_reg(0x0F, R8, R4)
    a.ldx(BPF_B, R3, R10, KEY + _ky("proto"))
    a.jmp_imm(0x15, R3, 6, "tcp")
    a.jmp_imm(0x15, R3, 17, "udp")
    a.jmp("rec")
    a.label("tcp")
    p.read_kernel(R8, 13, SCR + 16, 1, "rec")   # raw flags byte
    a.ldx(BPF_B, R3, R10, SCR + 16)
    # composite-flag classification, same encoding as every other flags
    # field (parse.h:93-102 / asm_flowpath tcp branch)
    for combo, bit in ((0x12, 0x100), (0x11, 0x200), (0x14, 0x400)):
        a.mov_reg(R4, R3)
        a.alu_imm(0x57, R4, combo)
        a.jmp_imm(0x55, R4, combo, f"dcls_{bit:x}")
        a.alu_imm(0x47, R3, bit)
        a.label(f"dcls_{bit:x}")
    a.stx(BPF_H, R10, R3, REC + _dp("latest_flags"))
    a.label("udp")
    p.read_kernel(R8, 0, SCR + 8, 4, "rec")     # src/dst ports (BE)
    a.ldx(BPF_H, R3, R10, SCR + 8)
    a.endian_be(R3, 16)
    a.stx(BPF_H, R10, R3, KEY + _ky("src_port"))
    a.ldx(BPF_H, R3, R10, SCR + 10)
    a.endian_be(R3, 16)
    a.stx(BPF_H, R10, R3, KEY + _ky("dst_port"))
    a.label("rec")
    # skb->len and socket state
    p.read_kernel(R7, o_len, SCR, 4, "out")
    a.ldx(BPF_W, R8, R10, SCR)                  # r8 = len
    a.st_imm(BPF_B, R10, REC + _dp("latest_state"), 0)
    p.read_kernel(R7, o_sk, SCR, 8, "out")
    a.ldx(BPF_DW, R3, R10, SCR)
    a.jmp_imm(0x15, R3, 0, "nostate")
    p.read_kernel(R3, o_state, SCR + 8, 1, "nostate")
    a.ldx(BPF_B, R4, R10, SCR + 8)
    a.stx(BPF_B, R10, R4, REC + _dp("latest_state"))
    a.label("nostate")
    a.call(HELPER_KTIME_GET_NS)
    a.stx(BPF_DW, R10, R0, NOW)
    a.ld_map_fd(R1, flows_drops_fd)
    a.mov_reg(R2, R10)
    a.alu_imm(0x07, R2, KEY)
    a.call(HELPER_MAP_LOOKUP)
    a.jmp_imm(0x15, R0, 0, "miss")
    a.ldx(BPF_DW, R3, R10, NOW)
    a.stx(BPF_DW, R0, R3, _dp("last_seen_ns"))
    # saturating u16 adds (no_sat_add16)
    a.ldx(BPF_H, R3, R0, _dp("bytes"))
    a.alu_reg(0x0F, R3, R8)
    a.jmp_imm(0xB5, R3, 0xFFFF, "bytes_ok")
    a.mov_imm(R3, 0xFFFF)
    a.label("bytes_ok")
    a.stx(BPF_H, R0, R3, _dp("bytes"))
    a.ldx(BPF_H, R3, R0, _dp("packets"))
    a.alu_imm(0x07, R3, 1)
    a.jmp_imm(0xB5, R3, 0xFFFF, "pkts_ok")
    a.mov_imm(R3, 0xFFFF)
    a.label("pkts_ok")
    a.stx(BPF_H, R0, R3, _dp("packets"))
    a.stx(BPF_W, R0, R9, _dp("latest_cause"))
    a.ldx(BPF_H, R3, R10, REC + _dp("latest_flags"))
    a.ldx(BPF_H, R4, R0, _dp("latest_flags"))
    a.alu_reg(0x4F, R3, R4)
    a.stx(BPF_H, R0, R3, _dp("latest_flags"))
    a.ldx(BPF_B, R3, R10, REC + _dp("latest_state"))
    a.stx(BPF_B, R0, R3, _dp("latest_state"))
    a.jmp("out")
    a.label("miss")
    # REC already carries eth_protocol/flags/state; fill the rest
    a.ldx(BPF_DW, R3, R10, NOW)
    a.stx(BPF_DW, R10, R3, REC + _dp("first_seen_ns"))
    a.stx(BPF_DW, R10, R3, REC + _dp("last_seen_ns"))
    a.mov_reg(R3, R8)
    a.jmp_imm(0xB5, R3, 0xFFFF, "fb_ok")
    a.mov_imm(R3, 0xFFFF)
    a.label("fb_ok")
    a.stx(BPF_H, R10, R3, REC + _dp("bytes"))
    a.st_imm(BPF_H, R10, REC + _dp("packets"), 1)
    a.stx(BPF_W, R10, R9, REC + _dp("latest_cause"))
    a.ld_map_fd(R1, flows_drops_fd)
    a.mov_reg(R2, R10)
    a.alu_imm(0x07, R2, KEY)
    a.mov_reg(R3, R10)
    a.alu_imm(0x07, R3, REC)
    a.mov_imm(R4, 0)
    a.call(HELPER_MAP_UPDATE)
    a.label("out")
    a.mov_imm(R0, 0)
    a.exit()
    return a.assemble()
