"""Hand-assembled kernel flow datapath (no compiler required).

Builds a TC classifier that aggregates IPv4 AND IPv6 TCP/UDP/ICMP packets
into the `aggregated_flows` hash (same no_flow_key/no_flow_stats layout as
the C datapath, so the entire userspace pipeline runs unchanged on top):

    parse eth/IPv4/IPv6 -> flow key on the stack
    -> map lookup: hit  -> first-seen-interface-deduped accounting
                   miss -> BPF_NOEXIST insert, EEXIST-race re-merge,
                           ring-buffer fallback when the map is full

Feature parity with flowpath.c (each gated on the map fds the loader hands
in, the moral equivalent of the C datapath's `volatile const` config):

- IPv4 + IPv6 keys (v4-mapped addresses), TCP/UDP ports, ICMP/ICMPv6
  type+code, MAC addresses, DSCP, TCP-flag accumulation
- multi-interface dedup: bytes/packets counted only from the first-seen
  interface; (ifindex, direction) observation list with overflow counting
  (reference semantics: bpf/flows.c:100-142)
- DNS tracking: query timestamps stashed in `dns_inflight` under the
  reversed tuple + transaction id; responses correlate to a latency and
  upsert the per-CPU `flows_dns` feature record (reference:
  bpf/dns_tracker.h; C twin: bpf/dns.h in this repo)
- hashmap-failure fallback into the `direct_flows` ring buffer with
  errno_fallback recorded (reference: bpf/flows.c fallback path)
- global error/health counters (PERCPU_ARRAY, enum no_counter_key)
- optional 1/N sampling baked in at build time (the loader rebuilds per
  config)

Also covered: the in-kernel flow-filter gate (filter.h twin — LPM rule
lookup with the full predicate set, src-first/dst-retry, peer-CIDR check,
accept/reject/no-match counters) and handshake RTT (SYN→SYN|ACK correlation
into per-CPU flows_extra records).

Beyond flowpath.c/the reference: IPv4-options packets key their real ports
(fill_iphdr assumes ihl=5 and mis-reads them, utils.h:113-118) and IPv6
flows behind extension headers key the real transport via a bounded chain
walk (fill_ip6hdr keys the first next-header).

Concurrency (the C twin spin-locks, flowpath.c:44-107; spin locks need
BTF-described map values this path doesn't have, so it is LOCK-FREE with
the same guarantees): bytes/packets via atomic adds, tcp_flags via an
atomic OR on the containing aligned word (no lost bits), observed-intf
appends via atomic fetch-add slot reservation (no lost/torn entries; the
counter saturates near capacity instead of wrapping). The one plain store
is last_seen — racing writers both store ~now, correct to a packet's skew.
Residual benign race: the SAME new interface appending twice under a race
(dedup'd again at read-out). Per-packet trackers run on BOTH parse paths:
TCP flags everywhere, and the UDP payload probes (DNS, QUIC) read at the
fast path's constant offset or the slow path's dynamic CURSOR via
bpf_skb_load_bytes (`udp_trackers`) — IPv4-options/IPv6-ext flows are
fully feature-enriched except passive TLS, which needs the TCP doff walk
and stays fast-path-only. Validated by the live verifier, end-to-end veth
traffic tests, and a cross-CPU stress test (tests/test_asm_flowpath.py).

The port's copy of `netobserv_tpu/datapath/asm_flowpath.py`, kept so
that the port imports nothing of the JAX package; each function names
its original by line.
"""

from __future__ import annotations

from netobserv_tpu_torch.datapath.asm import (
    Asm, BPF_B, BPF_DW, BPF_H, BPF_W, HELPER_KTIME_GET_NS, HELPER_MAP_DELETE,
    HELPER_MAP_LOOKUP, HELPER_MAP_UPDATE, HELPER_RINGBUF_OUTPUT, R0, R1, R2,
    R3, R4, R5, R6, R7, R8, R9, R10,
)

# __sk_buff field offsets
SKB_LEN = 0
SKB_IFINDEX = 40
SKB_DATA = 76
SKB_DATA_END = 80

from netobserv_tpu_torch.model import binfmt


def _st(field: str) -> int:
    """no_flow_stats field offset, derived from the layout-pinned dtype so
    the assembled stores can never drift from records.h/binfmt.

    Reference: `netobserv_tpu/datapath/asm_flowpath.py:74`."""
    return binfmt.FLOW_STATS_DTYPE.fields[field][1]


def _ky(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_flowpath.py:80`."""
    return binfmt.FLOW_KEY_DTYPE.fields[field][1]


def _dr(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_flowpath.py:84`."""
    return binfmt.DNS_REC_DTYPE.fields[field][1]


def _xr(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_flowpath.py:88`."""
    return binfmt.EXTRA_REC_DTYPE.fields[field][1]


def _qr(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_flowpath.py:92`."""
    return binfmt.QUIC_REC_DTYPE.fields[field][1]


ST_FIRST = _st("first_seen_ns")
ST_LAST = _st("last_seen_ns")
ST_BYTES = _st("bytes")
ST_PACKETS = _st("packets")
ST_ETH = _st("eth_protocol")
ST_IFINDEX = _st("if_index_first")
ST_DIR = _st("direction_first")
ST_NOBS = _st("n_observed_intf")
ST_OBSDIR = _st("observed_direction")
ST_OBSIF = _st("observed_intf")
ST_FLAGS = _st("tcp_flags")
# atomic-OR staging: tcp_flags occupies memory bytes 2..3 of the 4-aligned
# word that starts at eth_protocol, so an atomic OR of `flags << _FLAGS_SHIFT`
# accumulates flag bits across CPUs without touching eth_protocol (which is
# only ever rewritten with the same value)
assert ST_FLAGS == ST_ETH + 2 and ST_ETH % 4 == 0
# slot-reservation staging: n_observed_intf is memory byte 3 of the
# 4-aligned word at direction_first, so an atomic fetch-add of
# `1 << _NOBS_SHIFT` hands each CPU an exclusive observed-list slot; the
# addend leaves the other three bytes (direction_first/errno_fallback/dscp)
# untouched
assert _st("n_observed_intf") == ST_DIR + 3 and ST_DIR % 4 == 0
# BPF programs execute in HOST byte order, so the staging shifts flip with
# endianness (the asm_flowpath twin of asm.py's _REGS_BYTE nibble flip): on
# little-endian, memory bytes 2..3 are the word's HIGH u16 and byte 3 its
# HIGH byte; on big-endian (s390x) both are the word's LOW bits, so the
# shifts collapse to 0 and the old-slot extraction masks instead of shifting.
# Big-endian bound: the LE counter harmlessly wraps out of the u32 at 256,
# while the BE low-byte counter would carry into dscp — unreachable in
# practice because the saturation-undo below keeps it ≤ capacity + the
# number of concurrently executing CPUs (≪ 255).
_FLAGS_SHIFT = 16 if __import__("sys").byteorder == "little" else 0
_NOBS_SHIFT = 24 if __import__("sys").byteorder == "little" else 0
ST_SRC_MAC = _st("src_mac")
ST_DST_MAC = _st("dst_mac")
ST_SAMPLING = _st("sampling")
ST_ERRNO = _st("errno_fallback")
ST_DSCP = _st("dscp")
KY_SRC_IP = _ky("src_ip")
KY_DST_IP = _ky("dst_ip")
KY_SPORT = _ky("src_port")
KY_DPORT = _ky("dst_port")
KY_PROTO = _ky("proto")
KY_ICMP_TYPE = _ky("icmp_type")
KY_ICMP_CODE = _ky("icmp_code")

HELPER_PRANDOM_U32 = 7

KEY_SIZE = binfmt.FLOW_KEY_DTYPE.itemsize        # 40
STATS_SIZE = binfmt.FLOW_STATS_DTYPE.itemsize    # 104
EVENT_SIZE = binfmt.FLOW_EVENT_DTYPE.itemsize    # 144
DNSREC_SIZE = binfmt.DNS_REC_DTYPE.itemsize      # 64

# stack layout (relative to r10, all 8-aligned). The flow event is laid out
# contiguously (key then stats, the no_flow_event wire layout) so the
# ring-buffer fallback can ship it with one helper call.
EV = -EVENT_SIZE          # -144: no_flow_event
KEY = EV                  # key at EV+0 (40B)
VAL = EV + KEY_SIZE       # stats at EV+40 (104B)
CORR = EV - 40            # -184: no_dns_corr_key (40B)
DNSREC = CORR - DNSREC_SIZE  # -248: no_dns_rec build slot
SPILL = DNSREC - 8        # -256: this packet's tcp flags
NOW = SPILL - 8           # -264: bpf_ktime_get_ns()
DNSMETA = NOW - 8         # -272: dns id (u16 @+0), flags (u16 @+2), seen (@+4)
LAT = DNSMETA - 8         # -280: dns latency (u64)
CTRKEY = LAT - 8          # -288: global-counter index (u32)
FKEY = CTRKEY - 24        # -312: no_filter_key (u32 prefix_len + 16B ip)
FACT = FKEY - 8           # -320: matched rule's action, saved across lookups
QMETA = FACT - 8          # -328: quic seen (u8 @+0), is_long (@+1), ver (@+4)
TLSBUF = QMETA - 16       # -344: TLS header bytes via bpf_skb_load_bytes
FSAMP = TLSBUF - 8        # -352: matched rule's sample override (u32)
FSKIP = FSAMP - 8         # -360: filter verdict says drop (reject/no-match)
CURSOR = FSKIP - 8        # -368: TLS extension-walk packet cursor
EXTREM = CURSOR - 8       # -376: remaining bytes in the extension list/ext
BESTV = EXTREM - 8        # -384: best supported_version seen (CH scan)
KNOWNF = BESTV - 8        # -392: best version is a known one (CH scan)

# extension-walk bound: the reference walks up to 30 extensions
# (tls_tracker.h); 16 covers real-world hellos at half the unrolled size
TLS_MAX_EXTS = 16

HELPER_SKB_LOAD_BYTES = 26

# no_dns_corr_key field offsets (bpf/maps.h struct no_dns_corr_key)
CK_SPORT, CK_DPORT, CK_SRC_IP, CK_DST_IP, CK_ID, CK_PROTO = 0, 2, 4, 20, 36, 38

DNS_QR_BIT = 0x8000

# enum no_counter_key (bpf/config.h) — must match model.flow.GlobalCounter
CTR_FAIL_UPDATE_FLOW = 0
CTR_FAIL_CREATE_FLOW = 1
CTR_FAIL_UPDATE_DNS = 2
CTR_FILTER_REJECT = 3
CTR_FILTER_ACCEPT = 4
CTR_FILTER_NOMATCH = 5
CTR_OBSERVED_INTF_MISSED = 12


def _fr(field: str) -> int:
    """Reference: `netobserv_tpu/datapath/asm_flowpath.py:194`."""
    return binfmt.FILTER_RULE_DTYPE.fields[field][1]


class _Flow:
    """Emitter for one build of the flow program (holds the option fds).

    Reference: `netobserv_tpu/datapath/asm_flowpath.py:198`."""

    def __init__(self, map_fd: int, direction: int, sampling: int,
                 ringbuf_fd, counters_fd, dns_inflight_fd, flows_dns_fd,
                 dns_port: int, rtt_inflight_fd=None, flows_extra_fd=None,
                 filter_rules_fd=None, filter_peers_fd=None,
                 flows_quic_fd=None, quic_mode: int = 0,
                 enable_tls: bool = False, sampling_gate_fd=None,
                 has_filter_sampling: bool = False):
        """Reference: `netobserv_tpu/datapath/asm_flowpath.py:201`."""
        self.a = Asm()
        self.map_fd = map_fd
        self.direction = direction
        self.sampling = sampling
        self.ringbuf_fd = ringbuf_fd
        self.counters_fd = counters_fd
        self.dns_inflight_fd = dns_inflight_fd
        self.flows_dns_fd = flows_dns_fd
        self.dns_port = dns_port
        self.rtt_inflight_fd = rtt_inflight_fd
        self.flows_extra_fd = flows_extra_fd
        self.filter_rules_fd = filter_rules_fd
        self.filter_peers_fd = filter_peers_fd
        self.flows_quic_fd = flows_quic_fd
        self.quic_mode = quic_mode
        self.enable_tls = enable_tls
        self.sampling_gate_fd = sampling_gate_fd
        # reference has_filter_sampling (flows.c:160-208): when any filter
        # rule carries a sample override, the 1/N gate moves to after the
        # filter so the matched rule's rate can replace the global one
        self.has_filter_sampling = (has_filter_sampling
                                    and filter_rules_fd is not None)
        self._ctr_n = 0

    def set_gate(self, value: int) -> None:
        """Record the per-CPU sampling decision for the aux kprobes
        (sampling_gate map; the C datapath's no_set_do_sampling twin).
        Clobbers r0-r3.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:232`."""
        a = self.a
        self._gate_n = getattr(self, "_gate_n", 0) + 1
        lbl = f"gate_done_{value}_{self._gate_n}"
        a.st_imm(BPF_W, R10, CTRKEY, 0)
        a.ld_map_fd(R1, self.sampling_gate_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, CTRKEY)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, lbl)
        a.st_imm(BPF_B, R0, 0, value)
        a.label(lbl)

    # --- helpers -----------------------------------------------------------
    def count(self, ctr: int) -> None:
        """Bump global_counters[ctr] (per-CPU slot; non-atomic is exact).
        Clobbers r0-r5 (embedded helper call); no-op when the counters map
        isn't wired.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:249`."""
        if self.counters_fd is None:
            return
        a = self.a
        lbl = f"ctr_done_{self._ctr_n}"
        self._ctr_n += 1
        a.st_imm(BPF_W, R10, CTRKEY, ctr)
        a.ld_map_fd(R1, self.counters_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, CTRKEY)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, lbl)
        a.ldx(BPF_DW, R3, R0, 0)
        a.alu_imm(0x07, R3, 1)
        a.stx(BPF_DW, R0, R3, 0)
        a.label(lbl)

    def classify_tcp_flags(self, tag: str) -> None:
        """Fold the synthetic composite bits into the raw flags byte in r3 —
        SYN_ACK/FIN_ACK/RST_ACK exactly like parse.h:93-102; feeds both the
        accumulated stats flags and the filter gate's tcp_flags predicate.
        Shared by the fast (constant-offset) and slow (cursor) parses.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:269`."""
        a = self.a
        for combo, bit in ((0x12, 0x100), (0x11, 0x200), (0x14, 0x400)):
            a.mov_reg(R4, R3)
            a.alu_imm(0x57, R4, combo)
            a.jmp_imm(0x55, R4, combo, f"cls_{tag}_{bit:x}")
            a.alu_imm(0x47, R3, bit)
            a.label(f"cls_{tag}_{bit:x}")

    def bounds(self, need: int, fail: str) -> None:
        """if data + need > data_end goto fail (r7=data, r8=data_end).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:282`."""
        a = self.a
        a.mov_reg(R2, R7)
        a.alu_imm(0x07, R2, need)
        a.jmp_reg(0x2D, R2, R8, fail)

    # --- program sections --------------------------------------------------
    def parse_l4(self, l4: int, v: str, icmp_proto: int) -> None:
        """TCP/UDP/ICMP parse with constant offsets (emitted per IP version
        so the verifier sees only constant packet offsets).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:290`."""
        a = self.a
        a.jmp_imm(0x15, R9, 6, f"tcp_{v}")
        a.jmp_imm(0x15, R9, 17, f"udp_{v}")
        a.jmp_imm(0x15, R9, 132, f"ports_{v}")  # SCTP: same port offsets
        a.jmp_imm(0x15, R9, icmp_proto, f"icmp_{v}")
        # other protocols: keyed on addresses+proto, no ports (the
        # reference's fill_l4info default — GRE/ESP/... flows still count)
        a.jmp("key_done")

        a.label(f"tcp_{v}")
        self.bounds(l4 + 14, f"ports_{v}")      # flags byte at l4+13
        a.ldx(BPF_B, R3, R7, l4 + 13)
        self.classify_tcp_flags(v)
        a.stx(BPF_DW, R10, R3, SPILL)
        if self.enable_tls:
            self.parse_tls(l4, v)
        a.jmp(f"ports_{v}")

        a.label(f"icmp_{v}")
        self.bounds(l4 + 2, "out")
        a.ldx(BPF_B, R3, R7, l4)                # icmp type
        a.stx(BPF_B, R10, R3, KEY + KY_ICMP_TYPE)
        a.ldx(BPF_B, R3, R7, l4 + 1)            # icmp code
        a.stx(BPF_B, R10, R3, KEY + KY_ICMP_CODE)
        a.jmp("key_done")

        a.label(f"udp_{v}")
        a.label(f"ports_{v}")
        self.bounds(l4 + 4, "out")
        a.ldx(BPF_H, R3, R7, l4)                # bswap16 to host order
        a.endian_be(R3, 16)
        a.stx(BPF_H, R10, R3, KEY + KY_SPORT)
        a.ldx(BPF_H, R3, R7, l4 + 2)
        a.endian_be(R3, 16)
        a.stx(BPF_H, R10, R3, KEY + KY_DPORT)
        self.udp_trackers(tag=v, payload_base=l4 + 8)
        a.jmp("key_done")

    def udp_trackers(self, tag: str, payload_base: int | None) -> None:
        """DNS-header + QUIC-invariant probes over the UDP payload — shared
        by the constant-offset fast path (`payload_base` = l4 + 8) and the
        IPv4-options/IPv6-ext slow paths (`payload_base=None`: the UDP
        header sits at the dynamic CURSOR stack slot), closing the r3 gap
        where slow-path flows skipped DNS/QUIC tracking. All payload reads
        go through bpf_skb_load_bytes: it takes a RUNTIME offset (no
        verifier constant needed) and reads frag-resident payload (UDP GSO)
        that direct packet pointers cannot reach. Expects r9 = transport
        protocol; only UDP(17) rows enter the probes.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:331`."""
        a = self.a

        def payload_addr(extra: int) -> None:
            """r2 = packet offset of UDP payload + extra."""
            if payload_base is not None:
                a.mov_imm(R2, payload_base + extra)
            else:
                a.ldx(BPF_DW, R2, R10, CURSOR)
                a.alu_imm(0x07, R2, 8 + extra)

        def load_payload(extra: int, n: int, fail: str) -> None:
            a.mov_reg(R1, R6)
            payload_addr(extra)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, TLSBUF)
            a.mov_imm(R4, n)
            a.call(HELPER_SKB_LOAD_BYTES)
            a.jmp_imm(0x55, R0, 0, fail)        # payload too short

        def ntohs_from_buf(off: int) -> None:
            """r3 = host-order u16 from two BE bytes at TLSBUF+off."""
            a.ldx(BPF_B, R3, R10, TLSBUF + off)
            a.alu_imm(0x67, R3, 8)
            a.ldx(BPF_B, R4, R10, TLSBUF + off + 1)
            a.alu_reg(0x4F, R3, R4)

        done = f"udp_trk_done_{tag}"
        if self.dns_inflight_fd is not None:
            # DNS header parse (UDP on the DNS port only)
            a.jmp_imm(0x55, R9, 17, "key_done")     # TCP: no UDP trackers
            a.ldx(BPF_H, R3, R10, KEY + KY_SPORT)
            a.jmp_imm(0x15, R3, self.dns_port, f"dns_hdr_{tag}")
            a.ldx(BPF_H, R3, R10, KEY + KY_DPORT)
            a.jmp_imm(0x55, R3, self.dns_port, f"dns_done_{tag}")
            a.label(f"dns_hdr_{tag}")
            load_payload(0, 12, f"dns_done_{tag}")  # full no_dns_hdr
            ntohs_from_buf(0)                       # transaction id
            a.stx(BPF_H, R10, R3, DNSMETA)
            ntohs_from_buf(2)                       # flags
            a.stx(BPF_H, R10, R3, DNSMETA + 2)
            a.st_imm(BPF_W, R10, DNSMETA + 4, 1)    # header seen
            # qname starts after the 12-byte header; the offset differs per
            # IP version/path, so stash it for the common dns_rec block
            # (TLSBUF+8 held header bytes 8..11, already consumed; QUIC's
            # 5-byte scratch and TLS's TCP-only use never collide)
            payload_addr(12)
            a.stx(BPF_W, R10, R2, TLSBUF + 8)
            a.label(f"dns_done_{tag}")
        if self.flows_quic_fd is not None and self.quic_mode:
            # QUIC invariants (quic.h / RFC 8999): fixed bit, long-header
            # version, short-header established marker.
            a.jmp_imm(0x55, R9, 17, "key_done")     # UDP only
            if self.quic_mode == 1:                 # only UDP/443
                a.ldx(BPF_H, R3, R10, KEY + KY_SPORT)
                a.jmp_imm(0x15, R3, 443, f"quic_port_ok_{tag}")
                a.ldx(BPF_H, R3, R10, KEY + KY_DPORT)
                a.jmp_imm(0x55, R3, 443, done)
                a.label(f"quic_port_ok_{tag}")
            load_payload(0, 5, done)                # first byte + version
            a.ldx(BPF_B, R3, R10, TLSBUF)
            a.jmp_imm(0x45, R3, 0x40, f"quic_fixed_{tag}")  # fixed bit?
            a.jmp(done)
            a.label(f"quic_fixed_{tag}")
            a.jmp_imm(0x45, R3, 0x80, f"quic_long_{tag}")   # long header?
            a.st_imm(BPF_B, R10, QMETA, 1)          # short: established
            a.jmp(done)
            a.label(f"quic_long_{tag}")
            a.mov_imm(R4, 0)                        # version: 4 BE bytes
            for i in range(4):
                a.alu_imm(0x67, R4, 8)
                a.ldx(BPF_B, R3, R10, TLSBUF + 1 + i)
                a.alu_reg(0x4F, R4, R3)
            a.jmp_imm(0x15, R4, 0, done)            # version negotiation
            a.stx(BPF_W, R10, R4, QMETA + 4)
            a.st_imm(BPF_B, R10, QMETA, 1)
            a.st_imm(BPF_B, R10, QMETA + 1, 1)      # long header seen
        a.label(done)

    def parse_tls(self, l4: int, v: str) -> None:
        """Passive TLS metadata from the TCP payload (tls.h twin): record
        -type bitmap, ClientHello/ServerHello hello version — including the
        TLS 1.3 extension walk (reference tls_tracker.h:60-210): the CH
        supported_versions list is scanned with known-over-unknown-then-
        higher preference, the SH yields the selected version and the
        key-share group — plus the ServerHello cipher suite. Stored into the
        stack stats (VAL) — the miss path inserts them as-built; the hit
        path merges them (version-mismatch flagging included). The unrolled
        walk visits up to TLS_MAX_EXTS extensions (reference: 30).

        Reads go through bpf_skb_load_bytes, NOT direct packet pointers:
        locally-generated TCP payload usually lives in skb page frags, where
        data_end covers only the linear headers and pointer-based reads see
        nothing (the classic non-linear-skb trap).

        Runs inside the TCP branch with r9 = proto(6); r9 is used as scratch
        and restored on every exit path.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:419`."""
        a = self.a
        t = f"tls_{v}"
        done = f"{t}_done"

        def load_bytes(off_reg_setup, dst_off: int, n: int) -> None:
            """bpf_skb_load_bytes(skb, r2=offset, r3=stack+dst_off, r4=n);
            jumps to `done` on failure (offset beyond the packet)."""
            a.mov_reg(R1, R6)
            off_reg_setup()                     # materialize r2 = offset
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, TLSBUF + dst_off)
            a.mov_imm(R4, n)
            a.call(HELPER_SKB_LOAD_BYTES)
            a.jmp_imm(0x55, R0, 0, done)

        # payload offset = l4 + doff; doff byte is always in the linear area
        a.ldx(BPF_B, R4, R7, l4 + 12)
        a.alu_imm(0x57, R4, 0xF0)
        a.alu_imm(0x77, R4, 2)
        a.jmp_imm(0xA5, R4, 20, done)           # doff < 20: not TCP
        a.mov_reg(R9, R4)
        a.alu_imm(0x07, R9, l4)                 # r9 = payload offset (kept)
        # payload-less segments (pure ACKs — the majority) skip the helper
        a.ldx(BPF_W, R3, R6, SKB_LEN)
        a.jmp_reg(0xBD, R3, R9, done)           # skb->len <= payload off

        # record header(5) + hs type(1) + len(3) + hello version(2) = 11
        load_bytes(lambda: a.mov_reg(R2, R9), 0, 11)
        a.ldx(BPF_B, R3, R10, TLSBUF + 1)       # record version hi byte
        a.jmp_imm(0x55, R3, 0x03, done)         # not SSL3.x: not TLS
        a.ldx(BPF_B, R3, R10, TLSBUF)           # record type
        for rec_type, bit in ((20, 0x01), (21, 0x02), (22, 0x04),
                              (23, 0x08), (24, 0x10)):
            a.jmp_imm(0x15, R3, rec_type, f"{t}_bit_{bit:x}")
        a.jmp(done)                             # unknown record type
        for rec_type, bit in ((20, 0x01), (21, 0x02), (22, 0x04),
                              (23, 0x08), (24, 0x10)):
            a.label(f"{t}_bit_{bit:x}")
            a.ldx(BPF_B, R3, R10, VAL + _st("tls_types"))
            a.alu_imm(0x47, R3, bit)
            a.stx(BPF_B, R10, R3, VAL + _st("tls_types"))
            if rec_type == 22:
                a.jmp(f"{t}_hs")                # handshake: parse the hello
            else:
                a.jmp(done)
        a.label(f"{t}_hs")
        a.ldx(BPF_B, R5, R10, TLSBUF + 5)       # handshake type
        a.jmp_imm(0x15, R5, 1, f"{t}_hello")    # ClientHello
        a.jmp_imm(0x55, R5, 2, done)            # not ServerHello either
        a.label(f"{t}_hello")
        a.ldx(BPF_B, R3, R10, TLSBUF + 9)       # legacy hello version (BE)
        a.alu_imm(0x67, R3, 8)
        a.ldx(BPF_B, R4, R10, TLSBUF + 10)
        a.alu_reg(0x4F, R3, R4)
        a.jmp_imm(0x15, R3, 0, f"{t}_sh")
        a.ldx(BPF_H, R4, R10, VAL + _st("ssl_version"))
        a.jmp_imm(0x55, R4, 0, f"{t}_sh")       # first hello version wins
        a.stx(BPF_H, R10, R3, VAL + _st("ssl_version"))
        def cur_load(delta: int, dst_off: int, n: int) -> None:
            """bpf_skb_load_bytes at CURSOR+delta into TLSBUF+dst_off."""
            a.mov_reg(R1, R6)
            a.ldx(BPF_DW, R2, R10, CURSOR)
            if delta:
                a.alu_imm(0x07, R2, delta)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, TLSBUF + dst_off)
            a.mov_imm(R4, n)
            a.call(HELPER_SKB_LOAD_BYTES)
            a.jmp_imm(0x55, R0, 0, done)

        def ntohs_at(off: int, dst: int) -> None:
            """dst = big-endian u16 at TLSBUF+off (byte loads: no bswap)."""
            a.ldx(BPF_B, dst, R10, off)
            a.alu_imm(0x67, dst, 8)
            a.ldx(BPF_B, R4, R10, off + 1)
            a.alu_reg(0x4F, dst, R4)

        def ext_hdr_and_type() -> None:
            """Read the 4B extension header at CURSOR; r3=type, r4=len."""
            cur_load(0, 0, 4)
            ntohs_at(TLSBUF, R3)
            a.mov_reg(R5, R3)                   # keep type; r4 next
            ntohs_at(TLSBUF + 2, R3)
            a.mov_reg(R4, R3)                   # r4 = len
            a.mov_reg(R3, R5)                   # r3 = type

        def ext_advance(i: int, walk: str, end: str) -> None:
            """CURSOR/EXTREM += one extension; jump to `end` when the list
            is exhausted; fall through to the next iteration label."""
            a.label(f"{t}_{walk}_{i}_adv")
            ntohs_at(TLSBUF + 2, R3)            # re-derive len (regs free)
            a.mov_reg(R4, R3)
            a.alu_imm(0x07, R4, 4)              # step = 4 + len
            a.ldx(BPF_DW, R3, R10, EXTREM)
            a.jmp_reg(0x3D, R4, R3, end)        # step >= remaining: done
            a.alu_reg(0x1F, R3, R4)             # remaining -= step
            a.stx(BPF_DW, R10, R3, EXTREM)
            a.ldx(BPF_DW, R3, R10, CURSOR)
            a.alu_reg(0x0F, R3, R4)
            a.stx(BPF_DW, R10, R3, CURSOR)

        a.label(f"{t}_sh")
        a.jmp_imm(0x15, R5, 2, f"{t}_srv")      # ServerHello: cipher + exts
        # --- ClientHello: 1.2 vs 1.3 via supported_versions (tls.h twin) ---
        a.ldx(BPF_H, R3, R10, VAL + _st("ssl_version"))
        a.jmp_imm(0x55, R3, 0x0303, done)       # only 0x0303 is ambiguous
        a.mov_reg(R3, R9)
        a.alu_imm(0x07, R3, 43)                 # session-id length byte
        a.stx(BPF_DW, R10, R3, CURSOR)
        cur_load(0, 0, 1)
        a.ldx(BPF_B, R3, R10, TLSBUF)
        a.alu_imm(0x07, R3, 1)
        a.ldx(BPF_DW, R4, R10, CURSOR)
        a.alu_reg(0x0F, R4, R3)
        a.stx(BPF_DW, R10, R4, CURSOR)          # += 1 + sid_len
        cur_load(0, 0, 2)                       # cipher-suites list length
        ntohs_at(TLSBUF, R3)
        a.alu_imm(0x07, R3, 2)
        a.ldx(BPF_DW, R4, R10, CURSOR)
        a.alu_reg(0x0F, R4, R3)
        a.stx(BPF_DW, R10, R4, CURSOR)          # += 2 + cipher_len
        cur_load(0, 0, 1)                       # compression list length
        a.ldx(BPF_B, R3, R10, TLSBUF)
        a.alu_imm(0x07, R3, 1)
        a.ldx(BPF_DW, R4, R10, CURSOR)
        a.alu_reg(0x0F, R4, R3)
        a.stx(BPF_DW, R10, R4, CURSOR)          # += 1 + compr_len
        cur_load(0, 0, 2)                       # extensions total length
        ntohs_at(TLSBUF, R3)
        a.stx(BPF_DW, R10, R3, EXTREM)
        a.ldx(BPF_DW, R4, R10, CURSOR)
        a.alu_imm(0x07, R4, 2)
        a.stx(BPF_DW, R10, R4, CURSOR)          # -> first extension header
        a.st_imm(BPF_DW, R10, BESTV, 0)
        a.st_imm(BPF_DW, R10, KNOWNF, 0)
        for i in range(TLS_MAX_EXTS):
            a.label(f"{t}_che_{i}")
            a.ldx(BPF_DW, R3, R10, EXTREM)
            a.jmp_imm(0xA5, R3, 4, done)        # no room for a header
            ext_hdr_and_type()
            a.jmp_imm(0x15, R3, 0x002B, f"{t}_chsv")
            ext_advance(i, "che", done)
        a.jmp(done)
        # supported_versions list: <=5 versions, favor known then higher
        # (IS_KNOWN_VERSION_EXT semantics, tls_tracker.h:112-120)
        a.label(f"{t}_chsv")
        a.stx(BPF_DW, R10, R4, EXTREM)          # reuse: bytes in this ext
        for j in range(5):
            a.label(f"{t}_chv_{j}")
            a.ldx(BPF_DW, R3, R10, EXTREM)
            a.jmp_imm(0xA5, R3, 3 + 2 * j, f"{t}_chv_end")
            cur_load(4 + 1 + 2 * j, 4, 2)       # skip hdr(4) + list len(1)
            ntohs_at(TLSBUF + 4, R3)
            a.mov_imm(R4, 0)
            a.jmp_imm(0xA5, R3, 0x0300, f"{t}_chv{j}_k")
            a.jmp_imm(0x25, R3, 0x0304, f"{t}_chv{j}_k")
            a.mov_imm(R4, 1)                    # 0x0300..0x0304: known
            a.label(f"{t}_chv{j}_k")
            nxt = f"{t}_chv_{j + 1}" if j < 4 else f"{t}_chv_end"
            a.ldx(BPF_DW, R5, R10, KNOWNF)
            a.jmp_reg(0x1D, R5, R4, f"{t}_chv{j}_same")
            a.jmp_imm(0x15, R4, 1, f"{t}_chv{j}_take")  # known beats unknown
            a.jmp(nxt)
            a.label(f"{t}_chv{j}_same")
            a.ldx(BPF_DW, R5, R10, BESTV)
            a.jmp_reg(0xBD, R3, R5, nxt)        # JLE: not higher -> skip
            a.label(f"{t}_chv{j}_take")
            a.stx(BPF_DW, R10, R3, BESTV)
            a.stx(BPF_DW, R10, R4, KNOWNF)
        a.label(f"{t}_chv_end")
        a.ldx(BPF_DW, R3, R10, BESTV)
        a.jmp_imm(0x15, R3, 0, done)            # empty list: keep legacy
        a.stx(BPF_H, R10, R3, VAL + _st("ssl_version"))
        a.jmp(done)

        # --- ServerHello: cipher suite, then supported_versions/key_share --
        a.label(f"{t}_srv")
        # session id length at payload+43 (5 rec + 4 hs + 2 ver + 32 random)
        load_bytes(lambda: (a.mov_reg(R2, R9), a.alu_imm(0x07, R2, 43)),
                   11, 1)
        a.ldx(BPF_B, R5, R10, TLSBUF + 11)
        a.jmp_imm(0x25, R5, 32, done)           # sid_len > 32: implausible
        # CURSOR -> cipher suite (payload + 44 + sid_len); r1-r5 die at
        # every helper call, so the offset lives on the stack from here on
        a.mov_reg(R3, R9)
        a.alu_reg(0x0F, R3, R5)
        a.alu_imm(0x07, R3, 44)
        a.stx(BPF_DW, R10, R3, CURSOR)
        cur_load(0, 12, 2)
        ntohs_at(TLSBUF + 12, R3)
        a.stx(BPF_H, R10, R3, VAL + _st("tls_cipher_suite"))
        a.ldx(BPF_H, R3, R10, VAL + _st("ssl_version"))
        a.jmp_imm(0x55, R3, 0x0303, done)       # exts only disambiguate 1.3
        # layout after cipher: compression(1) + exts_len(2) + extensions
        cur_load(3, 0, 2)
        ntohs_at(TLSBUF, R3)
        a.stx(BPF_DW, R10, R3, EXTREM)
        a.ldx(BPF_DW, R4, R10, CURSOR)
        a.alu_imm(0x07, R4, 5)
        a.stx(BPF_DW, R10, R4, CURSOR)          # first extension header
        for i in range(TLS_MAX_EXTS):
            a.label(f"{t}_she_{i}")
            a.ldx(BPF_DW, R3, R10, EXTREM)
            a.jmp_imm(0xA5, R3, 4, done)
            ext_hdr_and_type()
            a.jmp_imm(0x15, R3, 0x002B, f"{t}_she_{i}_sv")
            a.jmp_imm(0x15, R3, 0x0033, f"{t}_she_{i}_ks")
            a.jmp(f"{t}_she_{i}_adv")
            a.label(f"{t}_she_{i}_sv")          # the selected 1.3 version
            a.jmp_imm(0xA5, R4, 2, f"{t}_she_{i}_adv")
            cur_load(4, 4, 2)
            ntohs_at(TLSBUF + 4, R3)
            a.stx(BPF_H, R10, R3, VAL + _st("ssl_version"))
            a.jmp(f"{t}_she_{i}_adv")
            a.label(f"{t}_she_{i}_ks")          # key-share group
            a.jmp_imm(0xA5, R4, 2, f"{t}_she_{i}_adv")
            cur_load(4, 4, 2)
            ntohs_at(TLSBUF + 4, R3)
            a.stx(BPF_H, R10, R3, VAL + _st("tls_key_share"))
            ext_advance(i, "she", done)
        a.label(done)
        a.mov_imm(R9, 6)                        # restore proto for the
        # shared ports/tracker gates downstream

    def slow_l4(self, v: str, icmp_proto: int) -> None:
        """L4 key fields at a DYNAMIC offset (stack slot CURSOR) via
        bpf_skb_load_bytes — used by the IPv4-options and IPv6-extension
        slow paths, where the L4 offset isn't a verifier-visible constant.
        Ports/ICMP + TCP FLAGS (into SPILL, so flag accumulation, the
        filter's tcp_flags predicate, and handshake-RTT stamping all work
        for slow-path TCP flows too), plus the UDP payload trackers
        (DNS/QUIC via the shared `udp_trackers`, reading at CURSOR+8);
        only passive TLS stays fast-path-only (it needs the TCP doff
        walk). r9 = final transport protocol. Truncated packets keep the
        address+proto key (reference behavior: fill_l4info leaves ports
        zero when the header doesn't fit).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:661`."""
        a = self.a
        t = f"slow_{v}"

        def load_at_cursor(n: int) -> None:
            a.mov_reg(R1, R6)
            a.ldx(BPF_DW, R2, R10, CURSOR)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, TLSBUF)
            a.mov_imm(R4, n)
            a.call(HELPER_SKB_LOAD_BYTES)
            a.jmp_imm(0x55, R0, 0, "key_done")

        def ports_from_tlsbuf() -> None:
            a.ldx(BPF_B, R3, R10, TLSBUF)
            a.alu_imm(0x67, R3, 8)
            a.ldx(BPF_B, R4, R10, TLSBUF + 1)
            a.alu_reg(0x4F, R3, R4)
            a.stx(BPF_H, R10, R3, KEY + KY_SPORT)
            a.ldx(BPF_B, R3, R10, TLSBUF + 2)
            a.alu_imm(0x67, R3, 8)
            a.ldx(BPF_B, R4, R10, TLSBUF + 3)
            a.alu_reg(0x4F, R3, R4)
            a.stx(BPF_H, R10, R3, KEY + KY_DPORT)

        a.jmp_imm(0x15, R9, 6, f"{t}_t")
        a.jmp_imm(0x15, R9, 17, f"{t}_p")
        a.jmp_imm(0x15, R9, 132, f"{t}_p")
        a.jmp_imm(0x15, R9, icmp_proto, f"{t}_i")
        a.jmp("key_done")
        a.label(f"{t}_t")
        # TCP: ports + the flags byte (tcphdr+13), composite-classified
        # exactly like the fast path
        load_at_cursor(14)
        ports_from_tlsbuf()
        a.ldx(BPF_B, R3, R10, TLSBUF + 13)
        self.classify_tcp_flags(t)
        a.stx(BPF_DW, R10, R3, SPILL)
        a.jmp("key_done")
        a.label(f"{t}_p")
        load_at_cursor(4)
        ports_from_tlsbuf()
        # UDP payload trackers (DNS/QUIC) at the DYNAMIC offset: the UDP
        # header sits at CURSOR, so slow-path flows get the same feature
        # enrichment as the fast path (r3 gap closed; TLS stays fast-path
        # -only — its parse needs the TCP doff walk)
        self.udp_trackers(tag=t, payload_base=None)
        a.jmp("key_done")
        a.label(f"{t}_i")
        load_at_cursor(2)
        a.ldx(BPF_B, R3, R10, TLSBUF)
        a.stx(BPF_B, R10, R3, KEY + KY_ICMP_TYPE)
        a.ldx(BPF_B, R3, R10, TLSBUF + 1)
        a.stx(BPF_B, R10, R3, KEY + KY_ICMP_CODE)
        a.jmp("key_done")

    def copy_ip16(self, pkt_off: int, key_off: int) -> None:
        """Copy a 16-byte address from the packet to the key (word chunks:
        stack DW stores would be misaligned at these offsets).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:728`."""
        a = self.a
        for i in range(0, 16, 4):
            a.ldx(BPF_W, R3, R7, pkt_off + i)
            a.stx(BPF_W, R10, R3, key_off + i)

    def corr_key(self, reverse: bool) -> None:
        """Build no_dns_corr_key at CORR from the flow key on the stack.
        reverse=True swaps src/dst (query side: the response's own tuple
        must produce this key).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:736`."""
        a = self.a
        sp, dp = (KY_DPORT, KY_SPORT) if reverse else (KY_SPORT, KY_DPORT)
        si, di = (KY_DST_IP, KY_SRC_IP) if reverse else (KY_SRC_IP, KY_DST_IP)
        for off in range(CORR, CORR + 40, 8):
            a.st_imm(BPF_DW, R10, off, 0)
        a.ldx(BPF_H, R4, R10, KEY + sp)
        a.stx(BPF_H, R10, R4, CORR + CK_SPORT)
        a.ldx(BPF_H, R4, R10, KEY + dp)
        a.stx(BPF_H, R10, R4, CORR + CK_DPORT)
        for i in range(0, 16, 4):
            a.ldx(BPF_W, R4, R10, KEY + si + i)
            a.stx(BPF_W, R10, R4, CORR + CK_SRC_IP + i)
            a.ldx(BPF_W, R4, R10, KEY + di + i)
            a.stx(BPF_W, R10, R4, CORR + CK_DST_IP + i)
        a.ldx(BPF_H, R4, R10, DNSMETA)
        a.stx(BPF_H, R10, R4, CORR + CK_ID)
        a.ldx(BPF_B, R4, R10, KEY + KY_PROTO)
        a.stx(BPF_B, R10, R4, CORR + CK_PROTO)

    def stamp(self, fd: int) -> None:
        """rtt/dns shared half: record NOW in `fd` under the REVERSED tuple
        (the reply's own tuple will produce this key). Falls through with the
        update result in r0 for callers that count failures.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:759`."""
        a = self.a
        self.corr_key(reverse=True)
        a.ld_map_fd(R1, fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, CORR)
        a.mov_reg(R3, R10)
        a.alu_imm(0x07, R3, NOW)
        a.mov_imm(R4, 0)                        # BPF_ANY
        a.call(HELPER_MAP_UPDATE)

    def measure(self, fd: int, done: str, tag: str) -> None:
        """rtt/dns shared half: correlate the reply's own tuple against the
        stamp in `fd`, leave (NOW - stamp) in the LAT slot when the clocks
        agree, delete the stamp, and fall through to `done`.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:773`."""
        a = self.a
        self.corr_key(reverse=False)
        a.ld_map_fd(R1, fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, CORR)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, done)
        a.ldx(BPF_DW, R3, R0, 0)                # stamp_ns
        a.ldx(BPF_DW, R4, R10, NOW)
        a.jmp_reg(0xBD, R4, R3, f"{tag}_del")   # now <= stamp: clock skew
        a.alu_reg(0x1F, R4, R3)                 # r4 = now - stamp
        a.stx(BPF_DW, R10, R4, LAT)
        a.label(f"{tag}_del")
        a.ld_map_fd(R1, fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, CORR)
        a.call(HELPER_MAP_DELETE)

    def filter_key(self, ip_off: int) -> None:
        """Build no_filter_key at FKEY (prefix_len=128 + one key address).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:795`."""
        a = self.a
        a.st_imm(BPF_W, R10, FKEY, 128)
        for i in range(0, 16, 4):
            a.ldx(BPF_W, R3, R10, KEY + ip_off + i)
            a.stx(BPF_W, R10, R3, FKEY + 4 + i)

    def port_pred(self, port_off: int, base: str, fail: str, tag: str) -> None:
        """One side's port predicate vs the rule in r0 (filter.h
        no_port_pred_ok): range [start,end] when set, then 1-2 exact ports
        when set. `base` in {dport, sport}.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:803`."""
        a = self.a
        a.ldx(BPF_H, R9, R10, KEY + port_off)
        a.ldx(BPF_H, R3, R0, _fr(f"{base}_start"))
        a.ldx(BPF_H, R4, R0, _fr(f"{base}_end"))
        a.mov_reg(R5, R3)
        a.alu_reg(0x4F, R5, R4)
        a.jmp_imm(0x15, R5, 0, f"{tag}_norange")
        a.jmp_reg(0xAD, R9, R3, fail)           # port < start
        a.jmp_reg(0x2D, R9, R4, fail)           # port > end
        a.label(f"{tag}_norange")
        a.ldx(BPF_H, R3, R0, _fr(f"{base}1"))
        a.ldx(BPF_H, R4, R0, _fr(f"{base}2"))
        a.mov_reg(R5, R3)
        a.alu_reg(0x4F, R5, R4)
        a.jmp_imm(0x15, R5, 0, f"{tag}_ok")
        a.jmp_reg(0x1D, R9, R3, f"{tag}_ok")    # == p1
        a.jmp_reg(0x5D, R9, R4, fail)           # != p2 either
        a.label(f"{tag}_ok")

    def filter_side(self, side: str, keyed_ip: int, peer_ip: int,
                    fail: str) -> None:
        """One evaluation of filter.h's no_filter_try: LPM rule lookup on
        `keyed_ip`, all predicates, optional peer-CIDR check, then verdict.
        Jumps to `fail` when this side produced no usable match (-1 in C).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:826`."""
        a = self.a
        t = f"flt_{side}"
        if self.has_filter_sampling:
            # reset per-side: a predicates-pass match that then fails the
            # peer-CIDR check must not leak its sample_override into the
            # retry/no-match sampling decision
            a.st_imm(BPF_DW, R10, FSAMP, 0)
        self.filter_key(keyed_ip)
        a.ld_map_fd(R1, self.filter_rules_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, FKEY)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, fail)
        # r0 = rule; predicates (no helper calls until the peer check)
        a.ldx(BPF_B, R3, R0, _fr("proto"))
        a.jmp_imm(0x15, R3, 0, f"{t}_proto_ok")
        a.ldx(BPF_B, R4, R10, KEY + KY_PROTO)
        a.jmp_reg(0x5D, R3, R4, fail)
        a.label(f"{t}_proto_ok")
        a.ldx(BPF_B, R3, R0, _fr("direction"))
        a.jmp_imm(0x15, R3, 255, f"{t}_dir_ok")
        a.jmp_imm(0x55, R3, self.direction, fail)
        a.label(f"{t}_dir_ok")
        self.port_pred(KY_DPORT, "dport", fail, f"{t}_dp")
        self.port_pred(KY_SPORT, "sport", fail, f"{t}_sp")
        # either-direction range: sp in [start,end] OR dp in [start,end]
        a.ldx(BPF_H, R3, R0, _fr("port_start"))
        a.ldx(BPF_H, R4, R0, _fr("port_end"))
        a.mov_reg(R5, R3)
        a.alu_reg(0x4F, R5, R4)
        a.jmp_imm(0x15, R5, 0, f"{t}_norange")
        a.ldx(BPF_H, R9, R10, KEY + KY_SPORT)
        a.jmp_reg(0xAD, R9, R3, f"{t}_try_dp")  # sp < start
        a.jmp_reg(0xBD, R9, R4, f"{t}_range_ok")  # sp <= end
        a.label(f"{t}_try_dp")
        a.ldx(BPF_H, R9, R10, KEY + KY_DPORT)
        a.jmp_reg(0xAD, R9, R3, fail)
        a.jmp_reg(0x2D, R9, R4, fail)
        a.label(f"{t}_range_ok")
        a.label(f"{t}_norange")
        # either-direction exact ports: any of sp/dp == p1/p2
        a.ldx(BPF_H, R3, R0, _fr("port1"))
        a.ldx(BPF_H, R4, R0, _fr("port2"))
        a.mov_reg(R5, R3)
        a.alu_reg(0x4F, R5, R4)
        a.jmp_imm(0x15, R5, 0, f"{t}_ports_ok")
        a.ldx(BPF_H, R9, R10, KEY + KY_SPORT)
        a.jmp_reg(0x1D, R9, R3, f"{t}_ports_ok")
        a.jmp_reg(0x1D, R9, R4, f"{t}_ports_ok")
        a.ldx(BPF_H, R9, R10, KEY + KY_DPORT)
        a.jmp_reg(0x1D, R9, R3, f"{t}_ports_ok")
        a.jmp_reg(0x5D, R9, R4, fail)
        a.label(f"{t}_ports_ok")
        a.ldx(BPF_B, R3, R0, _fr("icmp_type"))
        a.jmp_imm(0x15, R3, 0, f"{t}_it_ok")
        a.ldx(BPF_B, R4, R10, KEY + KY_ICMP_TYPE)
        a.jmp_reg(0x5D, R3, R4, fail)
        a.label(f"{t}_it_ok")
        a.ldx(BPF_B, R3, R0, _fr("icmp_code"))
        a.jmp_imm(0x15, R3, 0, f"{t}_ic_ok")
        a.ldx(BPF_B, R4, R10, KEY + KY_ICMP_CODE)
        a.jmp_reg(0x5D, R3, R4, fail)
        a.label(f"{t}_ic_ok")
        a.ldx(BPF_H, R3, R0, _fr("tcp_flags"))
        a.jmp_imm(0x15, R3, 0, f"{t}_tf_ok")
        a.ldx(BPF_DW, R4, R10, SPILL)
        a.alu_reg(0x5F, R4, R3)                 # r4 &= rule flags
        a.jmp_imm(0x15, R4, 0, fail)
        a.label(f"{t}_tf_ok")
        a.ldx(BPF_B, R3, R0, _fr("want_drops"))
        a.jmp_imm(0x55, R3, 0, fail)            # TC path is never drops
        # predicates hold; save the verdict before any further lookup
        a.ldx(BPF_B, R3, R0, _fr("action"))
        a.stx(BPF_DW, R10, R3, FACT)
        if self.has_filter_sampling:
            a.ldx(BPF_W, R3, R0, _fr("sample_override"))
            a.stx(BPF_W, R10, R3, FSAMP)
        a.ldx(BPF_B, R3, R0, _fr("peer_cidr_check"))
        a.jmp_imm(0x15, R3, 0, f"{t}_verdict")
        self.filter_key(peer_ip)
        a.ld_map_fd(R1, self.filter_peers_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, FKEY)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, fail)            # peer outside CIDR: retry
        a.label(f"{t}_verdict")
        a.ldx(BPF_DW, R3, R10, FACT)
        a.jmp_imm(0x15, R3, 1, "flt_reject")    # NO_FILTER_REJECT
        self.count(CTR_FILTER_ACCEPT)
        a.jmp("flt_done")

    def filter_block(self) -> None:
        """filter.h no_flow_filter: source CIDR first, dst CIDR retry, then
        reject-on-no-match. With has_filter_sampling, the 1/N gate runs here
        instead of at entry, using the matched rule's `sample_override` (else
        the global rate) — and, matching the reference, the aux-probe gate is
        set from that decision even for packets the verdict then drops.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:922`."""
        a = self.a
        self.filter_side("src", KY_SRC_IP, KY_DST_IP, fail="flt_dst")
        a.label("flt_dst")
        self.filter_side("dst", KY_DST_IP, KY_SRC_IP, fail="flt_nomatch")
        a.label("flt_nomatch")
        self.count(CTR_FILTER_NOMATCH)
        if self.has_filter_sampling:
            a.st_imm(BPF_DW, R10, FSKIP, 1)
            a.jmp("flt_sample")
        else:
            a.jmp("out")        # rules configured but none matched
        a.label("flt_reject")
        self.count(CTR_FILTER_REJECT)
        if self.has_filter_sampling:
            a.st_imm(BPF_DW, R10, FSKIP, 1)
            a.jmp("flt_sample")
        else:
            a.jmp("out")
        a.label("flt_done")
        if self.has_filter_sampling:
            a.label("flt_sample")
            # effective rate: the matched rule's override, else the global
            a.ldx(BPF_W, R9, R10, FSAMP)
            a.jmp_imm(0x55, R9, 0, "fs_have")
            a.mov_imm(R9, self.sampling)
            a.label("fs_have")
            a.stx(BPF_W, R10, R9, VAL + ST_SAMPLING)
            a.jmp_imm(0x25, R9, 1, "fs_gate")   # JGT: rate > 1 -> 1/N
            if self.sampling_gate_fd is not None:
                self.set_gate(1)
            a.jmp("fs_skipchk")
            a.label("fs_gate")
            a.call(HELPER_PRANDOM_U32)
            a.alu_reg(0x9F, R0, R9)             # r0 %= rate (ALU64 MOD X)
            a.jmp_imm(0x15, R0, 0, "fs_sampled")
            if self.sampling_gate_fd is not None:
                self.set_gate(0)
            a.jmp("out")                        # not the sampled 1/N
            a.label("fs_sampled")
            if self.sampling_gate_fd is not None:
                self.set_gate(1)
            a.label("fs_skipchk")
            a.ldx(BPF_DW, R3, R10, FSKIP)
            a.jmp_imm(0x55, R3, 0, "out")       # verdict said drop

    def build(self) -> bytes:
        """entry/parse/filter head + the flow-aggregation tail.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:973`."""
        self.emit_head()
        self.emit_tail()
        a = self.a
        a.label("out")
        a.mov_imm(R0, 0)                        # TC_ACT_OK
        a.exit()
        return a.assemble()

    def emit_head(self) -> None:
        """Everything up to a built+filtered flow key: sampling gate, parse
        (key/MACs/DSCP/flags + enabled tracker header parses), and the flow
        -filter gate. Falls through with the key at KEY and per-packet
        tracker metadata on the stack; unparseable/filtered packets jumped
        to \"out\" (the caller emits that label).

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:983`."""
        a = self.a
        a.mov_reg(R6, R1)                       # r6 = ctx

        if self.sampling > 1 and not self.has_filter_sampling:
            # 1/N gate, baked in at build time (loader-rewritten-const analog)
            a.call(HELPER_PRANDOM_U32)
            a.alu_imm(0x97, R0, self.sampling)  # r0 %= N (ALU64 MOD K)
            if self.sampling_gate_fd is not None:
                a.jmp_imm(0x55, R0, 0, "unsampled")
                self.set_gate(1)
                a.jmp("sampled")
                a.label("unsampled")
                self.set_gate(0)
                a.jmp("out")
                a.label("sampled")
            else:
                a.jmp_imm(0x55, R0, 0, "out")   # not the sampled 1/N: out

        a.call(HELPER_KTIME_GET_NS)
        a.stx(BPF_DW, R10, R0, NOW)

        a.ldx(BPF_W, R7, R6, SKB_DATA)          # r7 = data
        a.ldx(BPF_W, R8, R6, SKB_DATA_END)      # r8 = data_end
        self.bounds(14, "out")

        # zero the event + scratch slots
        for off in range(EV, EV + EVENT_SIZE, 8):
            a.st_imm(BPF_DW, R10, off, 0)
        a.st_imm(BPF_DW, R10, SPILL, 0)
        a.st_imm(BPF_DW, R10, DNSMETA, 0)
        a.st_imm(BPF_DW, R10, LAT, 0)
        a.st_imm(BPF_DW, R10, QMETA, 0)

        # MACs: frame dst at 0..5, src at 6..11 (stats carry the packet's)
        a.ldx(BPF_W, R3, R7, 6)
        a.stx(BPF_W, R10, R3, VAL + ST_SRC_MAC)
        a.ldx(BPF_H, R3, R7, 10)
        a.stx(BPF_H, R10, R3, VAL + ST_SRC_MAC + 4)
        # dst_mac lands on a 2-aligned stack offset: half-word stores only
        for i in range(0, 6, 2):
            a.ldx(BPF_H, R3, R7, i)
            a.stx(BPF_H, R10, R3, VAL + ST_DST_MAC + i)

        a.ldx(BPF_H, R3, R7, 12)                # ethertype (LE view of BE)
        a.jmp_imm(0x15, R3, 0x0008, "v4")
        a.jmp_imm(0x15, R3, 0xDD86, "v6")
        a.jmp("out")

        # --- IPv4 ---------------------------------------------------------
        a.label("v4")
        self.bounds(38, "out")                  # eth+ip20+l4 first 4 bytes

        def v4_l3() -> None:
            """DSCP/proto/addresses — all within the fixed 20-byte header."""
            a.ldx(BPF_B, R3, R7, 15)            # TOS -> dscp
            a.alu_imm(0x77, R3, 2)
            a.stx(BPF_B, R10, R3, VAL + ST_DSCP)
            a.ldx(BPF_B, R9, R7, 23)            # protocol
            a.stx(BPF_B, R10, R9, KEY + KY_PROTO)
            # v4-mapped addresses: ::ffff prefix + 4 address bytes
            a.st_imm(BPF_H, R10, KEY + KY_SRC_IP + 10, 0xFFFF)
            a.ldx(BPF_W, R3, R7, 26)            # saddr (BE bytes as-is)
            a.stx(BPF_W, R10, R3, KEY + KY_SRC_IP + 12)
            a.st_imm(BPF_H, R10, KEY + KY_DST_IP + 10, 0xFFFF)
            a.ldx(BPF_W, R3, R7, 30)            # daddr
            a.stx(BPF_W, R10, R3, KEY + KY_DST_IP + 12)
            a.st_imm(BPF_H, R10, VAL + ST_ETH, 0x0800)
            # non-first fragments carry no L4 header: keep the addrs+proto
            # key, never read payload bytes as ports (the reference doesn't
            # check frag_off and mis-keys these). LE halfword view of the
            # BE flags/fragment-offset field: 0xFF1F covers the 13 offset
            # bits and excludes MF/DF, so first fragments still parse ports
            a.ldx(BPF_H, R3, R7, 20)
            a.alu_imm(0x57, R3, 0xFF1F)
            a.jmp_imm(0x55, R3, 0, "key_done")

        a.ldx(BPF_B, R3, R7, 14)                # version/ihl
        a.jmp_imm(0x15, R3, 0x45, "v4_std")
        # IP options present: the reference mis-parses these (fill_iphdr
        # assumes ihl=5, utils.h:113-118); here the L4 offset is computed
        # from ihl and the ports read via bpf_skb_load_bytes
        a.mov_reg(R4, R3)
        a.alu_imm(0x77, R4, 4)
        a.jmp_imm(0x55, R4, 4, "out")           # not IPv4: drop
        a.alu_imm(0x57, R3, 0x0F)
        a.jmp_imm(0xA5, R3, 5, "out")           # ihl < 5: malformed
        a.alu_imm(0x27, R3, 4)
        a.alu_imm(0x07, R3, 14)
        a.stx(BPF_DW, R10, R3, CURSOR)          # dynamic L4 offset
        v4_l3()
        self.slow_l4("v4", icmp_proto=1)

        a.label("v4_std")
        v4_l3()
        self.parse_l4(l4=34, v="v4", icmp_proto=1)

        # --- IPv6 ---------------------------------------------------------
        a.label("v6")
        self.bounds(54, "out")                  # eth + fixed v6 header
        # traffic class = low nibble of byte14 ++ high nibble of byte15;
        # dscp = tc >> 2
        a.ldx(BPF_B, R3, R7, 14)
        a.alu_imm(0x57, R3, 0x0F)
        a.alu_imm(0x67, R3, 2)
        a.ldx(BPF_B, R4, R7, 15)
        a.alu_imm(0x77, R4, 6)
        a.alu_reg(0x4F, R3, R4)
        a.stx(BPF_B, R10, R3, VAL + ST_DSCP)
        self.copy_ip16(22, KEY + KY_SRC_IP)
        self.copy_ip16(38, KEY + KY_DST_IP)
        a.st_imm(BPF_H, R10, VAL + ST_ETH, 0x86DD)
        a.ldx(BPF_B, R9, R7, 20)                # next header
        a.stx(BPF_B, R10, R9, KEY + KY_PROTO)
        _V6_EXT = (0, 43, 44, 60)               # hop/routing/frag/dst-opts
        for h in _V6_EXT:
            a.jmp_imm(0x15, R9, h, "v6_ext")
        self.parse_l4(l4=54, v="v6", icmp_proto=58)

        # extension-header chain walk (the reference skips this entirely —
        # utils.h:133-148 keys such flows on the FIRST next-header with no
        # ports; here a bounded walk finds the real transport). Each header
        # is [next-header, hdr-ext-len] with size 8 + len*8 bytes, except
        # the fragment header which is a fixed 8.
        a.label("v6_ext")
        a.st_imm(BPF_DW, R10, CURSOR, 54)
        for step in range(4):
            a.label(f"v6x_{step}")
            a.mov_reg(R1, R6)
            a.ldx(BPF_DW, R2, R10, CURSOR)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, TLSBUF)
            a.mov_imm(R4, 4)    # [nh, len, frag-off hi, frag-off lo]
            a.call(HELPER_SKB_LOAD_BYTES)
            # truncated chain: keyed on the last seen next-header, no ports
            a.jmp_imm(0x55, R0, 0, "key_done")
            # size of the CURRENT header (its type is in the flow key slot)
            a.ldx(BPF_B, R3, R10, KEY + KY_PROTO)
            a.ldx(BPF_B, R4, R10, TLSBUF + 1)   # hdr-ext-len
            a.jmp_imm(0x55, R3, 44, f"v6x_{step}_var")
            a.mov_imm(R4, 0)                    # fragment: fixed 8 bytes
            # non-first fragment (13-bit offset != 0): no L4 header in this
            # packet — key on addrs + the fragment's next-header, portless
            a.ldx(BPF_B, R3, R10, TLSBUF + 2)
            a.alu_imm(0x67, R3, 8)
            a.ldx(BPF_B, R5, R10, TLSBUF + 3)
            a.alu_reg(0x4F, R3, R5)
            a.alu_imm(0x57, R3, 0xFFF8)
            a.jmp_imm(0x15, R3, 0, f"v6x_{step}_var")
            a.ldx(BPF_B, R3, R10, TLSBUF)
            a.stx(BPF_B, R10, R3, KEY + KY_PROTO)
            a.jmp("key_done")
            a.label(f"v6x_{step}_var")
            a.alu_imm(0x27, R4, 8)
            a.alu_imm(0x07, R4, 8)
            a.ldx(BPF_DW, R5, R10, CURSOR)
            a.alu_reg(0x0F, R5, R4)
            a.stx(BPF_DW, R10, R5, CURSOR)
            a.ldx(BPF_B, R9, R10, TLSBUF)       # chain's next-header
            a.stx(BPF_B, R10, R9, KEY + KY_PROTO)
            if step < 3:
                nxt = f"v6x_{step + 1}"
                for h in _V6_EXT:
                    a.jmp_imm(0x15, R9, h, nxt)
                a.jmp("v6x_done")
                # the jeqs above fall through to the next iteration only via
                # `nxt`; non-extension headers exit the walk
        a.label("v6x_done")
        self.slow_l4("v6", icmp_proto=58)

        a.label("key_done")

        # --- flow filter gate (filter.h twin; before trackers/upsert) ------
        if self.filter_rules_fd is not None:
            if self.has_filter_sampling:
                a.st_imm(BPF_DW, R10, FSKIP, 0)
            self.filter_block()

    def emit_tail(self) -> None:
        """Flow aggregation: correlations, upsert, feature records.

        Reference: `netobserv_tpu/datapath/asm_flowpath.py:1166`."""
        a = self.a
        # --- DNS correlation (stack-only; before the flow upsert) ----------
        if self.dns_inflight_fd is not None:
            a.ldx(BPF_W, R3, R10, DNSMETA + 4)
            a.jmp_imm(0x15, R3, 0, "rtt_chk")
            a.ldx(BPF_H, R3, R10, DNSMETA + 2)
            a.jmp_imm(0x45, R3, DNS_QR_BIT, "dns_resp")   # JSET: response
            # query: stash timestamp under the reversed tuple
            self.stamp(self.dns_inflight_fd)
            a.jmp_imm(0x15, R0, 0, "rtt_chk")
            self.count(CTR_FAIL_UPDATE_DNS)
            a.jmp("rtt_chk")
            # response: correlate to the stashed query and compute latency
            a.label("dns_resp")
            self.measure(self.dns_inflight_fd, done="rtt_chk", tag="dns")

        # --- TCP handshake RTT (SYN -> SYN|ACK correlation) ----------------
        # The clang path measures smoothed RTT from fentry:tcp_rcv_established
        # (flowpath_probes.c); without BTF the assembler measures the
        # handshake RTT instead: a pure SYN stamps rtt_inflight under the
        # reversed tuple (the corr key builder zero-pads dns_id for TCP) and
        # the returning SYN|ACK's own tuple correlates to a latency. DNS (UDP)
        # and RTT (TCP) are per-packet exclusive, so CORR/LAT slots are shared.
        a.label("rtt_chk")
        if self.rtt_inflight_fd is not None:
            a.ldx(BPF_B, R3, R10, KEY + KY_PROTO)
            a.jmp_imm(0x55, R3, 6, "flow_upsert")
            a.ldx(BPF_DW, R3, R10, SPILL)
            a.jmp_imm(0x45, R3, 0x02, "rtt_syn_any")      # SYN bit set?
            a.jmp("flow_upsert")
            a.label("rtt_syn_any")
            a.jmp_imm(0x45, R3, 0x10, "rtt_synack")       # ACK too?
            # pure SYN: stamp the reversed tuple (dns_id stays zero for TCP)
            self.stamp(self.rtt_inflight_fd)
            a.jmp("flow_upsert")
            a.label("rtt_synack")
            self.measure(self.rtt_inflight_fd, done="flow_upsert", tag="rtt")

        # --- flow upsert ---------------------------------------------------
        a.label("flow_upsert")
        a.ld_map_fd(R1, self.map_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, KEY)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x15, R0, 0, "miss")

        # hit: multi-interface dedup (reference bpf/flows.c:100-110) — only
        # the interface that FIRST saw the flow counts bytes/packets; any
        # other interface updates last_seen/flags and the observed list
        a.label("hit_merge")
        a.ldx(BPF_W, R4, R6, SKB_IFINDEX)
        a.ldx(BPF_W, R3, R0, ST_IFINDEX)
        a.jmp_reg(0x5D, R3, R4, "hit_other")    # not the first-seen intf
        # counting path: bytes += skb->len (atomic), packets += 1 (atomic),
        # last_seen = now (plain store: racing writers both store ~now, so
        # the field is correct to within one packet's skew — the one update
        # the C twin's spin lock covers that stays lock-free here, since
        # spin locks need BTF-described map values the assembler path
        # doesn't have), flags |= packet flags (ATOMIC or: no lost bits)
        a.ldx(BPF_W, R3, R6, SKB_LEN)
        a.atomic_add(BPF_DW, R0, R3, ST_BYTES)
        a.mov_imm(R4, 1)
        a.atomic_add(BPF_W, R0, R4, ST_PACKETS)
        a.ldx(BPF_DW, R3, R10, NOW)
        a.stx(BPF_DW, R0, R3, ST_LAST)
        a.ldx(BPF_DW, R3, R10, SPILL)
        if _FLAGS_SHIFT:
            a.alu_imm(0x67, R3, _FLAGS_SHIFT)   # flags -> tcp_flags bytes (LE)
        a.atomic_or(BPF_W, R0, R3, ST_ETH)
        if self.has_filter_sampling:
            # latest effective rate wins (stored by flt_sample on the stack)
            a.ldx(BPF_W, R3, R10, VAL + ST_SAMPLING)
            a.stx(BPF_W, R0, R3, ST_SAMPLING)
        elif self.sampling > 1:
            a.mov_imm(R3, self.sampling)
            a.stx(BPF_W, R0, R3, ST_SAMPLING)
        if self.enable_tls:
            # TLS merge on the counting path (flowpath.c:64-80): first
            # version wins; a later conflicting hello sets the mismatch flag
            a.ldx(BPF_H, R3, R10, VAL + _st("ssl_version"))
            a.jmp_imm(0x15, R3, 0, "tlsm_ciph")
            a.ldx(BPF_H, R4, R0, _st("ssl_version"))
            a.jmp_imm(0x15, R4, 0, "tlsm_store")
            a.jmp_reg(0x1D, R4, R3, "tlsm_ciph")    # same version: ok
            a.ldx(BPF_B, R5, R0, _st("misc_flags"))
            a.alu_imm(0x47, R5, 0x01)               # NO_MISC_SSL_MISMATCH
            a.stx(BPF_B, R0, R5, _st("misc_flags"))
            a.jmp("tlsm_ciph")
            a.label("tlsm_store")
            a.stx(BPF_H, R0, R3, _st("ssl_version"))
            a.label("tlsm_ciph")
            a.ldx(BPF_H, R3, R10, VAL + _st("tls_cipher_suite"))
            a.jmp_imm(0x15, R3, 0, "tlsm_ks")
            a.stx(BPF_H, R0, R3, _st("tls_cipher_suite"))
            a.label("tlsm_ks")
            a.ldx(BPF_H, R3, R10, VAL + _st("tls_key_share"))
            a.jmp_imm(0x15, R3, 0, "tlsm_types")
            a.stx(BPF_H, R0, R3, _st("tls_key_share"))
            a.label("tlsm_types")
            a.ldx(BPF_B, R3, R10, VAL + _st("tls_types"))
            a.ldx(BPF_B, R4, R0, _st("tls_types"))
            a.alu_reg(0x4F, R3, R4)
            a.stx(BPF_B, R0, R3, _st("tls_types"))
        # dscp: latest nonzero wins (flowpath.c:62-63)
        a.ldx(BPF_B, R3, R10, VAL + ST_DSCP)
        a.jmp_imm(0x15, R3, 0, "dns_rec")
        a.stx(BPF_B, R0, R3, ST_DSCP)
        a.jmp("dns_rec")

        a.label("hit_other")
        # secondary interface: span/flags only — never re-count traffic
        a.ldx(BPF_DW, R3, R10, NOW)
        a.stx(BPF_DW, R0, R3, ST_LAST)
        a.ldx(BPF_DW, R3, R10, SPILL)
        if _FLAGS_SHIFT:
            a.alu_imm(0x67, R3, _FLAGS_SHIFT)   # flags -> tcp_flags bytes (LE)
        a.atomic_or(BPF_W, R0, R3, ST_ETH)
        # (ifindex, direction) dedup scan over the observed slots (r4 =
        # ifindex; direction is a build-time constant -> immediate compare)
        n_obs = binfmt.FLOW_STATS_DTYPE["observed_intf"].shape[0]
        for i in range(n_obs):
            a.ldx(BPF_W, R3, R0, ST_OBSIF + 4 * i)
            a.jmp_reg(0x5D, R3, R4, f"obs_next_{i}")
            a.ldx(BPF_B, R3, R0, ST_OBSDIR + i)
            a.jmp_imm(0x15, R3, self.direction, "dns_rec")  # recorded
            a.label(f"obs_next_{i}")
        # append via slot RESERVATION: fetch-add (1<<24) on the aligned word
        # holding n_observed_intf hands this CPU an exclusive slot index, so
        # concurrent appends can neither lose a slot nor tear each other's
        # entries. Readers tolerate the two residual artifacts: a reserved-
        # but-not-yet-written slot reads as ifindex 0 (skipped at read-out,
        # record.py), and a racing append of the SAME new interface may
        # duplicate it (dedup'd at read-out, record.py)
        a.mov_imm(R3, 1 << _NOBS_SHIFT)
        a.atomic_fetch_add(BPF_W, R0, R3, ST_DIR)  # r3 = old word
        if _NOBS_SHIFT:
            a.alu_imm(0x77, R3, _NOBS_SHIFT)    # r3 = old n (0..255)
        else:
            a.alu_imm(0x57, R3, 0xFF)           # BE: old n is the LOW byte
        a.jmp_imm(0x35, R3, n_obs, "obs_full")
        a.mov_reg(R5, R3)
        a.alu_imm(0x67, R5, 2)                  # n << 2
        a.mov_reg(R7, R0)
        a.alu_reg(0x0F, R7, R5)
        a.stx(BPF_W, R7, R4, ST_OBSIF)          # observed_intf[n] = ifindex
        a.mov_reg(R7, R0)
        a.alu_reg(0x0F, R7, R3)
        a.mov_imm(R5, self.direction)
        a.stx(BPF_B, R7, R5, ST_OBSDIR)         # observed_direction[n] = dir
        a.jmp("dns_rec")
        a.label("obs_full")
        # undo the reservation so the counter SATURATES near capacity (at
        # most +n_cpus transient) instead of wrapping at 256 and handing
        # out in-use slots; readers clamp at capacity
        a.mov_imm(R3, -(1 << _NOBS_SHIFT))
        a.atomic_add(BPF_W, R0, R3, ST_DIR)
        # overflow: count it, except for zero-proto traffic which routinely
        # saturates the array (reference bpf/flows.c:133-142)
        a.ldx(BPF_B, R3, R10, KEY + KY_PROTO)
        a.jmp_imm(0x15, R3, 0, "dns_rec")
        self.count(CTR_OBSERVED_INTF_MISSED)
        a.jmp("dns_rec")

        # miss: build fresh stats in the stack event and NOEXIST-insert
        a.label("miss")
        a.ldx(BPF_DW, R3, R10, NOW)
        a.stx(BPF_DW, R10, R3, VAL + ST_FIRST)
        a.stx(BPF_DW, R10, R3, VAL + ST_LAST)
        a.ldx(BPF_W, R3, R6, SKB_LEN)
        a.stx(BPF_DW, R10, R3, VAL + ST_BYTES)
        a.st_imm(BPF_W, R10, VAL + ST_PACKETS, 1)
        a.ldx(BPF_DW, R3, R10, SPILL)
        a.stx(BPF_H, R10, R3, VAL + ST_FLAGS)
        a.ldx(BPF_W, R4, R6, SKB_IFINDEX)
        a.stx(BPF_W, R10, R4, VAL + ST_IFINDEX)
        a.st_imm(BPF_B, R10, VAL + ST_DIR, self.direction)
        if not self.has_filter_sampling:
            # (with filter sampling, flt_sample already stored the rate)
            a.st_imm(BPF_W, R10, VAL + ST_SAMPLING, self.sampling)
        a.st_imm(BPF_B, R10, VAL + ST_NOBS, 1)
        a.st_imm(BPF_B, R10, VAL + ST_OBSDIR, self.direction)
        a.stx(BPF_W, R10, R4, VAL + ST_OBSIF)   # observed_intf[0]
        a.ld_map_fd(R1, self.map_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, KEY)
        a.mov_reg(R3, R10)
        a.alu_imm(0x07, R3, VAL)
        a.mov_imm(R4, 1)                        # BPF_NOEXIST
        a.call(HELPER_MAP_UPDATE)
        a.jmp_imm(0x15, R0, 0, "dns_rec")
        a.jmp_imm(0x15, R0, -17, "eexist")      # -EEXIST: lost insert race
        # map full (or other failure): count + ship the event upstairs
        a.mov_reg(R9, R0)                       # save err across count()
        self.count(CTR_FAIL_CREATE_FLOW)
        if self.ringbuf_fd is not None:
            a.mov_imm(R3, 0)
            a.alu_reg(0x1F, R3, R9)             # r3 = -err (positive errno)
            a.stx(BPF_B, R10, R3, VAL + ST_ERRNO)
            a.ld_map_fd(R1, self.ringbuf_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, EV)
            a.mov_imm(R3, EVENT_SIZE)
            a.mov_imm(R4, 0)
            a.call(HELPER_RINGBUF_OUTPUT)
        a.jmp("dns_rec")
        a.label("eexist")
        # another CPU created it between lookup and insert: merge into it
        a.ld_map_fd(R1, self.map_fd)
        a.mov_reg(R2, R10)
        a.alu_imm(0x07, R2, KEY)
        a.call(HELPER_MAP_LOOKUP)
        a.jmp_imm(0x55, R0, 0, "hit_merge")
        self.count(CTR_FAIL_UPDATE_FLOW)
        a.jmp("dns_rec")

        # --- DNS feature record (after the base flow update, dns.h twin) ---
        a.label("dns_rec")
        if self.flows_dns_fd is not None:
            a.ldx(BPF_W, R3, R10, DNSMETA + 4)
            a.jmp_imm(0x15, R3, 0, "extra_rec")
            a.ld_map_fd(R1, self.flows_dns_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, KEY)
            a.call(HELPER_MAP_LOOKUP)
            a.jmp_imm(0x15, R0, 0, "dnsrec_miss")
            # update this CPU's slot in place
            a.ldx(BPF_DW, R3, R0, _dr("first_seen_ns"))
            a.jmp_imm(0x55, R3, 0, "dnsrec_last")
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R0, R4, _dr("first_seen_ns"))
            a.label("dnsrec_last")
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R0, R4, _dr("last_seen_ns"))
            a.ldx(BPF_H, R3, R10, DNSMETA)
            a.stx(BPF_H, R0, R3, _dr("dns_id"))
            a.ldx(BPF_H, R3, R0, _dr("dns_flags"))
            a.ldx(BPF_H, R4, R10, DNSMETA + 2)
            a.alu_reg(0x4F, R3, R4)
            a.stx(BPF_H, R0, R3, _dr("dns_flags"))
            a.st_imm(BPF_B, R0, _dr("errno"), 0)
            # latency: max of observed (dns.h:116-117)
            a.ldx(BPF_DW, R3, R0, _dr("latency_ns"))
            a.ldx(BPF_DW, R4, R10, LAT)
            a.jmp_reg(0x3D, R3, R4, "extra_rec")  # existing >= new: keep
            a.stx(BPF_DW, R0, R4, _dr("latency_ns"))
            a.jmp("extra_rec")
            a.label("dnsrec_miss")
            for off in range(DNSREC, DNSREC + DNSREC_SIZE, 8):
                a.st_imm(BPF_DW, R10, off, 0)
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R10, R4, DNSREC + _dr("first_seen_ns"))
            a.stx(BPF_DW, R10, R4, DNSREC + _dr("last_seen_ns"))
            a.ldx(BPF_DW, R4, R10, LAT)
            a.stx(BPF_DW, R10, R4, DNSREC + _dr("latency_ns"))
            a.ldx(BPF_H, R4, R10, DNSMETA)
            a.stx(BPF_H, R10, R4, DNSREC + _dr("dns_id"))
            a.ldx(BPF_H, R4, R10, DNSMETA + 2)
            a.stx(BPF_H, R10, R4, DNSREC + _dr("dns_flags"))
            a.ldx(BPF_H, R4, R10, VAL + ST_ETH)
            a.stx(BPF_H, R10, R4, DNSREC + _dr("eth_protocol"))
            # qname: copy min(32, remaining payload) raw label bytes into
            # the record (dns.h no_dns_copy_name analog; decode_qname stops
            # at the terminating NUL, so trailing qtype bytes are inert).
            # bpf_skb_load_bytes reads frag-resident payload too.
            a.ldx(BPF_W, R5, R10, TLSBUF + 8)   # qname packet offset
            a.ldx(BPF_W, R4, R6, SKB_LEN)
            a.jmp_reg(0xBD, R4, R5, "dnsname_done")  # no bytes past header
            a.alu_reg(0x1F, R4, R5)             # r4 = available bytes
            # slow-path queries carry a DYNAMIC qname offset (scalar, not
            # const), so the verifier cannot derive r4 >= 1 from the branch
            # above — pin it explicitly (skb_load_bytes rejects size 0)
            a.jmp_imm(0xB5, R4, 0, "dnsname_done")
            name_max = binfmt.DNS_REC_DTYPE["name"].itemsize
            a.jmp_imm(0xB5, R4, name_max, "dnsname_len_ok")
            a.mov_imm(R4, name_max)
            a.label("dnsname_len_ok")
            a.mov_reg(R1, R6)
            a.mov_reg(R2, R5)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, DNSREC + _dr("name"))
            a.call(HELPER_SKB_LOAD_BYTES)       # failure leaves zeros
            a.label("dnsname_done")
            a.ld_map_fd(R1, self.flows_dns_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, KEY)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, DNSREC)
            a.mov_imm(R4, 0)                    # BPF_ANY
            a.call(HELPER_MAP_UPDATE)
            a.jmp_imm(0x15, R0, 0, "extra_rec")
            self.count(CTR_FAIL_UPDATE_DNS)
            a.jmp("extra_rec")

        # --- RTT feature record (flows_extra; additional_metrics_t twin) ---
        a.label("extra_rec")
        if self.flows_extra_fd is not None:
            a.ldx(BPF_B, R3, R10, KEY + KY_PROTO)
            a.jmp_imm(0x55, R3, 6, "quic_rec")
            a.ldx(BPF_DW, R3, R10, LAT)         # measured handshake rtt
            a.jmp_imm(0x15, R3, 0, "quic_rec")
            a.ld_map_fd(R1, self.flows_extra_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, KEY)
            a.call(HELPER_MAP_LOOKUP)
            a.jmp_imm(0x15, R0, 0, "xrec_miss")
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R0, R4, _xr("last_seen_ns"))
            a.ldx(BPF_DW, R3, R0, _xr("rtt_ns"))
            a.ldx(BPF_DW, R4, R10, LAT)
            a.jmp_reg(0x3D, R3, R4, "quic_rec")  # existing >= new: keep
            a.stx(BPF_DW, R0, R4, _xr("rtt_ns"))
            a.jmp("quic_rec")
            a.label("xrec_miss")
            # build in the DNSREC scratch (32B needed, 64B slot, same align)
            for off in range(DNSREC, DNSREC + 32, 8):
                a.st_imm(BPF_DW, R10, off, 0)
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R10, R4, DNSREC + _xr("first_seen_ns"))
            a.stx(BPF_DW, R10, R4, DNSREC + _xr("last_seen_ns"))
            a.ldx(BPF_DW, R4, R10, LAT)
            a.stx(BPF_DW, R10, R4, DNSREC + _xr("rtt_ns"))
            a.ldx(BPF_H, R4, R10, VAL + ST_ETH)
            a.stx(BPF_H, R10, R4, DNSREC + _xr("eth_protocol"))
            a.ld_map_fd(R1, self.flows_extra_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, KEY)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, DNSREC)
            a.mov_imm(R4, 0)                    # BPF_ANY
            a.call(HELPER_MAP_UPDATE)
            a.jmp_imm(0x15, R0, 0, "quic_rec")
            self.count(CTR_FAIL_UPDATE_FLOW)

        # --- QUIC feature record (flows_quic; quic.h twin) -----------------
        a.label("quic_rec")
        if self.flows_quic_fd is not None and self.quic_mode:
            a.ldx(BPF_B, R3, R10, QMETA)        # quic invariants seen?
            a.jmp_imm(0x15, R3, 0, "out")
            a.ld_map_fd(R1, self.flows_quic_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, KEY)
            a.call(HELPER_MAP_LOOKUP)
            a.jmp_imm(0x15, R0, 0, "qrec_miss")
            # NOTE: like quic.h:42-50, the hit path does not backfill
            # first_seen/eth into a fresh per-CPU slot (another CPU created
            # the entry); consumers read only version/header flags
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R0, R4, _qr("last_seen_ns"))
            a.ldx(BPF_W, R3, R0, _qr("version"))
            a.ldx(BPF_W, R4, R10, QMETA + 4)
            a.jmp_reg(0x3D, R3, R4, "qrec_hdr")  # existing >= new: keep
            a.stx(BPF_W, R0, R4, _qr("version"))
            a.label("qrec_hdr")
            a.ldx(BPF_B, R3, R10, QMETA + 1)
            a.jmp_imm(0x15, R3, 0, "qrec_short")
            a.mov_imm(R4, 1)
            a.stx(BPF_B, R0, R4, _qr("seen_long_hdr"))
            a.jmp("out")
            a.label("qrec_short")
            a.mov_imm(R4, 1)
            a.stx(BPF_B, R0, R4, _qr("seen_short_hdr"))
            a.jmp("out")
            a.label("qrec_miss")
            for off in range(DNSREC, DNSREC + 24, 8):
                a.st_imm(BPF_DW, R10, off, 0)
            a.ldx(BPF_DW, R4, R10, NOW)
            a.stx(BPF_DW, R10, R4, DNSREC + _qr("first_seen_ns"))
            a.stx(BPF_DW, R10, R4, DNSREC + _qr("last_seen_ns"))
            a.ldx(BPF_W, R4, R10, QMETA + 4)
            a.stx(BPF_W, R10, R4, DNSREC + _qr("version"))
            a.ldx(BPF_H, R4, R10, VAL + ST_ETH)
            a.stx(BPF_H, R10, R4, DNSREC + _qr("eth_protocol"))
            a.ldx(BPF_B, R3, R10, QMETA + 1)
            a.jmp_imm(0x15, R3, 0, "qrec_fr_short")
            a.mov_imm(R4, 1)
            a.stx(BPF_B, R10, R4, DNSREC + _qr("seen_long_hdr"))
            a.jmp("qrec_write")
            a.label("qrec_fr_short")
            a.mov_imm(R4, 1)
            a.stx(BPF_B, R10, R4, DNSREC + _qr("seen_short_hdr"))
            a.label("qrec_write")
            a.ld_map_fd(R1, self.flows_quic_fd)
            a.mov_reg(R2, R10)
            a.alu_imm(0x07, R2, KEY)
            a.mov_reg(R3, R10)
            a.alu_imm(0x07, R3, DNSREC)
            a.mov_imm(R4, 0)                    # BPF_ANY
            a.call(HELPER_MAP_UPDATE)


def build_flow_program(map_fd: int, direction: int = 0, sampling: int = 0,
                       ringbuf_fd: int | None = None,
                       counters_fd: int | None = None,
                       dns_inflight_fd: int | None = None,
                       flows_dns_fd: int | None = None,
                       dns_port: int = 53,
                       rtt_inflight_fd: int | None = None,
                       flows_extra_fd: int | None = None,
                       filter_rules_fd: int | None = None,
                       filter_peers_fd: int | None = None,
                       flows_quic_fd: int | None = None,
                       quic_mode: int = 0,
                       enable_tls: bool = False,
                       sampling_gate_fd: int | None = None,
                       has_filter_sampling: bool = False) -> bytes:
    """Assemble one per-direction flow program. Optional map fds gate the
    corresponding feature blocks, mirroring the C datapath's loader-rewritten
    `cfg_enable_*` constants (a feature whose map isn't wired costs zero
    instructions).

    Reference: `netobserv_tpu/datapath/asm_flowpath.py:1558`."""
    return _Flow(map_fd, direction, sampling, ringbuf_fd, counters_fd,
                 dns_inflight_fd, flows_dns_fd, dns_port,
                 rtt_inflight_fd, flows_extra_fd,
                 filter_rules_fd, filter_peers_fd,
                 flows_quic_fd, quic_mode, enable_tls,
                 sampling_gate_fd, has_filter_sampling).build()
