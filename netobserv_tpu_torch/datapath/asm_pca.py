"""Hand-assembled PCA (packet capture) datapath — no compiler required.

Builds a TC/TCX classifier that copies each packet's first
NO_MAX_PAYLOAD_SIZE bytes into the `packet_records` ring buffer as a
`no_packet_event` (records.h:195), the same layout the clang-built `pca.h`
program produces — so PerfTracer/PerfBuffer/pcap framing run unchanged.

Shape: reserve a record in the ring buffer, fill (if_index, pkt_len,
timestamp), zero the payload area (ringbuf memory is NOT zeroed — an
unwritten tail would leak stale kernel bytes to userspace), then
bpf_skb_load_bytes a min(skb->len, snap) prefix; discard the reservation on
copy failure. Verified by the live kernel (tests/test_asm_flowpath.py PCA
e2e).

The port's copy of `netobserv_tpu/datapath/asm_pca.py`, kept so that the
port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

from netobserv_tpu_torch.datapath.asm import (
    Asm, BPF_DW, BPF_W, HELPER_KTIME_GET_NS, R0, R1, R2, R3, R4, R6, R7, R8,
    R10,
)
from netobserv_tpu_torch.model import binfmt

HELPER_PRANDOM_U32 = 7
HELPER_SKB_LOAD_BYTES = 26
HELPER_RINGBUF_RESERVE = 131
HELPER_RINGBUF_SUBMIT = 132
HELPER_RINGBUF_DISCARD = 133

SKB_LEN = 0
SKB_IFINDEX = 40

_REC = binfmt.PACKET_EVENT_DTYPE
_OFF_IFINDEX = _REC.fields["if_index"][1]
_OFF_PKT_LEN = _REC.fields["pkt_len"][1]
_OFF_TS = _REC.fields["timestamp_ns"][1]
_OFF_PAYLOAD = _REC.fields["payload"][1]
SNAP = binfmt.MAX_PAYLOAD_SIZE


def build_pca_program(ringbuf_fd: int, sampling: int = 0,
                      direction: int = 0,
                      filter_rules_fd: int | None = None,
                      filter_peers_fd: int | None = None,
                      counters_fd: int | None = None) -> bytes:
    """One program serves both directions (the record carries no direction;
    reference parity — `no_packet_event` has if_index/len/timestamp only).
    `sampling` > 1 bakes in a 1/N gate, the loader-rewritten-const analog.

    With filter trie fds wired, the program front-loads the flow datapath's
    shared parse + filter gate (asm_flowpath emit_head): only packets an
    Accept rule matches are captured — the pca.h in-kernel filtering
    behavior, previously clang-object-only.

    Reference: `netobserv_tpu/datapath/asm_pca.py:41`."""
    if filter_rules_fd is not None:
        from netobserv_tpu_torch.datapath.asm_flowpath import _Flow

        # direction matters here: filter rules carry a direction predicate,
        # so the loader builds one program per hook when filtering
        emitter = _Flow(map_fd=0, direction=direction, sampling=sampling,
                        ringbuf_fd=None, counters_fd=counters_fd,
                        dns_inflight_fd=None, flows_dns_fd=None, dns_port=53,
                        filter_rules_fd=filter_rules_fd,
                        filter_peers_fd=filter_peers_fd)
        emitter.emit_head()              # parse + filter; drops go to "out"
        _emit_capture(emitter.a, ringbuf_fd)
        a = emitter.a
        a.label("out")
        a.mov_imm(R0, 0)
        a.exit()
        return a.assemble()
    a = Asm()
    a.mov_reg(R6, R1)                        # r6 = ctx

    if sampling > 1:
        a.call(HELPER_PRANDOM_U32)
        a.alu_imm(0x97, R0, sampling)        # r0 %= N (ALU64 MOD K)
        a.jmp_imm(0x55, R0, 0, "out")        # not the sampled 1/N: out

    _emit_capture(a, ringbuf_fd)
    a.label("out")
    a.mov_imm(R0, 0)                         # TC_ACT_OK
    a.exit()
    return a.assemble()


def _emit_capture(a: Asm, ringbuf_fd: int) -> None:
    """Reserve + fill + submit one no_packet_event (falls through to the
    caller's \"out\" label; needs only r6 = ctx live).

    Reference: `netobserv_tpu/datapath/asm_pca.py:86`."""
    a.ld_map_fd(R1, ringbuf_fd)
    a.mov_imm(R2, _REC.itemsize)
    a.mov_imm(R3, 0)
    a.call(HELPER_RINGBUF_RESERVE)
    a.jmp_imm(0x15, R0, 0, "out")            # ring full: drop
    a.mov_reg(R7, R0)                        # r7 = record ptr

    a.ldx(BPF_W, R3, R6, SKB_IFINDEX)
    a.stx(BPF_W, R7, R3, _OFF_IFINDEX)
    a.ldx(BPF_W, R8, R6, SKB_LEN)            # r8 = original length
    a.stx(BPF_W, R7, R8, _OFF_PKT_LEN)
    a.call(HELPER_KTIME_GET_NS)
    a.stx(BPF_DW, R7, R0, _OFF_TS)

    # zero the payload area: ringbuf_reserve memory is recycled, and the
    # tail past the captured prefix must not leak stale kernel bytes
    for off in range(_OFF_PAYLOAD, _REC.itemsize, 8):
        a.st_imm(BPF_DW, R7, off, 0)

    # n = min(skb->len, SNAP); empty frames discard
    a.jmp_imm(0xB5, R8, SNAP, "len_ok")      # JLE imm
    a.mov_imm(R8, SNAP)
    a.label("len_ok")
    a.jmp_imm(0x15, R8, 0, "discard")

    a.mov_reg(R1, R6)                        # skb_load_bytes(ctx, 0, dst, n)
    a.mov_imm(R2, 0)
    a.mov_reg(R3, R7)
    a.alu_imm(0x07, R3, _OFF_PAYLOAD)
    a.mov_reg(R4, R8)
    a.call(HELPER_SKB_LOAD_BYTES)
    a.jmp_imm(0x55, R0, 0, "discard")        # copy failed: drop the record

    a.mov_reg(R1, R7)
    a.mov_imm(R2, 0)
    a.call(HELPER_RINGBUF_SUBMIT)
    a.jmp("out")

    a.label("discard")
    a.mov_reg(R1, R7)
    a.mov_imm(R2, 0)
    a.call(HELPER_RINGBUF_DISCARD)
