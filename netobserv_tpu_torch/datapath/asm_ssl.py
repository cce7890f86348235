"""Hand-assembled OpenSSL SSL_write uprobe program (no compiler required).

The assembler twin of `flowpath_probes.c:380-399` (SEC("uprobe/SSL_write")):
at SSL_write(ssl, buf, num) entry, reserve a `no_ssl_event` in the
`ssl_events` ring buffer, stamp time + pid_tgid, clamp the caller's length
exactly like the C probe (negative -> 0, cap at NO_MAX_SSL_DATA), copy the
plaintext with bpf_probe_read_user, and submit. A failed user-memory read
discards the reservation instead of shipping uninitialized ring memory.

x86_64 calling convention: arg2 (buf) in rsi, arg3 (num) in rdx; pt_regs
field offsets are the stable kernel ABI for BPF_PROG_TYPE_KPROBE.

The port's copy of `netobserv_tpu/datapath/asm_ssl.py`, kept so that the
port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

from netobserv_tpu_torch.datapath.asm import (
    Asm, BPF_DW, BPF_W, HELPER_KTIME_GET_NS, R0, R1, R2, R3, R6, R7, R8, R9,
)
from netobserv_tpu_torch.model import binfmt

HELPER_GET_PID_TGID = 14
HELPER_PROBE_READ_USER = 112
HELPER_RINGBUF_RESERVE = 131
HELPER_RINGBUF_SUBMIT = 132
HELPER_RINGBUF_DISCARD = 133

# x86_64 struct pt_regs offsets (kernel ABI)
PT_REGS_RDX = 96   # arg3
PT_REGS_RSI = 104  # arg2

EV_SIZE = binfmt.SSL_EVENT_DTYPE.itemsize          # 24 + 16K
MAX_DATA = binfmt.MAX_SSL_DATA
EV_TS = binfmt.SSL_EVENT_DTYPE.fields["timestamp_ns"][1]
EV_PID = binfmt.SSL_EVENT_DTYPE.fields["pid_tgid"][1]
EV_LEN = binfmt.SSL_EVENT_DTYPE.fields["data_len"][1]
EV_TYPE = binfmt.SSL_EVENT_DTYPE.fields["ssl_type"][1]
EV_DATA = binfmt.SSL_EVENT_DTYPE.fields["data"][1]

SSL_TYPE_WRITE = 1


def build_ssl_write_program(ringbuf_fd: int) -> bytes:
    """Reference: `netobserv_tpu/datapath/asm_ssl.py:42`."""
    a = Asm()
    a.mov_reg(R6, R1)                       # r6 = pt_regs
    a.ldx(BPF_DW, R7, R6, PT_REGS_RSI)      # r7 = buf
    a.ldx(BPF_DW, R8, R6, PT_REGS_RDX)      # r8 = num (int arg)
    # int semantics like the C probe: negative -> 0, cap at MAX_DATA
    a.alu_imm(0x67, R8, 32)                 # zero-extend the low 32 bits
    a.alu_imm(0x77, R8, 32)
    a.jmp_imm(0xB5, R8, MAX_DATA, "len_ok")     # <= cap: as-is
    a.jmp_imm(0xB5, R8, 0x7FFFFFFF, "len_cap")  # positive int > cap
    a.mov_imm(R8, 0)                        # negative int -> 0
    a.jmp("len_ok")
    a.label("len_cap")
    a.mov_imm(R8, MAX_DATA)
    a.label("len_ok")

    a.ld_map_fd(R1, ringbuf_fd)
    a.mov_imm(R2, EV_SIZE)
    a.mov_imm(R3, 0)
    a.call(HELPER_RINGBUF_RESERVE)
    a.jmp_imm(0x55, R0, 0, "have")
    a.jmp("out")                            # ring full: drop the event
    a.label("have")
    a.mov_reg(R9, R0)                       # r9 = event
    a.call(HELPER_KTIME_GET_NS)
    a.stx(BPF_DW, R9, R0, EV_TS)
    a.call(HELPER_GET_PID_TGID)
    a.stx(BPF_DW, R9, R0, EV_PID)
    a.stx(BPF_W, R9, R8, EV_LEN)
    # one word covers ssl_type + the 3 pad bytes (zeroes them: ring memory
    # is not zero-initialized and pads must not leak)
    a.st_imm(BPF_W, R9, EV_TYPE, SSL_TYPE_WRITE)
    a.jmp_imm(0x15, R8, 0, "submit")        # empty write: header-only event
    a.mov_reg(R1, R9)
    a.alu_imm(0x07, R1, EV_DATA)
    a.mov_reg(R2, R8)
    a.mov_reg(R3, R7)
    a.call(HELPER_PROBE_READ_USER)
    a.jmp_imm(0x15, R0, 0, "submit")
    a.mov_reg(R1, R9)                       # unreadable user buffer: discard
    a.mov_imm(R2, 0)
    a.call(HELPER_RINGBUF_DISCARD)
    a.jmp("out")
    a.label("submit")
    a.mov_reg(R1, R9)
    a.mov_imm(R2, 0)
    a.call(HELPER_RINGBUF_SUBMIT)
    a.label("out")
    a.mov_imm(R0, 0)
    a.exit()
    return a.assemble()
