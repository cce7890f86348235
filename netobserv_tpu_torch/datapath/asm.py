"""A minimal eBPF assembler: named registers, labels, patched jumps.

Exists so the datapath can ship a REAL in-kernel flow program in environments
without clang (the image this framework was built in): programs are assembled
instruction-by-instruction and validated by the live kernel verifier
(tests/test_prog_load.py, test_asm_flowpath.py). The clang-built flowpath.c
remains the full-featured datapath; this is the minimal subset.

The port's copy of `netobserv_tpu/datapath/asm.py`, kept so that the
port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10 = range(11)

# opcode building blocks
BPF_LDX, BPF_ST, BPF_STX = 0x61, 0x62, 0x63
BPF_W, BPF_H, BPF_B, BPF_DW = 0x00, 0x08, 0x10, 0x18
BPF_ALU64_K, BPF_ALU64_X = 0x07, 0x0F
BPF_MOV_K, BPF_MOV_X = 0xB7, 0xBF
BPF_JMP_CALL, BPF_EXIT = 0x85, 0x95

HELPER_MAP_LOOKUP = 1
HELPER_MAP_UPDATE = 2
HELPER_MAP_DELETE = 3
HELPER_KTIME_GET_NS = 5
HELPER_RINGBUF_OUTPUT = 130


#: struct bpf_insn packs dst_reg:4/src_reg:4 as C BITFIELDS, so the nibble
#: order follows the host's bitfield allocation: dst in the LOW nibble on
#: little-endian, the HIGH nibble on big-endian (s390x)
_REGS_BYTE = ((lambda dst, src: (src << 4) | dst)
              if __import__("sys").byteorder == "little"
              else (lambda dst, src: (dst << 4) | src))


def encode(opcode: int, dst: int = 0, src: int = 0, off: int = 0,
           imm: int = 0) -> bytes:
    """Encode one eBPF instruction (struct bpf_insn) — the single encoding
    definition shared with syscall_bpf.

    Reference: `netobserv_tpu/datapath/asm.py:39`."""
    return struct.pack("=BBhi", opcode, _REGS_BYTE(dst, src), off, imm)


def encode_ld_map_fd(dst: int, map_fd: int) -> bytes:
    """BPF_LD_IMM64 with BPF_PSEUDO_MAP_FD (two instruction slots).

    Reference: `netobserv_tpu/datapath/asm.py:46`."""
    return encode(0x18, dst, 1, 0, map_fd) + encode(0x00)

BPF_ANY = 0
BPF_NOEXIST = 1


@dataclass
class Asm:
    """Reference: `netobserv_tpu/datapath/asm.py:55`."""
    _insns: list[tuple] = field(default_factory=list)  # (bytes | jump tuple)
    _labels: dict[str, int] = field(default_factory=dict)

    def _emit(self, raw: bytes) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:59`."""
        self._insns.append(("raw", raw))

    def label(self, name: str) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:62`."""
        self._labels[name] = len(self._insns)

    # --- moves / alu ---
    def mov_imm(self, dst: int, imm: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:66`."""
        self._emit(encode(0xB7, dst, 0, 0, imm))

    def mov_reg(self, dst: int, src: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:69`."""
        self._emit(encode(0xBF, dst, src))

    def alu_imm(self, op: int, dst: int, imm: int) -> None:
        """op: 0x07 add, 0x17 sub, 0x47 or, 0x57 and, 0x67 lsh, 0x77 rsh,
        0xa7 xor, 0x27 mul (all ALU64 K forms).

        Reference: `netobserv_tpu/datapath/asm.py:72`."""
        self._emit(encode(op, dst, 0, 0, imm))

    def alu_reg(self, op: int, dst: int, src: int) -> None:
        """op ALU64 X forms: 0x0f add, 0x1f sub, 0x4f or, 0x5f and, 0x2f mul.

        Reference: `netobserv_tpu/datapath/asm.py:77`."""
        self._emit(encode(op, dst, src))

    def endian_be(self, dst: int, bits: int) -> None:
        """bswap to big-endian interpretation (BPF_END | BPF_TO_BE).

        Reference: `netobserv_tpu/datapath/asm.py:81`."""
        self._emit(encode(0xDC, dst, 0, 0, bits))

    # --- memory ---
    def ldx(self, size: int, dst: int, src: int, off: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:86`."""
        self._emit(encode(0x61 | size, dst, src, off))

    def st_imm(self, size: int, dst: int, off: int, imm: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:89`."""
        self._emit(encode(0x62 | size, dst, 0, off, imm))

    def stx(self, size: int, dst: int, src: int, off: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:92`."""
        self._emit(encode(0x63 | size, dst, src, off))

    def atomic_add(self, size: int, dst: int, src: int, off: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:95`."""
        self._emit(encode(0xC3 | size, dst, src, off))

    def atomic_or(self, size: int, dst: int, src: int, off: int) -> None:
        """*(dst+off) |= src, atomically (BPF_ATOMIC imm=BPF_OR, kernel
        5.12+) — lock-free accumulation of flag bits across CPUs.

        Reference: `netobserv_tpu/datapath/asm.py:98`."""
        self._emit(encode(0xC3 | size, dst, src, off, 0x40))

    def atomic_fetch_add(self, size: int, dst: int, src: int, off: int) -> None:
        """src = fetch_add(*(dst+off), src) (BPF_ATOMIC imm=BPF_ADD|FETCH,
        kernel 5.12+) — reserves unique slots/sequence numbers across CPUs.

        Reference: `netobserv_tpu/datapath/asm.py:103`."""
        self._emit(encode(0xC3 | size, dst, src, off, 0x01))

    def ld_map_fd(self, dst: int, map_fd: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:108`."""
        self._emit(encode_ld_map_fd(dst, map_fd)[:8])
        self._emit(encode_ld_map_fd(dst, map_fd)[8:])

    # --- control flow ---
    def jmp(self, target: str) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:113`."""
        self._insns.append(("jump", 0x05, 0, 0, target))

    def jmp_imm(self, op: int, dst: int, imm: int, target: str) -> None:
        """op: 0x15 jeq, 0x55 jne, 0x25 jgt, 0x35 jge, 0xa5 jlt, 0xb5 jle
        (K forms).

        Reference: `netobserv_tpu/datapath/asm.py:116`."""
        self._insns.append(("jump", op, dst, imm, target))

    def jmp_reg(self, op: int, dst: int, src: int, target: str) -> None:
        """op X forms: 0x1d jeq, 0x5d jne, 0x2d jgt, 0x3d jge, 0xad jlt.

        Reference: `netobserv_tpu/datapath/asm.py:121`."""
        self._insns.append(("jumpx", op, dst, src, target))

    def call(self, helper: int) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:125`."""
        self._emit(struct.pack("=BBhi", 0x85, 0, 0, helper))

    def exit(self) -> None:
        """Reference: `netobserv_tpu/datapath/asm.py:128`."""
        self._emit(struct.pack("=BBhi", 0x95, 0, 0, 0))

    # --- assembly ---
    def assemble(self) -> bytes:
        """Reference: `netobserv_tpu/datapath/asm.py:132`."""
        out = []
        for i, item in enumerate(self._insns):
            if item[0] == "raw":
                out.append(item[1])
            elif item[0] == "jump":
                _tag, op, dst, imm, target = item
                off = self._labels[target] - i - 1
                out.append(struct.pack("=BBhi", op, dst, off, imm))
            else:  # jumpx
                _tag, op, dst, src, target = item
                off = self._labels[target] - i - 1
                out.append(struct.pack("=BBhi", op, _REGS_BYTE(dst, src),
                                       off, 0))
        return b"".join(out)
