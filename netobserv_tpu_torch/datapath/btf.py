"""Minimal BTF reader: kernel struct member offsets from /sys/kernel/btf/vmlinux.

The clang datapath gets CO-RE relocations resolved by libbpf at load time;
the assembler datapath gets the same result one level up — the loader reads
the running kernel's BTF and bakes the resolved offsets into the assembled
probe programs as immediates. Same mechanism, same source of truth, no
compiler. (Reference analog: the BPF_CORE_READ chains in
flowpath_probes.c / the reference's bpf2go CO-RE objects.)

Format reference: Documentation/bpf/btf.rst (struct btf_header, btf_type).
Only what offset resolution needs is implemented: STRUCT/UNION members
(including anonymous nesting), and the modifier/typedef chain.

The port's copy of `netobserv_tpu/datapath/btf.py`, kept so that the
port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

import struct
from typing import Optional

BTF_MAGIC = 0xEB9F

KIND_INT = 1
KIND_PTR = 2
KIND_ARRAY = 3
KIND_STRUCT = 4
KIND_UNION = 5
KIND_ENUM = 6
KIND_FWD = 7
KIND_TYPEDEF = 8
KIND_VOLATILE = 9
KIND_CONST = 10
KIND_RESTRICT = 11
KIND_FUNC = 12
KIND_FUNC_PROTO = 13
KIND_VAR = 14
KIND_DATASEC = 15
KIND_FLOAT = 16
KIND_DECL_TAG = 17
KIND_TYPE_TAG = 18
KIND_ENUM64 = 19

# extra payload per kind, in (fixed, per_vlen) u32 words after btf_type
_KIND_EXTRA = {
    KIND_INT: (1, 0),
    KIND_ARRAY: (3, 0),
    KIND_STRUCT: (0, 3),
    KIND_UNION: (0, 3),
    KIND_ENUM: (0, 2),
    KIND_FUNC_PROTO: (0, 2),
    KIND_VAR: (1, 0),
    KIND_DATASEC: (0, 3),
    KIND_DECL_TAG: (1, 0),
    KIND_ENUM64: (0, 3),
}

_MODIFIERS = (KIND_TYPEDEF, KIND_VOLATILE, KIND_CONST, KIND_RESTRICT,
              KIND_TYPE_TAG)


class BTF:
    """Parsed BTF type graph with struct member offset resolution.

    Reference: `netobserv_tpu/datapath/btf.py:60`."""

    def __init__(self, path: str = "/sys/kernel/btf/vmlinux"):
        """Reference: `netobserv_tpu/datapath/btf.py:63`."""
        with open(path, "rb") as fh:
            data = fh.read()
        magic, _ver, _flags, hdr_len = struct.unpack_from("=HBBI", data, 0)
        if magic != BTF_MAGIC:
            raise ValueError(f"{path}: not BTF (magic {magic:#x})")
        type_off, type_len, str_off, str_len = struct.unpack_from(
            "=IIII", data, 8)
        self._strs = data[hdr_len + str_off:hdr_len + str_off + str_len]
        # types[i] = (kind, name_off, size_or_type, members)
        # members = [(name_off, type_id, offset_bits)] for STRUCT/UNION
        self.types: list[tuple] = [(0, 0, 0, None)]  # type_id 0 = void
        self._by_name: dict[tuple[int, str], int] = {}
        off = hdr_len + type_off
        end = off + type_len
        tid = 0
        while off < end:
            name_off, info, size = struct.unpack_from("=III", data, off)
            off += 12
            kind = (info >> 24) & 0x1F
            vlen = info & 0xFFFF
            members = None
            if kind in (KIND_STRUCT, KIND_UNION):
                members = []
                for _ in range(vlen):
                    m_name, m_type, m_off = struct.unpack_from(
                        "=III", data, off)
                    off += 12
                    if (info >> 31) & 1:  # kind_flag: bitfield encoding
                        m_off = m_off & 0xFFFFFF
                    members.append((m_name, m_type, m_off))
            else:
                fixed, per = _KIND_EXTRA.get(kind, (0, 0))
                off += 4 * (fixed + per * vlen)
            tid += 1
            self.types.append((kind, name_off, size, members))
            if name_off and kind in (KIND_STRUCT, KIND_UNION, KIND_TYPEDEF,
                                     KIND_INT, KIND_FLOAT, KIND_ENUM,
                                     KIND_ENUM64):
                self._by_name.setdefault((kind, self._name(name_off)), tid)

    def _name(self, name_off: int) -> str:
        """Reference: `netobserv_tpu/datapath/btf.py:104`."""
        endp = self._strs.index(b"\x00", name_off)
        return self._strs[name_off:endp].decode()

    def _resolve(self, tid: int) -> int:
        """Skip typedef/const/volatile chains to the concrete type.

        Reference: `netobserv_tpu/datapath/btf.py:108`."""
        kind, _n, size_or_type, _m = self.types[tid]
        while kind in _MODIFIERS:
            tid = size_or_type
            kind, _n, size_or_type, _m = self.types[tid]
        return tid

    def struct_id(self, name: str) -> int:
        """Reference: `netobserv_tpu/datapath/btf.py:116`."""
        for kind in (KIND_STRUCT, KIND_UNION):
            tid = self._by_name.get((kind, name))
            if tid is not None:
                return tid
        raise LookupError(f"struct {name} not in BTF")

    def _find_member(self, tid: int, want: str,
                     base_bits: int) -> Optional[tuple[int, int]]:
        """(offset_bits, member_type_id) for `want` in struct `tid`,
        descending into anonymous members.

        Reference: `netobserv_tpu/datapath/btf.py:123`."""
        _kind, _n, _sz, members = self.types[tid]
        for m_name, m_type, m_off in members or ():
            if m_name and self._name(m_name) == want:
                return base_bits + m_off, m_type
            if not m_name:  # anonymous struct/union: search inside
                inner = self._resolve(m_type)
                if self.types[inner][0] in (KIND_STRUCT, KIND_UNION):
                    hit = self._find_member(inner, want, base_bits + m_off)
                    if hit:
                        return hit
        return None

    def offset_of(self, struct_name: str, path: str) -> int:
        """Byte offset of a (possibly nested) member, e.g.
        offset_of("sock", "__sk_common.skc_dport"). Raises on bitfields
        (none of the fields the datapath reads are bitfields).

        Reference: `netobserv_tpu/datapath/btf.py:139`."""
        tid = self.struct_id(struct_name)
        bits = 0
        for comp in path.split("."):
            tid = self._resolve(tid)
            if self.types[tid][0] not in (KIND_STRUCT, KIND_UNION):
                raise LookupError(
                    f"{struct_name}.{path}: {comp} parent is not a struct")
            hit = self._find_member(tid, comp, bits)
            if hit is None:
                raise LookupError(f"{struct_name}.{path}: no member {comp}")
            bits, tid = hit
        if bits % 8:
            raise LookupError(f"{struct_name}.{path}: bitfield unsupported")
        return bits // 8


_cached: Optional[BTF] = None


def kernel_btf() -> BTF:
    """The running kernel's BTF (parsed once per process).

    Reference: `netobserv_tpu/datapath/btf.py:162`."""
    global _cached
    if _cached is None:
        _cached = BTF()
    return _cached


def available() -> bool:
    """Reference: `netobserv_tpu/datapath/btf.py:170`."""
    import os

    return os.path.exists("/sys/kernel/btf/vmlinux")
