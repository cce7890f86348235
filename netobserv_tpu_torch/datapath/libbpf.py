"""ctypes bindings for the system libbpf: load clang-built CO-RE objects.

A copy of `netobserv_tpu/datapath/libbpf.py` (lines 1-364): the bindings
over `libbpf.so.1`'s v1 API (`available`, `_load_lib`, `_bind`), the ELF
reader `_Elf` with `rodata_symbols`, and `BpfMapHandle`, `BpfProgHandle`,
`BpfLink` and `BpfObject` (open, map resize, pinning strip, `volatile
const` rewrite by `patch_rodata`, `set_type`, `set_autoload`, verifier
load, auto-attach). It lets `flowpath.bpf.o`, which
`datapath/bpf_build.py` builds where clang exists, drive the full C
datapath (`datapath/loader.LibbpfKernelFetcher`); the hand-assembled
datapath stays the fallback without a compiler.

Only the object/map/program handles needed by the loader are bound; all
calls are checked and raise OSError with errno context on failure.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
from typing import Iterator, Optional

log = logging.getLogger("netobserv_tpu_torch.datapath.libbpf")

_lib: Optional[ctypes.CDLL] = None


def available() -> bool:
    return _load_lib() is not None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libbpf.so.1", "libbpf.so",
                 ctypes.util.find_library("bpf") or ""):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name, use_errno=True)
            _bind(lib)
        except (OSError, AttributeError) as exc:
            # libbpf 0.x lacks some of the v1 symbols bound here: treat it
            # as unavailable so the loader falls back to the assembler path
            log.debug("libbpf candidate %s unusable: %s", name, exc)
            continue
        _lib = lib
        ver = lib.libbpf_version_string().decode()
        log.debug("libbpf %s loaded (%s)", ver, name)
        return _lib
    return None


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.libbpf_version_string.restype = ctypes.c_char_p
    lib.bpf_object__open_file.restype = p
    lib.bpf_object__open_file.argtypes = [ctypes.c_char_p, p]
    lib.bpf_object__load.argtypes = [p]
    lib.bpf_object__close.argtypes = [p]
    lib.bpf_object__next_map.restype = p
    lib.bpf_object__next_map.argtypes = [p, p]
    lib.bpf_object__next_program.restype = p
    lib.bpf_object__next_program.argtypes = [p, p]
    lib.bpf_object__find_map_by_name.restype = p
    lib.bpf_object__find_map_by_name.argtypes = [p, ctypes.c_char_p]
    lib.bpf_object__find_program_by_name.restype = p
    lib.bpf_object__find_program_by_name.argtypes = [p, ctypes.c_char_p]
    lib.bpf_map__name.restype = ctypes.c_char_p
    lib.bpf_map__name.argtypes = [p]
    lib.bpf_map__fd.argtypes = [p]
    lib.bpf_map__type.argtypes = [p]
    lib.bpf_map__key_size.argtypes = [p]
    lib.bpf_map__value_size.argtypes = [p]
    lib.bpf_map__max_entries.argtypes = [p]
    lib.bpf_map__set_max_entries.argtypes = [p, ctypes.c_uint]
    lib.bpf_map__set_pin_path.argtypes = [p, ctypes.c_char_p]
    lib.bpf_map__initial_value.restype = p
    lib.bpf_map__initial_value.argtypes = [p, ctypes.POINTER(ctypes.c_size_t)]
    lib.bpf_program__name.restype = ctypes.c_char_p
    lib.bpf_program__name.argtypes = [p]
    lib.bpf_program__section_name.restype = ctypes.c_char_p
    lib.bpf_program__section_name.argtypes = [p]
    lib.bpf_program__type.argtypes = [p]
    lib.bpf_program__set_type.argtypes = [p, ctypes.c_int]
    lib.bpf_program__set_autoload.argtypes = [p, ctypes.c_bool]
    lib.bpf_program__autoload.argtypes = [p]
    lib.bpf_program__autoload.restype = ctypes.c_bool
    lib.bpf_program__fd.argtypes = [p]
    lib.bpf_program__attach.restype = p
    lib.bpf_program__attach.argtypes = [p]
    lib.bpf_link__destroy.argtypes = [p]
    lib.bpf_map__reuse_fd.argtypes = [p, ctypes.c_int]


class _Elf:
    """Just enough ELF64 parsing to read a BPF object's sections and the
    .rodata symbol offsets (the `volatile const` config knobs; in an ET_REL
    object the DATASEC BTF offsets are unfilled — the symbol table is the
    authoritative source, exactly what libbpf itself uses at open time)."""

    def __init__(self, path: str):
        import struct as _struct

        self._s = _struct
        with open(path, "rb") as fh:
            self.data = fh.read()
        if self.data[:4] != b"\x7fELF" or self.data[4] != 2:
            raise ValueError(f"{path}: not an ELF64 object")
        self.e_shoff, = _struct.unpack_from("<Q", self.data, 0x28)
        (self.e_shentsize, self.e_shnum,
         self.e_shstrndx) = _struct.unpack_from("<HHH", self.data, 0x3A)
        _n, _t, self._shstr_off, _sz = self._shdr(self.e_shstrndx)

    def _shdr(self, i: int):
        base = self.e_shoff + i * self.e_shentsize
        sh_name, sh_type = self._s.unpack_from("<II", self.data, base)
        sh_offset, sh_size = self._s.unpack_from("<QQ", self.data,
                                                 base + 0x18)
        return sh_name, sh_type, sh_offset, sh_size

    def _str(self, tab_off: int, off: int) -> str:
        end = self.data.index(b"\x00", tab_off + off)
        return self.data[tab_off + off:end].decode()

    def section_index(self, name: str) -> Optional[int]:
        for i in range(self.e_shnum):
            sh_name, _t, _o, _sz = self._shdr(i)
            if self._str(self._shstr_off, sh_name) == name:
                return i
        return None

    def symbols_in(self, section_name: str) -> dict:
        """{symbol name: (offset, size)} for symbols defined in a section."""
        target = self.section_index(section_name)
        out: dict = {}
        if target is None:
            return out
        for i in range(self.e_shnum):
            _n, sh_type, off, size = self._shdr(i)
            if sh_type != 2:                     # SHT_SYMTAB
                continue
            base = self.e_shoff + i * self.e_shentsize
            sh_link, = self._s.unpack_from("<I", self.data, base + 0x28)
            _sn, _st, strtab_off, _ss = self._shdr(sh_link)
            for so in range(off, off + size, 24):  # Elf64_Sym
                st_name, _info, _other, st_shndx = self._s.unpack_from(
                    "<IBBH", self.data, so)
                st_value, st_size = self._s.unpack_from("<QQ", self.data,
                                                        so + 8)
                if st_shndx == target and st_name:
                    out[self._str(strtab_off, st_name)] = (st_value, st_size)
        return out


def rodata_symbols(path: str) -> dict:
    """{const name: (offset, size)} in the object's .rodata."""
    return _Elf(path).symbols_in(".rodata")


class BpfMapHandle:
    def __init__(self, lib, ptr):
        self._lib, self._ptr = lib, ptr

    @property
    def name(self) -> str:
        return self._lib.bpf_map__name(self._ptr).decode()

    @property
    def fd(self) -> int:
        return self._lib.bpf_map__fd(self._ptr)

    @property
    def type(self) -> int:
        return self._lib.bpf_map__type(self._ptr)

    @property
    def key_size(self) -> int:
        return self._lib.bpf_map__key_size(self._ptr)

    @property
    def value_size(self) -> int:
        return self._lib.bpf_map__value_size(self._ptr)

    @property
    def max_entries(self) -> int:
        return self._lib.bpf_map__max_entries(self._ptr)

    def set_max_entries(self, n: int) -> None:
        rc = self._lib.bpf_map__set_max_entries(self._ptr, n)
        if rc:
            raise OSError(-rc, f"set_max_entries({self.name}, {n})")

    def disable_pinning(self) -> None:
        self._lib.bpf_map__set_pin_path(self._ptr, None)

    def reuse_fd(self, fd: int) -> None:
        """Share another object's already-created map instead of creating
        a new one at load (cross-object map sharing: the probes object
        writes into the flow object's feature maps)."""
        rc = self._lib.bpf_map__reuse_fd(self._ptr, fd)
        if rc:
            raise OSError(-rc, f"reuse_fd({self.name})")

    def initial_value(self) -> Optional[memoryview]:
        """Writable view of a .rodata/.data/.bss map's initial contents;
        None for ordinary maps. Patch before load() to rewrite `volatile
        const` config knobs (the reference's configureFlowSpecVariables)."""
        size = ctypes.c_size_t(0)
        ptr = self._lib.bpf_map__initial_value(self._ptr,
                                               ctypes.byref(size))
        if not ptr or size.value == 0:
            return None
        buf = (ctypes.c_char * size.value).from_address(ptr)
        return memoryview(buf).cast("B")


class BpfProgHandle:
    def __init__(self, lib, ptr):
        self._lib, self._ptr = lib, ptr

    @property
    def name(self) -> str:
        return self._lib.bpf_program__name(self._ptr).decode()

    @property
    def section(self) -> str:
        return self._lib.bpf_program__section_name(self._ptr).decode()

    @property
    def type(self) -> int:
        return self._lib.bpf_program__type(self._ptr)

    @property
    def fd(self) -> int:
        return self._lib.bpf_program__fd(self._ptr)

    @property
    def autoload(self) -> bool:
        return self._lib.bpf_program__autoload(self._ptr)

    def set_autoload(self, on: bool) -> None:
        rc = self._lib.bpf_program__set_autoload(self._ptr, on)
        if rc:
            raise OSError(-rc, f"set_autoload({self.name})")

    def set_type(self, prog_type: int) -> None:
        """Needed for legacy section names libbpf can't infer (bpf2go's
        `classifier/...` sections land as UNSPEC)."""
        rc = self._lib.bpf_program__set_type(self._ptr, prog_type)
        if rc:
            raise OSError(-rc, f"set_type({self.name}, {prog_type})")

    def attach(self) -> "BpfLink":
        """libbpf auto-attach by section type (tracepoint/kprobe/fentry
        ...). Raises OSError on failure."""
        ctypes.set_errno(0)
        ptr = self._lib.bpf_program__attach(self._ptr)
        if not ptr:
            raise OSError(ctypes.get_errno() or 22,
                          f"bpf_program__attach({self.name})")
        return BpfLink(self._lib, ptr)


class BpfLink:
    """An attached program's link; destroy() detaches."""

    def __init__(self, lib, ptr):
        self._lib, self._ptr = lib, ptr

    def destroy(self) -> None:
        if self._ptr:
            self._lib.bpf_link__destroy(self._ptr)
            self._ptr = None


class BpfObject:
    """An opened (then loaded) BPF ELF object."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("libbpf not available on this system")
        self._lib = lib
        ctypes.set_errno(0)
        self._obj = lib.bpf_object__open_file(
            os.fsencode(path), None)
        if not self._obj:
            err = ctypes.get_errno()
            raise OSError(err, f"bpf_object__open_file({path})")
        self.loaded = False

    def maps(self) -> Iterator[BpfMapHandle]:
        cur = None
        while True:
            cur = self._lib.bpf_object__next_map(self._obj, cur)
            if not cur:
                return
            yield BpfMapHandle(self._lib, cur)

    def programs(self) -> Iterator[BpfProgHandle]:
        cur = None
        while True:
            cur = self._lib.bpf_object__next_program(self._obj, cur)
            if not cur:
                return
            yield BpfProgHandle(self._lib, cur)

    def map(self, name: str) -> Optional[BpfMapHandle]:
        ptr = self._lib.bpf_object__find_map_by_name(self._obj,
                                                     name.encode())
        return BpfMapHandle(self._lib, ptr) if ptr else None

    def program(self, name: str) -> Optional[BpfProgHandle]:
        ptr = self._lib.bpf_object__find_program_by_name(self._obj,
                                                         name.encode())
        return BpfProgHandle(self._lib, ptr) if ptr else None

    def patch_rodata(self, values: dict) -> int:
        """Rewrite `volatile const` knobs in the .rodata map image before
        load. `values` maps byte offsets to (size, int) or bytes. Returns
        the number of patches applied; raises if .rodata is absent."""
        import struct as _struct

        rodata = None
        for m in self.maps():
            if m.name.endswith(".rodata"):
                rodata = m
                break
        if rodata is None:
            raise RuntimeError("object has no .rodata map to patch")
        view = rodata.initial_value()
        if view is None:
            raise RuntimeError(".rodata has no initial value")
        n = 0
        for off, val in values.items():
            if isinstance(val, bytes):
                view[off:off + len(val)] = val
            else:
                size, num = val
                fmt = {1: "<B", 2: "<H", 4: "<I", 8: "<Q"}[size]
                view[off:off + size] = _struct.pack(fmt, num)
            n += 1
        return n

    def load(self) -> None:
        rc = self._lib.bpf_object__load(self._obj)
        if rc:
            raise OSError(-rc if rc < 0 else rc,
                          "bpf_object__load (see libbpf stderr for the "
                          "verifier log)")
        self.loaded = True

    def close(self) -> None:
        if self._obj:
            self._lib.bpf_object__close(self._obj)
            self._obj = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
