"""Uprobe attachment via perf_event_open(2) — no libbpf required.

Powers the self-managed OpenSSL plaintext tracer: resolve the target
function's file offset from the library's ELF symbol tables, open a uprobe
perf event on (path, offset), then bind a BPF_PROG_TYPE_KPROBE program to it
(PERF_EVENT_IOC_SET_BPF + ENABLE). Reference analog: the cilium/ebpf
link.Uprobe path used by pkg/tracer for SSL_write (tracer.go OpenSSL attach);
the mechanism here is the same one libbpf uses internally.

The port's copy of `netobserv_tpu/datapath/uprobe.py`, kept so that the
port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import struct

_libc = ctypes.CDLL(None, use_errno=True)
# syscall number and the pt_regs argument offsets (asm_ssl.py) are per-arch;
# only x86_64 is wired — other architectures must fail loudly, not call an
# unrelated syscall with a pointer argument
_PERF_EVENT_OPEN_BY_ARCH = {"x86_64": 298}


def _perf_event_open_nr() -> int:
    """Reference: `netobserv_tpu/datapath/uprobe.py:25`."""
    import platform

    machine = platform.machine()
    try:
        return _PERF_EVENT_OPEN_BY_ARCH[machine]
    except KeyError:
        raise RuntimeError(
            f"uprobe attach not wired for architecture {machine!r} "
            "(x86_64 only: syscall number + pt_regs offsets)") from None

PERF_FLAG_FD_CLOEXEC = 1 << 3
PERF_EVENT_IOC_ENABLE = 0x2400
PERF_EVENT_IOC_SET_BPF = 0x40042408

SHT_SYMTAB, SHT_DYNSYM = 2, 11
PT_LOAD = 1


def elf_func_offset(path: str, symbol: str) -> int:
    """File offset of `symbol` in the ELF at `path` (st_value translated
    through the containing PT_LOAD segment — libbpf's elf_find_func_offset).

    Reference: `netobserv_tpu/datapath/uprobe.py:44`."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"\x7fELF" or data[4] != 2:
        raise ValueError(f"{path}: not a 64-bit ELF")
    (e_phoff,) = struct.unpack_from("=Q", data, 0x20)
    (e_shoff,) = struct.unpack_from("=Q", data, 0x28)
    e_phentsize, e_phnum = struct.unpack_from("=HH", data, 0x36)
    e_shentsize, e_shnum = struct.unpack_from("=HH", data, 0x3A)

    sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (_name, stype, _flags, _addr, offset, size, link, _info, _align,
         entsize) = struct.unpack_from("=IIQQQQIIQQ", data, off)
        sections.append((stype, offset, size, link, entsize))

    vaddr = None
    for stype, offset, size, link, entsize in sections:
        if stype not in (SHT_SYMTAB, SHT_DYNSYM) or not entsize:
            continue
        _t, str_off, str_size, _l, _e = sections[link]
        for j in range(size // entsize):
            st = offset + j * entsize
            st_name, st_info = struct.unpack_from("=IB", data, st)
            (st_value,) = struct.unpack_from("=Q", data, st + 8)
            if not st_value or (st_info & 0xF) != 2:  # STT_FUNC
                continue
            end = data.index(b"\x00", str_off + st_name)
            if data[str_off + st_name:end].decode() == symbol:
                vaddr = st_value
                break
        if vaddr is not None:
            break
    if vaddr is None:
        raise LookupError(f"{symbol} not found in {path}")

    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        p_type, _pf = struct.unpack_from("=II", data, off)
        p_offset, p_vaddr, _paddr, p_filesz = struct.unpack_from(
            "=QQQQ", data, off + 8)
        if p_type == PT_LOAD and p_vaddr <= vaddr < p_vaddr + p_filesz:
            return vaddr - p_vaddr + p_offset
    raise LookupError(f"{symbol}: vaddr {vaddr:#x} outside any PT_LOAD")


def uprobe_pmu_type() -> int:
    """Reference: `netobserv_tpu/datapath/uprobe.py:93`."""
    with open("/sys/bus/event_source/devices/uprobe/type") as fh:
        return int(fh.read())


class _PerfAttachment:
    """A BPF program bound to a perf event; the event fd keeps the probe
    alive (closing detaches). Subclasses fill the perf_event_attr:
    struct perf_event_attr (zero-padded to 128B, size=VER5=112):
    type@0, size@4, config@8, sample_period@16, config1@56, config2@64.

    Reference: `netobserv_tpu/datapath/uprobe.py:98`."""

    def _open_and_bind(self, attr: bytearray, prog_fd: int,
                       desc: str) -> None:
        """Reference: `netobserv_tpu/datapath/uprobe.py:104`."""
        buf = (ctypes.c_char * len(attr)).from_buffer(attr)
        fd = _libc.syscall(_perf_event_open_nr(), buf, -1, 0, -1,
                           PERF_FLAG_FD_CLOEXEC)
        if fd < 0:
            err = ctypes.get_errno()
            raise OSError(err,
                          f"perf_event_open({desc}): {os.strerror(err)}")
        self.fd = fd
        try:
            fcntl.ioctl(fd, PERF_EVENT_IOC_SET_BPF, prog_fd)
            fcntl.ioctl(fd, PERF_EVENT_IOC_ENABLE, 0)
        except OSError:
            os.close(fd)
            raise

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/uprobe.py:121`."""
        try:
            os.close(self.fd)
        except OSError:
            pass


class UprobeAttachment(_PerfAttachment):
    """One live uprobe on (binary, file offset). The path buffer must
    outlive perf_event_open, so it is held.

    Reference: `netobserv_tpu/datapath/uprobe.py:128`."""

    def __init__(self, prog_fd: int, binary_path: str, file_offset: int):
        """Reference: `netobserv_tpu/datapath/uprobe.py:132`."""
        self._path_buf = ctypes.create_string_buffer(
            os.fsencode(binary_path) + b"\x00")
        attr = bytearray(128)
        struct.pack_into("=II", attr, 0, uprobe_pmu_type(), 112)
        struct.pack_into("=Q", attr, 56, ctypes.addressof(self._path_buf))
        struct.pack_into("=Q", attr, 64, file_offset)
        self._open_and_bind(attr, prog_fd,
                            f"uprobe {binary_path}+{file_offset:#x}")


PERF_TYPE_TRACEPOINT = 2
_TRACEFS = "/sys/kernel/tracing"


def ensure_tracefs() -> str:
    """Mount tracefs if absent (root; the image leaves it unmounted).

    Reference: `netobserv_tpu/datapath/uprobe.py:147`."""
    if not os.path.isdir(os.path.join(_TRACEFS, "events")):
        import subprocess

        subprocess.run(["mount", "-t", "tracefs", "tracefs", _TRACEFS],
                       capture_output=True)
    if not os.path.isdir(os.path.join(_TRACEFS, "events")):
        raise RuntimeError("tracefs unavailable (mount tracefs "
                           f"{_TRACEFS})")
    return _TRACEFS


def tracepoint_id(category: str, name: str) -> int:
    """Reference: `netobserv_tpu/datapath/uprobe.py:160`."""
    with open(f"{ensure_tracefs()}/events/{category}/{name}/id") as fh:
        return int(fh.read())


def tracepoint_fields(category: str, name: str) -> dict[str, int]:
    """field name -> byte offset in the tracepoint context, parsed from the
    live format file — layouts shift between kernel versions (6.18 inserted
    rx_sk into skb/kfree_skb), so offsets must never be hardcoded.

    Reference: `netobserv_tpu/datapath/uprobe.py:165`."""
    import re

    out: dict[str, int] = {}
    path = f"{ensure_tracefs()}/events/{category}/{name}/format"
    with open(path) as fh:
        for line in fh:
            # array dims may be symbolic on older kernels:
            # "__u8 saddr[sizeof(struct sockaddr_in6)]"
            m = re.search(
                r"field:[^;]*?(\w+)(?:\[[^\]]*\])?;\s*offset:(\d+);", line)
            if m:
                out[m.group(1)] = int(m.group(2))
    return out


class TracepointAttachment(_PerfAttachment):
    """A BPF_PROG_TYPE_TRACEPOINT program bound to a perf tracepoint event
    (PERF_TYPE_TRACEPOINT, config = event id) — the attach mechanism behind
    the reference's tracepoint sections (SEC(\"tracepoint/skb/kfree_skb\")).

    Reference: `netobserv_tpu/datapath/uprobe.py:184`."""

    def __init__(self, prog_fd: int, category: str, name: str):
        """Reference: `netobserv_tpu/datapath/uprobe.py:189`."""
        attr = bytearray(128)
        struct.pack_into("=II", attr, 0, PERF_TYPE_TRACEPOINT, 112)
        struct.pack_into("=Q", attr, 8, tracepoint_id(category, name))
        struct.pack_into("=Q", attr, 16, 1)  # sample_period (required != 0)
        self._open_and_bind(attr, prog_fd, f"tracepoint {category}/{name}")


def find_libssl() -> str | None:
    """Locate the OpenSSL shared library, preferring the newest ABI version
    (a leftover libssl.so.1.1 next to libssl.so.3 must not win — processes
    load the current SONAME) and real versioned files over dev symlinks.

    Reference: `netobserv_tpu/datapath/uprobe.py:197`."""
    candidates = []
    for libdir in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib",
                   "/lib/x86_64-linux-gnu", "/lib64"):
        try:
            for name in os.listdir(libdir):
                if name.startswith("libssl.so"):
                    suffix = name[len("libssl.so"):].lstrip(".")
                    version = tuple(
                        int(p) for p in suffix.split(".") if p.isdigit())
                    candidates.append((version, os.path.join(libdir, name)))
        except OSError:
            continue
    return max(candidates)[1] if candidates else None


def resolve_ssl_library(preferred: str = "") -> tuple[str, int]:
    """(path, SSL_write file offset): the configured path when it carries
    the symbol (OPENSSL_PATH may point at a vendored library), else the
    system libssl.

    Reference: `netobserv_tpu/datapath/uprobe.py:216`."""
    if preferred:
        try:
            return preferred, elf_func_offset(preferred, "SSL_write")
        except (OSError, ValueError, LookupError) as exc:
            import logging

            logging.getLogger("netobserv_tpu_torch.datapath.uprobe").warning(
                "OPENSSL_PATH %s unusable for the SSL_write uprobe (%s); "
                "falling back to the system libssl", preferred, exc)
    path = find_libssl()
    if path is None:
        raise RuntimeError("no libssl.so found (set OPENSSL_PATH to the "
                           "library your workload loads)")
    return path, elf_func_offset(path, "SSL_write")
