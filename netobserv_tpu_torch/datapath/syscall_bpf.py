"""Direct bpf(2) syscall access to BPF maps — no libbpf dependency.

Powers EBPF_PROGRAM_MANAGER_MODE (bpfman): an external lifecycle manager owns
the programs and pins the maps on bpffs; the agent opens the pinned maps and
evicts through them (reference analog: `pkg/tracer/tracer.go:275-384`). Also
used by tests to create scratch maps and exercise the real kernel eviction
path where CAP_BPF is available.

The port's copy of `netobserv_tpu/datapath/syscall_bpf.py`, kept so that
the port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import logging
import os
import platform
import struct
from typing import Optional

import numpy as np

log = logging.getLogger("netobserv_tpu_torch.datapath.syscall_bpf")

# syscall numbers for bpf(2)
_SYSCALL_TABLE = {
    "x86_64": 321,
    "aarch64": 280,
    "ppc64le": 361,
    "s390x": 351,
    "riscv64": 280,
}
_MACHINE = platform.machine()
if _MACHINE not in _SYSCALL_TABLE:
    raise ImportError(
        f"bpf(2) syscall number unknown for architecture {_MACHINE!r}")
_SYSCALL_NR = _SYSCALL_TABLE[_MACHINE]

# bpf(2) commands
BPF_MAP_CREATE = 0
BPF_MAP_LOOKUP_ELEM = 1
BPF_MAP_UPDATE_ELEM = 2
BPF_MAP_DELETE_ELEM = 3
BPF_MAP_GET_NEXT_KEY = 4
BPF_OBJ_PIN = 6
BPF_OBJ_GET = 7
BPF_MAP_LOOKUP_AND_DELETE_ELEM = 21
BPF_OBJ_GET_INFO_BY_FD = 15
BPF_MAP_LOOKUP_AND_DELETE_BATCH = 25  # only the delete variant is used here

# per-CPU map types (kernel enum bpf_map_type, uapi/linux/bpf.h): values
# cross the syscall boundary at round_up(value_size, 8) per possible CPU.
# PERCPU_HASH=5, PERCPU_ARRAY=6, LRU_PERCPU_HASH=10, PERCPU_CGROUP_STORAGE=21
PERCPU_MAP_TYPES = frozenset({5, 6, 10, 21})

# kernel-internal "operation not supported" — what BPF_DO_BATCH returns when
# the map type has no batch ops; distinct from errno.ENOTSUP (95) and has no
# errno.h name, so spell it out
ENOTSUPP_KERNEL = 524

BPF_ANY = 0
BPF_NOEXIST = 1

_libc = ctypes.CDLL(None, use_errno=True)


def _bpf(cmd: int, attr: bytes) -> int:
    """Reference: `netobserv_tpu/datapath/syscall_bpf.py:67`."""
    buf = ctypes.create_string_buffer(attr, len(attr))
    ret = _libc.syscall(_SYSCALL_NR, cmd, buf, len(attr))
    if ret < 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    return ret


def _bpf_inout(cmd: int, attr: bytearray) -> int:
    """Reference: `netobserv_tpu/datapath/syscall_bpf.py:76`."""
    buf = (ctypes.c_char * len(attr)).from_buffer(attr)
    ret = _libc.syscall(_SYSCALL_NR, cmd, buf, len(attr))
    if ret < 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    return ret


class BpfMap:
    """One open BPF map fd with typed key/value byte access.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:85`."""

    def __init__(self, fd: int, key_size: int, value_size: int,
                 max_entries: int = 0, n_cpus: int = 1,
                 percpu: bool = False):
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:88`."""
        self.fd = fd
        self.key_size = key_size
        self.value_size = value_size
        self.max_entries = max_entries
        self.n_cpus = n_cpus  # per-CPU maps: values are per-cpu arrays
        # per-CPU-ness must come from the map TYPE, not n_cpus>1: on a
        # 1-CPU machine a per-CPU map still crosses the syscall boundary at
        # the kernel's round_up(value_size, 8) stride
        self.percpu = percpu
        self._no_lookup_and_delete = False  # latched capability probe
        self._no_batch_ops = False          # latched (kernels < 5.6)
        self._batch_bufs = None             # cached drain_batched buffers

    # --- constructors ---
    @classmethod
    def create(cls, map_type: int, key_size: int, value_size: int,
               max_entries: int, name: bytes = b"",
               flags: int = 0) -> "BpfMap":
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:106`."""
        attr = struct.pack("=IIII", map_type, key_size, value_size,
                           max_entries)
        attr += struct.pack("=I", flags)  # map_flags (LPM needs NO_PREALLOC)
        attr += b"\x00" * 4  # inner_map_fd
        attr += b"\x00" * 4  # numa_node
        attr += name[:15].ljust(16, b"\x00")
        fd = _bpf(BPF_MAP_CREATE, attr)
        percpu = map_type in PERCPU_MAP_TYPES
        return cls(fd, key_size, value_size, max_entries,
                   # per-CPU buffers must span every possible CPU from the
                   # start — waiting for call sites to set n_cpus is how
                   # value-buffer overruns happen
                   n_cpus=n_possible_cpus() if percpu else 1,
                   percpu=percpu)

    def pin(self, path: str) -> None:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:124`."""
        pathbuf = ctypes.create_string_buffer(path.encode() + b"\x00")
        attr = struct.pack("=QI", ctypes.addressof(pathbuf), self.fd)
        _bpf(BPF_OBJ_PIN, attr)

    @staticmethod
    def get_info(fd: int) -> tuple[int, int, int, int]:
        """(map_type, key_size, value_size, max_entries) via
        BPF_OBJ_GET_INFO_BY_FD.

        Reference: `netobserv_tpu/datapath/syscall_bpf.py:130`."""
        info = ctypes.create_string_buffer(88)  # struct bpf_map_info
        attr = struct.pack("=IIQ", fd, len(info), ctypes.addressof(info))
        _bpf(BPF_OBJ_GET_INFO_BY_FD, attr)
        map_type, _id, key_size, value_size, max_entries = struct.unpack_from(
            "=IIIII", info.raw, 0)
        return map_type, key_size, value_size, max_entries

    @classmethod
    def open_pinned(cls, path: str, key_size: int, value_size: int,
                    n_cpus: Optional[int] = None) -> "BpfMap":
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:141`."""
        pathbuf = path.encode() + b"\x00"
        str_ptr = ctypes.create_string_buffer(pathbuf)
        attr = struct.pack("=Q", ctypes.addressof(str_ptr))
        fd = _bpf(BPF_OBJ_GET, attr)
        # validate the pinned map's REAL sizes: a layout mismatch would let
        # the kernel write past our value buffer (heap corruption)
        _mtype, real_key, real_value, _max_entries = cls.get_info(fd)
        if real_key != key_size or real_value != value_size:
            os.close(fd)
            raise ValueError(
                f"pinned map {path} layout mismatch: kernel has "
                f"key={real_key}/value={real_value}, expected "
                f"key={key_size}/value={value_size} (datapath version skew?)")
        percpu = _mtype in PERCPU_MAP_TYPES
        if n_cpus is None:
            # per-CPU buffers must span every possible CPU from the start;
            # relying on callers to pass n_cpus is how overruns happen
            n_cpus = n_possible_cpus() if percpu else 1
        return cls(fd, key_size, value_size, _max_entries, n_cpus=n_cpus,
                   percpu=percpu)

    # --- element ops ---
    # Per-CPU maps: the kernel transfers round_up(value_size, 8) bytes per
    # CPU (kernel/bpf/syscall.c bpf_map_value_size) in BOTH directions —
    # buffers must use the padded stride or copy_to_user overruns them for
    # any non-8-aligned value struct. The public API keeps the unpadded
    # value_size * n_cpus concatenation.
    @property
    def _pad_vs(self) -> int:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:171`."""
        return ((self.value_size + 7) & ~7) if self.percpu \
            else self.value_size

    def _unpad_value(self, raw: bytes) -> bytes:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:175`."""
        pad = self._pad_vs
        if pad == self.value_size:
            return raw[:self.value_size * self.n_cpus]
        return b"".join(raw[c * pad:c * pad + self.value_size]
                        for c in range(self.n_cpus))

    def _ptr_attr(self, key: bytes, value_buf=None, flags: int = 0) -> tuple:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:182`."""
        kbuf = ctypes.create_string_buffer(key, self.key_size)
        vbuf = value_buf if value_buf is not None else \
            ctypes.create_string_buffer(self._pad_vs * self.n_cpus)
        attr = struct.pack("=IxxxxQQQ", self.fd, ctypes.addressof(kbuf),
                           ctypes.addressof(vbuf), flags)
        return attr, kbuf, vbuf

    def update(self, key: bytes, value: bytes, flags: int = BPF_ANY) -> None:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:190`."""
        pad, vs = self._pad_vs, self.value_size
        if pad != vs and len(value) == vs * self.n_cpus:
            value = b"".join(value[c * vs:(c + 1) * vs].ljust(pad, b"\x00")
                             for c in range(self.n_cpus))
        vbuf = ctypes.create_string_buffer(value, pad * self.n_cpus)
        attr, _k, _v = self._ptr_attr(key, vbuf, flags)
        _bpf(BPF_MAP_UPDATE_ELEM, attr)

    def lookup(self, key: bytes) -> Optional[bytes]:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:199`."""
        attr, _k, vbuf = self._ptr_attr(key)
        try:
            _bpf(BPF_MAP_LOOKUP_ELEM, attr)
        except OSError as exc:
            if exc.errno == errno.ENOENT:
                return None
            raise
        return self._unpad_value(vbuf.raw)

    def lookup_and_delete(self, key: bytes) -> Optional[bytes]:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:209`."""
        attr, _k, vbuf = self._ptr_attr(key)
        try:
            _bpf(BPF_MAP_LOOKUP_AND_DELETE_ELEM, attr)
        except OSError as exc:
            if exc.errno == errno.ENOENT:
                return None
            if exc.errno in (errno.EINVAL, errno.ENOTSUP, errno.EPERM):
                raise NotImplementedError(
                    "LOOKUP_AND_DELETE unsupported for this map/kernel") from exc
            raise
        return self._unpad_value(vbuf.raw)

    def delete(self, key: bytes) -> bool:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:222`."""
        kbuf = ctypes.create_string_buffer(key, self.key_size)
        attr = struct.pack("=IxxxxQQQ", self.fd, ctypes.addressof(kbuf), 0, 0)
        try:
            _bpf(BPF_MAP_DELETE_ELEM, attr)
            return True
        except OSError as exc:
            if exc.errno == errno.ENOENT:
                return False
            raise

    def next_key(self, key: Optional[bytes]) -> Optional[bytes]:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:233`."""
        kbuf = ctypes.create_string_buffer(
            key if key is not None else b"\x00" * self.key_size, self.key_size)
        nbuf = ctypes.create_string_buffer(self.key_size)
        attr = struct.pack("=IxxxxQQQ", self.fd,
                           0 if key is None else ctypes.addressof(kbuf),
                           ctypes.addressof(nbuf), 0)
        try:
            _bpf(BPF_MAP_GET_NEXT_KEY, attr)
        except OSError as exc:
            if exc.errno == errno.ENOENT:
                return None
            raise
        return nbuf.raw

    def keys(self) -> list[bytes]:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:248`."""
        out = []
        key = self.next_key(None)
        while key is not None:
            out.append(key)
            key = self.next_key(key)
        return out

    def drain_batched_arrays(
            self, chunk: int = 2048
    ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Bulk eviction via BPF_MAP_LOOKUP_AND_DELETE_BATCH, decoded
        straight from the syscall buffers: returns ``(keys, values)`` u8
        arrays of shape ``(n, key_size)`` and ``(n, padded_value_stride)``.

        ZERO-COPY CONTRACT: when the drain completes in one syscall round
        (the steady state — `chunk` is clamped to the map size), the returned
        arrays are VIEWS of the cached ``_batch_bufs`` storage and are
        INVALIDATED by the next drain on this map. Callers copy exactly once,
        at their output boundary (the columnar eviction plane copies at
        EvictedFlows construction — pinned by the aliasing regression in
        tests/test_bpfman.py). Multi-round drains concatenate (fresh
        arrays). Per-CPU values keep the kernel's round_up(value_size, 8)
        stride; every record dtype in binfmt is 8-aligned, so the stride is
        normally the plain itemsize.

        Returns None (latched) when the kernel or map type doesn't support
        batch ops (< 5.6).

        Reference: `netobserv_tpu/datapath/syscall_bpf.py:256`."""
        if self._no_batch_ops:
            return None
        vstride = self._pad_vs * self.n_cpus
        # no point sizing rounds past the map itself; buffers are cached on
        # the object so steady-state eviction ticks don't re-zero hundreds
        # of KB per drain
        if self.max_entries:
            chunk = min(chunk, self.max_entries)
        # the batch token is opaque (u32 bucket cursor for hash maps); size
        # it generously and let the kernel use what it needs
        tok_a = ctypes.create_string_buffer(max(self.key_size, 8))
        tok_b = ctypes.create_string_buffer(max(self.key_size, 8))
        cached = self._batch_bufs
        if cached is not None and cached[0] >= chunk:
            _cap, kbuf, vbuf = cached  # reuse storage; keep caller's chunk
        else:
            kbuf = ctypes.create_string_buffer(self.key_size * chunk)
            vbuf = ctypes.create_string_buffer(vstride * chunk)
            self._batch_bufs = (chunk, kbuf, vbuf)
        done_k: list[np.ndarray] = []  # banked earlier rounds (copies)
        done_v: list[np.ndarray] = []
        pend_k = pend_v = None         # latest round: views into kbuf/vbuf

        def result() -> tuple[np.ndarray, np.ndarray]:
            if not done_k:
                if pend_k is None:
                    return (np.empty((0, self.key_size), np.uint8),
                            np.empty((0, vstride), np.uint8))
                return pend_k, pend_v  # single round: zero-copy views
            ks = done_k + ([pend_k] if pend_k is not None else [])
            vs = done_v + ([pend_v] if pend_v is not None else [])
            return np.concatenate(ks), np.concatenate(vs)

        first = True
        while True:
            if pend_k is not None:
                # the buffers are about to be rewritten: bank this round
                done_k.append(pend_k.copy())
                done_v.append(pend_v.copy())
                pend_k = pend_v = None
            attr = bytearray(struct.pack(
                "=QQQQIIQQ",
                0 if first else ctypes.addressof(tok_a),
                ctypes.addressof(tok_b),
                ctypes.addressof(kbuf), ctypes.addressof(vbuf),
                chunk, self.fd, 0, 0))
            done = False
            try:
                _bpf_inout(BPF_MAP_LOOKUP_AND_DELETE_BATCH, attr)
            except OSError as exc:
                if exc.errno == errno.ENOENT:
                    done = True          # iterated to the end; count is valid
                elif exc.errno == errno.ENOSPC:
                    # a single bucket holds more entries than `chunk`
                    chunk *= 2
                    kbuf = ctypes.create_string_buffer(self.key_size * chunk)
                    vbuf = ctypes.create_string_buffer(vstride * chunk)
                    self._batch_bufs = (chunk, kbuf, vbuf)
                    continue
                elif (first and not done_k
                      and exc.errno in (errno.EINVAL, errno.EPERM,
                                        errno.ENOTSUP, ENOTSUPP_KERNEL)):
                    self._no_batch_ops = True
                    return None
                elif done_k:
                    # banked entries are already DELETED from the kernel
                    # map; raising would lose them for good (the per-key
                    # idiom loses at most one). Return the partial drain —
                    # the remainder is picked up next eviction tick.
                    log.warning(
                        "batched drain aborted mid-iteration after %d "
                        "entries: %s (returning partial result)",
                        sum(len(k) for k in done_k), exc)
                    return result()
                else:
                    raise
            count = struct.unpack_from("=I", attr, 32)[0]
            if count:
                pend_k = np.frombuffer(
                    kbuf, dtype=np.uint8, count=count * self.key_size
                ).reshape(count, self.key_size)
                pend_v = np.frombuffer(
                    vbuf, dtype=np.uint8, count=count * vstride
                ).reshape(count, vstride)
            if done or count == 0:
                return result()
            ctypes.memmove(tok_a, tok_b, len(tok_b))
            first = False

    def drain_batched(self,
                      chunk: int = 2048) -> Optional[list[tuple[bytes, bytes]]]:
        """Bulk eviction via BPF_MAP_LOOKUP_AND_DELETE_BATCH: one syscall per
        `chunk` entries instead of two per entry — the batched analog of the
        reference's per-key eviction loop (`tracer.go:1022-1054`). The pairs
        view over drain_batched_arrays (values re-packed to the unpadded
        concatenation); returns None (latched) when the kernel or map type
        doesn't support batch ops (< 5.6).

        Reference: `netobserv_tpu/datapath/syscall_bpf.py:365`."""
        res = self.drain_batched_arrays(chunk)
        if res is None:
            return None
        keys, vals = res
        return [(keys[i].tobytes(), self._unpad_value(vals[i].tobytes()))
                for i in range(len(keys))]

    def drain(self) -> list[tuple[bytes, bytes]]:
        """Eviction: batched lookup-and-delete when the kernel supports it,
        else the two-phase per-key idiom (iterate keys, then lookup-and-
        delete each, falling back to lookup+delete on old kernels, latched
        after the first failure) — the reference's eviction loop
        (`tracer.go:1022-1054`, legacy `tracer_legacy.go:11-35`).

        Reference: `netobserv_tpu/datapath/syscall_bpf.py:380`."""
        batched = self.drain_batched()
        if batched is not None:
            return batched
        out = []
        for key in self.keys():
            if self._no_lookup_and_delete:
                val = self.lookup(key)
                self.delete(key)
            else:
                try:
                    val = self.lookup_and_delete(key)
                except NotImplementedError:
                    self._no_lookup_and_delete = True
                    val = self.lookup(key)
                    self.delete(key)
            if val is not None:
                out.append((key, val))
        return out

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:405`."""
        try:
            os.close(self.fd)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# program load: raw instruction assembly + BPF_PROG_LOAD
# ---------------------------------------------------------------------------
BPF_PROG_LOAD = 5
BPF_PROG_TYPE_KPROBE = 2
BPF_PROG_TYPE_SCHED_CLS = 3
BPF_PROG_TYPE_TRACEPOINT = 5


def insn(opcode: int, dst: int = 0, src: int = 0, off: int = 0,
         imm: int = 0) -> bytes:
    """Encode one eBPF instruction (delegates to the single encoding
    definition in datapath.asm).

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:421`."""
    from netobserv_tpu_torch.datapath.asm import encode
    return encode(opcode, dst, src, off, imm)


def ld_map_fd(dst: int, map_fd: int) -> bytes:
    """BPF_LD_IMM64 with BPF_PSEUDO_MAP_FD (two instruction slots).

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:429`."""
    from netobserv_tpu_torch.datapath.asm import encode_ld_map_fd
    return encode_ld_map_fd(dst, map_fd)


def packet_counter_prog(map_fd: int) -> bytes:
    """A minimal TC classifier: atomically bump slot 0 of an array map and
    pass the packet. Used to validate the load/attach path end-to-end with a
    real program when no compiler is available.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:435`."""
    return b"".join([
        insn(0x62, 10, 0, -4, 0),      # *(u32*)(r10-4) = 0   (key)
        insn(0xBF, 2, 10),             # r2 = r10
        insn(0x07, 2, 0, 0, -4),       # r2 += -4
        ld_map_fd(1, map_fd),          # r1 = map
        insn(0x85, 0, 0, 0, 1),        # call map_lookup_elem
        insn(0x15, 0, 0, 3, 0),        # if r0 == 0 goto +3
        insn(0xB7, 1, 0, 0, 1),        # r1 = 1
        insn(0xDB, 0, 1, 0, 0x00),     # lock *(u64*)(r0+0) += r1
        insn(0xB7, 0, 0, 0, 0),        # r0 = TC_ACT_OK
        insn(0x95),                    # exit
    ])


def prog_load(insns: bytes, prog_type: int = BPF_PROG_TYPE_SCHED_CLS,
              license_: bytes = b"GPL", name: bytes = b"netobserv") -> int:
    """BPF_PROG_LOAD; returns the program fd (raises OSError with the
    verifier log on rejection).

    libbpf's two-phase strategy: first load with no log (a verbose log for a
    program of any size overflows fixed buffers — the kernel then fails the
    load with ENOSPC even when the program is valid); only on rejection retry
    at log_level=1 with a large buffer to harvest the actual error.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:453`."""
    n_insns = len(insns) // 8
    insn_buf = ctypes.create_string_buffer(insns, len(insns))
    lic_buf = ctypes.create_string_buffer(license_ + b"\x00")

    def attempt(log_level: int, log_buf) -> int:
        attr = struct.pack(
            "=IIQQIIQI",
            prog_type, n_insns, ctypes.addressof(insn_buf),
            ctypes.addressof(lic_buf),
            log_level, len(log_buf) if log_buf is not None else 0,
            ctypes.addressof(log_buf) if log_buf is not None else 0,
            0)  # kern_version
        attr += struct.pack("=I", 0)  # prog_flags
        attr += name[:15].ljust(16, b"\x00")
        return _bpf(BPF_PROG_LOAD, attr)

    try:
        return attempt(0, None)
    except OSError:
        log_buf = ctypes.create_string_buffer(1 << 23)
        try:
            # reproduce with the error log enabled (fd is equally valid if
            # the rejection somehow doesn't reproduce)
            return attempt(1, log_buf)
        except OSError as exc2:
            log_txt = log_buf.value.decode(errors="replace").strip()
            raise OSError(exc2.errno,
                          f"{exc2.strerror}; verifier log:\n{log_txt}") \
                from exc2


def obj_pin(fd: int, path: str) -> None:
    """Reference: `netobserv_tpu/datapath/syscall_bpf.py:493`."""
    pathbuf = ctypes.create_string_buffer(path.encode() + b"\x00")
    attr = struct.pack("=QI", ctypes.addressof(pathbuf), fd)
    _bpf(BPF_OBJ_PIN, attr)


# --- TCX links (kernel >= 6.6) -------------------------------------------

BPF_LINK_CREATE = 28
BPF_LINK_DETACH = 34
BPF_TCX_INGRESS = 46
BPF_TCX_EGRESS = 47


def link_create_tcx(prog_fd: int, if_index: int, direction: str) -> int:
    """Attach a SCHED_CLS program to an interface's TCX hook via
    BPF_LINK_CREATE; returns the bpf_link fd — closing it detaches (reference
    analog: cilium/ebpf link.AttachTCX used at tracer.go:454-459). Raises
    OSError(ENOTSUP/EINVAL) on pre-6.6 kernels, letting callers fall back to
    legacy TC; OSError(EEXIST) when mprog rejects a duplicate attachment.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:507`."""
    attach_type = BPF_TCX_INGRESS if direction == "ingress" else BPF_TCX_EGRESS
    # union bpf_attr link_create: prog_fd, target_ifindex, attach_type, flags
    # + zeroed tcx { relative_fd/id, expected_revision } tail (= default
    # anchor position, no revision check)
    attr = struct.pack("=IIII", prog_fd, if_index, attach_type, 0)
    attr += b"\x00" * 16
    return _bpf(BPF_LINK_CREATE, attr)


def link_detach(link_fd: int) -> None:
    """Explicit BPF_LINK_DETACH (the link fd alone also detaches on close).

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:522`."""
    attr = struct.pack("=I", link_fd)
    _bpf(BPF_LINK_DETACH, attr)


BPF_LINK_GET_FD_BY_ID = 30
BPF_LINK_GET_NEXT_ID = 31
BPF_LINK_TYPE_TCX = 11


def prog_id_of(prog_fd: int) -> int:
    """Kernel-assigned program id (bpf_prog_info.id).

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:533`."""
    info = ctypes.create_string_buffer(256)
    attr = struct.pack("=IIQ", prog_fd, len(info), ctypes.addressof(info))
    _bpf(BPF_OBJ_GET_INFO_BY_FD, attr)
    return struct.unpack_from("=I", info.raw, 4)[0]


def link_info(link_fd: int) -> tuple[int, int, int, int, int]:
    """(link_type, link_id, prog_id, tcx_ifindex, tcx_attach_type) — the tcx
    fields are only meaningful when link_type == BPF_LINK_TYPE_TCX.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:541`."""
    info = ctypes.create_string_buffer(256)
    attr = struct.pack("=IIQ", link_fd, len(info), ctypes.addressof(info))
    _bpf(BPF_OBJ_GET_INFO_BY_FD, attr)
    ltype, lid, pid = struct.unpack_from("=III", info.raw, 0)
    ifindex, attach_type = struct.unpack_from("=II", info.raw, 16)
    return ltype, lid, pid, ifindex, attach_type


def iter_link_ids():
    """Yield every bpf_link id on the system (CAP_BPF required).

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:552`."""
    cur = 0
    while True:
        attr = bytearray(struct.pack("=III", cur, 0, 0))
        try:
            _bpf_inout(BPF_LINK_GET_NEXT_ID, attr)
        except OSError as exc:
            if exc.errno == errno.ENOENT:
                return
            raise
        cur = struct.unpack_from("=I", attr, 4)[0]
        yield cur


def find_tcx_link(if_index: int, direction: str,
                  prog_id: Optional[int] = None) -> Optional[int]:
    """Open the existing TCX link on (if_index, direction), optionally
    requiring it to carry a specific program — the adoption path when
    link_create returns EEXIST (reference: link.QueryPrograms + NewFromID,
    tracer.go:464-480). Returns a link fd or None.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:567`."""
    want = BPF_TCX_INGRESS if direction == "ingress" else BPF_TCX_EGRESS
    for lid in iter_link_ids():
        attr = struct.pack("=I", lid)
        try:
            fd = _bpf(BPF_LINK_GET_FD_BY_ID, attr)
        except OSError:
            continue
        try:
            ltype, _lid, pid, ifx, atype = link_info(fd)
        except OSError:
            os.close(fd)
            continue  # unrelated link whose info query fails; keep scanning
        if (ltype == BPF_LINK_TYPE_TCX and ifx == if_index and atype == want
                and (prog_id is None or pid == prog_id)):
            return fd
        os.close(fd)
    return None


RINGBUF_BUSY_BIT = 0x80000000
RINGBUF_DISCARD_BIT = 0x40000000
_RB_HDR_SIZE = 8


def parse_ringbuf_records(data, consumer_pos: int, producer_pos: int,
                          mask: int) -> tuple[list[bytes], int]:
    """Walk ring records in [consumer_pos, producer_pos); returns
    (records, new_consumer_pos). Stops at a BUSY (still-being-written)
    record. Pure function so the wire format is unit-testable.

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:597`."""
    out: list[bytes] = []
    pos = consumer_pos
    while pos < producer_pos:
        off = pos & mask
        hdr = int.from_bytes(data[off:off + 4], "little")
        if hdr & RINGBUF_BUSY_BIT:
            break
        length = hdr & ~(RINGBUF_BUSY_BIT | RINGBUF_DISCARD_BIT)
        if not (hdr & RINGBUF_DISCARD_BIT):
            start = off + _RB_HDR_SIZE
            out.append(bytes(data[start:start + length]))
        pos += (_RB_HDR_SIZE + length + 7) & ~7  # 8-byte aligned advance
    return out, pos


class RingBufReader:
    """mmap consumer for a BPF_MAP_TYPE_RINGBUF map (libbpf ring layout:
    consumer page rw at offset 0; producer page + data ro at PAGE_SIZE).

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:617`."""

    def __init__(self, ringbuf_map: BpfMap):
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:621`."""
        import mmap as _mmap
        import select

        self._map = ringbuf_map
        _mtype, _k, _v, max_entries = BpfMap.get_info(ringbuf_map.fd)
        self._size = max_entries
        self._mask = max_entries - 1
        page = _mmap.PAGESIZE
        self._cons = _mmap.mmap(ringbuf_map.fd, page, _mmap.MAP_SHARED,
                                _mmap.PROT_READ | _mmap.PROT_WRITE, offset=0)
        self._prod = _mmap.mmap(ringbuf_map.fd, page + 2 * max_entries,
                                _mmap.MAP_SHARED, _mmap.PROT_READ,
                                offset=page)
        self._data_off = page
        self._epoll = select.epoll()
        self._epoll.register(ringbuf_map.fd, select.EPOLLIN)
        self._pending: list[bytes] = []

    def _positions(self) -> tuple[int, int]:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:640`."""
        cons = int.from_bytes(self._cons[0:8], "little")
        prod = int.from_bytes(self._prod[0:8], "little")
        return cons, prod

    def read(self, timeout_s: float) -> Optional[bytes]:
        """One record, or None on timeout.

        Reference: `netobserv_tpu/datapath/syscall_bpf.py:645`."""
        if self._pending:
            return self._pending.pop(0)
        cons, prod = self._positions()
        if cons >= prod:
            if not self._epoll.poll(timeout_s):
                return None
            cons, prod = self._positions()
        data = memoryview(self._prod)[self._data_off:]
        records, new_cons = parse_ringbuf_records(data, cons, prod, self._mask)
        self._cons[0:8] = new_cons.to_bytes(8, "little")
        if not records:
            return None
        self._pending = records[1:]
        return records[0]

    def close(self) -> None:
        """Reference: `netobserv_tpu/datapath/syscall_bpf.py:662`."""
        self._epoll.close()
        self._cons.close()
        self._prod.close()


def n_possible_cpus() -> int:
    """Reference: `netobserv_tpu/datapath/syscall_bpf.py:668`."""
    try:
        with open("/sys/devices/system/cpu/possible") as fh:
            spec = fh.read().strip()
        last = spec.split("-")[-1].split(",")[-1]
        return int(last) + 1
    except (OSError, ValueError):
        return os.cpu_count() or 1


def bpf_available() -> bool:
    """Can this process create BPF maps? (CAP_BPF or root + kernel support)

    Reference: `netobserv_tpu/datapath/syscall_bpf.py:678`."""
    try:
        m = BpfMap.create(1, 4, 8, 4, b"probe")  # BPF_MAP_TYPE_HASH
        m.close()
        return True
    except OSError:
        return False
