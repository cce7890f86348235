"""The host packers of the three device feeds (dense, compact and
resident), the per-CPU merges and the fused drain pipeline.

Counterpart of `netobserv_tpu/datapath/flowpack.py`: the layout constants
(`DENSE_WORDS`, `COMPACT_WORDS`, `RESIDENT_HDR`, `HOT_WORDS`, `NK_WORDS`,
`RTT_MAX_US`), `compact_buf_len`, `ResidentCaps`, `default_resident_caps`,
`resident_buf_len`, `zero_resident_region`, `KeyDict` in its Python form,
`_fit_rows`, `_feature_words`, `_rtt_code11`, `_lat_code16`, `pack_dense`
with `pack_dense_sharded` and `_pack_submit` (`:341-466`), `pack_compact`
(`:468-565`) and the Python twin of `pack_resident`, kept as a copy. The
layouts are pinned in the reference's `datapath/native/flowpack.cc`
(`fp_pack_dense`, `fp_pack_compact`, `fp_pack_resident`); the device
unpacks are `sketch/state.dense_to_arrays`, `compact_to_arrays` and
`resident_to_arrays`.

- The dense feed is B rows of DENSE_WORDS words, one per event, the rows
  past the event count zeroed.
- The compact feed is one flat buffer: B v4 rows of COMPACT_WORDS words
  (both addresses v4-in-v6 mapped, no drop data), then a spill lane of
  `spill_cap` dense rows for the rest; a batch whose spill rows pass
  `spill_cap` does not pack (`pack_compact` returns None, and the caller
  packs it dense).
- One resident region is a flat uint32 buffer: a header of RESIDENT_HDR
  words (sampling, new keys, spill rows, dns | drops << 16), B hot rows of
  HOT_WORDS words, the sparse DNS lane (caps.dns words), the sparse drop
  lane (caps.drop x 2 words), the new-key lane (caps.nk x NK_WORDS words)
  and the full-width spill lane (caps.spill x DENSE_WORDS words, the dense
  feed's rows). A hot row names its key by a 20-bit slot id of the device
  key table; the host `KeyDict` assigns the slots and the new-key lane
  defines them on the device.

Every feed has a native packer, the port's copy of the reference's C++
(`csrc/flowpack.cc`, from `netobserv_tpu/datapath/native/flowpack.cc`),
built with the host C++ compiler at first use
(`ops/kernels/_build.build_host`), and a Python twin, the layout oracle:

- dense and compact: `pack_dense` and `pack_compact` run the native pass by
  default and the twin with `native=False`; `pack_dense_sharded` splits
  the rows over threads of one pool (`_pack_submit`), each a native pass
  on its own row range (ctypes releases the GIL, so they run at once);
- resident: `NativeKeyDict` with `pack_resident_native`, the staging
  rings' default on every device, or `KeyDict` with `pack_resident`. The
  two dictionaries do not mix. `pack_resident_segment` (the port's own)
  packs every region of one ring-slot image in one native call, spread
  over the caller and the parked threads of a `PackWorkers`; each region
  equals `pack_resident_native`'s.

The per-CPU merges (`merge_percpu`, `merge_percpu_batch` with its
`threads=` row split, reference `:724-816`), the event compose
(`events_from_keys_stats`, `:819-852`) and the fused drain pipeline
(`NativePipe` with `PipeResult` and `PipeChunk` and their ctypes structs,
`:854-1102`) call the same library; their plain twins are
`model/accumulate.COLUMNAR_MERGES` and `model/binfmt.events_from_keys_stats`
and the Python drain chain of `datapath/loader.py`.

A missing compiler, a failed build or a library whose ABI version, record
or struct sizes or layout constants disagree with this package raises;
nothing falls back to a Python form.

The native and Python packers give the same buffers word for word (and
for the resident feed the same rows consumed and dictionary count, chunk
after chunk), with one exception: the native dictionary keys on a 64-bit
fingerprint of the 40 key bytes, the Python one on the bytes. Two keys
with one fingerprint (p ~ n^2 / 2^65, about 1e-6 with 2^18 keys) share a
slot in the native dictionary, where the Python one gives the second key a
slot of its own.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.model.columnar import pack_key_words
from netobserv_tpu_torch.ops.kernels import _build

#: resident feed constants; layout pinned in flowpack.cc fp_pack_resident
RESIDENT_HDR = 4
HOT_WORDS = 3
NK_WORDS = 11
#: row width of the dense feed and of the resident spill lane
DENSE_WORDS = 20
#: row width of the compact (v4) feed; layout pinned in fp_pack_compact
COMPACT_WORDS = 10
#: bytes 8..11 of a v4-in-v6 mapped address as a little-endian u32
V4_PREFIX_WORD2 = 0xFFFF0000
#: hot-row rtt code ceiling (µs); larger samples spill full-width
RTT_MAX_US = 0xFF << 14


def compact_buf_len(batch_size: int, spill_cap: int) -> int:
    """Flat word count of a compact feed buffer: compact lane + spill
    lane."""
    return batch_size * COMPACT_WORDS + spill_cap * DENSE_WORDS


class ResidentCaps:
    """Static side-lane capacities of the resident feed (fixed shapes keep
    the device unpack free of data-dependent shapes; a lane that fills ends
    the chunk, and the rest packs into the next one)."""

    __slots__ = ("dns", "drop", "nk", "spill")

    def __init__(self, dns: int, drop: int, nk: int, spill: int):
        self.dns, self.drop, self.nk, self.spill = dns, drop, nk, spill

    def __iter__(self):
        return iter((self.dns, self.drop, self.nk, self.spill))

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __repr__(self):
        return (f"ResidentCaps(dns={self.dns}, drop={self.drop}, "
                f"nk={self.nk}, spill={self.spill})")


def default_resident_caps(batch_size: int) -> ResidentCaps:
    """Production sizing: DNS-latency and drop rows are minorities of live
    traffic; new keys per batch are a trickle once the flow table is warm;
    the spill lane only carries rows the hot row cannot represent
    exactly."""
    return ResidentCaps(dns=max(batch_size // 16, 64),
                        drop=max(batch_size // 16, 64),
                        nk=max(batch_size // 32, 64),
                        spill=max(batch_size // 64, 32))


def resident_buf_len(batch_size: int, caps: ResidentCaps) -> int:
    """Flat word count of a resident feed buffer (header + all lanes)."""
    return (RESIDENT_HDR + batch_size * HOT_WORDS + caps.dns + caps.drop * 2
            + caps.nk * NK_WORDS + caps.spill * DENSE_WORDS)


def zero_resident_region(out: np.ndarray, batch_size: int,
                         caps: ResidentCaps) -> None:
    """Mask a resident region as empty by zeroing only the words the device
    unpack reads as validity gates: the header, hot-row word 0 (valid bit,
    slot, rtt code), the sparse dns/drop lanes (their entries scatter by
    embedded row index), new-key word 0 (defined bit) and spill word 14
    (valid). Every other word of an invalid row is masked on the device."""
    hot_off = RESIDENT_HDR
    dns_off = hot_off + batch_size * HOT_WORDS
    nk_off = dns_off + caps.dns + caps.drop * 2
    spill_off = nk_off + caps.nk * NK_WORDS
    out[:RESIDENT_HDR] = 0
    out[hot_off:dns_off:HOT_WORDS] = 0
    out[dns_off:nk_off] = 0
    out[nk_off:spill_off:NK_WORDS] = 0
    out[spill_off + 14::DENSE_WORDS] = 0


class KeyDict:
    """Host key -> slot dictionary backing the resident feed, in Python.

    Slots are assigned sequentially in first-seen order. `reset` empties
    the dictionary; the device key table needs no matching reset, because
    every live slot is redefined through the new-key lane before a hot row
    references it. `slots` maps a key's 40 packed bytes to its slot."""

    def __init__(self, slot_cap: int = 1 << 18):
        if slot_cap <= 0 or slot_cap > (1 << 20):
            raise ValueError("slot_cap must be in 1..2^20 (20-bit slot ids)")
        self.slot_cap = slot_cap
        self.slots: dict[bytes, int] = {}

    def count(self) -> int:
        return len(self.slots)

    def reset(self) -> None:
        self.slots.clear()


def _fit_rows(arr, n, dtype):
    """Contiguous, exactly n rows (zero-padded), or None for a missing or
    empty lane."""
    if arr is None or not len(arr):
        return None
    a = np.ascontiguousarray(arr[:n], dtype=dtype)
    if len(a) < n:
        a = np.concatenate([a, np.zeros(n - len(a), dtype)])
    return np.ascontiguousarray(a)


def _feature_words(stats, ex, xl, qc, dr) -> np.ndarray:
    """(n, 4) u32 feature words 16..19 of the dense row (w16 = tcp_flags |
    dscp << 16 | markers << 24, w17 = drop bytes | packets << 16, w18 =
    drop cause | state << 16, w19 = 0). Markers: bit 0 QUIC seen, bit 1 a
    complete NAT translation, bit 2 IPsec encrypted, bit 3 an IPsec
    return code."""
    n = len(stats)
    w = np.zeros((n, 4), np.uint32)
    markers = np.zeros(n, np.uint32)
    if qc is not None:
        markers |= ((qc["version"] != 0) | (qc["seen_long_hdr"] != 0)
                    | (qc["seen_short_hdr"] != 0)).astype(np.uint32)
    if xl is not None:
        # complete translation = both endpoints observed
        both = xl["src_ip"].any(axis=1) & xl["dst_ip"].any(axis=1)
        markers |= both.astype(np.uint32) << 1
    if ex is not None:
        markers |= (ex["ipsec_encrypted"] != 0).astype(np.uint32) << 2
        markers |= (ex["ipsec_ret"] != 0).astype(np.uint32) << 3
    w[:, 0] = (stats["tcp_flags"].astype(np.uint32)
               | (stats["dscp"].astype(np.uint32) << 16)
               | (markers << 24))
    if dr is not None:
        w[:, 1] = (dr["bytes"].astype(np.uint32)
                   | (dr["packets"].astype(np.uint32) << 16))
        # saturate, don't mask: subsystem drop reasons carry the subsystem
        # in bits 16+, and saturation lands them in the overflow bucket
        w[:, 2] = (np.minimum(dr["latest_cause"], np.uint32(0xFFFF))
                   | (dr["latest_state"].astype(np.uint32) << 16))
    return w


def _rtt_code11(rtt_us: int) -> int:
    """8-bit mantissa and 3-bit base-4 exponent: m << (2 * e) <= rtt_us."""
    e = 0
    while (rtt_us >> (2 * e)) > 0xFF:
        e += 1
    return ((rtt_us >> (2 * e)) & 0xFF) | (e << 8)


def _lat_code16(us: int) -> int:
    """12-bit mantissa and 4-bit exponent, saturating: m << e <= us."""
    e = 0
    while (us >> e) > 0xFFF and e < 15:
        e += 1
    return min(us >> e, 0xFFF) | (e << 12)


#: feature lanes of a pack call, in argument order, with their dtypes
_LANE_DTYPES = (binfmt.EXTRA_REC_DTYPE, binfmt.DNS_REC_DTYPE,
                binfmt.DROPS_REC_DTYPE, binfmt.XLAT_REC_DTYPE,
                binfmt.QUIC_REC_DTYPE)


def _pack_args(events_raw, batch_size: int, caps: ResidentCaps, start: int,
               out: Optional[np.ndarray], lanes: tuple):
    """The checks both packers make: (events, out, the feature lanes
    fitted to the event count, None where absent)."""
    if isinstance(events_raw, np.ndarray):
        events = np.ascontiguousarray(events_raw,
                                      dtype=binfmt.FLOW_EVENT_DTYPE)
    else:
        events = binfmt.decode_flow_events(events_raw)
    n = len(events)
    if batch_size > 0xFFFF:
        raise ValueError("resident feed row indices are 16-bit")
    if min(caps.spill, caps.nk) < 1:
        raise ValueError("resident caps must be >= 1 (progress guarantee)")
    if not 0 <= start <= n:
        raise ValueError(f"start {start} out of range 0..{n}")
    total = resident_buf_len(batch_size, caps)
    if out is None:
        out = np.empty(total, dtype=np.uint32)
    elif (out.shape != (total,) or out.dtype != np.uint32
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous ({total},) uint32")
    return events, out, tuple(_fit_rows(a, n, dt)
                              for a, dt in zip(lanes, _LANE_DTYPES))


def pack_resident(events_raw: bytes | np.ndarray,
                  batch_size: int,
                  kdict: KeyDict,
                  caps: ResidentCaps,
                  start: int = 0,
                  extra: Optional[np.ndarray] = None,
                  dns: Optional[np.ndarray] = None,
                  drops: Optional[np.ndarray] = None,
                  xlat: Optional[np.ndarray] = None,
                  quic: Optional[np.ndarray] = None,
                  out: Optional[np.ndarray] = None
                  ) -> tuple[np.ndarray, int]:
    """Raw flow events -> one resident region. Packs events[start:] until
    the hot or spill lane fills; returns (buffer, rows consumed). The
    caller ships the (always self-consistent) prefix and calls again from
    the next row, so the dictionary and the device key table learn
    monotonically even under cold-start key floods.

    A row rides the hot lane when its key has a slot (known, or new while
    the new-key lane and the dictionary have room), its packets and flags
    fit 11 bits, its DSCP 6 bits, its sampling equals the region's (the
    first row's), its rtt is at most RTT_MAX_US, and its DNS latency and
    drops fit their lanes; otherwise it rides the spill lane in full."""
    if not isinstance(kdict, KeyDict):
        raise TypeError("pack_resident takes the Python KeyDict; a "
                        "NativeKeyDict packs with pack_resident_native")
    events, out, (ex, dn, dr, xl, qc) = _pack_args(
        events_raw, batch_size, caps, start, out,
        (extra, dns, drops, xlat, quic))
    n = len(events)
    hot_off = RESIDENT_HDR
    dns_off = hot_off + batch_size * HOT_WORDS
    drop_off = dns_off + caps.dns
    nk_off = drop_off + caps.drop * 2
    spill_off = nk_off + caps.nk * NK_WORDS
    out[:] = 0
    def_sampling = int(events["stats"]["sampling"][start]) if start < n else 0
    out[0] = def_sampling
    if start >= n:
        return out, 0
    # derived arrays over the remainder only: a batch split into many
    # continuation chunks must not recompute the whole batch per chunk
    sl = slice(start, n)
    kw_rel = pack_key_words(events["key"][sl])
    fw_rel = _feature_words(events["stats"][sl],
                            ex[sl] if ex is not None else None,
                            xl[sl] if xl is not None else None,
                            qc[sl] if qc is not None else None,
                            dr[sl] if dr is not None else None)
    stats = events["stats"]
    # u32 wrap, as the native packer's cast and the dense feed's u32 column
    rtt_rel = ((ex["rtt_ns"][sl] // 1000).astype(np.uint32)
               if ex is not None else np.zeros(n - start, np.uint32))
    dlat_rel = ((dn["latency_ns"][sl] // 1000).astype(np.uint64)
                if dn is not None else np.zeros(n - start, np.uint64))
    slots = kdict.slots
    nh = nd = nr = nk = ns = 0
    i = start
    # per row, because the dictionary evolves first-seen-sequentially
    while i < n and nh < batch_size:
        j = i - start
        kb = kw_rel[j].tobytes()
        slot = slots.get(kb)
        if slot is None and nk < caps.nk and len(slots) < kdict.slot_cap:
            slot = len(slots)
            slots[kb] = slot
            row = nk_off + nk * NK_WORDS
            out[row] = 0x80000000 | slot
            out[row + 1:row + 11] = kw_rel[j]
            nk += 1
        rtt = int(rtt_rel[j])
        dlat = int(dlat_rel[j])
        has_drops = dr is not None and bool(dr["bytes"][i] or dr["packets"][i])
        pk, fl = int(stats["packets"][i]), int(stats["tcp_flags"][i])
        hot_ok = (slot is not None and pk < 0x800 and fl < 0x800
                  and int(stats["dscp"][i]) < 0x40
                  and int(stats["sampling"][i]) == def_sampling
                  and rtt <= RTT_MAX_US
                  and (not dlat or nd < caps.dns)
                  and (not has_drops or nr < caps.drop))
        if hot_ok:
            row = hot_off + nh * HOT_WORDS
            out[row] = 0x80000000 | (_rtt_code11(rtt) << 20) | slot
            out[row + 1] = np.float32(stats["bytes"][i]).view(np.uint32)
            out[row + 2] = (pk | (fl << 11)
                            | (int(stats["dscp"][i]) << 22)
                            | ((int(fw_rel[j, 0]) >> 24) << 28))
            if dlat:
                out[dns_off + nd] = (nh << 16) | _lat_code16(dlat)
                nd += 1
            if has_drops:
                cause = min(int(dr["latest_cause"][i]), 0xFFFF)
                out[drop_off + nr * 2] = (nh << 16) | cause
                out[drop_off + nr * 2 + 1] = ((int(dr["packets"][i]) << 16)
                                              | int(dr["bytes"][i]))
                nr += 1
            nh += 1
        else:
            if ns >= caps.spill:
                break  # chunk full: the caller continues from row i
            row = spill_off + ns * DENSE_WORDS
            out[row:row + 10] = kw_rel[j]
            out[row + 10] = np.float32(stats["bytes"][i]).view(np.uint32)
            out[row + 11] = pk
            out[row + 12] = rtt
            # explicit u32 wrap: np.uint32(x) raises for x >= 2^32 (a DNS
            # latency over about 71 minutes in µs)
            out[row + 13] = np.uint32(dlat & 0xFFFFFFFF)
            out[row + 14] = 1
            out[row + 15] = stats["sampling"][i]
            out[row + 16:row + 20] = fw_rel[j]
            ns += 1
        i += 1
    out[1], out[2], out[3] = nk, ns, nd | (nr << 16)
    return out, i - start


# ------------------------------------------------------ the native packer

#: the library's source in csrc/, and the ABI version it must report
NATIVE_SOURCE = "flowpack.cc"
ABI_VERSION = 4
#: the records the library reads, in `fp_struct_sizes` order (the
#: pipeline's structs follow them, `_PIPE_STRUCTS`)
_NATIVE_RECORDS = (binfmt.FLOW_KEY_DTYPE, binfmt.FLOW_STATS_DTYPE,
                   binfmt.FLOW_EVENT_DTYPE, *_LANE_DTYPES,
                   binfmt.NEVENTS_REC_DTYPE)
#: the layout constants, in `fp_layout_words` order
_NATIVE_LAYOUT = (DENSE_WORDS, COMPACT_WORDS, RESIDENT_HDR, HOT_WORDS,
                  NK_WORDS, V4_PREFIX_WORD2)

_LIB: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> None:
    vp, sz, u32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32
    for name, res, args in (
            ("fp_abi_version", ctypes.c_uint32, []),
            ("fp_struct_sizes", ctypes.c_uint32, [vp, ctypes.c_uint32]),
            ("fp_layout_words", ctypes.c_uint32, [vp, ctypes.c_uint32]),
            ("fp_pack_dense", None, [vp, sz, vp, vp, vp, vp, vp, vp, sz]),
            ("fp_pack_compact", ctypes.c_int,
             [vp, sz, vp, vp, vp, vp, vp, vp, sz, sz]),
            ("fp_dict_new", vp, [ctypes.c_uint32]),
            ("fp_dict_free", None, [vp]),
            ("fp_dict_reset", None, [vp]),
            ("fp_dict_count", ctypes.c_uint32, [vp]),
            ("fp_dict_lookup", None, [vp, vp, sz, vp]),
            ("fp_pack_resident", ctypes.c_int64,
             [vp, sz, sz, vp, vp, vp, vp, vp, vp, vp, sz, sz, sz, sz, sz]),
            ("fp_pack_resident_segment", ctypes.c_int64,
             [vp, vp, vp, vp, vp, vp, vp, u32, vp, vp, vp, u32, u32, u32,
              u32, u32, u32, vp, vp, u32]),
            ("fp_workers_new", vp, []),
            ("fp_workers_free", None, [vp]),
            ("fp_events_from_keys_stats", None, [vp, vp, sz, vp]),
            ("fp_pipe_new", vp, [vp, u32, u32]),
            ("fp_pipe_free", None, [vp]),
            ("fp_buf_free", None, [vp]),
            ("fp_pipe_set_drained", ctypes.c_int, [vp, u32, vp, vp, u32]),
            ("fp_drain_to_resident", ctypes.c_int64, [vp, vp, vp]),
            *((fn, None, [vp, sz, vp]) for fn, _ in _MERGE_FNS.values()),
            *((fn + "_batch", None, [vp, sz, sz, vp])
              for fn, _ in _MERGE_FNS.values())):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def _check_abi(lib: ctypes.CDLL, path) -> None:
    """Raise unless the library reports ABI_VERSION, the record sizes of
    `model/binfmt`'s dtypes, the sizes of this module's ctypes mirrors of
    the pipeline's structs and this module's layout constants."""
    ver = int(lib.fp_abi_version())
    if ver != ABI_VERSION:
        raise RuntimeError(f"{path}: packer ABI version {ver}, this package "
                           f"needs {ABI_VERSION}")
    want = ([dt.itemsize for dt in _NATIVE_RECORDS]
            + [ctypes.sizeof(c) for c in _PIPE_STRUCTS])
    sizes = np.zeros(len(want), np.uint64)
    n = int(lib.fp_struct_sizes(sizes.ctypes.data, len(sizes)))
    if n != len(want) or sizes.tolist() != want:
        raise RuntimeError(f"{path}: record sizes {sizes.tolist()[:n]} "
                           "differ from model/binfmt's and the pipeline "
                           f"structs' {want}")
    words = np.zeros(len(_NATIVE_LAYOUT), np.uint32)
    n = int(lib.fp_layout_words(words.ctypes.data, len(words)))
    if n != len(_NATIVE_LAYOUT) or words.tolist() != list(_NATIVE_LAYOUT):
        raise RuntimeError(f"{path}: layout words {words.tolist()[:n]} "
                           f"differ from this module's {_NATIVE_LAYOUT}")


def native_lib() -> ctypes.CDLL:
    """The native packer's library: built at first use (`_build.build_host`),
    loaded, declared and checked once per process. Raises if it cannot be
    built or fails the check."""
    global _LIB
    if _LIB is None:
        path = _build.build_host(NATIVE_SOURCE)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _check_abi(lib, path)
        _LIB = lib
    return _LIB


class NativeKeyDict:
    """Host key -> slot dictionary of the native packer (`csrc/flowpack.cc`
    `fp_dict`: open addressing on a 64-bit key fingerprint). Slots are
    assigned sequentially in first-seen order, as `KeyDict` assigns them;
    `reset` empties it. `close` frees it (also on garbage collection)."""

    def __init__(self, slot_cap: int = 1 << 18):
        if slot_cap <= 0 or slot_cap > (1 << 20):
            raise ValueError("slot_cap must be in 1..2^20 (20-bit slot ids)")
        self.slot_cap = slot_cap
        self._lib = native_lib()
        self._handle = self._lib.fp_dict_new(slot_cap)
        if not self._handle:
            raise MemoryError("fp_dict_new failed")

    def _live_handle(self) -> int:
        """The C dictionary's address; raises once closed."""
        if not self._handle:
            raise ValueError("NativeKeyDict is closed")
        return self._handle

    def count(self) -> int:
        return int(self._lib.fp_dict_count(self._live_handle()))

    def reset(self) -> None:
        self._lib.fp_dict_reset(self._live_handle())

    def slots_of(self, words: np.ndarray) -> np.ndarray:
        """int64 slot of each (n, 10) row of packed key words, -1 where the
        dictionary has none."""
        kw = np.ascontiguousarray(words, dtype=np.uint32).reshape(-1, 10)
        out = np.empty(len(kw), np.int64)
        self._lib.fp_dict_lookup(self._live_handle(), kw.ctypes.data, len(kw),
                                 out.ctypes.data)
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.fp_dict_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def _addr(a: Optional[np.ndarray]) -> Optional[int]:
    return a.ctypes.data if a is not None else None


def pack_resident_native(events_raw: bytes | np.ndarray,
                         batch_size: int,
                         kdict: NativeKeyDict,
                         caps: ResidentCaps,
                         start: int = 0,
                         extra: Optional[np.ndarray] = None,
                         dns: Optional[np.ndarray] = None,
                         drops: Optional[np.ndarray] = None,
                         xlat: Optional[np.ndarray] = None,
                         quic: Optional[np.ndarray] = None,
                         out: Optional[np.ndarray] = None
                         ) -> tuple[np.ndarray, int]:
    """`pack_resident` in C++: the same arguments, checks, region and rows
    consumed, with a `NativeKeyDict` (the module docstring says where the
    two dictionaries can part)."""
    if not isinstance(kdict, NativeKeyDict):
        raise TypeError("pack_resident_native takes a NativeKeyDict; the "
                        "Python KeyDict packs with pack_resident")
    events, out, lanes = _pack_args(events_raw, batch_size, caps, start, out,
                                    (extra, dns, drops, xlat, quic))
    consumed = kdict._lib.fp_pack_resident(
        events.ctypes.data, start, len(events), *(_addr(a) for a in lanes),
        kdict._live_handle(), out.ctypes.data, batch_size, caps.dns, caps.drop,
        caps.nk, caps.spill)
    return out, int(consumed)


class PackWorkers:
    """Parked native threads of `pack_resident_segment` (`csrc/flowpack.cc`
    `fp_workers_new`): started by the first call that wants them, asleep
    between calls. One call at a time uses them; a call that finds them
    busy packs in its own thread. `close` stops and joins them (also on
    garbage collection)."""

    def __init__(self):
        self._lib = native_lib()
        self._handle = self._lib.fp_workers_new()

    def close(self) -> None:
        if self._handle:
            self._lib.fp_workers_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def pack_resident_segment(events: np.ndarray, lanes: tuple,
                          bounds: np.ndarray, dicts: np.ndarray,
                          starts: np.ndarray, out: np.ndarray,
                          batch_size: int, caps: ResidentCaps, slot_cap: int,
                          stats: np.ndarray,
                          workers: Optional[PackWorkers] = None,
                          threads: int = 1) -> int:
    """Pack one segment of a chunk, every region in one native call
    (`fp_pack_resident_segment`, the interpreter lock released once):
    region i is rows `bounds[i]:bounds[i + 1]` of `events` and of each
    feature lane (`lanes`: extra, dns, drops, xlat, quic, each None or
    fitted to the events as `_fit_rows` fits them), packed from row
    `starts[i]` on (advanced in place) with the dictionary whose handle is
    `dicts[i]` into words `i * resident_buf_len(batch_size, caps)` on of
    `out`, after an epoch roll where that dictionary holds `slot_cap`
    slots; a region already exhausted is masked as `zero_resident_region`
    masks it. Each region's buffer, rows consumed and dictionary equal
    `pack_resident_native`'s. `stats[i]` gets region i's rows consumed,
    spill rows, epoch roll (0 or 1) and pack nanoseconds, all 0 for a
    masked region. The regions spread over min(threads, regions) threads:
    the caller and `workers`' helpers. Returns the regions with rows left
    (0 ends the chunk)."""
    nr = len(dicts)
    rw = resident_buf_len(batch_size, caps)
    if (events.dtype != binfmt.FLOW_EVENT_DTYPE
            or not events.flags.c_contiguous):
        raise ValueError("events must be C-contiguous flow events")
    if (bounds.dtype != np.uint64 or bounds.shape != (nr + 1,)
            or dicts.dtype != np.uint64 or starts.dtype != np.uint64
            or starts.shape != (nr,) or stats.dtype != np.int64
            or stats.shape != (nr, 4) or not stats.flags.c_contiguous):
        raise ValueError("bounds, dicts and starts must be uint64 and "
                         "stats (regions, 4) int64")
    if bounds[-1] > len(events) or any(
            a is not None and len(a) < len(events) for a in lanes):
        raise ValueError("a region runs past the events or a lane")
    if (out.dtype != np.uint32 or not out.flags.c_contiguous
            or len(out) < nr * rw):
        raise ValueError(f"out must be C-contiguous uint32 of at least "
                         f"{nr * rw} words")
    left = native_lib().fp_pack_resident_segment(
        events.ctypes.data, *(_addr(a) for a in lanes), bounds.ctypes.data,
        nr, dicts.ctypes.data, starts.ctypes.data, out.ctypes.data,
        batch_size, caps.dns, caps.drop, caps.nk, caps.spill, slot_cap,
        stats.ctypes.data, workers._handle if workers else None,
        threads)
    if left == -3:
        raise RuntimeError("resident pack made no progress")
    if left < 0:
        raise ValueError(f"fp_pack_resident_segment refused its arguments "
                         f"({left})")
    return int(left)


# ------------------------------------------------------ the per-CPU merges

#: merge kind -> (native entry, record dtype); the kinds of
#: `model/accumulate.COLUMNAR_MERGES`, the plain twins
_MERGE_FNS = {
    "stats": ("fp_merge_stats", binfmt.FLOW_STATS_DTYPE),
    "extra": ("fp_merge_extra", binfmt.EXTRA_REC_DTYPE),
    "drops": ("fp_merge_drops", binfmt.DROPS_REC_DTYPE),
    "dns": ("fp_merge_dns", binfmt.DNS_REC_DTYPE),
    "nevents": ("fp_merge_nevents", binfmt.NEVENTS_REC_DTYPE),
    "xlat": ("fp_merge_xlat", binfmt.XLAT_REC_DTYPE),
    "quic": ("fp_merge_quic", binfmt.QUIC_REC_DTYPE),
}

#: rows below which splitting one map's merge over threads costs more than
#: it saves (one batch call is already a few ns a row)
_MERGE_LANE_MIN_ROWS = 4096


def merge_percpu(kind: str, values: np.ndarray) -> np.ndarray:
    """Merge one key's per-CPU partials ((n_cpu,) records of `kind`) into
    one record, natively (reference `datapath/flowpack.py:746-761`)."""
    fn_name, dtype = _MERGE_FNS[kind]
    values = np.ascontiguousarray(values, dtype=dtype)
    out = np.zeros(1, dtype=dtype)
    getattr(native_lib(), fn_name)(values.ctypes.data, len(values),
                                   out.ctypes.data)
    return out[0]


def merge_percpu_batch(kind: str, values: np.ndarray,
                       out: Optional[np.ndarray] = None,
                       threads: int = 1) -> np.ndarray:
    """Merge a whole drained map's per-CPU partials ((n_keys, n_cpus)
    records of `kind`) into (n_keys,) records in one native call
    (reference `:769-816`); `model/accumulate.COLUMNAR_MERGES[kind]` is
    the plain twin. `out` is a caller buffer of (n_keys,) records.
    `threads` > 1 splits the rows of a map of at least
    `_MERGE_LANE_MIN_ROWS` into that many contiguous ranges, one native
    call each on the packer pool (ctypes releases the GIL)."""
    fn_name, dtype = _MERGE_FNS[kind]
    values = np.ascontiguousarray(values, dtype=dtype)
    if values.ndim != 2:
        raise ValueError(f"values must be (n_keys, n_cpus), got "
                         f"{values.shape}")
    n_keys, n_cpus = values.shape
    if out is not None and (out.dtype != dtype or len(out) != n_keys
                            or not out.flags.c_contiguous):
        raise ValueError("out must be a contiguous (n_keys,) array of the "
                         "record dtype")
    if out is None:
        out = np.zeros(n_keys, dtype=dtype)
    if not n_keys:
        return out
    fn = getattr(native_lib(), fn_name + "_batch")

    def run(lo: int, hi: int) -> None:
        fn(values[lo:hi].ctypes.data, hi - lo, n_cpus, out[lo:hi].ctypes.data)

    if threads > 1 and n_keys >= max(_MERGE_LANE_MIN_ROWS, 2 * threads):
        bounds = [n_keys * i // threads for i in range(threads + 1)]
        for f in _pack_submit(threads, [
                functools.partial(run, bounds[i], bounds[i + 1])
                for i in range(threads)]):
            f.result()
    else:
        run(0, n_keys)
    return out


def events_from_keys_stats(keys: np.ndarray, stats: np.ndarray,
                           n_total: Optional[int] = None) -> np.ndarray:
    """FLOW_EVENT rows composed from a drain's two columns in one native
    pass (reference `:819-852`): `keys` (n, 40) u8 or (n,) FLOW_KEY,
    `stats` (n,) FLOW_STATS; `n_total` adds zeroed rows past n (the
    loader's orphan rows). `model/binfmt.events_from_keys_stats` is the
    plain twin."""
    if keys.dtype != np.uint8:
        keys = np.ascontiguousarray(keys).view(np.uint8).reshape(
            -1, binfmt.FLOW_KEY_DTYPE.itemsize)
    n = len(keys)
    if len(stats) != n:
        raise ValueError(f"keys/stats length mismatch: {n} vs {len(stats)}")
    if n_total is not None and n_total < n:
        raise ValueError(f"n_total {n_total} < {n} rows")
    keys = np.ascontiguousarray(keys)
    stats = np.ascontiguousarray(stats, dtype=binfmt.FLOW_STATS_DTYPE)
    out = np.zeros(n_total if n_total is not None else n,
                   dtype=binfmt.FLOW_EVENT_DTYPE)
    if n:
        native_lib().fp_events_from_keys_stats(
            keys.ctypes.data, stats.ctypes.data, n, out.ctypes.data)
    return out


# ------------------------------------------------- the fused drain pipeline
#
# One native call (`fp_drain_to_resident`) runs the drain chain of
# `datapath/loader.py`: every map's drain (batched bpf(2) lookup-and-delete,
# or rows injected with `set_drained`), the per-CPU merges
# (`fp_merge_*_batch`), the key join (`loader._join_keys`'s rules) and,
# with a pack geometry, the resident pack of the ring's `_fold_chunk`
# (`fp_pack_resident`), with the ring's own dictionaries. Its output is
# the Python chain's, byte for byte (tests/test_torch_native_pipeline.py).

#: map kind ids of the pipeline (flowpack.cc FPK_*); map 0 of a pipe is the
#: aggregation map, kind "stats"
PIPE_KINDS = {"stats": 0, "extra": 1, "dns": 2, "drops": 3,
              "nevents": 4, "xlat": 5, "quic": 6}

#: record dtype of each kind (the aligned feature arrays' dtypes)
PIPE_DTYPES = {kind: dtype for kind, (_, dtype) in _MERGE_FNS.items()}

_PIPE_MAX_MAPS = 8
_PIPE_MAX_LADDER = 8


class _PipeMapCfg(ctypes.Structure):
    _fields_ = [("fd", ctypes.c_int32), ("kind", ctypes.c_uint32),
                ("value_size", ctypes.c_uint32), ("n_cpus", ctypes.c_uint32),
                ("max_entries", ctypes.c_uint32)]


class _PipeLadder(ctypes.Structure):
    _fields_ = [("k", ctypes.c_uint32), ("nr", ctypes.c_uint32),
                ("dicts", ctypes.POINTER(ctypes.c_uint64))]


class _PipePackCfg(ctypes.Structure):
    _fields_ = [("n_ladder", ctypes.c_uint32), ("batch_size", ctypes.c_uint32),
                ("batch_per_region", ctypes.c_uint32),
                ("slot_cap", ctypes.c_uint32), ("dns_cap", ctypes.c_uint32),
                ("drop_cap", ctypes.c_uint32), ("nk_cap", ctypes.c_uint32),
                ("spill_cap", ctypes.c_uint32),
                ("ladder", _PipeLadder * _PIPE_MAX_LADDER)]


class _PipeChunk(ctypes.Structure):
    _fields_ = [("row_start", ctypes.c_uint64), ("rows", ctypes.c_uint64),
                ("arena_off", ctypes.c_uint64), ("k", ctypes.c_uint32),
                ("n_segs", ctypes.c_uint32), ("spills", ctypes.c_uint32),
                ("resets", ctypes.c_uint32)]


class _PipeResult(ctypes.Structure):
    _fields_ = [("n_events", ctypes.c_uint64), ("n_agg", ctypes.c_uint64),
                ("n_orphans", ctypes.c_uint64),
                ("packed_rows", ctypes.c_uint64),
                ("drain_ns", ctypes.c_uint64), ("merge_ns", ctypes.c_uint64),
                ("join_ns", ctypes.c_uint64), ("pack_ns", ctypes.c_uint64),
                ("syscalls", ctypes.c_uint64),
                ("lex_fallback", ctypes.c_uint64),
                ("batch_err_mask", ctypes.c_uint64),
                ("n_chunks", ctypes.c_uint64),
                ("arena_words", ctypes.c_uint64),
                ("spill_rows", ctypes.c_uint64),
                ("dict_resets", ctypes.c_uint64), ("segs", ctypes.c_uint64),
                ("events", ctypes.c_void_p), ("arena", ctypes.c_void_p),
                ("chunks", ctypes.c_void_p),
                ("aligned", ctypes.c_void_p * _PIPE_MAX_MAPS),
                ("map_rows", ctypes.c_uint64 * _PIPE_MAX_MAPS)]


#: the ctypes mirrors, in `fp_struct_sizes` order after the records
_PIPE_STRUCTS = (_PipeMapCfg, _PipePackCfg, _PipeChunk, _PipeResult)


def _pipe_view(addr: Optional[int], nbytes: int,
               dtype) -> Optional[np.ndarray]:
    if not addr or nbytes == 0:
        return None
    buf = (ctypes.c_uint8 * nbytes).from_address(addr)
    return np.frombuffer(buf, dtype=dtype)


class PipeChunk:
    """One pack chunk of a fused drain: one k-chunk of the ring's `fold`
    (reference `:958-977`). Its `n_segs` segments of `n_shards * k * lanes`
    regions each start at word `arena_off` of the arena, one ring slot
    image a segment."""

    __slots__ = ("row_start", "rows", "arena_off", "k", "n_segs", "spills",
                 "resets")

    def __init__(self, c: _PipeChunk):
        self.row_start = int(c.row_start)
        self.rows = int(c.rows)
        self.arena_off = int(c.arena_off)
        self.k = int(c.k)
        self.n_segs = int(c.n_segs)
        self.spills = int(c.spills)
        self.resets = int(c.resets)


class PipeResult:
    """What one fused drain gives (reference `:980-1038`). `events` and
    `aligned[kind]` are views of the pipe's scratch, valid until its next
    drain (the caller copies them once, into its `EvictedFlows`); the
    packed `arena` belongs to this object until `free()`."""

    __slots__ = ("n_events", "n_agg", "n_orphans", "packed_rows", "drain_s",
                 "merge_s", "join_s", "pack_s", "syscalls", "lex_fallback",
                 "batch_err_mask", "map_rows", "events", "aligned", "arena",
                 "chunks", "spill_rows", "dict_resets", "segs", "_arena_ptr")

    def __init__(self, res: _PipeResult, kinds: list):
        self.n_events = int(res.n_events)
        self.n_agg = int(res.n_agg)
        self.n_orphans = int(res.n_orphans)
        self.packed_rows = int(res.packed_rows)
        self.drain_s = res.drain_ns * 1e-9
        self.merge_s = res.merge_ns * 1e-9
        self.join_s = res.join_ns * 1e-9
        self.pack_s = res.pack_ns * 1e-9
        self.syscalls = int(res.syscalls)
        self.lex_fallback = int(res.lex_fallback)
        self.batch_err_mask = int(res.batch_err_mask)
        self.spill_rows = int(res.spill_rows)
        self.dict_resets = int(res.dict_resets)
        self.segs = int(res.segs)
        self.map_rows = [int(res.map_rows[i]) for i in range(len(kinds))]
        self.events = _pipe_view(
            res.events, self.n_events * binfmt.FLOW_EVENT_DTYPE.itemsize,
            binfmt.FLOW_EVENT_DTYPE)
        self.aligned = {}
        for i, kind in enumerate(kinds[1:], 1):
            dt = PIPE_DTYPES[kind]
            self.aligned[kind] = _pipe_view(
                res.aligned[i], self.n_events * dt.itemsize, dt)
        self._arena_ptr = res.arena or 0
        self.arena = _pipe_view(self._arena_ptr, int(res.arena_words) * 4,
                                np.uint32)
        self.chunks = []
        if res.n_chunks and res.chunks:
            carr = (_PipeChunk * int(res.n_chunks)).from_address(res.chunks)
            self.chunks = [PipeChunk(c) for c in carr]

    def free(self) -> None:
        """Free the arena (idempotent)."""
        if self._arena_ptr:
            native_lib().fp_buf_free(self._arena_ptr)
            self._arena_ptr = 0
            self.arena = None

    def __del__(self):
        if getattr(self, "_arena_ptr", 0):
            self.free()


class NativePipe:
    """One `fp_drain_to_resident` pipeline over a fixed set of maps
    (reference `:1041-1102`). `maps` is [(fd, kind, value_size, n_cpus,
    max_entries)], map 0 the aggregation map (kind "stats", n_cpus 1); a
    map of fd < 0 is injected (`set_drained`). `lanes` spreads the maps'
    drains and merges over that many native threads; the call holds no
    GIL. A configuration the library rejects raises ValueError."""

    def __init__(self, maps: list, lanes: int = 1):
        if not maps or len(maps) > _PIPE_MAX_MAPS:
            raise ValueError(f"1..{_PIPE_MAX_MAPS} maps required")
        self._lib = native_lib()
        self.kinds = [m[1] for m in maps]
        cfgs = (_PipeMapCfg * len(maps))()
        for i, (fd, kind, value_size, n_cpus, max_entries) in enumerate(maps):
            cfgs[i] = _PipeMapCfg(fd=fd, kind=PIPE_KINDS[kind],
                                  value_size=value_size, n_cpus=n_cpus,
                                  max_entries=max_entries)
        self._handle = self._lib.fp_pipe_new(ctypes.addressof(cfgs),
                                             len(maps), max(lanes, 1))
        if not self._handle:
            raise ValueError("fp_pipe_new rejected the map configuration")

    def _live_handle(self) -> int:
        if not self._handle:
            raise ValueError("NativePipe is closed")
        return self._handle

    def set_drained(self, idx: int, keys: np.ndarray,
                    vals: np.ndarray) -> None:
        """Inject one drain of map `idx` (fd < 0): keys (n, 40) u8, vals
        n rows of n_cpus records, contiguous (the kernel's layout)."""
        keys = np.ascontiguousarray(keys)
        vals = np.ascontiguousarray(vals)
        rc = self._lib.fp_pipe_set_drained(
            self._live_handle(), idx, keys.ctypes.data, vals.ctypes.data,
            len(keys))
        if rc != 0:
            raise ValueError(f"fp_pipe_set_drained({idx}) failed")

    def drain(self, pack: Optional[dict] = None) -> PipeResult:
        """Run the pipeline. `pack` (None: drain, merge and join only) is
        {"batch_size", "batch_per_region", "slot_cap", "caps":
        ResidentCaps, "ladder": [(k, [dictionary handles])]}, the ladder
        ascending from k = 1, the handles `NativeKeyDict._live_handle()`s
        in the ring's per-region order
        (`sketch/staging.ResidentPackSurface.pack_spec`). Raises
        RuntimeError on a failed allocation or a pack that made no
        progress."""
        res = _PipeResult()
        keepalive = []
        pk_addr = None
        if pack is not None:
            caps, ladder = pack["caps"], pack["ladder"]
            if len(ladder) > _PIPE_MAX_LADDER:
                raise ValueError("ladder too deep")
            pk = _PipePackCfg(
                n_ladder=len(ladder), batch_size=pack["batch_size"],
                batch_per_region=pack["batch_per_region"],
                slot_cap=pack["slot_cap"], dns_cap=caps.dns,
                drop_cap=caps.drop, nk_cap=caps.nk, spill_cap=caps.spill)
            for li, (k, handles) in enumerate(ladder):
                arr = (ctypes.c_uint64 * len(handles))(*handles)
                keepalive.append(arr)
                pk.ladder[li] = _PipeLadder(
                    k=k, nr=len(handles),
                    dicts=ctypes.cast(arr, ctypes.POINTER(ctypes.c_uint64)))
            keepalive.append(pk)
            pk_addr = ctypes.addressof(pk)
        rc = int(self._lib.fp_drain_to_resident(
            self._live_handle(), pk_addr, ctypes.addressof(res)))
        del keepalive
        if rc < 0:
            raise RuntimeError(f"fp_drain_to_resident failed (rc={rc})")
        return PipeResult(res, self.kinds)

    def close(self) -> None:
        if self._handle:
            self._lib.fp_pipe_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


# ------------------------------------------------- the dense and compact feeds

def _events_of(events_raw) -> np.ndarray:
    """Flow events as a contiguous FLOW_EVENT_DTYPE array (raw bytes are
    decoded)."""
    if isinstance(events_raw, np.ndarray):
        return np.ascontiguousarray(events_raw, dtype=binfmt.FLOW_EVENT_DTYPE)
    return binfmt.decode_flow_events(events_raw)


def _out_buffer(out: Optional[np.ndarray], shape: tuple) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype=np.uint32)
    if (out.shape != shape or out.dtype != np.uint32
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be C-contiguous {shape} uint32")
    return out


def pack_dense(events_raw: bytes | np.ndarray,
               batch_size: Optional[int] = None,
               extra: Optional[np.ndarray] = None,
               dns: Optional[np.ndarray] = None,
               drops: Optional[np.ndarray] = None,
               xlat: Optional[np.ndarray] = None,
               quic: Optional[np.ndarray] = None,
               out: Optional[np.ndarray] = None,
               native: bool = True) -> np.ndarray:
    """Raw flow events -> one (batch_size, DENSE_WORDS) u32 array, the dense
    feed (`sketch/state.dense_to_arrays` unpacks it). The rows past the
    event count are zeroed, so a reused `out` never leaks stale rows.
    `native=False` runs the Python twin."""
    events = _events_of(events_raw)
    n = len(events)
    batch_size = batch_size or max(n, 1)
    if n > batch_size:
        raise ValueError(f"{n} events exceed batch size {batch_size}")
    out = _out_buffer(out, (batch_size, DENSE_WORDS))
    ex, dn, dr, xl, qc = (_fit_rows(a, n, dt) for a, dt in zip(
        (extra, dns, drops, xlat, quic), _LANE_DTYPES))
    if native:
        native_lib().fp_pack_dense(
            events.ctypes.data, n, *(_addr(a) for a in (ex, dn, dr, xl, qc)),
            out.ctypes.data, batch_size)
        return out
    out[n:] = 0
    if n:
        stats = events["stats"]
        out[:n, :10] = pack_key_words(events["key"])
        out[:n, 10] = stats["bytes"].astype(np.float32).view(np.uint32)
        out[:n, 11] = stats["packets"]
        out[:n, 12] = ex["rtt_ns"] // 1000 if ex is not None else 0
        out[:n, 13] = dn["latency_ns"] // 1000 if dn is not None else 0
        out[:n, 14] = 1
        out[:n, 15] = stats["sampling"]
        out[:n, 16:] = _feature_words(stats, ex, xl, qc, dr)
    return out


_PACK_POOL: Optional[ThreadPoolExecutor] = None
_PACK_POOL_SIZE = 0
_PACK_POOL_LOCK = threading.Lock()


def _pack_submit(threads: int, fns: list[Callable]) -> list[Future]:
    """Submit pack jobs to the one packer pool under its lock: making the
    pool, growing it (retiring the old pool's workers) and submitting are
    one step, so a concurrent grower never shuts a pool down between
    another caller getting it and submitting to it. `shutdown(wait=False)`
    lets jobs already submitted run to their end."""
    global _PACK_POOL, _PACK_POOL_SIZE
    with _PACK_POOL_LOCK:
        if _PACK_POOL is None or _PACK_POOL_SIZE < threads:
            if _PACK_POOL is not None:
                _PACK_POOL.shutdown(wait=False)
            _PACK_POOL = ThreadPoolExecutor(max_workers=threads,
                                            thread_name_prefix="flowpack")
            _PACK_POOL_SIZE = threads
        return [_PACK_POOL.submit(fn) for fn in fns]


def pack_dense_sharded(events_raw: bytes | np.ndarray,
                       batch_size: int,
                       threads: int,
                       extra: Optional[np.ndarray] = None,
                       dns: Optional[np.ndarray] = None,
                       drops: Optional[np.ndarray] = None,
                       xlat: Optional[np.ndarray] = None,
                       quic: Optional[np.ndarray] = None,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """`pack_dense` (native) with the rows split over `threads` packer
    threads, each packing a disjoint row range of the same `out`; the last
    also zeroes the rows past the events. The same buffer as `pack_dense`;
    one thread, or fewer than two rows a thread, packs in one pass."""
    events = _events_of(events_raw)
    n = len(events)
    if n > batch_size:
        raise ValueError(f"{n} events exceed batch size {batch_size}")
    feats = {"extra": extra, "dns": dns, "drops": drops, "xlat": xlat,
             "quic": quic}
    if threads <= 1 or n < 2 * threads:
        return pack_dense(events, batch_size=batch_size, out=out, **feats)
    out = _out_buffer(out, (batch_size, DENSE_WORDS))
    bounds = [n * i // threads for i in range(threads + 1)]

    def shard(i):
        lo, hi = bounds[i], bounds[i + 1]
        bs = (batch_size - lo) if i == threads - 1 else (hi - lo)
        pack_dense(events[lo:hi], batch_size=bs, out=out[lo:lo + bs],
                   **{k: (v[lo:hi] if v is not None and len(v) else None)
                      for k, v in feats.items()})

    for f in _pack_submit(threads, [lambda i=i: shard(i)
                                    for i in range(threads)]):
        f.result()
    return out


def pack_compact(events_raw: bytes | np.ndarray,
                 batch_size: int,
                 spill_cap: int,
                 extra: Optional[np.ndarray] = None,
                 dns: Optional[np.ndarray] = None,
                 drops: Optional[np.ndarray] = None,
                 xlat: Optional[np.ndarray] = None,
                 quic: Optional[np.ndarray] = None,
                 out: Optional[np.ndarray] = None,
                 native: bool = True) -> Optional[np.ndarray]:
    """Raw flow events -> one flat u32 buffer `[batch_size * COMPACT_WORDS
    v4 rows | spill_cap * DENSE_WORDS dense rows]`, the compact feed
    (`sketch/state.compact_to_arrays` unpacks it). Non-v4 flows, and rows
    that carry drop data, ride the spill lane; returns None when they pass
    `spill_cap` (the caller packs that batch dense). `native=False` runs
    the Python twin."""
    events = _events_of(events_raw)
    n = len(events)
    if n > batch_size:
        raise ValueError(f"{n} events exceed batch size {batch_size}")
    out = _out_buffer(out, (compact_buf_len(batch_size, spill_cap),))
    ex, dn, dr, xl, qc = (_fit_rows(a, n, dt) for a, dt in zip(
        (extra, dns, drops, xlat, quic), _LANE_DTYPES))
    if native:
        ns = native_lib().fp_pack_compact(
            events.ctypes.data, n, *(_addr(a) for a in (ex, dn, dr, xl, qc)),
            out.ctypes.data, batch_size, spill_cap)
        return None if ns < 0 else out
    comp = out[:batch_size * COMPACT_WORDS].reshape(batch_size, COMPACT_WORDS)
    spill = out[batch_size * COMPACT_WORDS:].reshape(spill_cap, DENSE_WORDS)
    comp[:] = 0
    spill[:] = 0
    if not n:
        return out
    kw = pack_key_words(events["key"])
    stats = events["stats"]
    fw = _feature_words(stats, ex, xl, qc, dr)
    has_drops = (fw[:, 1] != 0) if dr is not None else np.zeros(n, np.bool_)
    is4 = ((kw[:, 0] == 0) & (kw[:, 1] == 0) & (kw[:, 2] == V4_PREFIX_WORD2)
           & (kw[:, 4] == 0) & (kw[:, 5] == 0) & (kw[:, 6] == V4_PREFIX_WORD2)
           & ~has_drops)
    n_sp = int((~is4).sum())
    if n_sp > spill_cap:
        return None
    rtt = ((ex["rtt_ns"] // 1000).astype(np.uint32) if ex is not None
           else np.zeros(n, np.uint32))
    dlat = ((dn["latency_ns"] // 1000).astype(np.uint32) if dn is not None
            else np.zeros(n, np.uint32))
    c = comp[:int(is4.sum())]
    c[:, 0] = kw[is4, 3]
    c[:, 1] = kw[is4, 7]
    c[:, 2] = kw[is4, 8]
    c[:, 3] = kw[is4, 9] | np.uint32(0x80000000)
    c[:, 4] = stats["bytes"][is4].astype(np.float32).view(np.uint32)
    c[:, 5] = stats["packets"][is4]
    c[:, 6] = rtt[is4]
    c[:, 7] = dlat[is4]
    c[:, 8] = stats["sampling"][is4]
    c[:, 9] = fw[is4, 0]
    if n_sp:
        sp = spill[:n_sp]
        sp[:, :10] = kw[~is4]
        sp[:, 10] = stats["bytes"][~is4].astype(np.float32).view(np.uint32)
        sp[:, 11] = stats["packets"][~is4]
        sp[:, 12] = rtt[~is4]
        sp[:, 13] = dlat[~is4]
        sp[:, 14] = 1
        sp[:, 15] = stats["sampling"][~is4]
        sp[:, 16:] = fw[~is4]
    return out
