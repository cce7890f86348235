"""Binary layout of the datapath records the resident feed reads.

Counterpart of `netobserv_tpu/model/binfmt.py` (the dtypes `FLOW_KEY_DTYPE`,
`FLOW_STATS_DTYPE`, `FLOW_EVENT_DTYPE`, `DNS_REC_DTYPE`, `DROPS_REC_DTYPE`,
`XLAT_REC_DTYPE`, `EXTRA_REC_DTYPE`, `QUIC_REC_DTYPE` and the functions
`decode_flow_events`, `encode_flow_events`, `events_from_keys_stats`), kept
as a copy so the port imports nothing of the JAX package. The layouts are
the eBPF datapath's structs (`netobserv_tpu/datapath/bpf/records.h`),
native-endian and naturally aligned; a CPU test pins every dtype against
the reference's.
"""

from __future__ import annotations

import numpy as np

from netobserv_tpu_torch.model.flow import MAX_OBSERVED_INTERFACES

# flow key: C struct no_flow_key (40 bytes)
FLOW_KEY_DTYPE = np.dtype([
    ("src_ip", "u1", 16),
    ("dst_ip", "u1", 16),
    ("src_port", "u2"),
    ("dst_port", "u2"),
    ("proto", "u1"),
    ("icmp_type", "u1"),
    ("icmp_code", "u1"),
    ("pad0", "u1"),
])
assert FLOW_KEY_DTYPE.itemsize == 40

# base flow stats: C struct no_flow_stats (104 bytes); the kernel's spin
# lock is a plain u32 placeholder on the host side
NIFS = MAX_OBSERVED_INTERFACES

FLOW_STATS_DTYPE = np.dtype([
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("bytes", "u8"),
    ("packets", "u4"),
    ("eth_protocol", "u2"),
    ("tcp_flags", "u2"),
    ("src_mac", "u1", 6),
    ("dst_mac", "u1", 6),
    ("if_index_first", "u4"),
    ("lock", "u4"),
    ("sampling", "u4"),
    ("direction_first", "u1"),
    ("errno_fallback", "u1"),
    ("dscp", "u1"),
    ("n_observed_intf", "u1"),
    ("observed_direction", "u1", NIFS),
    ("pad0", "u1", 2),  # aligns observed_intf (u32[]) to 4 in the C struct
    ("observed_intf", "u4", NIFS),
    ("ssl_version", "u2"),
    ("tls_cipher_suite", "u2"),
    ("tls_key_share", "u2"),
    ("tls_types", "u1"),
    ("misc_flags", "u1"),
    ("pad1", "u1", 4),
])
assert FLOW_STATS_DTYPE.itemsize == 104, FLOW_STATS_DTYPE.itemsize

# ringbuffer fallback payload: C struct no_flow_event (key + stats)
FLOW_EVENT_DTYPE = np.dtype([
    ("key", FLOW_KEY_DTYPE),
    ("stats", FLOW_STATS_DTYPE),
])
assert FLOW_EVENT_DTYPE.itemsize == 144

# per-feature records (values of the per-CPU feature maps, merged at
# eviction)
DNS_REC_DTYPE = np.dtype([
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("latency_ns", "u8"),
    ("dns_id", "u2"),
    ("dns_flags", "u2"),
    ("eth_protocol", "u2"),
    ("errno", "u1"),
    ("name", "S32"),  # DNS_NAME_MAX_LEN
    ("pad0", "u1", 1),
])
assert DNS_REC_DTYPE.itemsize == 64, DNS_REC_DTYPE.itemsize

DROPS_REC_DTYPE = np.dtype([
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("bytes", "u2"),
    ("packets", "u2"),
    ("latest_cause", "u4"),
    ("latest_flags", "u2"),
    ("eth_protocol", "u2"),
    ("latest_state", "u1"),
    ("pad0", "u1", 3),
])
assert DROPS_REC_DTYPE.itemsize == 32, DROPS_REC_DTYPE.itemsize

XLAT_REC_DTYPE = np.dtype([
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("src_ip", "u1", 16),
    ("dst_ip", "u1", 16),
    ("src_port", "u2"),
    ("dst_port", "u2"),
    ("zone_id", "u2"),
    ("eth_protocol", "u2"),
])
assert XLAT_REC_DTYPE.itemsize == 56, XLAT_REC_DTYPE.itemsize

EXTRA_REC_DTYPE = np.dtype([  # rtt + ipsec (reference: additional_metrics_t)
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("rtt_ns", "u8"),
    ("ipsec_ret", "i4"),
    ("eth_protocol", "u2"),
    ("ipsec_encrypted", "u1"),
    ("pad0", "u1", 1),
])
assert EXTRA_REC_DTYPE.itemsize == 32, EXTRA_REC_DTYPE.itemsize

QUIC_REC_DTYPE = np.dtype([
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("version", "u4"),
    ("eth_protocol", "u2"),
    ("seen_long_hdr", "u1"),
    ("seen_short_hdr", "u1"),
])
assert QUIC_REC_DTYPE.itemsize == 24, QUIC_REC_DTYPE.itemsize


def decode_flow_events(raw: bytes | bytearray | memoryview) -> np.ndarray:
    """Bulk-decode a byte buffer of contiguous flow events (ringbuf drain)."""
    if len(raw) % FLOW_EVENT_DTYPE.itemsize:
        raise ValueError(
            f"buffer length {len(raw)} not a multiple of flow event size "
            f"{FLOW_EVENT_DTYPE.itemsize}")
    return np.frombuffer(raw, dtype=FLOW_EVENT_DTYPE)


def encode_flow_events(events: np.ndarray) -> bytes:
    """Inverse of decode_flow_events."""
    return np.ascontiguousarray(events, dtype=FLOW_EVENT_DTYPE).tobytes()


def events_from_keys_stats(keys: np.ndarray, stats: np.ndarray,
                           n_total: int | None = None) -> np.ndarray:
    """Compose FLOW_EVENT rows from separate key/stats arrays; ``n_total``
    over-allocates zeroed tail rows."""
    n = len(keys)
    if len(stats) != n:
        raise ValueError(f"keys/stats length mismatch: {n} vs {len(stats)}")
    out = np.zeros(n_total if n_total is not None else n,
                   dtype=FLOW_EVENT_DTYPE)
    out["key"][:n] = keys
    out["stats"][:n] = stats
    return out
