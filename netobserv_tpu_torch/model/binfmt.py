"""Binary layout of the datapath records the resident feed reads.

Counterpart of `netobserv_tpu/model/binfmt.py` (the dtypes `FLOW_KEY_DTYPE`,
`FLOW_STATS_DTYPE`, `FLOW_EVENT_DTYPE`, `DNS_REC_DTYPE`, `DROPS_REC_DTYPE`,
`NEVENTS_REC_DTYPE`, `XLAT_REC_DTYPE`, `EXTRA_REC_DTYPE`, `QUIC_REC_DTYPE`,
the filter, packet and SSL layouts of lines 164-222 (`FILTER_KEY_DTYPE`,
`FILTER_RULE_DTYPE`, `MAX_PAYLOAD_SIZE`, `PACKET_EVENT_DTYPE`,
`MAX_SSL_DATA`, `SSL_EVENT_DTYPE`) and the functions `decode_flow_events`, `encode_flow_events`,
`events_from_keys_stats`), kept as a copy so the port imports nothing of
the JAX package. The layouts are
the eBPF datapath's structs (`netobserv_tpu/datapath/bpf/records.h`),
native-endian and naturally aligned; a CPU test pins every dtype against
the reference's.
"""

from __future__ import annotations

import numpy as np

from netobserv_tpu_torch.model.flow import (
    MAX_EVENT_MD, MAX_NETWORK_EVENTS, MAX_OBSERVED_INTERFACES,
)

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

NEVENTS_REC_DTYPE = np.dtype([
    ("first_seen_ns", "u8"),
    ("last_seen_ns", "u8"),
    ("events", "u1", (MAX_NETWORK_EVENTS, MAX_EVENT_MD)),
    ("bytes", "u2", MAX_NETWORK_EVENTS),
    ("packets", "u2", MAX_NETWORK_EVENTS),
    ("eth_protocol", "u2"),
    ("n_events", "u1"),
    ("pad0", "u1", 5),
])
assert NEVENTS_REC_DTYPE.itemsize == 72, NEVENTS_REC_DTYPE.itemsize

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

# ---------------------------------------------------------------------------
# flow-filter LPM entries — C: struct no_filter_key / no_filter_rule
# (written by datapath/filter_compile.py, matched by bpf/filter.h)
# ---------------------------------------------------------------------------
FILTER_KEY_DTYPE = np.dtype([
    ("prefix_len", "u4"),
    ("ip", "u1", 16),
])
assert FILTER_KEY_DTYPE.itemsize == 20

FILTER_RULE_DTYPE = np.dtype([
    ("proto", "u1"),
    ("icmp_type", "u1"),
    ("icmp_code", "u1"),
    ("direction", "u1"),
    ("action", "u1"),
    ("want_drops", "u1"),
    ("peer_cidr_check", "u1"),
    ("pad0", "u1"),
    ("dport_start", "u2"), ("dport_end", "u2"),
    ("dport1", "u2"), ("dport2", "u2"),
    ("sport_start", "u2"), ("sport_end", "u2"),
    ("sport1", "u2"), ("sport2", "u2"),
    ("port_start", "u2"), ("port_end", "u2"),
    ("port1", "u2"), ("port2", "u2"),
    ("tcp_flags", "u2"),
    ("pad1", "u1", 2),
    ("sample_override", "u4"),
])
assert FILTER_RULE_DTYPE.itemsize == 40, FILTER_RULE_DTYPE.itemsize

# ---------------------------------------------------------------------------
# PCA packet payload record — C: struct no_packet_event
# ---------------------------------------------------------------------------
MAX_PAYLOAD_SIZE = 256

PACKET_EVENT_DTYPE = np.dtype([
    ("if_index", "u4"),
    ("pkt_len", "u4"),
    ("timestamp_ns", "u8"),
    ("payload", "u1", MAX_PAYLOAD_SIZE),
])
assert PACKET_EVENT_DTYPE.itemsize == 272

# ---------------------------------------------------------------------------
# SSL (OpenSSL uprobe) event — C: struct no_ssl_event
# ---------------------------------------------------------------------------
MAX_SSL_DATA = 16 * 1024

SSL_EVENT_DTYPE = np.dtype([
    ("timestamp_ns", "u8"),
    ("pid_tgid", "u8"),
    ("data_len", "i4"),
    ("ssl_type", "u1"),
    ("pad0", "u1", 3),
    ("data", "u1", MAX_SSL_DATA),
])
assert SSL_EVENT_DTYPE.itemsize == 24 + MAX_SSL_DATA



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
