"""Per-feature merge semantics: how two partial observations of one flow
combine.

A copy of `netobserv_tpu/model/accumulate.py` (lines 1-442), kept so the
port imports nothing of the JAX package: the per-record rules
`accumulate_base`, `accumulate_dns`, `accumulate_drops`,
`accumulate_extra`, `accumulate_xlat`, `accumulate_network_events` and
`accumulate_quic` (`:42-179`), `merge_percpu` (`:180`), and their columnar
twins over (n_keys, n_cpus) partials with `COLUMNAR_MERGES` (`:205-442`).
Plain numpy, no device. The rules hold wherever partials merge: the
per-CPU feature maps at eviction, the ring-buffer singles the accounter
re-aggregates (`flow/accounter.py`), and the device folds (bytes and
packets add, RTT and DNS latency take the max).

The per-record functions mutate `dst` (a numpy structured scalar or
1-element view) in place, merging `src` into it. Each columnar merge is
bit for bit the matching per-record function run in CPU order per key.
`tests/test_torch_accumulate.py` holds every function against the
reference's.
"""

from __future__ import annotations

import numpy as np

U16_MAX = np.uint64(0xFFFF)

# no_flow_stats.misc_flags bits (records.h NO_MISC_SSL_MISMATCH)
MISC_SSL_MISMATCH = 0x01
U32_MAX = np.uint64(0xFFFF_FFFF)
U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)


def _sat_add(a, b, cap) -> int:
    s = int(a) + int(b)
    return int(cap) if s > int(cap) else s


def _merge_times(dst, src) -> None:
    """first_seen = min (zero means unset), last_seen = max."""
    s_first, s_last = int(src["first_seen_ns"]), int(src["last_seen_ns"])
    d_first = int(dst["first_seen_ns"])
    if d_first == 0 or (s_first != 0 and s_first < d_first):
        dst["first_seen_ns"] = s_first
    if int(dst["last_seen_ns"]) < s_last:
        dst["last_seen_ns"] = s_last


def accumulate_base(dst, src) -> None:
    """Merge two base flow_stats partials (reference: AccumulateBase,
    `flow_content.go:28-63`): add bytes/packets, OR flags, min/max times,
    latest-non-zero wins for eth_protocol/dscp/sampling, MACs fill if unset."""
    dst_was_empty = int(dst["first_seen_ns"]) == 0 and int(dst["packets"]) == 0
    _merge_times(dst, src)
    dst["bytes"] = _sat_add(dst["bytes"], src["bytes"], U64_MAX)
    dst["packets"] = _sat_add(dst["packets"], src["packets"], U32_MAX)
    dst["tcp_flags"] = int(dst["tcp_flags"]) | int(src["tcp_flags"])
    if int(src["eth_protocol"]) != 0:
        dst["eth_protocol"] = src["eth_protocol"]
    if int(src["dscp"]) != 0:
        dst["dscp"] = src["dscp"]
    if int(src["sampling"]) != 0:
        dst["sampling"] = src["sampling"]
    if not np.any(dst["src_mac"]):
        dst["src_mac"] = src["src_mac"]
    if not np.any(dst["dst_mac"]):
        dst["dst_mac"] = src["dst_mac"]
    if int(src["errno_fallback"]) != 0:
        dst["errno_fallback"] = src["errno_fallback"]
    # first-seen identity fields: keep dst's unless dst was a fresh zero entry
    if dst_was_empty:
        dst["if_index_first"] = src["if_index_first"]
        dst["direction_first"] = src["direction_first"]
    # ssl_version: first non-zero observation wins; a conflicting later
    # version raises the mismatch flag instead of overwriting (same rule the
    # kernel applies at entry time, reference bpf/flows.c:111-118)
    if int(src["ssl_version"]) != 0:
        if int(dst["ssl_version"]) == 0:
            dst["ssl_version"] = src["ssl_version"]
        elif int(dst["ssl_version"]) != int(src["ssl_version"]):
            dst["misc_flags"] = int(dst["misc_flags"]) | MISC_SSL_MISMATCH
    for fld in ("tls_cipher_suite", "tls_key_share"):
        if int(src[fld]) != 0:
            dst[fld] = src[fld]
    dst["tls_types"] = int(dst["tls_types"]) | int(src["tls_types"])
    dst["misc_flags"] = int(dst["misc_flags"]) | int(src["misc_flags"])
    # observed-interfaces dedup (bounded at MAX_OBSERVED_INTERFACES; the
    # datapath's lock-free slot reservation can leave the counter
    # transiently above capacity — clamp before indexing)
    cap = len(dst["observed_intf"])
    n_dst = min(int(dst["n_observed_intf"]), cap)
    for j in range(min(int(src["n_observed_intf"]), cap)):
        oi, od = int(src["observed_intf"][j]), int(src["observed_direction"][j])
        seen = any(
            int(dst["observed_intf"][i]) == oi
            and int(dst["observed_direction"][i]) == od
            for i in range(n_dst))
        if not seen and n_dst < cap:
            dst["observed_intf"][n_dst] = oi
            dst["observed_direction"][n_dst] = od
            n_dst += 1
    dst["n_observed_intf"] = n_dst


def accumulate_dns(dst, src) -> None:
    """DNS: max latency wins, flags OR, latest id/errno observation adopted
    (reference: AccumulateDNS, `flow_content.go:76-96` — errno is assigned from
    the incoming partial even when it clears a previous error)."""
    _merge_times(dst, src)
    dst["dns_flags"] = int(dst["dns_flags"]) | int(src["dns_flags"])
    if int(src["dns_id"]) != 0:
        dst["dns_id"] = src["dns_id"]
    if int(dst["errno"]) != int(src["errno"]):
        dst["errno"] = src["errno"]
    if int(src["latency_ns"]) > int(dst["latency_ns"]):
        dst["latency_ns"] = src["latency_ns"]
    if bytes(src["name"]).rstrip(b"\x00"):
        dst["name"] = src["name"]


def accumulate_drops(dst, src) -> None:
    """Packet drops: saturating u16 adds, flags OR, latest non-zero cause/state
    win (reference: AccumulateDrops, `flow_content.go:98-117`)."""
    _merge_times(dst, src)
    dst["bytes"] = _sat_add(dst["bytes"], src["bytes"], U16_MAX)
    dst["packets"] = _sat_add(dst["packets"], src["packets"], U16_MAX)
    dst["latest_flags"] = int(dst["latest_flags"]) | int(src["latest_flags"])
    if int(src["latest_cause"]) != 0:
        dst["latest_cause"] = src["latest_cause"]
    if int(src["latest_state"]) != 0:
        dst["latest_state"] = src["latest_state"]


def accumulate_extra(dst, src) -> None:
    """RTT max-merge + IPsec highest-return-code priority (reference:
    AccumulateAdditional, `flow_content.go:154-178`)."""
    _merge_times(dst, src)
    if int(src["rtt_ns"]) > int(dst["rtt_ns"]):
        dst["rtt_ns"] = src["rtt_ns"]
    if int(dst["ipsec_ret"]) < int(src["ipsec_ret"]):
        dst["ipsec_ret"] = src["ipsec_ret"]
        dst["ipsec_encrypted"] = src["ipsec_encrypted"]
    elif int(dst["ipsec_ret"]) == int(src["ipsec_ret"]) and int(src["ipsec_encrypted"]):
        dst["ipsec_encrypted"] = src["ipsec_encrypted"]


def accumulate_xlat(dst, src) -> None:
    """NAT translation: a complete (both-endpoints) observation replaces
    (reference: AccumulateXlat, `flow_content.go:139-152`)."""
    _merge_times(dst, src)
    if np.any(src["src_ip"]) and np.any(src["dst_ip"]):
        for fld in ("src_ip", "dst_ip", "src_port", "dst_port", "zone_id"):
            dst[fld] = src[fld]


def accumulate_network_events(dst, src) -> None:
    """Network events: dedup append into a wrapping ring of MAX_NETWORK_EVENTS
    (reference: AccumulateNetworkEvents, `flow_content.go:119-137`)."""
    _merge_times(dst, src)
    idx = int(dst["n_events"]) % dst["events"].shape[0]
    cap = dst["events"].shape[0]
    for j in range(src["events"].shape[0]):
        ev = src["events"][j]
        if int(src["packets"][j]) == 0:
            continue
        dup = any(np.array_equal(dst["events"][i], ev) for i in range(cap))
        if not dup:
            dst["events"][idx] = ev
            dst["bytes"][idx] = _sat_add(dst["bytes"][idx], src["bytes"][j], U16_MAX)
            dst["packets"][idx] = _sat_add(dst["packets"][idx], src["packets"][j], U16_MAX)
            idx = (idx + 1) % cap
    dst["n_events"] = idx


def accumulate_quic(dst, src) -> None:
    """QUIC: max version wins, header-seen flags max/OR (reference:
    AccumulateQuic, `flow_content.go:179-197`)."""
    _merge_times(dst, src)
    if int(src["version"]) > int(dst["version"]):
        dst["version"] = src["version"]
    if int(dst["seen_long_hdr"]) < int(src["seen_long_hdr"]):
        dst["seen_long_hdr"] = src["seen_long_hdr"]
    if int(dst["seen_short_hdr"]) < int(src["seen_short_hdr"]):
        dst["seen_short_hdr"] = src["seen_short_hdr"]


def merge_percpu(values: np.ndarray, accumulate_fn) -> np.ndarray:
    """Merge per-CPU partial records (shape (n_cpu,) structured) into one."""
    out = values[0].copy()
    if "n_observed_intf" in (out.dtype.names or ()):
        # the datapath's lock-free slot reservation can leave the counter
        # transiently above capacity — clamp exactly like the native twin
        # (flowpack.cc fp_merge_stats), including the n_cpu==1 fast path
        cap = len(out["observed_intf"])
        if int(out["n_observed_intf"]) > cap:
            out["n_observed_intf"] = cap
    for i in range(1, len(values)):
        accumulate_fn(out, values[i])
    return out


# ---------------------------------------------------------------------------
# Columnar per-CPU merge: the whole-drain twins of the per-record functions
# above. Each takes `values` of shape (n_keys, n_cpus) and returns (n_keys,)
# merged records, bit-exact against running the matching `accumulate_*`
# sequentially per key. The reference pins four forms of these rules
# (per-record python, per-key native, columnar python, batch native); a
# native per-CPU merge of the port is held against this module.
# ---------------------------------------------------------------------------

def _col_times(values: np.ndarray, out: np.ndarray) -> None:
    """first_seen = min over non-zero (zero means unset), last_seen = max."""
    first = values["first_seen_ns"]
    masked = np.where(first == np.uint64(0), U64_MAX, first)
    fmin = masked.min(axis=1)
    out["first_seen_ns"] = np.where(fmin == U64_MAX, np.uint64(0), fmin)
    out["last_seen_ns"] = values["last_seen_ns"].max(axis=1)


def _col_latest_nonzero(field: np.ndarray) -> np.ndarray:
    """(n, c) -> (n,): last non-zero value per row, else column 0's value —
    the vectorized 'latest non-zero observation wins' rule."""
    n, c = field.shape
    nz = field != 0
    has = nz.any(axis=1)
    last = c - 1 - nz[:, ::-1].argmax(axis=1)
    idx = np.where(has, last, 0)
    return field[np.arange(n), idx]


def _col_observed_intf(values: np.ndarray, out: np.ndarray) -> None:
    """Observed-interface dedup-append, vectorized over keys. Candidate
    positions are walked sequentially ((n_cpus-1) * cap iterations, each a
    whole-axis op over the keys that have any src entries at all), because
    each append changes what later candidates dedup against."""
    n, c = values.shape
    cap = values.dtype["observed_intf"].shape[0]
    src_n = np.minimum(values["n_observed_intf"][:, 1:], cap)
    active = np.nonzero(src_n.any(axis=1))[0]
    if not len(active):
        return
    v = values[active]
    m = len(active)
    cnt = np.minimum(v["n_observed_intf"][:, 0], cap).astype(np.int64)
    d_int = v["observed_intf"][:, 0].copy()
    d_dir = v["observed_direction"][:, 0].copy()
    slot = np.arange(cap)[None, :]
    for ci in range(1, c):
        s_cnt = np.minimum(v["n_observed_intf"][:, ci], cap)
        for j in range(cap):
            valid = j < s_cnt
            if not valid.any():
                continue
            cint = v["observed_intf"][:, ci, j]
            cdir = v["observed_direction"][:, ci, j]
            # dedup only against the OCCUPIED dst slots (i < n_dst)
            seen = ((d_int == cint[:, None]) & (d_dir == cdir[:, None])
                    & (slot < cnt[:, None])).any(axis=1)
            rows = np.nonzero(valid & ~seen & (cnt < cap))[0]
            if len(rows):
                d_int[rows, cnt[rows]] = cint[rows]
                d_dir[rows, cnt[rows]] = cdir[rows]
                cnt[rows] += 1
    out["observed_intf"][active] = d_int
    out["observed_direction"][active] = d_dir
    out["n_observed_intf"][active] = cnt


def merge_base_columnar(values: np.ndarray) -> np.ndarray:
    """Columnar twin of accumulate_base over (n_keys, n_cpus) flow_stats."""
    n, c = values.shape
    out = values[:, 0].copy()
    cap = values.dtype["observed_intf"].shape[0]
    np.minimum(out["n_observed_intf"], cap, out=out["n_observed_intf"])
    if c == 1 or n == 0:
        return out
    ar = np.arange(n)
    _col_times(values, out)
    # bytes: saturating u64 — cumulative clamp per CPU column (8-ish columns)
    # mirrors the native wrap-detect exactly; a plain sum could overflow
    acc = values["bytes"][:, 0].astype(np.uint64)
    for j in range(1, c):
        s = acc + values["bytes"][:, j]
        acc = np.where(s < acc, U64_MAX, s)
    out["bytes"] = acc
    psum = values["packets"].astype(np.uint64).sum(axis=1)
    out["packets"] = np.minimum(psum, U32_MAX).astype(np.uint32)
    out["tcp_flags"] = np.bitwise_or.reduce(values["tcp_flags"], axis=1)
    for fld in ("eth_protocol", "dscp", "sampling", "errno_fallback",
                "tls_cipher_suite", "tls_key_share"):
        out[fld] = _col_latest_nonzero(values[fld])
    out["tls_types"] = np.bitwise_or.reduce(values["tls_types"], axis=1)
    # MACs fill-if-unset: the first column (in merge order) with any non-zero
    # byte wins; all-zero keeps column 0's zeros
    for fld in ("src_mac", "dst_mac"):
        first = values[fld].any(axis=2).argmax(axis=1)
        out[fld] = values[fld][ar, first]
    # first-seen identity: adopted from each src while the accumulated dst is
    # still an all-empty entry -> the column at (first non-empty index), or
    # the last column when every partial is empty
    nonempty = (values["first_seen_ns"] != 0) | (values["packets"] != 0)
    j = np.where(nonempty.any(axis=1), nonempty.argmax(axis=1), c - 1)
    j = np.minimum(j, c - 1)
    out["if_index_first"] = values["if_index_first"][ar, j]
    out["direction_first"] = values["direction_first"][ar, j]
    # ssl_version: first non-zero wins; any DIFFERENT later non-zero raises
    # the mismatch flag (kernel entry rule)
    sv = values["ssl_version"]
    nzv = sv != 0
    firstv = sv[ar, nzv.argmax(axis=1)]
    out["ssl_version"] = np.where(nzv.any(axis=1), firstv, 0)
    mismatch = (nzv & (sv != firstv[:, None])).any(axis=1)
    out["misc_flags"] = (np.bitwise_or.reduce(values["misc_flags"], axis=1)
                         | np.where(mismatch, np.uint8(MISC_SSL_MISMATCH),
                                    np.uint8(0)))
    _col_observed_intf(values, out)
    return out


def merge_dns_columnar(values: np.ndarray) -> np.ndarray:
    n, c = values.shape
    out = values[:, 0].copy()
    if c == 1 or n == 0:
        return out
    _col_times(values, out)
    out["dns_flags"] = np.bitwise_or.reduce(values["dns_flags"], axis=1)
    out["dns_id"] = _col_latest_nonzero(values["dns_id"])
    # errno adopts EVERY incoming partial (even clearing): last column wins
    out["errno"] = values["errno"][:, -1]
    out["latency_ns"] = values["latency_ns"].max(axis=1)
    names = values["name"]
    nz = names != b""  # S-dtype: trailing-NUL-stripped compare (python rule)
    has = nz.any(axis=1)
    last = c - 1 - nz[:, ::-1].argmax(axis=1)
    out["name"] = names[np.arange(n), np.where(has, last, 0)]
    return out


def merge_drops_columnar(values: np.ndarray) -> np.ndarray:
    n, c = values.shape
    out = values[:, 0].copy()
    if c == 1 or n == 0:
        return out
    _col_times(values, out)
    for fld in ("bytes", "packets"):
        s = values[fld].astype(np.uint64).sum(axis=1)
        out[fld] = np.minimum(s, U16_MAX).astype(np.uint16)
    out["latest_flags"] = np.bitwise_or.reduce(values["latest_flags"], axis=1)
    out["latest_cause"] = _col_latest_nonzero(values["latest_cause"])
    out["latest_state"] = _col_latest_nonzero(values["latest_state"])
    return out


def merge_extra_columnar(values: np.ndarray) -> np.ndarray:
    n, c = values.shape
    out = values[:, 0].copy()
    if c == 1 or n == 0:
        return out
    ar = np.arange(n)
    _col_times(values, out)
    out["rtt_ns"] = values["rtt_ns"].max(axis=1)
    # ipsec: highest return code wins its encrypted flag; among columns tied
    # at the max, a later non-zero encrypted overrides (sequential adoption)
    ret = values["ipsec_ret"]
    enc = values["ipsec_encrypted"]
    rstar = ret.max(axis=1)
    elig = ret == rstar[:, None]
    encnz = elig & (enc != 0)
    has = encnz.any(axis=1)
    last_nz = c - 1 - encnz[:, ::-1].argmax(axis=1)
    idx = np.where(has, last_nz, elig.argmax(axis=1))
    out["ipsec_ret"] = rstar
    out["ipsec_encrypted"] = enc[ar, idx]
    return out


def merge_xlat_columnar(values: np.ndarray) -> np.ndarray:
    n, c = values.shape
    out = values[:, 0].copy()
    if c == 1 or n == 0:
        return out
    _col_times(values, out)
    complete = values["src_ip"].any(axis=2) & values["dst_ip"].any(axis=2)
    has = complete.any(axis=1)
    last = c - 1 - complete[:, ::-1].argmax(axis=1)
    idx = np.where(has, last, 0)
    ar = np.arange(n)
    for fld in ("src_ip", "dst_ip", "src_port", "dst_port", "zone_id"):
        out[fld] = values[fld][ar, idx]
    return out


def merge_quic_columnar(values: np.ndarray) -> np.ndarray:
    n, c = values.shape
    out = values[:, 0].copy()
    if c == 1 or n == 0:
        return out
    _col_times(values, out)
    out["version"] = values["version"].max(axis=1)
    out["seen_long_hdr"] = values["seen_long_hdr"].max(axis=1)
    out["seen_short_hdr"] = values["seen_short_hdr"].max(axis=1)
    return out


def merge_nevents_columnar(values: np.ndarray) -> np.ndarray:
    """Columnar twin of accumulate_network_events: dedup-append into each
    key's wrapping ring. The ring evolves entry by entry (each append changes
    the dedup set AND the cursor), so candidates are walked sequentially —
    (n_cpus-1) * MAX_NETWORK_EVENTS iterations, each vectorized over keys."""
    n, c = values.shape
    out = values[:, 0].copy()
    if c == 1 or n == 0:
        return out
    _col_times(values, out)
    cap = values.dtype["events"].shape[0]
    idx = (out["n_events"].astype(np.int64)) % cap
    for ci in range(1, c):
        for j in range(cap):
            act = values["packets"][:, ci, j] != 0
            if not act.any():
                continue
            cand = values["events"][:, ci, j]                  # (n, md)
            dup = (out["events"] == cand[:, None, :]).all(axis=2).any(axis=1)
            rows = np.nonzero(act & ~dup)[0]
            if len(rows):
                ri = idx[rows]
                out["events"][rows, ri] = cand[rows]
                nb = (out["bytes"][rows, ri].astype(np.uint64)
                      + values["bytes"][rows, ci, j])
                out["bytes"][rows, ri] = np.minimum(nb, U16_MAX)
                npk = (out["packets"][rows, ri].astype(np.uint64)
                       + values["packets"][rows, ci, j])
                out["packets"][rows, ri] = np.minimum(npk, U16_MAX)
                idx[rows] = (ri + 1) % cap
        out["n_events"] = idx
    return out


#: kind -> columnar merge fn (kind names shared with flowpack._MERGE_FNS)
COLUMNAR_MERGES = {
    "stats": merge_base_columnar,
    "dns": merge_dns_columnar,
    "drops": merge_drops_columnar,
    "extra": merge_extra_columnar,
    "xlat": merge_xlat_columnar,
    "quic": merge_quic_columnar,
    "nevents": merge_nevents_columnar,
}
