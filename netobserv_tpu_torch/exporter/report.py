"""Render a window report into the host JSON object, and the report sinks.

Counterpart of `netobserv_tpu/exporter/tpu_sketch.py` (`_slot_key_entries`,
`heavy_identity_index`, `report_to_json`, `_default_sink`,
`KafkaReportSink`, `make_report_sink`), a copy with its imports pointed at
this package's copies of the key layout, thresholds, victim naming,
drop-reason names and Kafka client (`kafka/producer.py`); `_read_secret`
is a copy of `netobserv_tpu/exporter/kafka.py:65-69`.
`SIGNAL_FIELDS`, the signal name of each report's suspect list, is the
alerting plane's (`alerts/rules.py`), re-exported here. A report's tensors are read through
`np.asarray` after `report_numpy` has moved them to the host.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Optional

import numpy as np
import torch

from netobserv_tpu_torch.alerts.rules import SIGNAL_FIELDS  # noqa: F401
from netobserv_tpu_torch.config import (
    DEFAULT_ASYM_MIN_BYTES, DEFAULT_ASYM_RATIO, DEFAULT_CHURN_ASCENT,
    DEFAULT_CHURN_MIN_BYTES, DEFAULT_DDOS_Z, DEFAULT_DROP_Z,
    DEFAULT_SCAN_FANOUT, DEFAULT_SYNFLOOD_MIN, DEFAULT_SYNFLOOD_RATIO,
)
from netobserv_tpu_torch.model.columnar import unpack_key_words
from netobserv_tpu_torch.model.flow import ip_from_16
from netobserv_tpu_torch.query.core import victim_bucket_names
from netobserv_tpu_torch.utils.drop_reasons import drop_reason_name

ReportSink = Callable[[dict], None]


def _default_sink(report: dict) -> None:
    """One JSON line a report on standard output (the reference's default
    sink, `tpu_sketch.py:51-53`)."""
    sys.stdout.write(json.dumps(report, separators=(",", ":")) + "\n")
    sys.stdout.flush()


class KafkaReportSink:
    """Publishes window reports as JSON Kafka messages, key
    "sketch_report", one message a report; closeable
    (`tpu_sketch.py:56-86`). `cfg` is an `AgentConfig`: its `KAFKA_*`
    settings pick the brokers, topic, acks (0 when `kafka_async`), TLS,
    SASL and compression."""

    def __init__(self, cfg):
        from netobserv_tpu_torch.kafka.producer import (
            KafkaProducer, SASLSettings, TLSSettings,
        )
        sasl = SASLSettings(enable=cfg.kafka_enable_sasl,
                            mechanism=cfg.kafka_sasl_type)
        if sasl.enable:
            sasl.username = _read_secret(cfg.kafka_sasl_client_id_path)
            sasl.password = _read_secret(cfg.kafka_sasl_client_secret_path)
        self._producer = KafkaProducer(
            brokers=cfg.kafka_brokers, topic=cfg.kafka_topic,
            acks=0 if cfg.kafka_async else 1,
            tls=TLSSettings(
                enable=cfg.kafka_enable_tls,
                insecure_skip_verify=cfg.kafka_tls_insecure_skip_verify,
                ca_path=cfg.kafka_tls_ca_cert_path,
                cert_path=cfg.kafka_tls_user_cert_path,
                key_path=cfg.kafka_tls_user_key_path),
            sasl=sasl, compression=cfg.kafka_compression)

    def __call__(self, report: dict) -> None:
        self._producer.send_batch([
            (b"sketch_report",
             json.dumps(report, separators=(",", ":")).encode())])

    def close(self) -> None:
        self._producer.close()


def _read_secret(path: str) -> str:
    if not path:
        return ""
    with open(path) as fh:
        return fh.read().strip()


def make_report_sink(cfg) -> ReportSink:
    """The SKETCH_REPORT_SINK switch (`tpu_sketch.py:89-97`): "" or
    "stdout" gives the JSON-lines sink, "kafka" a `KafkaReportSink` over
    `cfg`'s `KAFKA_*` settings."""
    if cfg.sketch_report_sink == "kafka":
        return KafkaReportSink(cfg)
    if cfg.sketch_report_sink not in ("", "stdout"):
        raise ValueError(
            f"SKETCH_REPORT_SINK={cfg.sketch_report_sink!r} (want "
            "stdout|kafka)")
    return _default_sink


def _host(x):
    if isinstance(x, torch.Tensor):
        arr = x.detach().to("cpu", copy=True).numpy()
        # uint32 lanes ride int64 on the device
        return arr.astype(np.uint32) if arr.dtype == np.int64 else arr
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    return x


def report_numpy(report):
    """The same report with every tensor moved to host numpy, key words and
    hashes as np.uint32 — one device-to-host copy per field."""
    return _host(report)


def _slot_key_entries(words: np.ndarray, rows) -> list[dict]:
    """Render slot-table rows' packed key words into addr/port dicts, with
    a stable `Key` fingerprint string (the churn alert rules' dedup id)."""
    rows = np.asarray(rows, dtype=np.int64)
    out: list[dict] = []
    if not len(rows):
        return out
    keys = unpack_key_words(words[rows])
    for k in keys:
        src = ip_from_16(k["src_ip"].tobytes())
        dst = ip_from_16(k["dst_ip"].tobytes())
        sp, dp, proto = int(k["src_port"]), int(k["dst_port"]), \
            int(k["proto"])
        out.append({
            "SrcAddr": src, "DstAddr": dst, "SrcPort": sp, "DstPort": dp,
            "Proto": proto,
            "Key": f"{src}:{sp}->{dst}:{dp}/{proto}",
        })
    return out


def heavy_identity_index(report) -> dict:
    """(h1, h2) identity -> rendered key entry of every VALID slot — the
    previous-roll index `report_to_json` diffs against to name EVICTED
    keys (identities that left the table since the last closed window).
    Host-side numpy only; the exporter/aggregator stash one per ROLL."""
    report = report_numpy(report)
    valid = np.asarray(report.heavy.valid)
    rows = np.nonzero(valid)[0]
    h1 = np.asarray(report.heavy.h1)
    h2 = np.asarray(report.heavy.h2)
    counts = np.asarray(report.heavy.counts)
    entries = _slot_key_entries(np.asarray(report.heavy.words), rows)
    out = {}
    for j, i in enumerate(rows):
        e = dict(entries[j])
        e["EstBytes"] = float(counts[i])
        out[(int(h1[i]), int(h2[i]))] = e
    return out


def report_to_json(report, max_heavy: int = 64,
                   scan_fanout_threshold: float = DEFAULT_SCAN_FANOUT,
                   ddos_z_threshold: float = DEFAULT_DDOS_Z,
                   synflood_min: float = DEFAULT_SYNFLOOD_MIN,
                   synflood_ratio: float = DEFAULT_SYNFLOOD_RATIO,
                   drop_z_threshold: float = DEFAULT_DROP_Z,
                   asym_min_bytes: float = DEFAULT_ASYM_MIN_BYTES,
                   asym_ratio: float = DEFAULT_ASYM_RATIO,
                   churn_ascent: float = DEFAULT_CHURN_ASCENT,
                   churn_min_bytes: float = DEFAULT_CHURN_MIN_BYTES,
                   prev_heavy_index: Optional[dict] = None,
                   partial_window: bool = False) -> dict:
    """Render a device WindowReport into a host JSON object.

    The persistent-slot table makes this a per-KEY churn renderer too:
    FlowAscents / FlowDescents / NewHeavyKeys derive from each slot's
    (counts, prev_counts, first_seen) under the `churn_ascent` /
    `churn_min_bytes` gates — the ONE threshold truth the zoo runner and
    the default flow_ascent/new_heavy_key alert rules share (the
    alerts/rules.py one-truth note). `prev_heavy_index` (the previous
    ROLL's `heavy_identity_index`) names EvictedKeys by diffing identity
    sets; without it the list renders empty (first window, refresh-only
    consumers)."""
    report = report_numpy(report)
    words = np.asarray(report.heavy.words)
    valid = np.asarray(report.heavy.valid)
    counts = np.asarray(report.heavy.counts)
    prevs = np.asarray(report.heavy.prev_counts)
    first_seen = np.asarray(report.heavy.first_seen)
    window = int(report.window)
    order = np.argsort(-np.where(valid, counts, -np.inf))[:max_heavy]
    heavy = []
    sel = [i for i in order if valid[i]]
    if sel:
        keys = unpack_key_words(words[sel])
        for j, i in enumerate(sel):
            k = keys[j]
            heavy.append({
                "SrcAddr": ip_from_16(k["src_ip"].tobytes()),
                "DstAddr": ip_from_16(k["dst_ip"].tobytes()),
                "SrcPort": int(k["src_port"]),
                "DstPort": int(k["dst_port"]),
                "Proto": int(k["proto"]),
                "EstBytes": float(counts[i]),
                "PrevEstBytes": float(prevs[i]),
                "FirstSeenWindow": int(first_seen[i]),
            })
    # --- per-key churn (the device-resident heavy-hitter plane) ---
    # ascent: window-over-window growth >= churn_ascent with real current
    # mass; descent: the reciprocal collapse of a previously-heavy key;
    # new: first_seen == this window (gated to window > 0 — in the
    # table's very first window EVERYTHING is new, which is noise, and
    # prev_counts are all zero so ascents are structurally quiet too)
    asc_all = np.nonzero(valid & (prevs > 0)
                         & (counts >= churn_ascent * prevs)
                         & (counts >= churn_min_bytes))[0]
    asc_rows = asc_all[np.argsort(-counts[asc_all])][:32]
    # descents render only for CLOSED windows: a mid-window refresh
    # compares a partial window against a full previous one, so right
    # after a roll EVERY steady incumbent would read as collapsed
    # (ascents have no such problem — a partial count exceeding the full
    # previous window is real growth, and it is what makes detection
    # sub-window)
    desc_all = np.nonzero(valid & (prevs >= churn_min_bytes)
                          & (counts <= prevs / churn_ascent))[0] \
        if not partial_window else np.zeros(0, np.int64)
    desc_rows = desc_all[np.argsort(-prevs[desc_all])][:32]
    new_all = np.nonzero(valid & (first_seen == window)
                         & (counts >= churn_min_bytes))[0] \
        if window > 0 else np.zeros(0, np.int64)
    new_rows = new_all[np.argsort(-counts[new_all])][:32]

    def churn_entries(rows) -> list[dict]:
        out = _slot_key_entries(words, rows)
        for j, i in enumerate(rows):
            out[j].update({
                "EstBytes": float(counts[i]),
                "PrevEstBytes": float(prevs[i]),
                "Ratio": round(float(counts[i] / max(prevs[i], 1.0)), 3),
                "FirstSeenWindow": int(first_seen[i]),
            })
        return out

    evicted_keys: list[dict] = []
    if prev_heavy_index:
        h1a = np.asarray(report.heavy.h1)
        h2a = np.asarray(report.heavy.h2)
        cur_ids = {(int(h1a[i]), int(h2a[i]))
                   for i in np.nonzero(valid)[0]}
        gone = [e for ident, e in prev_heavy_index.items()
                if ident not in cur_ids]
        gone.sort(key=lambda e: -e.get("EstBytes", 0.0))
        evicted_keys = gone[:32]
    # best-effort victim names (numpy hash twin under DST_BUCKET_SEED;
    # report rendering never launches device work)
    n_buckets = np.asarray(report.ddos_z).shape[0]
    dst_bucket_names = victim_bucket_names(
        words[np.asarray(sel, dtype=np.int64)] if sel
        else words[:0], heavy, n_buckets)

    def victims(bucket: int) -> list:
        return dst_bucket_names.get(int(bucket), [])

    z = np.asarray(report.ddos_z)
    suspects = np.nonzero(z > ddos_z_threshold)[0]
    suspects = suspects[np.argsort(-z[suspects])]  # worst first before [:32]
    # port-scan suspects: source buckets whose distinct-(dst addr, dst
    # port) PAIR fan-out this window exceeds the threshold (a scanner
    # touches hundreds+; a normal client a handful)
    fanout = np.asarray(report.per_src_fanout)
    scan = np.argsort(fanout)[::-1]
    scan = scan[fanout[scan] >= scan_fanout_threshold]
    # SYN-flood suspects: victim buckets offered >= synflood_min half-open
    # attempts this window while accepting (SYN-ACKing) at most 1/ratio of
    # them — the offered:accepted asymmetry IS the flood signature
    syn = np.asarray(report.syn_rate)
    synack = np.asarray(report.synack_rate)
    syn_z = np.asarray(report.syn_z)
    flood = np.nonzero((syn >= synflood_min)
                       & (syn >= synflood_ratio * (synack + 1.0)))[0]
    flood = flood[np.argsort(-syn[flood])]
    drop_z = np.asarray(report.drop_z)
    drop_anom = np.nonzero(drop_z > drop_z_threshold)[0]
    drop_anom = drop_anom[np.argsort(-drop_z[drop_anom])]  # worst first
    causes = np.asarray(report.drop_causes)
    cause_idx = np.nonzero(causes > 0)[0]
    cause_idx = cause_idx[np.argsort(-causes[cause_idx])][:16]

    def cause_name(c: int) -> str:
        # live-kernel mapping first (the static reference table mislabels
        # on newer kernels — utils/drop_reasons.py); the histogram's last
        # bucket catches saturated/subsystem reasons (state.py N_DROP_CAUSES)
        if c == causes.shape[0] - 1:
            return "OTHER_OR_SUBSYSTEM"
        return drop_reason_name(int(c))
    # one-way conversations: pair buckets over the volume floor whose
    # byte share in one direction exceeds the ratio (exfil / UDP-flood
    # shape; a healthy TCP transfer still carries ~3-5% ACK backflow)
    fwd = np.asarray(report.conv_fwd)
    rev = np.asarray(report.conv_rev)
    conv_total = fwd + rev
    one_way_share = np.maximum(fwd, rev) / np.maximum(conv_total, 1.0)
    asym = np.nonzero((conv_total >= asym_min_bytes)
                      & (one_way_share >= asym_ratio))[0]
    asym = asym[np.argsort(-conv_total[asym])]
    dscp = np.asarray(report.dscp_bytes)
    dscp_idx = np.nonzero(dscp > 0)[0]

    def dscp_name(c: int) -> str:
        # RFC 2474/2597/3246 codepoints (stable, unlike the kernel enums);
        # unnamed codepoints print numerically
        if c == 46:
            return "EF"
        if c == 44:
            return "VOICE-ADMIT"
        if c % 8 == 0:
            return f"CS{c // 8}"
        afc, afd = c // 8, (c % 8) // 2
        if 1 <= afc <= 4 and 1 <= afd <= 3 and c % 2 == 0:
            return f"AF{afc}{afd}"
        return str(c)
    qs = [0.5, 0.9, 0.95, 0.99, 0.999]
    return {
        "Type": "sketch_window_report",
        "Window": int(report.window),
        "Records": float(report.total_records),
        "Bytes": float(report.total_bytes),
        "DistinctSrcEstimate": float(report.distinct_src),
        "DropBytes": float(report.total_drop_bytes),
        "DropPackets": float(report.total_drop_packets),
        "QuicRecords": float(report.quic_records),
        "NatRecords": float(report.nat_records),
        "HeavyHitters": heavy,
        "RttQuantilesUs": {str(q): float(v) for q, v in zip(
            qs, np.asarray(report.rtt_quantiles_us))},
        "DnsLatencyQuantilesUs": {str(q): float(v) for q, v in zip(
            qs, np.asarray(report.dns_quantiles_us))},
        "DdosSuspectBuckets": [
            {"bucket": int(b), "z": float(z[b]),
             "probable_victims": victims(b)} for b in suspects[:32]],
        "PortScanSuspectBuckets": [
            {"bucket": int(b), "distinct_dst_port_pairs": float(fanout[b])}
            for b in scan[:32]],
        "SynFloodSuspectBuckets": [
            {"bucket": int(b), "syn": float(syn[b]),
             "synack": float(synack[b]), "z": float(syn_z[b]),
             "probable_victims": victims(b)}
            for b in flood[:32]],
        "DropAnomalyBuckets": [
            {"bucket": int(b), "z": float(drop_z[b]),
             "probable_victims": victims(b)}
            for b in drop_anom[:32]],
        "AsymmetricConversationBuckets": [
            {"bucket": int(b), "bytes": float(conv_total[b]),
             "one_way_share": round(float(one_way_share[b]), 4)}
            for b in asym[:32]],
        "DropCauses": {str(int(c)): float(causes[c]) for c in cause_idx},
        "DropCauseNames": {cause_name(int(c)): float(causes[c])
                           for c in cause_idx},
        "DscpBytes": {str(int(d)): float(dscp[d]) for d in dscp_idx},
        "DscpClassBytes": {dscp_name(int(d)): float(dscp[d])
                           for d in dscp_idx},
        "FlowAscents": churn_entries(asc_rows),
        "FlowDescents": churn_entries(desc_rows),
        "NewHeavyKeys": churn_entries(new_rows),
        "EvictedKeys": evicted_keys,
        "HeavyChurn": {
            "ascents": int(len(asc_all)),
            "descents": int(len(desc_all)),
            "new": int(len(new_all)),
            "evictions": float(report.heavy_evictions),
            "tracked": int(valid.sum()),
        },
    }
