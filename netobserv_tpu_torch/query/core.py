"""The sketch query math, over host snapshots.

Counterpart of `netobserv_tpu/query/core.py` (`victim_bucket_names`,
`_stamp`, `cm_error_bars`, `topk_payload`, `churn_payload`,
`cardinality_payload`, `victims_payload` and `frequency_payload`,
`:1-171`), kept as a copy. Everything here is host numpy over an immutable
snapshot dict and the numpy hash twins (`ops/hashing`), so answering a
query never launches device work.

A snapshot dict, as the exporter publishes it at a window roll or a
mid-window refresh (`query/snapshot.SnapshotPublisher`):

- ``window``  int, the closed (or, for a refresh, the live) window id;
- ``ts_ms``   int, the publish wall time;
- ``seq``     int, the publish sequence; pollers order answers by
              ``(window, seq)``;
- ``report``  the rendered window report (`exporter/report.report_to_json`);
- ``cm_bytes`` / ``cm_pkts``  f32[depth, width] Count-Min planes, or None
              where a deployment has no whole-width planes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from netobserv_tpu_torch.ops.hashing import (
    DST_BUCKET_SEED, base_hashes_multi_np, hash_words_np,
)


def victim_bucket_names(heavy_words: np.ndarray, heavy: list[dict],
                        n_buckets: int) -> dict[int, list]:
    """Heavy-hitter addresses hashed into the EWMA victim buckets the
    anomaly signals use. Both directions name a victim: inbound traffic
    buckets via the dst words, outbound via the src words (the device folds
    both into one bucket family under DST_BUCKET_SEED).

    `heavy_words` are the (n, KEY_WORDS) key words of exactly the rows
    rendered into `heavy`, in the same order."""
    names: dict[int, list] = {}
    if not len(heavy):
        return names
    for cols, field in ((heavy_words[:, 4:8], "DstAddr"),
                        (heavy_words[:, 0:4], "SrcAddr")):
        buckets = hash_words_np(cols, seed=DST_BUCKET_SEED) & (n_buckets - 1)
        for j, b in enumerate(buckets):
            lst = names.setdefault(int(b), [])
            if len(lst) < 3 and heavy[j][field] not in lst:
                lst.append(heavy[j][field])
    return names


def _stamp(snap: dict, payload: dict) -> dict:
    """Prefix a payload with the (window, ts_ms, seq) pollers order by."""
    return {"window": snap["window"], "ts_ms": snap["ts_ms"],
            "seq": snap.get("seq", 0), **payload}


def cm_error_bars(snap: dict) -> Optional[dict]:
    """The Cormode-Muthukrishnan overestimate bound of the snapshot's CM
    planes, shared by /query/frequency, /query/topk and /query/churn (the
    slot-table counts are CM point estimates too); None without planes."""
    cm = snap.get("cm_bytes")
    if cm is None:
        return None
    d, w = cm.shape
    eps = np.e / w
    return {
        "overestimate_bound_bytes": eps * float(np.sum(cm[0])),
        "confidence": 1.0 - float(np.exp(-d)),
    }


def topk_payload(snap: dict, n: int = 100) -> dict:
    """The window's heavy hitters (at most `n`, clamped to 1-1024), with
    the CM error bars."""
    n = max(1, min(int(n), 1024))
    payload = {"topk": snap["report"]["HeavyHitters"][:n]}
    bars = cm_error_bars(snap)
    if bars is not None:
        payload.update(bars)
    return _stamp(snap, payload)


def churn_payload(snap: dict) -> dict:
    """The window's per-key heavy-hitter churn as the renderer gated it:
    ascents, descents, new heavy keys, evicted keys and the summary, with
    the CM error bars."""
    report = snap["report"]
    payload = {
        "ascents": report.get("FlowAscents", []),
        "descents": report.get("FlowDescents", []),
        "new_heavy": report.get("NewHeavyKeys", []),
        "evicted": report.get("EvictedKeys", []),
        "summary": report.get("HeavyChurn", {}),
    }
    bars = cm_error_bars(snap)
    if bars is not None:
        payload.update(bars)
    return _stamp(snap, payload)


def cardinality_payload(snap: dict) -> dict:
    report = snap["report"]
    return _stamp(snap, {
        "distinct_src_estimate": report["DistinctSrcEstimate"],
        "records": report["Records"],
        "bytes": report["Bytes"]})


def victims_payload(snap: dict) -> dict:
    """Each signal's suspect buckets, named by the alerting plane's one
    `SIGNAL_FIELDS` map."""
    from netobserv_tpu_torch.alerts.rules import SIGNAL_FIELDS
    report = snap["report"]
    return _stamp(snap, {sig: report[key]
                         for sig, key in SIGNAL_FIELDS.items()})


def frequency_payload(snap: dict, src: str, dst: str, src_port: int = 0,
                      dst_port: int = 0, proto: int = 0) -> Optional[dict]:
    """CM point query of one 5-tuple with error bars, against the
    snapshot's planes, through the numpy hash twin. None when the snapshot
    carries no planes. A malformed address raises ValueError."""
    cm = snap.get("cm_bytes")
    cm_pkts = snap.get("cm_pkts")
    if cm is None or cm_pkts is None:
        return None
    from netobserv_tpu_torch.model import binfmt
    from netobserv_tpu_torch.model.columnar import pack_key_words
    from netobserv_tpu_torch.model.flow import ip_to_16

    karr = np.zeros(1, binfmt.FLOW_KEY_DTYPE)
    karr["src_ip"][0] = np.frombuffer(ip_to_16(src), np.uint8)
    karr["dst_ip"][0] = np.frombuffer(ip_to_16(dst), np.uint8)
    karr["src_port"] = src_port
    karr["dst_port"] = dst_port
    karr["proto"] = proto
    h = base_hashes_multi_np(pack_key_words(karr))
    d, w = cm.shape
    with np.errstate(over="ignore"):
        idx = (h["h1"][0] + np.arange(d, dtype=np.uint32) * h["h2"][0]) \
            & np.uint32(w - 1)
    est_bytes = float(np.min(cm[np.arange(d), idx]))
    est_pkts = float(np.min(cm_pkts[np.arange(d), idx]))
    # Cormode-Muthukrishnan: overestimate <= (e/w)*N with prob 1-e^-d
    n_bytes = float(np.sum(cm[0]))
    n_pkts = float(np.sum(cm_pkts[0]))
    eps = np.e / w
    return _stamp(snap, {
        "est_bytes": est_bytes,
        "est_packets": est_pkts,
        "overestimate_bound_bytes": eps * n_bytes,
        "overestimate_bound_packets": eps * n_pkts,
        "confidence": 1.0 - float(np.exp(-d)),
    })
