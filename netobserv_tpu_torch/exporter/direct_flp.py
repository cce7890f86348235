"""direct-flp: an embedded in-process flowlogs-pipeline.

A copy of `netobserv_tpu/exporter/direct_flp.py` (lines 1-1198), whose
reference is `pkg/exporter/direct_flp.go`: the agent feeds records
(converted to FLP GenericMaps, `flp_map.record_to_map`) into a pipeline
described by FLP_CONFIG (YAML or JSON) instead of shipping them anywhere.
PyYAML parses FLP_CONFIG, imported only when a non-empty one is given;
no other module of the port imports it. The `encode prom` stage makes
its metrics through the port's metrics facade (`metrics/registry.py`),
the only module that imports `prometheus_client`. The transports are the
port's own: `kafka/producer.KafkaProducer`, `exporter/ipfix`,
`grpc/flow.FlowClient` over `grpc/h2.py`, and `http.client`/`urllib`
for Loki and S3.

Supported stage subset (the shapes the reference's smoke-test configs use):
- ingest is implicit (the agent's record stream)
- `transform` / type `filter`: rules `remove_field`, `keep_entry_if_exists`,
  `keep_entry_if_doesnt_exist`, `keep_entry_if_equal`, `keep_entry_if_not_equal`
- `transform` / type `generic`: `policy: replace_keys` with `rules` [{input,
  output}] field renaming
- `transform` / type `network` (FLP transform_network.go subset): rules
  `add_subnet`, `add_service`, `add_subnet_label`, `decode_tcp_flags`,
  `reinterpret_direction`, plus `add_kubernetes`/`add_location` backed by
  PLUGGABLE data sources (exporter.flp_enrich: a file-backed or injected
  Kubernetes datasource via FLP_KUBE_MAP, an ip2location-layout range CSV
  via FLP_LOCATION_DB); a rule whose backend isn't configured warns+skips
- `extract` / type `conntrack` (FLP api/conntrack.go subset): canonical
  bidirectional connection hashing, per-direction (splitAB) sum/count/min/
  max/first/last aggregates, newConnection/flowLog/heartbeat/endConnection
  records with FIN-driven and timeout-driven teardown (timers ride the
  batch cadence)
- `extract` / type `aggregates` (api/extract_aggregate.go subset): group-by
  sum/min/max/avg/count/raw_values with running totals + per-cycle recent_*
  values and group expiry; replaces the stream like FLP's Extract
- `extract` / type `timebased` (api/extract_timebased.go subset): sliding-
  window top-K over indexKeys by sum/min/max/avg/count/last/diff
- `encode` / type `prom` (FLP encode_prom.go subset): counter/gauge/
  histogram metrics with labels and equal/not_equal/presence/absence/
  match_regex filters, registered on the exporter's `prom_registry`
  (served by the agent's metrics server when one is running)
- `encode` / type `kafka` (encode_kafka.go): JSON entries produced to a
  topic through the port's wire producer
- `encode` / type `s3` (encode_s3.go): batched JSON objects with the FLP
  store header, SigV4-signed PUTs under the reference's object layout
- `write` / type `stdout` (default when no pipeline is configured), type
  `loki` (push-API JSON streams with label promotion and tenant header),
  type `ipfix` (v4/v6 templates through the wire exporter) or type `grpc`
  (pbflow Records to a Collector, TLS/mTLS)

Not embedded: the OTLP encode family and FLP ingest stages (meaningless
in direct mode: the agent IS the ingest).

`_emit` writes a batch's stdout lines, each whole, and flushes under the
exporter's own lock, so no caller on another thread (a `close()` from
the stopping thread, say) tears a line or interleaves two batches;
`exporter/base.QueueExporter` keeps the calls themselves apart (ROADMAP
C16).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time as _time
from typing import Callable, Optional


from netobserv_tpu_torch.exporter.base import Exporter
from netobserv_tpu_torch.exporter.flp_enrich import (
    enrich_kubernetes, enrich_location,
)
from netobserv_tpu_torch.exporter.flp_map import record_to_map
from netobserv_tpu_torch.model.flow import TcpFlags
from netobserv_tpu_torch.model.record import Record

log = logging.getLogger("netobserv_tpu_torch.exporter.direct_flp")

Stage = Callable[[dict], Optional[dict]]


def _build_filter(params: dict) -> Stage:
    rules = params.get("rules", [])

    def stage(entry: dict) -> Optional[dict]:
        for rule in rules:
            rtype = rule.get("type")
            field = rule.get("removeField", rule.get(
                "keepEntryField", rule.get("input", rule.get("field"))))
            value = rule.get("keepEntryValue", rule.get("value"))
            if rtype == "remove_field":
                entry.pop(field, None)
            elif rtype == "keep_entry_if_exists":
                if field not in entry:
                    return None
            elif rtype == "keep_entry_if_doesnt_exist":
                if field in entry:
                    return None
            elif rtype == "keep_entry_if_equal":
                if entry.get(field) != value:
                    return None
            elif rtype == "keep_entry_if_not_equal":
                if entry.get(field) == value:
                    return None
        return entry

    return stage


# FLP utils/tcp_flags.go table (incl. the synthetic combination bits) —
# derived from the model enum so the mapping cannot drift
_TCP_FLAG_NAMES = [(f.value, f.name) for f in TcpFlags]

_PROTO_NAMES = {6: "tcp", 17: "udp", 132: "sctp"}


def _build_network(params: dict, kube_source=None, location_db=None) -> Stage:
    """FLP `transform network` subset (transform_network.go:64-160).
    `kube_source`/`location_db` are the pluggable enrichment backends
    (exporter.flp_enrich); without one, the corresponding rule warns and
    skips (the data must come from outside the process)."""
    import ipaddress
    import socket as _socket

    rules = params.get("rules", [])
    subnet_labels = []
    for lbl in params.get("subnetLabels", []):
        nets = [ipaddress.ip_network(c) for c in lbl.get("cidrs", [])]
        subnet_labels.append((lbl.get("name", ""), nets))
    dir_info = params.get("directionInfo", {})
    svc_cache: dict = {}
    # resolve enrichment backends ONCE at build time: a per-record warning
    # or import in the stage loop would run at export rate
    if kube_source is None and any(
            r.get("type") == "add_kubernetes" for r in rules):
        log.warning("transform.network rule add_kubernetes needs a "
                    "Kubernetes datasource (set FLP_KUBE_MAP or inject "
                    "kube_source); rule(s) skipped")
        rules = [r for r in rules if r.get("type") != "add_kubernetes"]
    if location_db is None and any(
            r.get("type") == "add_location" for r in rules):
        log.warning("transform.network rule add_location needs a GeoIP "
                    "database (set FLP_LOCATION_DB or inject "
                    "location_db); rule(s) skipped")
        rules = [r for r in rules if r.get("type") != "add_location"]

    def service_name(port, proto) -> str:
        key = (port, proto)
        if key not in svc_cache:
            name = ""
            try:
                pnum = int(proto)
                pname = _PROTO_NAMES.get(pnum, "")
            except (TypeError, ValueError):
                pname = str(proto).lower()
            try:
                name = _socket.getservbyport(int(port), pname) if pname \
                    else _socket.getservbyport(int(port))
            except (OSError, OverflowError, ValueError):
                name = ""
            svc_cache[key] = name
        return svc_cache[key]

    def stage(entry: dict) -> Optional[dict]:
        for rule in rules:
            rtype = rule.get("type")
            if rtype == "add_subnet":
                r = rule.get("add_subnet", rule)
                ip = entry.get(r.get("input"))
                if isinstance(ip, str):
                    mask = str(r.get("parameters",
                                     r.get("subnet_mask", "/24")))
                    if not mask.startswith("/"):
                        mask = "/" + mask
                    try:
                        net = ipaddress.ip_network(ip + mask, strict=False)
                        entry[r.get("output")] = str(net)
                    except ValueError:
                        pass
            elif rtype == "add_service":
                r = rule.get("add_service", rule)
                port = entry.get(r.get("input"))
                proto = entry.get(r.get("protocol"))
                if port is not None:
                    name = service_name(port, proto)
                    if name:
                        entry[r.get("output")] = name
            elif rtype == "add_subnet_label":
                r = rule.get("add_subnet_label", rule)
                ip = entry.get(r.get("input"))
                if isinstance(ip, str):
                    try:
                        addr = ipaddress.ip_address(ip)
                    except ValueError:
                        continue
                    for name, nets in subnet_labels:
                        if any(addr in n for n in nets):
                            entry[r.get("output")] = name
                            break
            elif rtype == "decode_tcp_flags":
                r = rule.get("decode_tcp_flags", rule)
                flags = entry.get(r.get("input"))
                if flags is not None:
                    try:
                        bits = int(flags)
                    except (TypeError, ValueError):
                        continue
                    names = [n for v, n in _TCP_FLAG_NAMES if bits & v]
                    if names or r.get("output") == r.get("input"):
                        entry[r.get("output")] = names
            elif rtype == "reinterpret_direction":
                # transform_network_direction.go: per-node direction from
                # the reporter's viewpoint (0 ingress / 1 egress / 2 inner)
                fd_field = dir_info.get("flowDirectionField")
                if not fd_field:
                    continue
                if dir_info.get("ifDirectionField") and fd_field in entry:
                    entry[dir_info["ifDirectionField"]] = entry[fd_field]
                reporter = entry.get(dir_info.get("reporterIPField"))
                src = entry.get(dir_info.get("srcHostField"))
                dst = entry.get(dir_info.get("dstHostField"))
                if not reporter:
                    continue
                if src != dst:
                    if src == reporter:
                        entry[fd_field] = 1     # egress
                    elif dst == reporter:
                        entry[fd_field] = 0     # ingress
                elif src:
                    entry[fd_field] = 2         # inner
            elif rtype == "add_kubernetes":
                enrich_kubernetes(entry, rule.get("kubernetes", rule),
                                  kube_source)
            elif rtype == "add_location":
                enrich_location(entry, rule.get("add_location", rule),
                                location_db)
            else:
                # NB: add_kubernetes_infra (FLP flow-layer classification)
                # lands here — it is NOT the per-IP metadata rule and stays
                # unsupported-with-warning
                log.warning("transform.network rule %r unsupported; skipped",
                            rtype)
        return entry

    return stage


def _build_prom(params: dict, registry,
                seen_names: set | None = None) -> Stage:
    """FLP `encode prom` subset (encode_prom.go): declarative metrics from
    the entry stream, registered on `registry`. Entries pass through.
    `seen_names` spans every prom stage of ONE exporter build: a name
    declared by an earlier stage is a same-config duplicate (skip — binding
    two stages to one collector double-counts), while a name alive in the
    registry but NOT in seen_names is a rebuild survivor (adopt).
    The collectors come from the metrics facade (`metrics/registry.py`)."""
    import re

    from netobserv_tpu_torch.metrics import registry as facade

    prefix = params.get("prefix", "")
    metrics = []
    if seen_names is None:
        seen_names = set()
    kind_for = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram", "agg_histogram": "histogram"}
    for item in params.get("metrics", []):
        name = prefix + item.get("name", "")
        labels = list(item.get("labels", []))
        mtype = item.get("type", "counter")
        if mtype not in kind_for:
            log.warning("prom metric type %r unsupported; skipped", mtype)
            continue
        if name in seen_names:
            # two entries sharing a name within ONE config: binding both to
            # the same collector would double-count, so the first wins
            log.warning("prom metric %r declared twice; second skipped", name)
            continue
        kind = kind_for[mtype]
        try:
            m = facade.make_metric(kind, name, name, labels, registry,
                                   buckets=item.get("buckets"))
        except ValueError as exc:
            # already registered = an exporter REBUILD against the shared
            # agent registry (restart-in-place): adopt the live collector so
            # the new stage keeps updating it — skipping would freeze the
            # series forever; an incompatible survivor degrades to warn+skip
            # like every other unsupported-config case (never abort startup)
            existing = facade.live_metric(registry, name)
            compatible = (facade.metric_kind(existing) == kind
                          and facade.metric_labels(existing) == labels)
            if compatible and kind == "histogram":
                # bucket edits across a restart-in-place must not be
                # silently ignored — stale boundaries would misbin forever.
                # Mirror prometheus_client's normalization: +inf is only
                # appended when the declared list doesn't already end in it
                want = [float(b) for b in (item.get("buckets")
                                           or facade.default_buckets())]
                if not want or want[-1] != float("inf"):
                    want.append(float("inf"))
                compatible = want == facade.histogram_bounds(existing)
            if compatible:
                m = existing
                log.info("prom metric %r reused from registry", name)
            else:
                log.warning("prom metric %r not registered (%s); skipped",
                            name, exc)
                continue
        seen_names.add(name)
        filters = []
        for f in item.get("filters", []):
            ftype = f.get("type", "equal")
            key, value = f.get("key"), f.get("value")
            if ftype in ("match_regex", "not_match_regex"):
                value = re.compile(str(value))
            elif ftype in ("equal", "not_equal"):
                value = str(value)
            filters.append((ftype, key, value))
        metrics.append((m, mtype, item.get("valueKey", ""), labels, filters))

    def matches(entry: dict, filters) -> bool:
        for ftype, key, value in filters:
            present = key in entry
            ev = str(entry.get(key)) if present else ""
            if ftype == "equal" and ev != value:
                return False
            if ftype == "not_equal" and ev == value:
                return False
            if ftype == "presence" and not present:
                return False
            if ftype == "absence" and present:
                return False
            if ftype == "match_regex" and not value.search(ev):
                return False
            if ftype == "not_match_regex" and value.search(ev):
                return False
        return True

    def stage(entry: dict) -> Optional[dict]:
        for m, mtype, value_key, labels, filters in metrics:
            if not matches(entry, filters):
                continue
            if value_key:
                if value_key not in entry:
                    continue            # FLP skips on a missing value key
                try:
                    v = float(entry[value_key] or 0)
                except (TypeError, ValueError):
                    continue
            else:
                v = 1.0
            series = m.labels(*[str(entry.get(lb, "")) for lb in labels]) \
                if labels else m
            if mtype == "counter":
                series.inc(v)
            elif mtype == "gauge":
                series.set(v)
            else:
                series.observe(v)
        return entry

    return stage


class _ConnTrack:
    """FLP `extract conntrack` subset (api/conntrack.go): stitches
    unidirectional flow logs into connection records keyed by a canonical
    (bidirectional when fieldGroupARef/BRef are set) hash. Emits the
    configured record types: newConnection, flowLog, heartbeat,
    endConnection (timeout-, terminating- and FIN-driven). Timer semantics
    ride the exporter's batch cadence: sweeps run per exported batch, not on
    a wall-clock goroutine like FLP's."""

    def __init__(self, params: dict):
        kd = params.get("keyDefinition", {})
        self.groups = {g.get("name"): list(g.get("fields", []))
                       for g in kd.get("fieldGroups", [])}
        h = kd.get("hash", {})
        self.refs = [self.groups.get(r, []) for r in
                     h.get("fieldGroupRefs", [])]
        self.group_a = self.groups.get(h.get("fieldGroupARef"), [])
        self.group_b = self.groups.get(h.get("fieldGroupBRef"), [])
        self.bidi = bool(self.group_a and self.group_b)
        self.out_types = set(params.get("outputRecordTypes", ["flowLog"]))
        self.out_fields = [
            (f.get("name"), f.get("operation", "count"),
             bool(f.get("splitAB")), f.get("input") or f.get("name"))
            for f in params.get("outputFields", [])]
        sched = (params.get("scheduling") or [{}])[0]
        self.end_timeout = _duration_s(sched.get("endConnectionTimeout"), 10)
        self.term_timeout = _duration_s(sched.get("terminatingTimeout"), 5)
        self.heartbeat_s = _duration_s(sched.get("heartbeatInterval"), 30)
        # FLP default (api/conntrack.go doc): 100k; 0 stays unlimited
        self.max_tracked = int(
            params.get("maxConnectionsTracked", 100_000))
        tf = params.get("tcpFlags", {})
        self.flags_field = tf.get("fieldName", "")
        self.detect_end = bool(tf.get("detectEndConnection"))
        self.swap_ab = bool(tf.get("swapAB"))
        self.conns: dict = {}
        self._hash_n = 0
        self._overflow = 0

    def _vals(self, entry: dict, fields) -> tuple:
        return tuple(str(entry.get(f, "")) for f in fields)

    def _key(self, entry: dict):
        ref_vals = tuple(self._vals(entry, g) for g in self.refs)
        if not self.bidi:
            return (ref_vals,)
        a, b = self._vals(entry, self.group_a), self._vals(entry, self.group_b)
        return (ref_vals, tuple(sorted((a, b))))

    def _agg_init(self) -> dict:
        agg = {}
        for name, op, split, _ in self.out_fields:
            for suffix in (("_AB", "_BA") if split else ("",)):
                agg[name + suffix] = 0 if op in ("sum", "count") else None
        return agg

    def _agg_update(self, agg: dict, entry: dict, is_ab: bool) -> None:
        for name, op, split, inp in self.out_fields:
            k = name + (("_AB" if is_ab else "_BA") if split else "")
            if op == "count":
                agg[k] = (agg[k] or 0) + 1
                continue
            if inp not in entry:
                continue
            try:
                v = float(entry[inp])
            except (TypeError, ValueError):
                continue
            cur = agg[k]
            if op == "sum":
                agg[k] = (cur or 0) + v
            elif op == "min":
                agg[k] = v if cur is None else min(cur, v)
            elif op == "max":
                agg[k] = v if cur is None else max(cur, v)
            elif op == "first":
                agg[k] = v if cur is None else cur
            elif op == "last":
                agg[k] = v

    def _conn_record(self, conn: dict, rtype: str) -> dict:
        rec = dict(conn["key_fields"])
        for k, v in conn["agg"].items():
            if v is not None:
                rec[k] = v
        rec["_RecordType"] = rtype
        rec["_HashId"] = conn["hash_id"]
        return rec

    def __call__(self, entry: dict):
        now = _time.monotonic()
        out = []
        key = self._key(entry)
        conn = self.conns.get(key)
        flags = 0
        if self.flags_field:
            try:
                flags = int(entry.get(self.flags_field, 0) or 0)
            except (TypeError, ValueError):
                flags = 0
        if conn is None:
            if not self.max_tracked or len(self.conns) < self.max_tracked:
                a = self._vals(entry, self.group_a) if self.bidi else ()
                key_fields = {f: entry.get(f)
                              for g in self.groups.values() for f in g}
                # swapAB: a first flow log carrying SYN_ACK was sent by the
                # server — orient the connection from the client instead,
                # and swap the A/B field values on the connection record
                # (FLP swaps the field groups pairwise by position)
                if self.bidi and self.swap_ab and flags & 0x100:
                    a = self._vals(entry, self.group_b)
                    for fa, fb in zip(self.group_a, self.group_b):
                        key_fields[fa], key_fields[fb] = \
                            entry.get(fb), entry.get(fa)
                self._hash_n += 1
                conn = {"a": a, "agg": self._agg_init(),
                        "key_fields": key_fields,
                        "hash_id": f"{self._hash_n:08x}",
                        "last_update": now, "last_report": now,
                        "fin_seen_at": None, "new": True}
                self.conns[key] = conn
            else:
                self._overflow += 1
        if conn is not None:
            is_ab = (not self.bidi
                     or self._vals(entry, self.group_a) == conn["a"])
            self._agg_update(conn["agg"], entry, is_ab)
            conn["last_update"] = now
            if self.detect_end and flags & 0x201:       # FIN or FIN_ACK
                conn["fin_seen_at"] = conn["fin_seen_at"] or now
            if conn.pop("new", False) and \
                    "newConnection" in self.out_types:
                out.append(self._conn_record(conn, "newConnection"))
        if "flowLog" in self.out_types:
            fl = dict(entry)
            fl["_RecordType"] = "flowLog"
            if conn is not None:
                fl["_HashId"] = conn["hash_id"]
            out.append(fl)
        return out

    def sweep(self) -> list:
        """Timer pass, run once per exported batch: heartbeats and
        connection teardown (idle timeout / FIN + terminating timeout)."""
        now = _time.monotonic()
        out = []
        if self._overflow:
            log.warning("conntrack: store full (%d); %d flow logs passed "
                        "through untracked since the last sweep",
                        self.max_tracked, self._overflow)
            self._overflow = 0
        for key in list(self.conns):
            conn = self.conns[key]
            ended = (now - conn["last_update"] >= self.end_timeout
                     or (conn["fin_seen_at"] is not None
                         and now - conn["fin_seen_at"] >= self.term_timeout))
            if ended:
                if "endConnection" in self.out_types:
                    out.append(self._conn_record(conn, "endConnection"))
                del self.conns[key]
            elif (now - conn["last_report"] >= self.heartbeat_s
                    and "heartbeat" in self.out_types):
                out.append(self._conn_record(conn, "heartbeat"))
                conn["last_report"] = now
        return out

    def flush(self) -> list:
        """Shutdown: every live connection emits its endConnection."""
        out = []
        if "endConnection" in self.out_types:
            out = [self._conn_record(c, "endConnection")
                   for c in self.conns.values()]
        self.conns.clear()
        return out


class _Aggregates:
    """FLP `extract aggregates` subset (api/extract_aggregate.go): group-by
    aggregation over the flow-log stream. Like FLP's Extract, the stage
    REPLACES the stream: flow logs are absorbed and one record per active
    (definition, group) is emitted per exported batch, carrying running
    totals plus recent_* values that reset each cycle; idle groups expire
    after expiryTime (default 2m)."""

    def __init__(self, params: dict):
        default_expiry = _duration_s(params.get("defaultExpiryTime"), 120)
        self.defs = []
        for d in params.get("rules", params.get("aggregates", [])):
            self.defs.append({
                "name": d.get("name", ""),
                "by": list(d.get("groupByKeys", [])),
                "op": d.get("operationType", "count"),
                "key": d.get("operationKey", ""),
                "expiry": _duration_s(d.get("expiryTime"), default_expiry),
                "groups": {},
            })

    def __call__(self, entry: dict):
        now = _time.monotonic()
        for d in self.defs:
            gv = tuple(str(entry.get(k, "")) for k in d["by"])
            g = d["groups"].get(gv)
            if g is None:
                g = d["groups"][gv] = {
                    "total_value": None, "total_count": 0, "recent_count": 0,
                    "recent_op": None, "recent_raw": [], "last": now}
            g["last"] = now
            v = 1.0
            if d["op"] != "count":
                # an entry without the operation key contributes nothing —
                # not even to the counts, or min/avg skew toward 0 (FLP
                # skips the whole entry on a missing value key)
                if d["key"] not in entry:
                    continue
                try:
                    v = float(entry[d["key"]] or 0)
                except (TypeError, ValueError):
                    continue
            g["total_count"] += 1
            g["recent_count"] += 1
            op, cur = d["op"], g["recent_op"]
            tot = g["total_value"]
            if op in ("sum", "count"):
                inc = v if op == "sum" else 1
                g["total_value"] = (tot or 0) + inc
                g["recent_op"] = (cur or 0) + inc
            elif op == "min":
                g["total_value"] = v if tot is None else min(tot, v)
                g["recent_op"] = v if cur is None else min(cur, v)
            elif op == "max":
                g["total_value"] = v if tot is None else max(tot, v)
                g["recent_op"] = v if cur is None else max(cur, v)
            elif op == "avg":
                g["total_value"] = (tot or 0.0) + \
                    (v - (tot or 0.0)) / g["total_count"]
                g["recent_op"] = ((cur or 0) * (g["recent_count"] - 1) + v) \
                    / g["recent_count"]
            elif op == "raw_values":
                g["recent_raw"].append(v)
        return None                              # extract replaces the stream

    def sweep(self) -> list:
        now = _time.monotonic()
        out = []
        for d in self.defs:
            for gv in list(d["groups"]):
                g = d["groups"][gv]
                if now - g["last"] >= d["expiry"]:
                    del d["groups"][gv]
                    continue
                rec = {
                    "name": d["name"], "operation_type": d["op"],
                    "operation_key": d["key"], "by": ",".join(d["by"]),
                    "aggregate": ",".join(gv),
                    "total_value": g["total_value"] or 0,
                    "total_count": g["total_count"],
                    "recent_raw_values": list(g["recent_raw"]),
                    "recent_op_value": g["recent_op"] or 0,
                    "recent_count": g["recent_count"],
                    "_".join(d["by"]): ",".join(gv),
                }
                for k, v in zip(d["by"], gv):
                    rec[k] = v
                out.append(rec)
                g["recent_count"] = 0
                g["recent_op"] = None
                g["recent_raw"] = []
        return out


class _Timebased:
    """FLP `extract timebased` subset (api/extract_timebased.go): per-rule
    sliding-window (timeInterval) top-K over indexKeys by an operation on
    operationKey. Absorbs flow logs; emits one record per reported index
    value per exported batch."""

    def __init__(self, params: dict):
        self.rules = []
        for r in params.get("rules", []):
            keys = list(r.get("indexKeys", []))
            if not keys and r.get("indexKey"):
                keys = [r["indexKey"]]
            self.rules.append({
                "name": r.get("name", ""), "keys": keys,
                "op": r.get("operationType", "sum"),
                "key": r.get("operationKey", ""),
                "topk": int(r.get("topK", 0)),
                "window": _duration_s(r.get("timeInterval"), 10),
                "series": {},                    # index tuple -> [(ts, v)]
            })

    def __call__(self, entry: dict):
        now = _time.monotonic()
        for r in self.rules:
            if r["key"] not in entry:
                continue                # missing input: no data point
            idx = tuple(str(entry.get(k, "")) for k in r["keys"])
            try:
                v = float(entry[r["key"]] or 0)
            except (TypeError, ValueError):
                continue
            r["series"].setdefault(idx, []).append((now, v))
        return None

    def sweep(self) -> list:
        now = _time.monotonic()
        out = []
        for r in self.rules:
            results = []
            for idx in list(r["series"]):
                pts = [(t, v) for t, v in r["series"][idx]
                       if now - t < r["window"]]
                if not pts:
                    del r["series"][idx]
                    continue
                r["series"][idx] = pts
                vals = [v for _, v in pts]
                op = r["op"]
                if op == "sum":
                    res = sum(vals)
                elif op == "min":
                    res = min(vals)
                elif op == "max":
                    res = max(vals)
                elif op == "avg":
                    res = sum(vals) / len(vals)
                elif op == "count":
                    res = float(len(vals))
                elif op == "last":
                    res = vals[-1]
                elif op == "diff":
                    res = vals[-1] - vals[0]
                else:
                    continue
                results.append((res, idx))
            results.sort(key=lambda x: x[0], reverse=True)
            if r["topk"]:
                results = results[:r["topk"]]
            for res, idx in results:
                rec = {"name": r["name"],
                       "index_key": ",".join(r["keys"]),
                       "operation": r["op"], r["key"]: res}
                for k, v in zip(r["keys"], idx):
                    rec[k] = v
                out.append(rec)
        return out


def _duration_s(v, default: float) -> float:
    """Parse an FLP/Go duration ('30s', '1m30s', '500ms', number) to
    seconds; malformed values warn and fall back to the default."""
    from netobserv_tpu_torch.config import parse_duration

    if v is None or v == "":
        return float(default)
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return parse_duration(str(v))
    except ValueError:
        log.warning("invalid duration %r; using default %ss", v, default)
        return float(default)


def _build_generic(params: dict) -> Stage:
    rules = params.get("rules", [])
    policy = params.get("policy", "replace_keys")

    def stage(entry: dict) -> Optional[dict]:
        out = {} if policy == "replace_keys" else dict(entry)
        for rule in rules:
            src, dst = rule.get("input"), rule.get("output")
            if src in entry:
                out[dst or src] = entry[src]
        return out

    return stage


class _KafkaEncode:
    """FLP `encode kafka` (encode_kafka.go): each entry is JSON-serialized
    and produced to a topic through the in-repo wire producer
    (`kafka/producer.py`). Entries pass through to the rest of the
    pipeline. Produce failures are logged and dropped — a dead broker must
    not wedge the eviction loop (exporters never crash the pipeline)."""

    def __init__(self, params: dict, producer=None):
        self._params = params
        self._producer = producer  # tests inject; lazily built otherwise
        self._pending: list[tuple[None, bytes]] = []

    def _ensure_producer(self):
        if self._producer is None:
            from netobserv_tpu_torch.kafka.producer import KafkaProducer
            address = self._params.get("address", "localhost:9092")
            self._producer = KafkaProducer(
                brokers=[address],
                topic=self._params.get("topic", "network-flows"))
        return self._producer

    def __call__(self, entry: dict) -> dict:
        self._pending.append(
            (None, json.dumps(entry, separators=(",", ":")).encode()))
        return entry

    def sweep(self) -> list:
        if self._pending:
            batch, self._pending = self._pending, []
            try:
                self._ensure_producer().send_batch(batch)
            except Exception as exc:
                log.warning("FLP kafka encode failed (%s); %d entries "
                            "dropped from the topic (pipeline continues)",
                            exc, len(batch))
        return []

    def close(self) -> None:
        if self._producer is not None:
            self._producer.close()


class _IPFIXWrite:
    """FLP `write ipfix` (write_ipfix.go): the entry stream becomes IPFIX
    data records through the in-repo exporter (`exporter/ipfix.py`, v4/v6
    templates, MTU split, TCP template re-send). Terminal stage. The
    exporter is built lazily inside the try-guarded push — a temporarily
    unreachable TCP collector must not crash agent startup (exporters
    never crash the pipeline)."""

    def __init__(self, params: dict, exporter=None):
        self._params = params
        self._exp = exporter

    def _ensure_exporter(self):
        if self._exp is None:
            from netobserv_tpu_torch.exporter.ipfix import IPFIXExporter
            self._exp = IPFIXExporter(
                self._params.get("targetHost", "localhost"),
                int(self._params.get("targetPort", 4739)),
                transport=str(self._params.get("transport", "udp")).lower())
        return self._exp

    def push(self, entries: list[dict]) -> None:
        from netobserv_tpu_torch.exporter.flp_map import map_to_record
        try:
            self._ensure_exporter().export_batch(
                [map_to_record(e) for e in entries])
        except Exception as exc:
            log.warning("FLP ipfix write failed (%s); %d records dropped",
                        exc, len(entries))

    def close(self) -> None:
        if self._exp is not None:
            self._exp.close()


def _sigv4_put(endpoint: str, secure: bool, bucket: str, key: str,
               body: bytes, access_key: str, secret_key: str,
               region: str = "us-east-1", timeout: float = 10.0,
               now=None) -> None:
    """Minimal AWS Signature V4 PUT-object over stdlib http.client — the
    S3 wire contract the reference's minio client speaks, with no SDK; the
    signature math is pinned by tests/test_torch_direct_flp.py, whose fake
    endpoint re-derives it server-side."""
    import datetime
    import hashlib
    import hmac
    import http.client

    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    host = endpoint
    path = "/" + bucket + "/" + key
    payload_hash = hashlib.sha256(body).hexdigest()
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed = ";".join(sorted(headers))
    canonical = "\n".join([
        "PUT", path, "",
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
        signed, payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])

    def hm(k, msg):
        return hmac.new(k, msg.encode(), hashlib.sha256).digest()

    sig_key = hm(hm(hm(hm(("AWS4" + secret_key).encode(), datestamp),
                       region), "s3"), "aws4_request")
    signature = hmac.new(sig_key, to_sign.encode(), hashlib.sha256).hexdigest()
    auth = (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}")
    cls = http.client.HTTPSConnection if secure else http.client.HTTPConnection
    conn = cls(endpoint, timeout=timeout)
    try:
        conn.request("PUT", path, body=body,
                     headers={**headers, "Authorization": auth,
                              "Content-Length": str(len(body))})
        resp = conn.getresponse()
        resp.read()
        if resp.status >= 300:
            raise IOError(f"S3 PUT {path} -> {resp.status}")
    finally:
        conn.close()


class _S3Encode:
    """FLP `encode s3` (encode_s3.go): entries buffer until `batchSize`,
    then ship as one JSON object with the FLP store header (version,
    capture window, count, user header parameters) under the reference's
    object-name layout `account/year=/month=/day=/hour=/stream-id=/<seq>`.
    Entries pass through; PUT failures are logged and dropped."""

    def __init__(self, params: dict, put=None):
        import time as _time
        import uuid

        self._p = params
        self._batch_size = int(params.get("batchSize", 10) or 10)
        self._pending: list[dict] = []
        self._stream_id = params.get("streamId", uuid.uuid4().hex[:12])
        self._seq = 0
        self._interval_start = _time.time()
        self._put = put or self._default_put

    def _default_put(self, key: str, body: bytes) -> None:
        _sigv4_put(self._p.get("endpoint", "localhost:9000"),
                   bool(self._p.get("secure", False)),
                   self._p.get("bucket", "netobserv"), key, body,
                   self._p.get("accessKeyId", ""),
                   self._p.get("secretAccessKey", ""))

    def __call__(self, entry: dict) -> dict:
        self._pending.append(entry)
        return entry

    def _object(self, flows, start_ts, end_ts) -> dict:
        import datetime

        def rfc3339(ts):
            return datetime.datetime.fromtimestamp(
                ts, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")

        obj = dict(self._p.get("objectHeaderParameters", {}) or {})
        obj["version"] = "v0.1"
        obj["capture_start_time"] = rfc3339(start_ts)
        obj["capture_end_time"] = rfc3339(end_ts)
        obj["number_of_flow_logs"] = len(flows)
        obj["flow_logs"] = flows
        return obj

    def _flush_batches(self, final: bool = False) -> None:
        import time as _time

        while (len(self._pending) >= self._batch_size
               or (final and self._pending)):
            batch = self._pending[:self._batch_size]
            self._pending = self._pending[self._batch_size:]
            now = _time.time()
            t = _time.gmtime(now)
            key = (f"{self._p.get('account', 'netobserv')}/"
                   f"year={t.tm_year:04d}/month={t.tm_mon:02d}/"
                   f"day={t.tm_mday:02d}/hour={t.tm_hour:02d}/"
                   f"stream-id={self._stream_id}/{self._seq:08d}")
            body = json.dumps(self._object(batch, self._interval_start, now),
                              separators=(",", ":")).encode()
            self._interval_start = now
            self._seq += 1
            try:
                self._put(key, body)
            except Exception as exc:
                log.warning("FLP s3 encode failed (%s); %d entries dropped "
                            "from the store (pipeline continues)",
                            exc, len(batch))

    def sweep(self) -> list:
        self._flush_batches()
        return []

    def flush(self) -> list:
        self._flush_batches(final=True)
        return []


class _GRPCWrite:
    """FLP `write grpc` (write_grpc.go): the entry stream leaves as pbflow
    Records to a pbflow.Collector (the in-repo flow client — TLS/mTLS via
    the `tls: {caCertPath, userCertPath, userKeyPath}` block). Terminal
    stage; lazily constructed and error-swallowing like the other
    writers."""

    def __init__(self, params: dict, client=None):
        self._params = params
        self._client = client

    def _ensure_client(self):
        if self._client is None:
            from netobserv_tpu_torch.grpc.flow import FlowClient
            tls = self._params.get("tls", {})
            self._client = FlowClient(
                self._params.get("targetHost", "localhost"),
                int(self._params.get("targetPort", 9999)),
                tls_ca=tls.get("caCertPath", ""),
                tls_cert=tls.get("userCertPath", ""),
                tls_key=tls.get("userKeyPath", ""))
        return self._client

    def push(self, entries: list[dict]) -> None:
        from netobserv_tpu_torch.exporter.flp_map import map_to_record
        from netobserv_tpu_torch.exporter.pb_convert import records_to_pb
        try:
            self._ensure_client().send(
                records_to_pb([map_to_record(e) for e in entries]))
        except Exception as exc:
            log.warning("FLP grpc write failed (%s); %d records dropped",
                        exc, len(entries))

    def close(self) -> None:
        if self._client is not None:
            self._client.close()


class DirectFLPExporter(Exporter):
    name = "direct-flp"

    def __init__(self, flp_config: str = "", stream=None, prom_registry=None,
                 kube_source=None, location_db=None, kafka_producer=None):
        from netobserv_tpu_torch.metrics.registry import new_registry

        self._stream = stream if stream is not None else sys.stdout
        #: one batch's lines are written whole under it (module docstring)
        self._emit_lock = threading.Lock()
        self._stages: list[Stage] = []
        # encode/prom metrics land here; the agent passes its own registry so
        # they surface on the existing /metrics server
        self.prom_registry = (prom_registry if prom_registry is not None
                              else new_registry())
        self._prom_names: set[str] = set()
        # pluggable enrichment backends (exporter.flp_enrich protocols)
        self._kube_source = kube_source
        self._location_db = location_db
        self._kafka_producer = kafka_producer  # tests inject a wired producer
        if flp_config.strip():
            import yaml  # only here: FLP_CONFIG is YAML (JSON is YAML too)

            self._build(yaml.safe_load(flp_config))

    def _build(self, cfg: dict) -> None:
        params = {p.get("name"): p for p in cfg.get("parameters", [])}
        # follow the pipeline order; ingest stages are implicit/skipped
        for step in cfg.get("pipeline", []):
            p = params.get(step.get("name"), {})
            if "transform" in p:
                t = p["transform"]
                ttype = t.get("type")
                if ttype == "filter":
                    self._stages.append(_build_filter(t.get("filter", {})))
                elif ttype == "generic":
                    self._stages.append(_build_generic(t.get("generic", {})))
                elif ttype == "network":
                    self._stages.append(_build_network(
                        t.get("network", {}),
                        kube_source=self._kube_source,
                        location_db=self._location_db))
                else:
                    log.warning("unsupported transform type %r ignored", ttype)
            elif "extract" in p:
                x = p["extract"]
                if x.get("type") == "conntrack":
                    self._stages.append(_ConnTrack(x.get("conntrack", {})))
                elif x.get("type") == "aggregates":
                    self._stages.append(_Aggregates(x.get("aggregates", {})))
                elif x.get("type") == "timebased":
                    self._stages.append(_Timebased(x.get("timebased", {})))
                else:
                    log.warning("unsupported extract type %r ignored",
                                x.get("type"))
            elif "encode" in p:
                e = p["encode"]
                if e.get("type") == "prom":
                    self._stages.append(
                        _build_prom(e.get("prom", {}), self.prom_registry,
                                    self._prom_names))
                elif e.get("type") == "kafka":
                    self._stages.append(
                        _KafkaEncode(e.get("kafka", {}),
                                     producer=self._kafka_producer))
                elif e.get("type") == "s3":
                    self._stages.append(_S3Encode(e.get("s3", {})))
                else:
                    log.warning("unsupported encode type %r ignored",
                                e.get("type"))
            elif "write" in p:
                wtype = p["write"].get("type", "stdout")
                if wtype == "loki":
                    self._writer = _LokiWriter(p["write"].get("loki", {}))
                elif wtype == "ipfix":
                    self._writer = _IPFIXWrite(p["write"].get("ipfix", {}))
                elif wtype == "grpc":
                    self._writer = _GRPCWrite(p["write"].get("grpc", {}))
                elif wtype != "stdout":
                    log.warning("write type %r unsupported; using stdout", wtype)
            elif "ingest" in p or not p:
                continue

    _writer = None  # non-stdout terminal (e.g. _LokiWriter)

    def export_batch(self, records: list[Record]) -> None:
        entries: list[dict] = [record_to_map(r) for r in records]
        self._emit(self._run_stages(entries))

    def _run_stages(self, entries: list[dict], stages=None) -> list[dict]:
        for stage in (self._stages if stages is None else stages):
            nxt: list[dict] = []
            for entry in entries:
                res = stage(entry)
                if res is None:
                    continue
                nxt.extend(res) if isinstance(res, list) else nxt.append(res)
            # stateful stages (conntrack) produce timer records per batch
            sweep = getattr(stage, "sweep", None)
            if sweep is not None:
                nxt.extend(sweep())
            entries = nxt
        return entries

    def _emit(self, out: list[dict]) -> None:
        if self._writer is not None:
            self._writer.push(out)
            return
        with self._emit_lock:
            for entry in out:
                self._stream.write(
                    json.dumps(entry, separators=(",", ":")) + "\n")
            self._stream.flush()

    def close(self) -> None:
        """Drain stateful stages: live connections emit endConnection
        through the remainder of the pipeline before shutdown. Never raises
        — a failed final emit must not abort agent shutdown (the fetcher
        teardown runs after this)."""
        for i, stage in enumerate(self._stages):
            flush = getattr(stage, "flush", None)
            if flush is None:
                continue
            try:
                pending = flush()
                if pending:
                    self._emit(self._run_stages(
                        pending, stages=self._stages[i + 1:]))
            except Exception as exc:
                log.warning("shutdown flush failed (%s); remaining "
                            "connection records dropped", exc)
        # release stage/writer transports (kafka producer, ipfix socket)
        for closer in (*self._stages, self._writer):
            close = getattr(closer, "close", None)
            if close is not None:
                try:
                    close()
                except Exception as exc:
                    log.warning("stage close failed: %s", exc)


class _LokiWriter:
    """FLP `write loki` subset (api/write_loki.go): push the entry stream to
    Loki's /loki/api/v1/push as JSON streams. Entries are grouped by their
    label set per batch; the agent's batching replaces batchWait/batchSize
    timers (one push per exported batch). Push failures are logged and
    dropped — an unreachable Loki must not wedge the eviction loop."""

    #: after this many consecutive failures, pushes are skipped until
    #: BACKOFF_S elapses — a dead Loki must not throttle the export queue
    #: to one TIMEOUT_S-blocked batch per drain. TIMEOUT_S stays above
    #: burst/compaction ingest latency so a merely SLOW Loki doesn't trip
    #: the breaker (a blip costs consecutive failures, not data loss).
    FAIL_THRESHOLD = 3
    BACKOFF_S = 30.0
    TIMEOUT_S = 5.0

    def __init__(self, params: dict):
        self.url = params.get("url", "http://localhost:3100").rstrip("/")
        self.tenant = params.get("tenantID", "")
        self.labels = list(params.get("labels", []))
        self.static_labels = dict(params.get("staticLabels", {}))
        self.ts_label = params.get("timestampLabel", "TimeFlowEndMs")
        # FLP timestampScale, e.g. "1s" / "1ms" -> ns multiplier
        scale = params.get("timestampScale", "1ms")
        self.ts_ns_mult = {"1s": 10**9, "1ms": 10**6, "1us": 10**3,
                           "1ns": 1}.get(scale, 10**6)
        self._consec_failures = 0
        self._backoff_until = 0.0
        self._backoff_dropped = 0

    def push(self, entries: list[dict]) -> None:
        import http.client
        import urllib.error
        import urllib.request

        if not entries:
            return
        if (self._consec_failures >= self.FAIL_THRESHOLD
                and _time.monotonic() < self._backoff_until):
            # tallied, not silent: the drop volume is reported on the next
            # dial (warning either way), so operators see what backoff cost
            self._backoff_dropped += len(entries)
            return
        streams: dict[tuple, list] = {}
        for e in entries:
            lbl = dict(self.static_labels)
            for k in self.labels:
                if k in e:
                    lbl[k] = str(e[k])
            try:
                ts = int(int(e.get(self.ts_label, 0)) * self.ts_ns_mult) \
                    or _time.time_ns()
            except (TypeError, ValueError):
                ts = _time.time_ns()
            streams.setdefault(tuple(sorted(lbl.items())), []).append(
                [str(ts), json.dumps(e, separators=(",", ":"))])
        body = json.dumps({"streams": [
            {"stream": dict(k), "values": v} for k, v in streams.items()
        ]}).encode()
        req = urllib.request.Request(
            self.url + "/loki/api/v1/push", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        if self.tenant:
            req.add_header("X-Scope-OrgID", self.tenant)
        try:
            urllib.request.urlopen(req, timeout=self.TIMEOUT_S).read()
            self._consec_failures = 0
            if self._backoff_dropped:
                log.warning("loki recovered; %d entries were dropped during "
                            "backoff", self._backoff_dropped)
                self._backoff_dropped = 0
        except (urllib.error.URLError, OSError,
                http.client.HTTPException) as exc:
            self._consec_failures += 1
            if self._consec_failures >= self.FAIL_THRESHOLD:
                self._backoff_until = _time.monotonic() + self.BACKOFF_S
            log.warning("loki push failed (%d entries dropped, %d more "
                        "during backoff): %s",
                        len(entries), self._backoff_dropped, exc)
            self._backoff_dropped = 0
