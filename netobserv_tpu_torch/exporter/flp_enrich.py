"""Kubernetes and GeoIP enrichment backends for the embedded FLP pipeline.

A copy of `netobserv_tpu/exporter/flp_enrich.py` (lines 1-210).
Closes the `add_kubernetes` / `add_location` gap in `direct_flp`
(reference: FLP `transform_network.go:78-126`, `kubernetes/enrich.go:37-104`,
`location/location.go`): the rules are fully implemented here against
PLUGGABLE data sources, because the data itself must come from outside the
process — a cluster API watch for Kubernetes, a GeoIP database for
location. The agent wires file-backed defaults (`FLP_KUBE_MAP`,
`FLP_LOCATION_DB`); tests and embedders inject mocks implementing the same
two-method protocols. A live-cluster informer is a `KubeDataSource` whose
`lookup` reads its watch cache — the enrichment logic is identical.
"""

from __future__ import annotations

import bisect
import csv
import ipaddress
import json
import logging
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("netobserv_tpu_torch.exporter.flp_enrich")


# ---------------------------------------------------------------------------
# Kubernetes
# ---------------------------------------------------------------------------


@dataclass
class KubeInfo:
    """What the datasource knows about one IP (FLP `model.ResourceMetaData`
    subset)."""

    name: str
    kind: str = "Pod"  # Pod | Service | Node
    namespace: str = ""
    owner_name: str = ""
    owner_kind: str = ""
    network_name: str = ""
    host_ip: str = ""
    host_name: str = ""
    zone: str = ""
    uid: str = ""
    labels: dict = field(default_factory=dict)


class KubeDataSource:
    """Protocol: map an IP to Kubernetes metadata. Implementations: the
    file-backed `StaticKubeDataSource` below, test mocks, or a live
    apiserver watch (same shape as FLP's informers datasource)."""

    def lookup(self, ip: str) -> Optional[KubeInfo]:  # pragma: no cover
        raise NotImplementedError


class StaticKubeDataSource(KubeDataSource):
    """IP -> KubeInfo from a dict or JSON file:
    `{"10.0.0.5": {"name": "web-1", "kind": "Pod", "namespace": "prod",
                   "owner_name": "web", "owner_kind": "Deployment", ...}}`.
    The file-backed flavor of the informer for air-gapped / test use."""

    def __init__(self, mapping: Optional[dict] = None,
                 path: Optional[str] = None):
        if mapping is None:
            with open(path) as fh:  # type: ignore[arg-type]
                mapping = json.load(fh)
        self._by_ip = {
            ip: info if isinstance(info, KubeInfo) else KubeInfo(**info)
            for ip, info in (mapping or {}).items()}

    def lookup(self, ip: str) -> Optional[KubeInfo]:
        return self._by_ip.get(ip)


# assignee -> FLP output key suffixes (api/transform_network.go:136-163)
_FLP_KEYS = {
    "namespace": "_Namespace", "name": "_Name", "kind": "_Type",
    "owner_name": "_OwnerName", "owner_kind": "_OwnerType",
    "network_name": "_NetworkName", "host_ip": "_HostIP",
    "host_name": "_HostName", "zone": "_Zone",
}
_OTEL_KEYS = {
    "namespace": "k8s.namespace.name", "name": "k8s.name",
    "kind": "k8s.type", "owner_name": "k8s.owner.name",
    "owner_kind": "k8s.owner.type", "network_name": "k8s.net.name",
    "host_ip": "k8s.host.ip", "host_name": "k8s.host.name",
    "zone": "k8s.zone",
}


def enrich_kubernetes(entry: dict, rule: dict,
                      source: KubeDataSource) -> None:
    """Apply one `add_kubernetes` rule in place (kubernetes/enrich.go:37-87):
    resolve the rule's IP field and write namespace/name/type/owner/host
    under the rule's output prefix; optional labels under `labels_prefix`."""
    ip = entry.get(rule.get("ipField") or rule.get("input"))
    if not isinstance(ip, str):
        return
    info = source.lookup(ip)
    if info is None:
        return
    out = rule.get("output") or ""
    keys = _OTEL_KEYS if rule.get("assignee") == "otel" else _FLP_KEYS
    if info.namespace:  # NETOBSERV-666: never write empty namespaces
        entry[out + keys["namespace"]] = info.namespace
    entry[out + keys["name"]] = info.name
    entry[out + keys["kind"]] = info.kind
    entry[out + keys["owner_name"]] = info.owner_name or info.name
    entry[out + keys["owner_kind"]] = info.owner_kind or info.kind
    if info.network_name:
        entry[out + keys["network_name"]] = info.network_name
    if info.host_ip:
        entry[out + keys["host_ip"]] = info.host_ip
        if info.host_name:
            entry[out + keys["host_name"]] = info.host_name
    if rule.get("add_zone") and info.zone:
        entry[out + keys["zone"]] = info.zone
    prefix = rule.get("labels_prefix")
    if prefix:
        for k, v in info.labels.items():
            entry[f"{prefix}_{k}"] = v


# ---------------------------------------------------------------------------
# GeoIP location
# ---------------------------------------------------------------------------

LOCATION_FIELDS = ("CountryName", "CountryLongName", "RegionName",
                   "CityName", "Latitude", "Longitude")


class LocationDB:
    """Protocol: map an IP to the six FLP location fields."""

    def lookup(self, ip: str) -> Optional[dict]:  # pragma: no cover
        raise NotImplementedError


class CsvLocationDB(LocationDB):
    """Range CSV in the ip2location LITE layout the reference downloads
    (location.go:46-51): rows of
    `ip_from,ip_to,country_code,country_name,region,city,lat,lon` with
    numeric range bounds (IPv4 as u32, IPv6 as u128 — families are kept in
    separate sorted tables, binary-searched per lookup)."""

    def __init__(self, path: str):
        self._v4: list[tuple[int, int, dict]] = []
        self._v6: list[tuple[int, int, dict]] = []
        # v4-mapped space in IPv6-layout DBs: ::ffff:0:0/96 as u128 bounds
        map_lo = 0xFFFF00000000
        map_hi = map_lo + 0xFFFFFFFF
        with open(path, newline="") as fh:
            for row in csv.reader(fh):
                if (len(row) < 8 or not row[0].strip().isdigit()
                        or not row[1].strip().isdigit()):
                    continue  # malformed rows are skipped, never fatal
                lo, hi = int(row[0]), int(row[1])
                info = {
                    "CountryName": row[2].strip(),
                    "CountryLongName": row[3].strip(),
                    "RegionName": row[4].strip(),
                    "CityName": row[5].strip(),
                    "Latitude": row[6].strip(),
                    "Longitude": row[7].strip(),
                }
                if map_lo <= lo and hi <= map_hi:
                    # IPv6-layout DBs carry IPv4 as ::ffff-mapped ranges;
                    # normalize to the v4 table (lookups normalize inputs
                    # the same way)
                    self._v4.append((lo - map_lo, hi - map_lo, info))
                elif hi > 0xFFFFFFFF:
                    self._v6.append((lo, hi, info))
                else:
                    self._v4.append((lo, hi, info))
        self._v4.sort(key=lambda t: t[0])
        self._v6.sort(key=lambda t: t[0])
        self._v4_lo = [t[0] for t in self._v4]
        self._v6_lo = [t[0] for t in self._v6]

    def lookup(self, ip: str) -> Optional[dict]:
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return None
        if addr.version == 6 and isinstance(
                addr, ipaddress.IPv6Address) and addr.ipv4_mapped:
            addr = addr.ipv4_mapped
        n = int(addr)
        table, los = ((self._v4, self._v4_lo) if addr.version == 4
                      else (self._v6, self._v6_lo))
        i = bisect.bisect_right(los, n) - 1
        if i >= 0 and table[i][0] <= n <= table[i][1]:
            return table[i][2]
        return None


def enrich_location(entry: dict, rule: dict, db: LocationDB) -> None:
    """Apply one `add_location` rule in place (transform_network.go:78-90)."""
    ip = entry.get(rule.get("input"))
    if not isinstance(ip, str):
        return
    info = db.lookup(ip)
    if info is None:
        return
    out = rule.get("output") or ""
    for f in LOCATION_FIELDS:
        entry[out + "_" + f] = info.get(f, "")
