"""Canonical datapath map-name registry.

Reference analog: `pkg/maps/maps.go` + `make verify-maps` — one authoritative
list, consistency-tested against the C source (tests/test_datapath.py) so the
loader, bpfman deployment args, and the C can never drift apart.

The port's copy of `netobserv_tpu/datapath/maps.py` (lines 8-27), kept so
that the port imports nothing of the JAX package; a CPU test holds it
against the reference's list and the C source's map definitions.
"""

MAPS = [
    "aggregated_flows",
    "direct_flows",
    "flows_dns",
    "flows_drops",
    "flows_nevents",
    "flows_xlat",
    "flows_extra",
    "flows_quic",
    "packet_records",
    "dns_inflight",
    "dns_scratch",
    "global_counters",
    "filter_rules",
    "filter_peers",
    "ipsec_ingress_inflight",
    "ipsec_egress_inflight",
    "ssl_events",
    "sampling_gate",
]
