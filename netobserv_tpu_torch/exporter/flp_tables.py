"""FLP string tables: TCP states, packet-drop causes, DNS rcodes.

A copy of `netobserv_tpu/exporter/flp_tables.py` (lines 1-199), whose
reference is `pkg/decode/decode_protobuf.go:199-464` (TCPStateToStr,
PktDropCauseToStr, DNSRcodeToStr) and
`pkg/utils/networkevents/network_events.go:133-139` (the OVN causes).
FLP consumers match on these exact names. The drop-cause table and its
subsystem encoding are the port's one copy in `utils/drop_reasons.py`,
imported here.
"""

from __future__ import annotations

from netobserv_tpu_torch.utils.drop_reasons import (  # noqa: F401
    DROP_CAUSES, SKB_DROP_SUBSYS_CORE, SKB_DROP_SUBSYS_OVS,
    SKB_DROP_SUBSYS_SHIFT,
)

# arbitrary private space for OVN network-event causes (reference
# network_events.go: customDropReasonSubSysOVNEvents)
OVN_EVENTS_SUBSYS = 1 << 24

TCP_STATES = {
    1: "TCP_ESTABLISHED",
    2: "TCP_SYN_SENT",
    3: "TCP_SYN_RECV",
    4: "TCP_FIN_WAIT1",
    5: "TCP_FIN_WAIT2",
    6: "TCP_CLOSE",
    7: "TCP_CLOSE_WAIT",
    8: "TCP_LAST_ACK",
    9: "TCP_LISTEN",
    10: "TCP_CLOSING",
    11: "TCP_NEW_SYN_RECV",
}
TCP_STATE_INVALID = "TCP_INVALID_STATE"

# OVN network-event causes injected into the drop-cause space (index order
# is the wire contract; reference network_events.go `causes`)
OVN_EVENT_CAUSES = [
    "Unknown",
    "EgressFirewall",
    "AdminNetworkPolicy",
    "BaselineAdminNetworkPolicy",
    "NetworkPolicy",
    "MulticastNS",
    "MulticastCluster",
    "NetpolNode",
    "NetpolNamespace",
    "UDNIsolation",
]

DNS_RCODES = {
    0: "NoError",
    1: "FormErr",
    2: "ServFail",
    3: "NXDomain",
    4: "NotImp",
    5: "Refused",
    6: "YXDomain",
    7: "YXRRSet",
    8: "NXRRSet",
    9: "NotAuth",
    10: "NotZone",
    16: "BADVERS",
    17: "BADKEY",
    18: "BADTIME",
    19: "BADMODE",
    20: "BADNAME",
    21: "BADALG",
}


def tcp_state_to_str(state: int) -> str:
    return TCP_STATES.get(state, TCP_STATE_INVALID)


def ovn_drop_reason_to_str(cause: int) -> str:
    """OVN network-event cause name, or "" when outside the OVN space
    (reference: DropReasonCodeToString)."""
    idx = cause - OVN_EVENTS_SUBSYS
    if 0 <= idx < len(OVN_EVENT_CAUSES):
        return OVN_EVENT_CAUSES[idx]
    return ""


def pkt_drop_cause_to_str(cause: int) -> str:
    name = DROP_CAUSES.get(cause)
    if name is not None:
        return name
    ovn = ovn_drop_reason_to_str(cause)
    if ovn:
        return "NetworkEvent_" + ovn
    return "SKB_DROP_UNKNOWN_CAUSE"


def dns_rcode_to_str(rcode: int) -> str:
    return DNS_RCODES.get(rcode, "UnDefined")
