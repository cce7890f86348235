"""Record -> FLP GenericMap field naming.

A copy of `netobserv_tpu/exporter/flp_map.py` (lines 1-149), whose
reference is `pkg/decode/decode_protobuf.go:57-197` (`RecordToMap`): the
field names the flowlogs-pipeline ecosystem expects, in the reference's
key order (the JSON lines follow it). The direct-flp exporter
(`direct_flp.py`) reads records through it and its write stages turn
entries back into records through `map_to_record`.
"""

from __future__ import annotations

from netobserv_tpu_torch.exporter.flp_tables import (
    dns_rcode_to_str, pkt_drop_cause_to_str, tcp_state_to_str,
)
from netobserv_tpu_torch.model.flow import ip_from_16
from netobserv_tpu_torch.model.record import Record
from netobserv_tpu_torch.model import tls_types


def _mac(raw: bytes) -> str:
    return ":".join(f"{b:02X}" for b in raw)


def record_to_map(r: Record) -> dict:
    """FLP GenericMap for one flow record."""
    f = r.features
    out = {
        "FlowDirection": r.direction,
        "Bytes": r.bytes_,
        "Packets": r.packets,
        "SrcAddr": r.key.src,
        "DstAddr": r.key.dst,
        "SrcMac": _mac(r.src_mac),
        "DstMac": _mac(r.dst_mac),
        "Etype": r.eth_protocol,
        "Duplicate": False,
        "TimeFlowStartMs": r.time_flow_start_ns // 1_000_000,
        "TimeFlowEndMs": r.time_flow_end_ns // 1_000_000,
        "TimeReceived": r.time_flow_end_ns // 1_000_000_000,
        "Interface": r.interface,
        "Interfaces": [d[0] for d in r.dup_list] or [r.interface],
        "IfDirections": [d[1] for d in r.dup_list] or [r.direction],
        "AgentIP": r.agent_ip,
        "Sampling": r.sampling,
    }
    if r.udn or any(d[2] for d in r.dup_list):
        out["Udns"] = [d[2] for d in r.dup_list] or [r.udn]
    if r.dscp:
        out["Dscp"] = r.dscp
    out["Proto"] = r.key.proto
    if r.key.proto in (1, 58):  # ICMP / ICMPv6
        out["IcmpType"] = r.key.icmp_type
        out["IcmpCode"] = r.key.icmp_code
    elif r.key.proto in (6, 17, 132):  # TCP / UDP / SCTP carry ports
        out["SrcPort"] = r.key.src_port
        out["DstPort"] = r.key.dst_port
    if r.key.proto == 6:
        out["Flags"] = r.tcp_flags
    if f.drop_packets or f.drop_bytes:
        out["PktDropBytes"] = f.drop_bytes
        out["PktDropPackets"] = f.drop_packets
        out["PktDropLatestFlags"] = f.drop_latest_flags
        out["PktDropLatestState"] = tcp_state_to_str(f.drop_latest_state)
        out["PktDropLatestDropCause"] = pkt_drop_cause_to_str(
            f.drop_latest_cause)
    if f.dns_id or f.dns_latency_ns or f.dns_errno:
        out["DnsId"] = f.dns_id
        out["DnsFlags"] = f.dns_flags
        out["DnsErrno"] = f.dns_errno
        out["DnsFlagsResponseCode"] = dns_rcode_to_str(f.dns_flags & 0xF)
        if f.dns_latency_ns:
            out["DnsLatencyMs"] = f.dns_latency_ns // 1_000_000
        if f.dns_name:
            out["DnsName"] = f.dns_name
    if f.rtt_ns:
        out["TimeFlowRttNs"] = f.rtt_ns
    if f.network_events:
        from netobserv_tpu_torch.utils.ovn_decoder import decode_event
        out["NetworkEvents"] = [decode_event(ev) for ev in f.network_events]
    if f.xlat_src_ip:
        out["XlatSrcAddr"] = ip_from_16(f.xlat_src_ip)
        out["XlatDstAddr"] = ip_from_16(f.xlat_dst_ip)
        out["XlatSrcPort"] = f.xlat_src_port
        out["XlatDstPort"] = f.xlat_dst_port
        out["ZoneId"] = f.xlat_zone_id
    if f.ipsec_encrypted or f.ipsec_encrypted_ret:
        out["IPSecRet"] = f.ipsec_encrypted_ret
        out["IPSecStatus"] = "success" if f.ipsec_encrypted else "failure"
    if r.ssl_version:
        out["TlsVersion"] = tls_types.tls_version_name(r.ssl_version)
    if r.tls_cipher_suite:
        out["TlsCipher"] = tls_types.cipher_suite_name(r.tls_cipher_suite)
    if r.tls_key_share:
        out["TlsKeyShare"] = tls_types.key_share_name(r.tls_key_share)
    if r.tls_types:
        # set for any TLS record type, hello or not (mid-connection attach)
        out["TlsTypes"] = tls_types.tls_types_names(r.tls_types)
    if r.ssl_mismatch:
        out["TlsMismatch"] = True
    if f.ssl_plaintext_events:
        out["SslPlaintextEvents"] = f.ssl_plaintext_events
        out["SslPlaintextBytes"] = f.ssl_plaintext_bytes
    if f.quic_version or f.quic_seen_long_hdr or f.quic_seen_short_hdr:
        out["QuicVersion"] = f.quic_version
        out["QuicLongHdr"] = f.quic_seen_long_hdr
        out["QuicShortHdr"] = f.quic_seen_short_hdr
    return out


def _parse_mac(v) -> bytes:
    if isinstance(v, bytes):
        return (v + b"\x00" * 6)[:6]
    try:
        return bytes(int(p, 16) for p in str(v).split(":"))[:6].ljust(6, b"\x00")
    except ValueError:
        return b"\x00" * 6


def map_to_record(entry: dict) -> Record:
    """Inverse of `record_to_map` for the fields the wire exporters carry
    (IPFIX templates, pbflow) — lets FLP write stages reuse the Record-based
    exporters on an entry stream that has passed through transform stages.
    Unknown/enriched keys are ignored; missing keys default to zero values
    (same tolerance as the reference's generic-map decode,
    pkg/decode/decode_protobuf.go)."""
    from netobserv_tpu_torch.model.flow import FlowKey, ip_to_16

    key = FlowKey(
        src_ip=ip_to_16(entry.get("SrcAddr", "0.0.0.0")),
        dst_ip=ip_to_16(entry.get("DstAddr", "0.0.0.0")),
        src_port=int(entry.get("SrcPort", 0)),
        dst_port=int(entry.get("DstPort", 0)),
        proto=int(entry.get("Proto", 0)),
        icmp_type=int(entry.get("IcmpType", 0)),
        icmp_code=int(entry.get("IcmpCode", 0)))
    return Record(
        key=key,
        bytes_=int(entry.get("Bytes", 0)),
        packets=int(entry.get("Packets", 0)),
        eth_protocol=int(entry.get("Etype", 0)),
        tcp_flags=int(entry.get("Flags", 0)),
        direction=int(entry.get("FlowDirection", 0)),
        src_mac=_parse_mac(entry.get("SrcMac", "")),
        dst_mac=_parse_mac(entry.get("DstMac", "")),
        interface=str(entry.get("Interface", "")),
        dscp=int(entry.get("Dscp", 0)),
        sampling=int(entry.get("Sampling", 0)),
        time_flow_start_ns=int(entry.get("TimeFlowStartMs", 0)) * 1_000_000,
        time_flow_end_ns=int(entry.get("TimeFlowEndMs", 0)) * 1_000_000,
        agent_ip=str(entry.get("AgentIP", "")),
    )
