"""Record <-> pbflow converters, on the port's own flow wire.

A copy of `netobserv_tpu/exporter/pb_convert.py` (lines 1-158) over
`netobserv_tpu_torch/pb/flow.py` in place of the generated `flow_pb2`.
The messages' bytes are protobuf's deterministic ones, so each function
sets what the reference's sets, down to the sub-messages that a protobuf
assignment marks present: `data_link`, `network`, `transport` and both
times always, `agent_ip` when the record has one, the DNS latency with
the DNS block, and so on.
"""

from __future__ import annotations

import struct

from netobserv_tpu_torch.model.flow import FlowFeatures, FlowKey, ip_from_16
from netobserv_tpu_torch.model.flow import ip_to_16
from netobserv_tpu_torch.model.record import Record
from netobserv_tpu_torch.pb import flow as pbflow
from netobserv_tpu_torch.utils.ovn_decoder import decode_event

V4_PREFIX = b"\x00" * 10 + b"\xff\xff"
_ZERO16 = b"\x00" * 16


def _ip(raw16: bytes) -> pbflow.IP:
    """`_set_ip` (`pb_convert.py:17-21`): a v4-mapped address as fixed32,
    any other as its 16 bytes."""
    if raw16[:12] == V4_PREFIX:
        return pbflow.IP(ipv4=struct.unpack(">I", raw16[12:16])[0])
    return pbflow.IP(ipv6=raw16)


def _get_ip(pb_ip) -> bytes:
    """`_get_ip` (`pb_convert.py:24-27`); an absent IP reads as `::`."""
    if pb_ip is None:
        return _ZERO16
    if pb_ip.WhichOneof("ip_family") == "ipv4":
        return V4_PREFIX + struct.pack(">I", pb_ip.ipv4)
    return bytes(pb_ip.ipv6) if pb_ip.ipv6 else _ZERO16


def _mac_to_u64(mac: bytes) -> int:
    return int.from_bytes(mac[:6], "big")


def _u64_to_mac(v: int) -> bytes:
    return v.to_bytes(8, "big")[2:]


def _timestamp(ns: int) -> pbflow.Timestamp:
    t = pbflow.Timestamp()
    t.FromNanoseconds(ns)
    return t


def _duration(ns: int) -> pbflow.Duration:
    d = pbflow.Duration()
    d.FromNanoseconds(ns)
    return d


def _direction(d: int) -> int:
    return pbflow.EGRESS if d == 1 else pbflow.INGRESS


def record_to_pb(r: Record) -> pbflow.Record:
    """`record_to_pb` (`pb_convert.py:38-105`)."""
    f = r.features
    pb = pbflow.Record(
        eth_protocol=r.eth_protocol, direction=_direction(r.direction),
        time_flow_start=_timestamp(r.time_flow_start_ns),
        time_flow_end=_timestamp(r.time_flow_end_ns),
        data_link=pbflow.DataLink(src_mac=_mac_to_u64(r.src_mac),
                                  dst_mac=_mac_to_u64(r.dst_mac)),
        network=pbflow.Network(src_addr=_ip(r.key.src_ip),
                               dst_addr=_ip(r.key.dst_ip), dscp=r.dscp),
        transport=pbflow.Transport(src_port=r.key.src_port,
                                   dst_port=r.key.dst_port,
                                   protocol=r.key.proto),
        bytes=r.bytes_, packets=r.packets, interface=r.interface,
        flags=r.tcp_flags, icmp_type=r.key.icmp_type,
        icmp_code=r.key.icmp_code, sampling=r.sampling)
    if r.agent_ip:
        pb.agent_ip = _ip(ip_to_16(r.agent_ip))
    pb.dup_list = [pbflow.DupMapEntry(interface=iface,
                                      direction=_direction(direction),
                                      udn=udn)
                   for iface, direction, udn in r.dup_list]
    if f.drop_bytes or f.drop_packets:
        pb.pkt_drop_bytes = f.drop_bytes
        pb.pkt_drop_packets = f.drop_packets
        pb.pkt_drop_latest_flags = f.drop_latest_flags
        pb.pkt_drop_latest_state = f.drop_latest_state
        pb.pkt_drop_latest_drop_cause = f.drop_latest_cause
    if f.dns_id or f.dns_latency_ns or f.dns_errno:
        pb.dns_id = f.dns_id
        pb.dns_flags = f.dns_flags
        pb.dns_errno = f.dns_errno
        pb.dns_latency = _duration(f.dns_latency_ns)
        pb.dns_name = f.dns_name
    if f.rtt_ns:
        pb.time_flow_rtt = _duration(f.rtt_ns)
    pb.network_events_metadata = [
        pbflow.NetworkEvent(events={k: v for k, v in
                                    decode_event(ev).items()})
        for ev in f.network_events]
    if f.xlat_src_ip:
        pb.xlat = pbflow.Xlat(src_addr=_ip(f.xlat_src_ip),
                              dst_addr=_ip(f.xlat_dst_ip),
                              src_port=f.xlat_src_port,
                              dst_port=f.xlat_dst_port,
                              zone_id=f.xlat_zone_id)
    pb.ipsec_encrypted = int(f.ipsec_encrypted)
    pb.ipsec_encrypted_ret = f.ipsec_encrypted_ret
    pb.ssl_version = r.ssl_version
    pb.ssl_mismatch = r.ssl_mismatch
    pb.tls_types = r.tls_types
    pb.tls_cipher_suite = r.tls_cipher_suite
    pb.tls_key_share = r.tls_key_share
    if f.quic_version or f.quic_seen_long_hdr or f.quic_seen_short_hdr:
        pb.quic = pbflow.Quic(version=f.quic_version,
                              seen_long_hdr=int(f.quic_seen_long_hdr),
                              seen_short_hdr=int(f.quic_seen_short_hdr))
    return pb


def _ns(msg) -> int:
    return 0 if msg is None else msg.ToNanoseconds()


def pb_to_record(pb: pbflow.Record) -> Record:
    """`pb_to_record` (`pb_convert.py:108-152`); an absent sub-message
    reads as its defaults, as protobuf's default instance does."""
    network = pb.network or pbflow.Network()
    transport = pb.transport or pbflow.Transport()
    data_link = pb.data_link or pbflow.DataLink()
    quic = pb.quic or pbflow.Quic()
    key = FlowKey(
        src_ip=_get_ip(network.src_addr), dst_ip=_get_ip(network.dst_addr),
        src_port=transport.src_port, dst_port=transport.dst_port,
        proto=transport.protocol,
        icmp_type=pb.icmp_type, icmp_code=pb.icmp_code)
    f = FlowFeatures(
        dns_id=pb.dns_id, dns_flags=pb.dns_flags,
        dns_latency_ns=_ns(pb.dns_latency),
        dns_errno=pb.dns_errno, dns_name=pb.dns_name,
        drop_bytes=pb.pkt_drop_bytes, drop_packets=pb.pkt_drop_packets,
        drop_latest_flags=pb.pkt_drop_latest_flags,
        drop_latest_state=pb.pkt_drop_latest_state,
        drop_latest_cause=pb.pkt_drop_latest_drop_cause,
        rtt_ns=_ns(pb.time_flow_rtt),
        ipsec_encrypted=bool(pb.ipsec_encrypted),
        ipsec_encrypted_ret=pb.ipsec_encrypted_ret,
        quic_version=quic.version,
        quic_seen_long_hdr=bool(quic.seen_long_hdr),
        quic_seen_short_hdr=bool(quic.seen_short_hdr))
    if pb.xlat is not None:
        f.xlat_src_ip = _get_ip(pb.xlat.src_addr)
        f.xlat_dst_ip = _get_ip(pb.xlat.dst_addr)
        f.xlat_src_port = pb.xlat.src_port
        f.xlat_dst_port = pb.xlat.dst_port
        f.xlat_zone_id = pb.xlat.zone_id
    agent_ip = ""
    if pb.agent_ip is not None:
        agent_ip = ip_from_16(_get_ip(pb.agent_ip))
    return Record(
        key=key, bytes_=pb.bytes, packets=pb.packets,
        eth_protocol=pb.eth_protocol, tcp_flags=pb.flags,
        direction=int(pb.direction),
        src_mac=_u64_to_mac(data_link.src_mac),
        dst_mac=_u64_to_mac(data_link.dst_mac),
        interface=pb.interface,
        dscp=network.dscp, sampling=pb.sampling,
        time_flow_start_ns=_ns(pb.time_flow_start),
        time_flow_end_ns=_ns(pb.time_flow_end),
        agent_ip=agent_ip,
        dup_list=[(d.interface, int(d.direction), d.udn)
                  for d in pb.dup_list],
        features=f,
        ssl_version=pb.ssl_version, ssl_mismatch=pb.ssl_mismatch,
        tls_types=pb.tls_types, tls_cipher_suite=pb.tls_cipher_suite,
        tls_key_share=pb.tls_key_share)


def records_to_pb(records: list[Record]) -> pbflow.Records:
    """`records_to_pb` (`pb_convert.py:155-158`)."""
    return pbflow.Records(entries=[record_to_pb(r) for r in records])
