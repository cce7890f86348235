"""The port's flow-filter compiler (netobserv_tpu_torch/datapath/
filter_compile.py) against the JAX package's, on the CPU.

- `compile_rule` and `compile_filters` byte for byte (every LPM key, rule
  value and peer key) on the rules of the reference's
  `tests/test_filter_compile.py` and a few more, each rule parsed by its
  own package's `config.parse_filter_rules`.
- Every rejection of the reference suite raises `ValueError` in both, with
  the same message.
- The filter layouts of the port's `model/binfmt` equal the reference's
  and decode the port's output as the reference suite decodes its own.

Tolerance: none; every comparison is of bytes or of messages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from netobserv_tpu import config as jcfg
from netobserv_tpu.datapath import filter_compile as jfc
from netobserv_tpu.model import binfmt as jbin
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.datapath import filter_compile as tfc
from netobserv_tpu_torch.model import binfmt as tbin

RULE_SETS = {
    "basic": '[{"ip_cidr":"10.0.0.0/8","action":"Reject","protocol":"TCP",'
             '"destination_port":443,"sample":10,"direction":"Ingress"}]',
    "ranges": '[{"ip_cidr":"10.0.0.0/8","source_port_range":"100-200",'
              '"destination_ports":"53,5353"}]',
    "either_ports": '[{"ip_cidr":"0.0.0.0/0","port_range":"8000-9000"}]',
    "v6_peer_flags": '[{"ip_cidr":"2001:db8::/32","peer_cidr":"10.1.0.0/16",'
                     '"tcp_flags":"SYN-ACK"}]',
    "peer_ip": '[{"ip_cidr":"0.0.0.0/0","peer_ip":"10.9.9.9"}]',
    "drops": '[{"ip_cidr":"0.0.0.0/0","drops":true}]',
    "icmp": '[{"ip_cidr":"192.168.0.0/16","protocol":"ICMP","icmp_type":8,'
            '"icmp_code":0,"direction":"Egress"}]',
    "icmpv6_ports_list": '[{"ip_cidr":"fd00::/8","protocol":"ICMPv6"},'
                         '{"ip_cidr":"10.2.0.0/16","protocol":"UDP",'
                         '"ports":"53,123","source_port":1000}]',
    "two_with_peers": '[{"ip_cidr":"10.0.0.0/8","action":"Accept",'
                      '"protocol":"TCP"},{"ip_cidr":"10.1.1.1/32",'
                      '"action":"Reject","peer_cidr":"192.168.0.0/16"}]',
    "flags_each": '[{"ip_cidr":"10.3.0.0/16","tcp_flags":"SYN"},'
                  '{"ip_cidr":"10.4.0.0/16","tcp_flags":"FIN-ACK"},'
                  '{"ip_cidr":"10.5.0.0/16","tcp_flags":"RST"}]',
    "sctp_sampled": '[{"ip_cidr":"172.16.0.0/12","protocol":"SCTP",'
                    '"destination_port_range":"1-65535","sample":3}]',
}

#: the reference suite's rejections (`tests/test_filter_compile.py:81-109`)
BAD_RULES = [
    {"ip_cidr": "10.0.0.0/8", "protocol": "CARRIER_PIGEON"},
    {"ip_cidr": "10.0.0.0/8", "port_range": "90-10"},
    {"ip_cidr": "10.0.0.0/8", "port": 1, "port_range": "1-2"},
    {"ip_cidr": "10.0.0.0/8", "tcp_flags": "WAT"},
    {"ip_cidr": "0.0.0.0/0", "destination_port": 70000},
    {"ip_cidr": "0.0.0.0/0", "ports": "53,70000"},
    {"ip_cidr": "0.0.0.0/0", "port_range": "1-70000"},
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


def _as_tuple(compiled):
    return (tuple(compiled.rules), tuple(compiled.peers))


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_compile_filters_byte_for_byte(name):
    text = RULE_SETS[name]
    ref = jfc.compile_filters(jcfg.parse_filter_rules(text))
    got = tfc.compile_filters(tcfg.parse_filter_rules(text))
    assert _as_tuple(got) == _as_tuple(ref)
    assert len(got.rules) == len(tcfg.parse_filter_rules(text))


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_compile_rule_byte_for_byte(name):
    for jr, tr in zip(jcfg.parse_filter_rules(RULE_SETS[name]),
                      tcfg.parse_filter_rules(RULE_SETS[name])):
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        assert tfc.compile_rule(tr) == jfc.compile_rule(jr)


@pytest.mark.parametrize("kwargs", BAD_RULES,
                         ids=[f"bad{i}" for i in range(len(BAD_RULES))])
def test_rejections_match(kwargs):
    ref = _outcome(jfc.compile_rule, jcfg.FlowFilterRule(**kwargs))
    got = _outcome(tfc.compile_rule, tcfg.FlowFilterRule(**kwargs))
    assert ref[0] == "ValueError"
    assert got == ref


def test_duplicate_prefix_and_too_many_rules_rejected_alike():
    dup = [{"ip_cidr": "10.0.0.0/8"},
           {"ip_cidr": "10.0.0.0/8", "action": "Reject"}]
    ref = _outcome(jfc.compile_filters,
                   [jcfg.FlowFilterRule(**d) for d in dup])
    got = _outcome(tfc.compile_filters,
                   [tcfg.FlowFilterRule(**d) for d in dup])
    assert ref[0] == "ValueError" and got == ref
    assert tfc.MAX_FILTER_RULES == jfc.MAX_FILTER_RULES
    many = [{"ip_cidr": f"10.{i}.0.0/16"}
            for i in range(tfc.MAX_FILTER_RULES + 1)]
    ref = _outcome(jfc.compile_filters,
                   [jcfg.FlowFilterRule(**d) for d in many])
    got = _outcome(tfc.compile_filters,
                   [tcfg.FlowFilterRule(**d) for d in many])
    assert ref[0] == "ValueError" and got == ref


def test_layouts_and_sizes_match_the_reference():
    for name in ("FILTER_KEY_DTYPE", "FILTER_RULE_DTYPE",
                 "PACKET_EVENT_DTYPE", "SSL_EVENT_DTYPE"):
        assert getattr(tbin, name) == getattr(jbin, name), name
    assert tbin.MAX_PAYLOAD_SIZE == jbin.MAX_PAYLOAD_SIZE
    assert tbin.MAX_SSL_DATA == jbin.MAX_SSL_DATA
    assert tfc.FILTER_KEY_SIZE == jfc.FILTER_KEY_SIZE == 20
    assert tfc.FILTER_RULE_SIZE == jfc.FILTER_RULE_SIZE == 40
    from netobserv_tpu.model import packet_record as jpr
    from netobserv_tpu_torch.model import packet_record as tpr
    assert tpr.PCAP_SNAP_LEN == tbin.MAX_PAYLOAD_SIZE
    assert tpr.pcap_file_header() == jpr.pcap_file_header()


def test_basic_rule_decodes_as_the_reference_suite_reads_it():
    """The reference suite's field checks (`tests/test_filter_compile.py:
    20-35`) on the port's output, decoded with the port's layouts."""
    out = tfc.compile_filters(tcfg.parse_filter_rules(RULE_SETS["basic"]))
    key = np.frombuffer(out.rules[0][0], dtype=tbin.FILTER_KEY_DTYPE)[0]
    assert int(key["prefix_len"]) == 96 + 8
    assert bytes(key["ip"])[10:12] == b"\xff\xff"
    rule = np.frombuffer(out.rules[0][1], dtype=tbin.FILTER_RULE_DTYPE)[0]
    assert (int(rule["proto"]), int(rule["action"]),
            int(rule["direction"])) == (6, 1, 0)
    assert int(rule["dport1"]) == 443 and int(rule["dport2"]) == 443
    assert int(rule["sample_override"]) == 10
