"""The adversarial traffic scenario zoo: nine deterministic generators,
each producing a pcap plus machine-checkable ground truth.

A copy of `netobserv_tpu/scenarios/zoo.py` (lines 1-477): the scenarios
write their pcaps through the port's `scenarios/synth.py`, byte for byte
the reference's, and `SIGNALS` comes from the port's
`alerts/rules.SIGNAL_FIELDS`. Every scenario is graded end to end through
the agent's `/query/*` routes (`scenarios/runner.py`): pcap -> datapath
replay -> columnar feed -> device sketch fold -> window roll -> query
snapshot -> HTTP. The truth dict states which alarms must FIRE, which
must stay QUIET, the exact heavy-hitter set and distinct-source count,
and (where relevant) DNS-latency / QUIC expectations: detection quality,
not throughput.

Scale note: flow volumes ride "jumbo" claimed IP lengths (synth.py), so a
megabyte elephant costs one small frame; packet counts stay in the low
thousands per scenario and the whole zoo replays in seconds.
"""

from __future__ import annotations

from netobserv_tpu_torch.scenarios.synth import (
    PcapBuilder, canonical_ip, dns_query, dns_response, heavy_entry,
    quic_long_header, tcp, udp,
)

SYN, SYNACK, ACK, PSHACK = 0x02, 0x12, 0x10, 0x18

#: every victim-signal key of /query/victims — scenarios pick their
#: expected/quiet subsets from this. Derived from the alerting plane's
#: SIGNAL_FIELDS (the ONE signal-name map: zoo grading, /query/victims
#: and the default alert rules can never drift apart)
from netobserv_tpu_torch.alerts.rules import SIGNAL_FIELDS  # noqa: E402

SIGNALS = tuple(SIGNAL_FIELDS)


def _benign_background(b: PcapBuilder, at_us: int = 0) -> dict:
    """Four full TCP connections (handshake + bidirectional data) — the
    healthy traffic every scenario carries so "quiet" alarms are asserted
    against realistic flows, not silence. ~10% byte backflow keeps the
    asymmetric-conversation signal quiet (a healthy transfer's ACK/response
    stream). Returns its ground-truth contribution."""
    server = "10.0.2.1"
    srcs = []
    for c in range(4):
        client = f"10.0.1.{c + 1}"
        srcs.append(client)
        sport, t = 40000 + c, at_us + c * 400
        b.add(t, client, server, 6, tcp(sport, 443, SYN),
              sport=sport, dport=443)
        b.add(t + 50, server, client, 6, tcp(443, sport, SYNACK),
              sport=443, dport=sport)
        b.add(t + 90, client, server, 6, tcp(sport, 443, ACK),
              sport=sport, dport=443)
        for i in range(3):
            b.add(t + 150 + i * 40, client, server, 6,
                  tcp(sport, 443, PSHACK), claim_len=30_000,
                  sport=sport, dport=443)
            b.add(t + 170 + i * 40, server, client, 6,
                  tcp(443, sport, PSHACK), claim_len=3_000,
                  sport=443, dport=sport)
    srcs.append(server)  # the server's response flows make it a source too
    return {"distinct_srcs": srcs}


def build_syn_flood(path: str) -> dict:
    """Spoofed SYN flood: 400 sources, one victim, zero SYN-ACKs. The
    offered:accepted flood ratio must fire and name the victim; the scan
    and asymmetry signals must stay quiet (one tiny probe per source)."""
    b = PcapBuilder()
    bg = _benign_background(b)
    victim = "10.0.0.80"
    for i in range(400):
        src = f"172.16.{i % 200}.{i // 200 + 1}"
        b.add(2000 + i * 50, src, victim, 6, tcp(2000 + i, 80, SYN),
              sport=2000 + i, dport=80)
    b.write(path)
    return {
        "name": "syn_flood",
        "expect_alarms": ["syn_flood"],
        "quiet_alarms": ["port_scan", "asym_conv", "drop_storm"],
        "victim": victim,
        "victim_signal": "syn_flood",
        "distinct_src": 400 + len(bg["distinct_srcs"]),
        "distinct_tol": 0.15,
        "min_records": 400,
    }


def build_dns_flood(path: str) -> dict:
    """DNS query flood against one resolver, with the latency collapse a
    real flood causes: legitimate clients' answers come back 120ms late
    (all answered — the latency histogram sees the spike), the flood's
    fat ANY-style queries are never answered (pure one-way mass — the
    UDP-flood/asymmetry signal). SYN-flood and scan signals stay quiet."""
    b = PcapBuilder()
    server = "10.0.0.53"
    tx = 1
    # legitimate lookups, answered late (the spike)
    legit = 20
    for c in range(legit):
        client = f"10.0.3.{c + 1}"
        for q in range(2):
            sport, t = 33000 + c, c * 900 + q * 300
            b.add(t, client, server, 17,
                  udp(sport, 53, dns_query(tx)), sport=sport, dport=53)
            b.add(t + 120_000, server, client, 17,
                  udp(53, sport, dns_response(tx)), sport=53, dport=sport)
            tx += 1
    # the flood: 160 spoofed sources x 12 fat queries, never answered
    flood = 160
    for i in range(flood):
        src = f"172.20.{i % 160}.{i // 160 + 1}"
        sport = 1500 + i
        for q in range(12):
            b.add(40_000 + i * 120 + q * 7, src, server, 17,
                  udp(sport, 53, dns_query(tx, pad=288)),
                  sport=sport, dport=53)
            tx += 1
    b.write(path)
    return {
        "name": "dns_flood",
        "expect_alarms": ["asym_conv"],
        "quiet_alarms": ["syn_flood", "port_scan"],
        "dns_p50_min_us": 50_000,
        "distinct_src": flood + legit + 1,  # + the resolver's responses
        "distinct_tol": 0.15,
        "min_records": flood + legit,
    }


def build_port_scan(path: str) -> dict:
    """One scanner sweeping 800 distinct (address, port) targets with lone
    SYNs. The per-source fan-out grid must flag the scanner; the SYN-flood
    signal must stay quiet — no single victim accumulates attempts."""
    b = PcapBuilder()
    bg = _benign_background(b)
    scanner = "10.0.9.9"
    targets = 800
    for i in range(targets):
        dst = f"198.18.{i // 250}.{i % 250 + 1}"
        b.add(3000 + i * 30, scanner, dst, 6,
              tcp(55555, 1000 + i, SYN), sport=55555, dport=1000 + i)
    b.write(path)
    return {
        "name": "port_scan",
        "expect_alarms": ["port_scan"],
        "quiet_alarms": ["syn_flood", "asym_conv", "drop_storm"],
        "distinct_src": 1 + len(bg["distinct_srcs"]),
        "distinct_tol": 0.3,
        "min_records": targets,
    }


def build_elephant_mice(path: str) -> dict:
    """16 elephant transfers over 2000 mice: the heavy-hitter table must
    recall >= 0.9 of the elephants in its top 16, the CM frequency route
    must answer within its stated error bar, and every alarm stays quiet
    (elephants carry healthy ~9% backflow; mice are tiny)."""
    b = PcapBuilder()
    server, mice_sink = "10.0.6.1", "10.0.6.2"
    heavy = []
    for e in range(16):
        client, sport = f"10.0.5.{e + 1}", 50000 + e
        t = e * 700
        b.add(t, client, server, 6, tcp(sport, 443, SYN),
              sport=sport, dport=443)
        b.add(t + 40, server, client, 6, tcp(443, sport, SYNACK),
              sport=443, dport=sport)
        b.add(t + 80, client, server, 6, tcp(sport, 443, ACK),
              sport=sport, dport=443)
        for i in range(20):
            b.add(t + 120 + i * 25, client, server, 6,
                  tcp(sport, 443, PSHACK), claim_len=60_000,
                  sport=sport, dport=443)
        for i in range(4):
            b.add(t + 140 + i * 120, server, client, 6,
                  tcp(443, sport, PSHACK), claim_len=30_000,
                  sport=443, dport=sport)
        heavy.append(heavy_entry(client, server, sport, 443, 6))
    mice_srcs = 500
    for m in range(mice_srcs):
        src = f"10.1.{m % 200}.{m // 200 + 1}"
        for f in range(4):
            b.add(12_000 + m * 60 + f * 9, src, mice_sink, 17,
                  udp(20000 + f, 8080, b"\x00" * 172),
                  sport=20000 + f, dport=8080)
    probe = heavy[0]
    b.write(path)
    return {
        "name": "elephant_mice",
        "heavy": heavy,
        "topk_n": 16,
        "min_recall": 0.9,
        "quiet_alarms": list(SIGNALS),
        "frequency_probe": {
            **probe,
            "true_bytes": b.flow_bytes[(probe["SrcAddr"], probe["DstAddr"],
                                        probe["SrcPort"], probe["DstPort"],
                                        6)]},
        "distinct_src": 16 + mice_srcs + 1,  # + the elephant server
        "distinct_tol": 0.1,
        "min_records": 16 + 4 * mice_srcs,
    }


def build_nat_churn(path: str) -> dict:
    """One NAT'd address churning through 600 source ports of short,
    COMPLETE connections. The discriminator scenario: 600 SYNs hit one server
    — but every one is answered, so the flood ratio stays quiet; 600 flows
    to one (addr, port) pair is fan-out 1 — the scan grid stays quiet; and
    the distinct-source estimate must stay ~2, not 600 (churn is ports,
    not hosts)."""
    b = PcapBuilder()
    nat, server = "203.0.113.7", "10.0.7.1"
    flows = 600
    for i in range(flows):
        sport, t = 20000 + i, i * 150
        b.add(t, nat, server, 6, tcp(sport, 443, SYN),
              sport=sport, dport=443)
        b.add(t + 30, server, nat, 6, tcp(443, sport, SYNACK),
              sport=443, dport=sport)
        b.add(t + 60, nat, server, 6, tcp(sport, 443, PSHACK),
              claim_len=2_000, sport=sport, dport=443)
        b.add(t + 90, server, nat, 6, tcp(443, sport, PSHACK),
              claim_len=1_500, sport=443, dport=sport)
    b.write(path)
    return {
        "name": "nat_churn",
        "quiet_alarms": list(SIGNALS),
        "distinct_src": 2,
        "distinct_tol": 0.5,
        "min_records": 2 * flows,
    }


def build_quic_heavy(path: str) -> dict:
    """QUIC-dominant mix: 12 long-header UDP/443 elephants over small
    web-ish mice. The datapath's QUIC marker must surface in the window's
    QuicRecords, the elephants must chart, and nothing alarms — heavy
    encrypted UDP is a workload, not an attack."""
    b = PcapBuilder()
    server = "10.0.9.1"
    heavy = []
    for e in range(12):
        client, sport = f"10.0.8.{e + 1}", 44000 + e
        t = e * 600
        for i in range(10):
            b.add(t + i * 40, client, server, 17,
                  udp(sport, 443, quic_long_header()), claim_len=30_000,
                  sport=sport, dport=443)
        for i in range(4):
            b.add(t + 60 + i * 90, server, client, 17,
                  udp(443, sport, quic_long_header()), claim_len=15_000,
                  sport=443, dport=sport)
        heavy.append(heavy_entry(client, server, sport, 443, 17))
    mice_srcs = 100
    for m in range(mice_srcs):
        src = f"10.2.{m % 100}.{m // 100 + 1}"
        for f in range(2):
            b.add(9_000 + m * 70 + f * 11, src, "10.0.9.2", 17,
                  udp(21000 + f, 8080, b"\x00" * 150),
                  sport=21000 + f, dport=8080)
    b.write(path)
    return {
        "name": "quic_heavy",
        "heavy": heavy,
        "topk_n": 12,
        "min_recall": 0.9,
        "quiet_alarms": list(SIGNALS),
        "quic_min_records": 12,
        "distinct_src": 12 + mice_srcs + 1,
        "distinct_tol": 0.15,
        "min_records": 12 + 2 * mice_srcs,
    }


def build_ipv6_heavy(path: str) -> dict:
    """IPv6-dominant mixed traffic (ROADMAP "richer workloads"): ten v6
    elephants with healthy ~9% backflow over v6 AND v4 mice plus the v4
    benign background. Nothing alarms — heavy v6 volume is a workload,
    not an attack — while the top-K must chart the v6 elephants (exact
    16-byte keys through the whole plane) and the distinct-source
    estimate must count v6 sources. Plumbing pin: the resident feed's hot
    rows are slot-id based and KEY-AGNOSTIC — v6 keys ride the full-width
    new-key lane like any other — so a v6-heavy mix must produce ZERO
    dense fallbacks (`sketch_dense_fallback_total`); only the compact
    feed degrades on v6 (its documented spill-overflow behavior). The
    runner reports the spill/fallback counters so the artifact shows the
    v6 plumbing, and grades the fallback count at 0."""
    b = PcapBuilder()
    bg = _benign_background(b)
    server = "2001:db8::10"
    heavy = []
    for e in range(10):
        client = f"2001:db8:0:1::{e + 1:x}"
        sport, t = 46000 + e, 2000 + e * 600
        b.add(t, client, server, 6, tcp(sport, 443, SYN),
              sport=sport, dport=443)
        b.add(t + 40, server, client, 6, tcp(443, sport, SYNACK),
              sport=443, dport=sport)
        b.add(t + 80, client, server, 6, tcp(sport, 443, ACK),
              sport=sport, dport=443)
        for i in range(18):
            b.add(t + 120 + i * 30, client, server, 6,
                  tcp(sport, 443, PSHACK), claim_len=50_000,
                  sport=sport, dport=443)
        for i in range(4):
            b.add(t + 140 + i * 110, server, client, 6,
                  tcp(443, sport, PSHACK), claim_len=22_000,
                  sport=443, dport=sport)
        heavy.append(heavy_entry(canonical_ip(client), canonical_ip(server),
                                 sport, 443, 6))
    mice6, sink6 = 180, "2001:db8::20"
    for m in range(mice6):
        src = f"2001:db8:aa::{m + 1:x}"
        for f in range(2):
            b.add(15_000 + m * 55 + f * 9, src, sink6, 17,
                  udp(23000 + f, 8080, b"\x00" * 160),
                  sport=23000 + f, dport=8080)
    mice4 = 60  # the mix stays honestly MIXED: the v4 hot-row path stays hot
    for m in range(mice4):
        src = f"10.3.{m % 60}.{m // 60 + 1}"
        b.add(28_000 + m * 40, src, "10.0.6.9", 17,
              udp(24000, 8080, b"\x00" * 150), sport=24000, dport=8080)
    b.write(path)
    return {
        "name": "ipv6_heavy",
        "heavy": heavy,
        "topk_n": 16,
        "min_recall": 0.9,
        "quiet_alarms": list(SIGNALS),
        # 10 elephant clients + their server's responder flows + v6/v4
        # mice + the benign background's sources
        "distinct_src": 10 + 1 + mice6 + mice4 + len(bg["distinct_srcs"]),
        "distinct_tol": 0.15,
        "min_records": 10 + 2 * mice6 + mice4,
        # the resident feed must NEVER wholesale-degrade on v6 traffic
        # (hot rows are key-agnostic; spill volume is cold-start/new-key
        # geometry, deployment-shape dependent, so it is reported but not
        # pinned)
        "max_dense_fallbacks": 0,
    }


def build_overlay_syn_scan(path: str) -> dict:
    """Mixed-attack OVERLAY (the ROADMAP leftover): a spoofed SYN flood
    AND an independent port scan run simultaneously in one pcap. BOTH
    alarms must fire with correct victim attribution — the flood names
    its victim, the scan grid flags the scanner's fan-out — while the
    dns/drop/asymmetry signals stay quiet (no cross-talk: the scanner's
    800 one-SYN targets must not read as flood victims, the flood's 400
    one-probe sources must not read as scanners), all under the zoo's ONE
    shared threshold set."""
    b = PcapBuilder()
    bg = _benign_background(b)
    victim = "10.0.0.80"
    flood_srcs = 400
    for i in range(flood_srcs):
        src = f"172.16.{i % 200}.{i // 200 + 1}"
        b.add(2000 + i * 50, src, victim, 6, tcp(2000 + i, 80, SYN),
              sport=2000 + i, dport=80)
    scanner = "10.0.9.9"
    targets = 800
    for i in range(targets):
        dst = f"198.18.{i // 250}.{i % 250 + 1}"
        # interleaved with the flood in time (a real mixed attack), still
        # inside the one 5s replay window
        b.add(2500 + i * 30, scanner, dst, 6,
              tcp(55555, 1000 + i, SYN), sport=55555, dport=1000 + i)
    b.write(path)
    return {
        "name": "overlay_syn_scan",
        "expect_alarms": ["syn_flood", "port_scan"],
        "quiet_alarms": ["asym_conv", "drop_storm"],
        "victim": victim,
        "victim_signal": "syn_flood",
        "distinct_src": flood_srcs + 1 + len(bg["distinct_srcs"]),
        "distinct_tol": 0.15,
        "min_records": flood_srcs + targets,
    }


def build_flow_ascent(path: str) -> dict:
    """A mouse flow ramping into an elephant MID-RUN — the persistent-slot
    churn scenario. One 5-tuple trickles ~600B per replay
    window through the first sketch window, then ramps to ~360KB per
    window; the slot table keeps the key's identity across the roll, so
    the window-over-window count:prev ratio explodes and the
    `flow_ascent` alert must RAISE — live, mid-window, with the exact key
    named — while `new_heavy_key` stays quiet (the key is NOT new: its
    slot's first_seen is window 0, which is exactly the new-vs-ascending
    discrimination the per-slot metadata buys). SYN/scan/drop/asym stay
    quiet (complete handshake, ~10%% backflow both phases); the DDoS
    z-signal is deliberately un-asserted — a 300x volume ramp to one
    destination is a legitimate surge either way.

    Timing contract with the runner: replay windows are 5s virtual and
    drain at ~0.25s wall each, so the phase boundary at virtual window 48
    lands ~12s wall — safely AFTER the 10s sketch-window roll the
    `runner` overrides configure (drains can lag but never lead, so the
    elephant phase can only land later, never before the roll; the mouse
    phase can only need window-0 mass, which the first drains deliver
    seconds before the roll)."""
    b = PcapBuilder()
    bg = _benign_background(b)
    client, server = "10.0.5.50", "10.0.6.1"
    sport = 51000
    # one replay window in virtual us. DELIBERATELY > the runner's 5s
    # replay window: the parser splits on a STRICT > 5s gap from each
    # window's first packet, so exactly-5s spacing would merge adjacent
    # windows pairwise and halve the drain count the phase timing needs
    W = 5_050_000
    mouse_w, total_w, mice = 48, 68, 3
    b.add(100, client, server, 6, tcp(sport, 443, SYN),
          sport=sport, dport=443)
    b.add(140, server, client, 6, tcp(443, sport, SYNACK),
          sport=443, dport=sport)
    b.add(180, client, server, 6, tcp(sport, 443, ACK),
          sport=sport, dport=443)
    # ONE time-ordered sweep: the pcap writer emits packets in call order
    # and the replay parser windows a monotone timestamp stream (real
    # captures are time-ordered) — interleaving per window keeps it so
    for w in range(total_w):
        if w < mouse_w:            # phase 1: the mouse (~600B/window)
            b.add(w * W + 500, client, server, 6, tcp(sport, 443, PSHACK),
                  claim_len=600, sport=sport, dport=443)
            # tiny response keeps the pair bucket two-way (~10% backflow)
            b.add(w * W + 700, server, client, 6, tcp(443, sport, PSHACK),
                  claim_len=64, sport=443, dport=sport)
        else:                      # phase 2: the elephant (~360KB/window)
            for i in range(12):
                b.add(w * W + 500 + i * 200, client, server, 6,
                      tcp(sport, 443, PSHACK), claim_len=30_000,
                      sport=sport, dport=443)
            b.add(w * W + 3200, server, client, 6, tcp(443, sport, PSHACK),
                  claim_len=36_000, sport=443, dport=sport)
        if w % 5 == 0:             # steady mice, sparse enough that their
            #                        one-way pair buckets stay under the
            #                        asym volume floor in every window
            for m in range(mice):
                b.add(w * W + 2000 + m * 50, f"10.1.9.{m + 1}", "10.0.6.2",
                      17, udp(22000 + m, 8080, b"\x00" * 160),
                      sport=22000 + m, dport=8080)
    b.write(path)
    key = heavy_entry(client, server, sport, 443, 6)
    return {
        "name": "flow_ascent",
        "expect_alarms": ["flow_ascent"],
        # ddos deliberately absent from BOTH lists (see docstring)
        "quiet_alarms": ["syn_flood", "port_scan", "drop_storm",
                         "asym_conv", "new_heavy_key"],
        "ascent_key": key,
        "heavy": [key],
        "topk_n": 4,
        "min_recall": 1.0,
        "distinct_src": 2 + mice + len(bg["distinct_srcs"]),
        "distinct_tol": 0.3,
        "min_records": 50,
        # multi-window runner shape: two ~10s sketch windows; detection
        # must land inside window 1 (the attack window) = sub-window
        # relative to the ramp, budgeted as 2 x window_s from replay start
        "runner": {"window_s": 10.0, "deadline_s": 120.0},
        "ttd_budget_s": 20.0,
    }


#: name -> build(path) -> truth; the runner, tests, and bench all
#: iterate this registry
SCENARIOS = {
    "syn_flood": build_syn_flood,
    "dns_flood": build_dns_flood,
    "port_scan": build_port_scan,
    "elephant_mice": build_elephant_mice,
    "nat_churn": build_nat_churn,
    "quic_heavy": build_quic_heavy,
    "ipv6_heavy": build_ipv6_heavy,
    "overlay_syn_scan": build_overlay_syn_scan,
    "flow_ascent": build_flow_ascent,
}
