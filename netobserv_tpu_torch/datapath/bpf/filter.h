/*
 * filter.h — LPM-trie flow filtering.
 *
 * Semantics (reference-behavior analog: bpf/flows_filter.h): rules live in an
 * LPM trie keyed by CIDR; a packet is matched by source CIDR first, then by
 * destination CIDR; a matching rule's predicates (protocol, ports/ranges,
 * ICMP type/code, direction, TCP flags, drops-only) must all hold. A rule may
 * additionally require the peer address to fall in a second LPM trie
 * (peer_cidr_check), override sampling (sample_override), and ACCEPT or
 * REJECT the packet. Counters record accept/reject/no-match.
 */
#ifndef NO_FILTER_H
#define NO_FILTER_H

#include "config.h"
#include "helpers.h"
#include "maps.h"
#include "parse.h"

#define NO_FILTER_ACCEPT 0
#define NO_FILTER_REJECT 1
#define NO_DIR_ANY 255

NO_INLINE void no_count(__u32 key) {
    __u64 *val = bpf_map_lookup_elem(&global_counters, &key);
    if (val)
        no_atomic_add64(val, 1);
}

NO_INLINE int no_port_pred_ok(__u16 pkt_port, __u16 start, __u16 end,
                              __u16 p1, __u16 p2) {
    if (start || end) {
        if (pkt_port < start || pkt_port > end)
            return 0;
    }
    if (p1 || p2) {
        if (pkt_port != p1 && pkt_port != p2)
            return 0;
    }
    return 1;
}

NO_INLINE int no_rule_matches(const struct no_filter_rule *rule,
                              const struct no_pkt *pkt, __u8 direction,
                              __u8 is_drop_path) {
    const struct no_flow_key *k = &pkt->key;
    if (rule->proto && rule->proto != k->proto)
        return 0;
    if (rule->direction != NO_DIR_ANY && rule->direction != direction)
        return 0;
    if (!no_port_pred_ok(k->dst_port, rule->dport_start, rule->dport_end,
                         rule->dport1, rule->dport2))
        return 0;
    if (!no_port_pred_ok(k->src_port, rule->sport_start, rule->sport_end,
                         rule->sport1, rule->sport2))
        return 0;
    /* either-direction port predicate */
    if (rule->port_start || rule->port_end) {
        if (!((k->src_port >= rule->port_start &&
               k->src_port <= rule->port_end) ||
              (k->dst_port >= rule->port_start &&
               k->dst_port <= rule->port_end)))
            return 0;
    }
    if (rule->port1 || rule->port2) {
        if (k->src_port != rule->port1 && k->src_port != rule->port2 &&
            k->dst_port != rule->port1 && k->dst_port != rule->port2)
            return 0;
    }
    if (rule->icmp_type && rule->icmp_type != k->icmp_type)
        return 0;
    if (rule->icmp_code && rule->icmp_code != k->icmp_code)
        return 0;
    if (rule->tcp_flags && (pkt->tcp_flags & rule->tcp_flags) == 0)
        return 0;
    if (rule->want_drops && !is_drop_path)
        return 0;
    return 1;
}

NO_INLINE int no_peer_in_cidr(const __u8 *peer_ip) {
    struct no_filter_key key;
    key.prefix_len = 128;
    __builtin_memcpy(key.ip, peer_ip, NO_IP_LEN);
    return bpf_map_lookup_elem(&filter_peers, &key) != 0;
}

/* one side's evaluation: -1 = no usable match (caller may retry other side),
 * 0 = reject, 1 = accept */
NO_INLINE int no_filter_try(const struct no_pkt *pkt, const __u8 *keyed_ip,
                            const __u8 *peer_ip, __u8 direction,
                            __u8 is_drop_path, __u32 *sampling_out) {
    struct no_filter_key lkey;
    lkey.prefix_len = 128;
    __builtin_memcpy(lkey.ip, keyed_ip, NO_IP_LEN);
    const struct no_filter_rule *rule =
        bpf_map_lookup_elem(&filter_rules, &lkey);
    if (!rule)
        return -1;
    if (!no_rule_matches(rule, pkt, direction, is_drop_path))
        return -1;
    if (rule->peer_cidr_check && !no_peer_in_cidr(peer_ip))
        return -1;
    if (rule->action == NO_FILTER_REJECT) {
        no_count(NO_CTR_FILTER_REJECT);
        return 0;
    }
    if (rule->sample_override && sampling_out)
        *sampling_out = rule->sample_override;
    no_count(NO_CTR_FILTER_ACCEPT);
    return 1;
}

/*
 * Returns 1 = keep the packet, 0 = drop it from flow tracking.
 * `*sampling_out` is set when a matching rule overrides sampling.
 */
NO_INLINE int no_flow_filter(const struct no_pkt *pkt, __u8 direction,
                             __u8 is_drop_path, __u32 *sampling_out) {
    if (!cfg_enable_flow_filtering)
        return 1;

    /* source CIDR first; if the src-side rule exists but its full evaluation
     * (predicates + peer check) doesn't match, retry with the dst CIDR —
     * same fallback order as the parity target (flows_filter.h:251) */
    int verdict = no_filter_try(pkt, pkt->key.src_ip, pkt->key.dst_ip,
                                direction, is_drop_path, sampling_out);
    if (verdict < 0)
        verdict = no_filter_try(pkt, pkt->key.dst_ip, pkt->key.src_ip,
                                direction, is_drop_path, sampling_out);
    if (verdict < 0) {
        no_count(NO_CTR_FILTER_NOMATCH);
        return 0; /* rules configured but none matched -> not interesting */
    }
    return verdict;
}

#endif /* NO_FILTER_H */
