/*
 * maps.h — all datapath maps.
 *
 * The reference's 17-map surface (bpf/maps_definition.h) plus `sampling_gate`
 * (this design's per-CPU replacement for the reference's `do_sampling` .bss
 * global), declared in this project's style. Sizes marked "resized at load" are declared at their
 * maximum; the loader shrinks them according to enabled features and
 * CACHE_MAX_FLOWS before load (the reference does the same,
 * pkg/tracer/tracer.go:117-135). All maps are pinned by name so an external
 * lifecycle manager (bpfman mode) can own them across agent restarts.
 */
#ifndef NO_MAPS_H
#define NO_MAPS_H

#include "helpers.h"
#include "records.h"
#include "config.h" /* no_do_sampling() reads cfg_has_sampling/cfg_sampling */

#define NO_PIN_BY_NAME 1

/* filter key/rule structs live in records.h (userspace writes them) */

/* DNS query/response correlation key */
struct no_dns_corr_key {
    __u16 src_port;
    __u16 dst_port;
    __u8 src_ip[NO_IP_LEN];
    __u8 dst_ip[NO_IP_LEN];
    __u16 dns_id;
    __u8 proto;
    __u8 _pad;
};

/* scratch buffer for DNS name copies (dodges the 512B stack limit) */
struct no_dns_name_scratch {
    char name[NO_DNS_NAME_MAX_LEN];
};

#define DEF_MAP(_name, _type, _key, _value, _max)                              \
    struct {                                                                   \
        __uint(type, _type);                                                   \
        __type(key, _key);                                                     \
        __type(value, _value);                                                 \
        __uint(max_entries, _max);                                             \
        __uint(pinning, NO_PIN_BY_NAME);                                       \
    } _name SEC(".maps")

#define DEF_RINGBUF(_name, _size)                                              \
    struct {                                                                   \
        __uint(type, BPF_MAP_TYPE_RINGBUF);                                    \
        __uint(max_entries, _size);                                            \
        __uint(pinning, NO_PIN_BY_NAME);                                       \
    } _name SEC(".maps")

/* main aggregation map: shared HASH with per-entry spin lock (resized) */
DEF_MAP(aggregated_flows, BPF_MAP_TYPE_HASH, struct no_flow_key,
        struct no_flow_stats, 1 << 24);

/* map-full fallback ring buffer (flow events pushed to userspace) */
DEF_RINGBUF(direct_flows, 1 << 24);

/* per-feature per-CPU partial maps, merged by userspace at eviction */
DEF_MAP(flows_dns, BPF_MAP_TYPE_PERCPU_HASH, struct no_flow_key,
        struct no_dns_rec, 1 << 24);
DEF_MAP(flows_drops, BPF_MAP_TYPE_PERCPU_HASH, struct no_flow_key,
        struct no_drops_rec, 1 << 24);
DEF_MAP(flows_nevents, BPF_MAP_TYPE_PERCPU_HASH, struct no_flow_key,
        struct no_nevents_rec, 1 << 24);
DEF_MAP(flows_xlat, BPF_MAP_TYPE_PERCPU_HASH, struct no_flow_key,
        struct no_xlat_rec, 1 << 24);
DEF_MAP(flows_extra, BPF_MAP_TYPE_PERCPU_HASH, struct no_flow_key,
        struct no_extra_rec, 1 << 24);
DEF_MAP(flows_quic, BPF_MAP_TYPE_PERCPU_HASH, struct no_flow_key,
        struct no_quic_rec, 1 << 24);

/* PCA captured packets */
DEF_RINGBUF(packet_records, 1 << 21);

/* DNS query->response correlation (latency measurement) */
DEF_MAP(dns_inflight, BPF_MAP_TYPE_HASH, struct no_dns_corr_key, __u64,
        1 << 20);

/* per-CPU scratch for DNS name copy */
DEF_MAP(dns_scratch, BPF_MAP_TYPE_PERCPU_ARRAY, __u32,
        struct no_dns_name_scratch, 1);

/* datapath global counters, scraped+reset each eviction */
DEF_MAP(global_counters, BPF_MAP_TYPE_PERCPU_ARRAY, __u32, __u64,
        NO_COUNTER_MAX);

/* LPM filter tries: primary CIDR and peer CIDR */
DEF_MAP(filter_rules, BPF_MAP_TYPE_LPM_TRIE, struct no_filter_key,
        struct no_filter_rule, 16);
DEF_MAP(filter_peers, BPF_MAP_TYPE_LPM_TRIE, struct no_filter_key, __u8, 16);

/* IPsec xfrm correlation: pid_tgid -> flow key between entry/return probes */
DEF_MAP(ipsec_ingress_inflight, BPF_MAP_TYPE_HASH, __u64, struct no_flow_key,
        1 << 12);
DEF_MAP(ipsec_egress_inflight, BPF_MAP_TYPE_HASH, __u64, struct no_flow_key,
        1 << 12);

/* OpenSSL uprobe plaintext events (sized for 16KB * 1000/s * 5s window) */
DEF_RINGBUF(ssl_events, 1 << 27);

/* per-CPU record of the TC path's most recent sampling decision; the aux
 * hooks (rtt/drops/nevents/xlat/ipsec) gate on it so per-flow features are
 * only collected for sampled flows (reference: `static u8 do_sampling`,
 * bpf/utils.h:9 — a per-CPU map instead of a .bss global avoids that
 * global's cross-CPU races and loads through raw bpf(2) without .bss
 * relocation support) */
DEF_MAP(sampling_gate, BPF_MAP_TYPE_PERCPU_ARRAY, __u32, __u8, 1);

NO_INLINE void no_set_do_sampling(__u8 v) {
    __u32 k = 0;
    __u8 *g = bpf_map_lookup_elem(&sampling_gate, &k);
    if (g)
        *g = v;
}

NO_INLINE __u8 no_do_sampling(void) {
    /* sampling disabled: every packet is sampled — short-circuit so aux
     * hooks on CPUs the TC path never ran on (RPS steering, cold start)
     * are not suppressed by the zero-initialised gate; the verifier prunes
     * this to a constant (volatile const) */
    if (!cfg_has_sampling && cfg_sampling <= 1)
        return 1;
    __u32 k = 0;
    __u8 *g = bpf_map_lookup_elem(&sampling_gate, &k);
    return g ? *g : 0;
}

#endif /* NO_MAPS_H */
