/*
 * flowpath.c — the TC/TCX flow-aggregation datapath.
 *
 * One program per hook point (tc/tcx x ingress/egress) funnels into
 * no_flow_monitor(): sampling gate -> parse -> filter -> inline trackers
 * (DNS/TLS/QUIC) -> upsert into the `aggregated_flows` shared hash under a
 * per-entry spin lock, with multi-interface dedup bookkeeping; when the map
 * is full (or racing inserts fail), the whole event falls back to the
 * `direct_flows` ring buffer with the errno recorded.
 *
 * Behavioral parity target: bpf/flows.c in netobserv-ebpf-agent (flow_monitor,
 * update_existing_flow, the BPF_NOEXIST+EEXIST retry idiom, observed-interface
 * dedup). This is a fresh implementation in this project's layout/style.
 *
 * Build: clang -g -O2 -target bpf -DNO_BPF_BUILD -c flowpath.c
 * (see ../native/CMakeLists.txt, DATAPATH_BPF option).
 */
#include "helpers.h"
#include "records.h"
#include "config.h"
#include "maps.h"
#include "parse.h"
#include "filter.h"
#include "dns.h"
#include "tls.h"
#include "quic.h"
#include "pca.h"

char LICENSE[] SEC("license") = "GPL";

#define DIR_INGRESS 0
#define DIR_EGRESS 1

/* 1-in-N sampling gate; returns 1 when the packet should be processed */
NO_INLINE int no_sampled(__u32 sampling) {
    if (sampling <= 1)
        return 1;
    return bpf_get_prandom_u32() % sampling == 0;
}

/* merge one packet into an existing map entry (under its spin lock).
 * Returns 1 when the observed-interface array overflowed (counted by the
 * caller, outside the lock). */
NO_INLINE int no_update_flow(struct no_flow_stats *s,
                             const struct no_pkt *pkt, __u32 if_index,
                             __u8 direction, __u32 sampling,
                             const struct no_tls_meta *tls, __u32 len) {
    int overflow = 0;
    bpf_spin_lock(&s->lock);
    if (s->if_index_first == if_index) {
        /* count bytes/packets only from the first-seen interface, so a flow
         * crossing veth+bridge+phys is not double-counted (reference:
         * update_existing_flow, bpf/flows.c:100-110) */
        if (s->first_seen_ns == 0 || pkt->ts_ns < s->first_seen_ns)
            s->first_seen_ns = pkt->ts_ns;
        if (pkt->ts_ns > s->last_seen_ns)
            s->last_seen_ns = pkt->ts_ns;
        s->bytes += len;
        s->packets += 1;
        s->tcp_flags |= pkt->tcp_flags;
        s->sampling = sampling;
        if (pkt->dscp)
            s->dscp = pkt->dscp;
        if (tls) {
            if (tls->version && s->ssl_version != tls->version) {
                if (s->ssl_version == 0)
                    s->ssl_version = tls->version;
                else
                    /* client/server hellos disagree on version
                     * (reference: bpf/flows.c:111-118) */
                    s->misc_flags |= NO_MISC_SSL_MISMATCH;
            }
            /* cipher_suite/key_share only ever parse out of a ServerHello
             * (tls.h), matching the reference's SERVER_HELLO gate */
            if (tls->cipher_suite)
                s->tls_cipher_suite = tls->cipher_suite;
            if (tls->key_share)
                s->tls_key_share = tls->key_share;
            s->tls_types |= tls->types_seen;
        }
    } else if (if_index != 0) {
        /* secondary interface: extend the time span and flags, remember the
         * (ifindex, direction) observation — but never re-count traffic */
        if (pkt->ts_ns > s->last_seen_ns)
            s->last_seen_ns = pkt->ts_ns;
        s->tcp_flags |= pkt->tcp_flags;
        __u8 n = s->n_observed_intf;
        __u8 seen = 0;
        #pragma unroll
        for (int i = 0; i < NO_MAX_OBSERVED_INTERFACES; i++) {
            if (i < n && s->observed_intf[i] == if_index &&
                s->observed_direction[i] == direction)
                seen = 1;
        }
        if (!seen) {
            if (n < NO_MAX_OBSERVED_INTERFACES) {
                s->observed_intf[n] = if_index;
                s->observed_direction[n] = direction;
                s->n_observed_intf = n + 1;
            } else {
                overflow = 1;
            }
        }
    }
    bpf_spin_unlock(&s->lock);
    return overflow;
}

NO_INLINE void no_init_stats(struct no_flow_stats *s, const struct no_pkt *pkt,
                             __u32 if_index, __u8 direction, __u32 sampling,
                             const struct no_tls_meta *tls, __u32 len) {
    __builtin_memset(s, 0, sizeof(*s));
    s->first_seen_ns = pkt->ts_ns;
    s->last_seen_ns = pkt->ts_ns;
    s->bytes = len;
    s->packets = 1;
    s->eth_protocol = pkt->eth_protocol;
    s->tcp_flags = pkt->tcp_flags;
    __builtin_memcpy(s->src_mac, pkt->src_mac, NO_ETH_ALEN);
    __builtin_memcpy(s->dst_mac, pkt->dst_mac, NO_ETH_ALEN);
    s->if_index_first = if_index;
    s->sampling = sampling;
    s->direction_first = direction;
    s->dscp = pkt->dscp;
    s->n_observed_intf = 1;
    s->observed_intf[0] = if_index;
    s->observed_direction[0] = direction;
    if (tls) {
        s->ssl_version = tls->version;
        s->tls_cipher_suite = tls->cipher_suite;
        s->tls_key_share = tls->key_share;
        s->tls_types = tls->types_seen;
    }
}

/* ring buffer fallback when the hash map can't take the flow */
NO_INLINE void no_ringbuf_fallback(const struct no_pkt *pkt, __u32 if_index,
                                   __u8 direction, __u32 sampling,
                                   const struct no_tls_meta *tls, __u32 len,
                                   __u8 err) {
    if (!cfg_enable_ringbuf_fallback)
        return;
    struct no_flow_event *ev =
        bpf_ringbuf_reserve(&direct_flows, sizeof(*ev), 0);
    if (!ev)
        return;
    __builtin_memcpy(&ev->key, &pkt->key, sizeof(ev->key));
    no_init_stats(&ev->stats, pkt, if_index, direction, sampling, tls, len);
    ev->stats.errno_fallback = err;
    bpf_ringbuf_submit(ev, 0);
}

NO_INLINE int no_flow_monitor(struct __sk_buff *skb, __u8 direction) {
    __u32 sampling = 0;
    if (!cfg_has_sampling) {
        /* no filter rule carries a sampling override: gate at the earliest
         * point, before any parsing (reference: bpf/flows.c:160-171).
         * Skip the gate write entirely when sampling is off — the reader
         * (no_do_sampling) short-circuits that case, so the store would be
         * pure per-packet overhead the verifier can't prune */
        if (cfg_sampling > 1) {
            if (!no_sampled(cfg_sampling)) {
                no_set_do_sampling(0);
                return TC_ACT_OK;
            }
            sampling = cfg_sampling;
            no_set_do_sampling(1);
        }
    }
    struct no_pkt pkt;
    __builtin_memset(&pkt, 0, sizeof(pkt));

    if (no_parse_packet(skb, &pkt) != 0)
        return TC_ACT_OK;
    pkt.ts_ns = bpf_ktime_get_ns();

    int skip = !no_flow_filter(&pkt, direction, 0, &sampling);
    if (cfg_has_sampling) {
        /* filter evaluation may have rewritten the rate for this flow; gate
         * now and record the decision for the aux hooks — even for packets
         * the filter will skip (reference: bpf/flows.c:194-206) */
        if (sampling == 0)
            sampling = cfg_sampling;
        if (!no_sampled(sampling)) {
            no_set_do_sampling(0);
            return TC_ACT_OK;
        }
        no_set_do_sampling(1);
    }
    if (skip)
        return TC_ACT_OK;

    struct no_tls_meta tls = {};
    no_track_dns(&pkt);
    no_track_tls(&pkt, &tls);
    no_track_quic(&pkt);

    __u32 if_index = skb->ifindex;
    struct no_flow_stats *existing =
        bpf_map_lookup_elem(&aggregated_flows, &pkt.key);
    if (existing) {
        if (no_update_flow(existing, &pkt, if_index, direction, sampling,
                           &tls, skb->len) &&
            pkt.key.proto != 0)
            /* zero-proto traffic routinely saturates the array; only count
             * real protocols (reference: bpf/flows.c:133-142) */
            no_count(NO_CTR_OBSERVED_INTF_MISSED);
    } else {
        struct no_flow_stats fresh;
        no_init_stats(&fresh, &pkt, if_index, direction, sampling, &tls,
                      skb->len);
        long err = bpf_map_update_elem(&aggregated_flows, &pkt.key, &fresh,
                                       BPF_NOEXIST);
        if (err == -NO_EEXIST) {
            /* another CPU created it between lookup and insert: merge */
            existing = bpf_map_lookup_elem(&aggregated_flows, &pkt.key);
            if (existing) {
                if (no_update_flow(existing, &pkt, if_index, direction,
                                   sampling, &tls, skb->len) &&
                    pkt.key.proto != 0)
                    no_count(NO_CTR_OBSERVED_INTF_MISSED);
            } else {
                no_count(NO_CTR_HASHMAP_FAIL_UPDATE_FLOW);
            }
        } else if (err != 0) {
            /* map full (or other failure): ship the whole event upstairs */
            no_count(NO_CTR_HASHMAP_FAIL_CREATE_FLOW);
            no_ringbuf_fallback(&pkt, if_index, direction, sampling, &tls,
                                skb->len, (__u8)(-err));
        }
    }
    no_record_dns(&pkt);
    return TC_ACT_OK;
}

SEC("tc_ingress")
int tc_ingress_flow(struct __sk_buff *skb) {
    return no_flow_monitor(skb, DIR_INGRESS);
}

SEC("tc_egress")
int tc_egress_flow(struct __sk_buff *skb) {
    return no_flow_monitor(skb, DIR_EGRESS);
}

SEC("tcx/ingress")
int tcx_ingress_flow(struct __sk_buff *skb) {
    no_flow_monitor(skb, DIR_INGRESS);
    return TC_ACT_UNSPEC; /* tcx: continue the chain */
}

SEC("tcx/egress")
int tcx_egress_flow(struct __sk_buff *skb) {
    no_flow_monitor(skb, DIR_EGRESS);
    return TC_ACT_UNSPEC;
}

/* PCA (packet capture) entry points — mutually exclusive deployment with the
 * flow programs; gated by cfg_enable_pca */
SEC("tc_pca_ingress")
int tc_pca_ingress(struct __sk_buff *skb) {
    return no_pca_capture(skb, DIR_INGRESS);
}

SEC("tc_pca_egress")
int tc_pca_egress(struct __sk_buff *skb) {
    return no_pca_capture(skb, DIR_EGRESS);
}

SEC("tcx/pca_ingress")
int tcx_pca_ingress(struct __sk_buff *skb) {
    no_pca_capture(skb, DIR_INGRESS);
    return TC_ACT_UNSPEC;
}

SEC("tcx/pca_egress")
int tcx_pca_egress(struct __sk_buff *skb) {
    no_pca_capture(skb, DIR_EGRESS);
    return TC_ACT_UNSPEC;
}
