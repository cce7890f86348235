/*
 * dns.h — DNS latency tracking, inline in the TC path.
 *
 * Behavior (reference analog: bpf/dns_tracker.h): a query on cfg_dns_port
 * stores its timestamp in `dns_inflight` keyed by the *reversed* tuple plus
 * the DNS transaction id, so the response (travelling the opposite direction)
 * finds it, yielding latency. The response's flags/rcode and the query name
 * (copied via a per-CPU scratch slot to dodge the 512B stack limit) are
 * recorded in the per-CPU `flows_dns` feature map.
 */
#ifndef NO_DNS_H
#define NO_DNS_H

#include "config.h"
#include "helpers.h"
#include "maps.h"
#include "parse.h"

struct no_dns_hdr {
    __u16 id;
    __u16 flags;
    __u16 qdcount;
    __u16 ancount;
    __u16 nscount;
    __u16 arcount;
};

#define NO_DNS_QR_BIT 0x8000

NO_INLINE void no_dns_corr_key_for_query(struct no_dns_corr_key *ck,
                                         const struct no_flow_key *k,
                                         __u16 dns_id) {
    /* reversed tuple: the response's own 5-tuple will produce this key */
    ck->src_port = k->dst_port;
    ck->dst_port = k->src_port;
    __builtin_memcpy(ck->src_ip, k->dst_ip, NO_IP_LEN);
    __builtin_memcpy(ck->dst_ip, k->src_ip, NO_IP_LEN);
    ck->dns_id = dns_id;
    ck->proto = k->proto;
    ck->_pad = 0;
}

NO_INLINE void no_dns_corr_key_for_response(struct no_dns_corr_key *ck,
                                            const struct no_flow_key *k,
                                            __u16 dns_id) {
    ck->src_port = k->src_port;
    ck->dst_port = k->dst_port;
    __builtin_memcpy(ck->src_ip, k->src_ip, NO_IP_LEN);
    __builtin_memcpy(ck->dst_ip, k->dst_ip, NO_IP_LEN);
    ck->dns_id = dns_id;
    ck->proto = k->proto;
    ck->_pad = 0;
}

/* copy a (possibly truncated) qname into out[NO_DNS_NAME_MAX_LEN] */
NO_INLINE void no_dns_copy_name(const __u8 *qname, const void *end,
                                char *out) {
    #pragma unroll
    for (int i = 0; i < NO_DNS_NAME_MAX_LEN; i++) {
        if (qname + i + 1 > (const __u8 *)end) {
            out[i] = 0;
            return;
        }
        out[i] = qname[i];
        if (qname[i] == 0)
            return;
    }
}

NO_INLINE void no_track_dns(struct no_pkt *pkt) {
    if (!cfg_enable_dns_tracking || pkt->key.proto != PROTO_UDP)
        return;
    if (pkt->key.src_port != cfg_dns_port && pkt->key.dst_port != cfg_dns_port)
        return;
    const struct no_dns_hdr *dns = pkt->l4_payload;
    if (!dns || (const void *)(dns + 1) > pkt->payload_end)
        return;
    __u16 id = no_ntohs(dns->id);
    __u16 flags = no_ntohs(dns->flags);
    struct no_dns_corr_key ck;

    if (!(flags & NO_DNS_QR_BIT)) {
        /* query: stash timestamp under the reversed tuple */
        no_dns_corr_key_for_query(&ck, &pkt->key, id);
        __u64 ts = pkt->ts_ns;
        if (bpf_map_update_elem(&dns_inflight, &ck, &ts, BPF_ANY) != 0)
            no_count(NO_CTR_HASHMAP_FAIL_UPDATE_DNS);
        pkt->dns_id = id;
        pkt->dns_flags = flags;
        return;
    }
    /* response: correlate and compute latency */
    no_dns_corr_key_for_response(&ck, &pkt->key, id);
    __u64 *sent = bpf_map_lookup_elem(&dns_inflight, &ck);
    pkt->dns_id = id;
    pkt->dns_flags = flags;
    if (sent) {
        if (pkt->ts_ns > *sent)
            pkt->dns_latency = pkt->ts_ns - *sent;
        bpf_map_delete_elem(&dns_inflight, &ck);
    }
}

/* upsert the per-CPU DNS feature record after the base flow update */
NO_INLINE void no_record_dns(const struct no_pkt *pkt) {
    if (!cfg_enable_dns_tracking || (!pkt->dns_id && !pkt->dns_latency))
        return;
    struct no_dns_rec *rec = bpf_map_lookup_elem(&flows_dns, &pkt->key);
    if (rec) {
        if (rec->first_seen_ns == 0)
            rec->first_seen_ns = pkt->ts_ns;
        rec->last_seen_ns = pkt->ts_ns;
        rec->dns_id = pkt->dns_id;
        rec->dns_flags |= pkt->dns_flags;
        rec->errno_code = 0;
        if (pkt->dns_latency > rec->latency_ns)
            rec->latency_ns = pkt->dns_latency;
        return;
    }
    struct no_dns_rec fresh = {
        .first_seen_ns = pkt->ts_ns,
        .last_seen_ns = pkt->ts_ns,
        .latency_ns = pkt->dns_latency,
        .dns_id = pkt->dns_id,
        .dns_flags = pkt->dns_flags,
        .eth_protocol = pkt->eth_protocol,
    };
    /* copy the qname through per-CPU scratch (stack budget) */
    __u32 zero = 0;
    struct no_dns_name_scratch *scratch =
        bpf_map_lookup_elem(&dns_scratch, &zero);
    const struct no_dns_hdr *dns = pkt->l4_payload;
    if (scratch && dns && (const void *)(dns + 1) <= pkt->payload_end) {
        no_dns_copy_name((const __u8 *)(dns + 1), pkt->payload_end,
                         scratch->name);
        __builtin_memcpy(fresh.name, scratch->name, NO_DNS_NAME_MAX_LEN);
    }
    if (bpf_map_update_elem(&flows_dns, &pkt->key, &fresh, BPF_ANY) != 0)
        no_count(NO_CTR_HASHMAP_FAIL_UPDATE_DNS);
}

#endif /* NO_DNS_H */
