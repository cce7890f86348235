/*
 * pca.h — packet capture (PCA mode): copy filtered packet payloads to a ring
 * buffer for userspace pcap framing (reference analog: bpf/pca.h).
 */
#ifndef NO_PCA_H
#define NO_PCA_H

#include "config.h"
#include "filter.h"
#include "helpers.h"
#include "maps.h"
#include "parse.h"

NO_INLINE int no_pca_capture(struct __sk_buff *skb, __u8 direction) {
    if (!cfg_enable_pca)
        return TC_ACT_OK;
    struct no_pkt pkt;
    __builtin_memset(&pkt, 0, sizeof(pkt));
    if (no_parse_packet(skb, &pkt) != 0)
        return TC_ACT_OK;
    pkt.ts_ns = bpf_ktime_get_ns();
    __u32 sampling = cfg_sampling;
    if (!no_flow_filter(&pkt, direction, 0, &sampling))
        return TC_ACT_OK;
    if (sampling > 1 && bpf_get_prandom_u32() % sampling != 0)
        return TC_ACT_OK;

    struct no_packet_event *ev =
        bpf_ringbuf_reserve(&packet_records, sizeof(*ev), 0);
    if (!ev)
        return TC_ACT_OK;
    ev->if_index = skb->ifindex;
    ev->pkt_len = skb->len;
    ev->timestamp_ns = pkt.ts_ns;
    __u32 copy = skb->len < NO_MAX_PAYLOAD_SIZE ? skb->len
                                                : NO_MAX_PAYLOAD_SIZE;
    const __u8 *data = (const __u8 *)(long)skb->data;
    const __u8 *end = (const __u8 *)(long)skb->data_end;
    #pragma unroll
    for (__u32 i = 0; i < NO_MAX_PAYLOAD_SIZE; i++) {
        if (i >= copy || data + i + 1 > end)
            break;
        ev->payload[i] = data[i];
    }
    bpf_ringbuf_submit(ev, 0);
    return TC_ACT_OK;
}

#endif /* NO_PCA_H */
