/*
 * parse.h — L2/L3/L4 header parsing for the TC/TCX path.
 *
 * Bounds-checked direct packet access (data/data_end), filling the flow key
 * and packet metadata. Reference-behavior analog: bpf/utils.h fill_*hdr.
 */
#ifndef NO_PARSE_H
#define NO_PARSE_H

#include "config.h"
#include "helpers.h"
#include "records.h"

#define ETH_P_IPV4 0x0800
#define ETH_P_IPV6 0x86DD
#define PROTO_TCP 6
#define PROTO_UDP 17
#define PROTO_SCTP 132
#define PROTO_ICMP 1
#define PROTO_ICMP6 58

/* synthetic exported flag bits on top of the RFC 9293 low byte */
#define NO_TCPF_SYN 0x02
#define NO_TCPF_ACK 0x10
#define NO_TCPF_FIN 0x01
#define NO_TCPF_RST 0x04
#define NO_TCPF_SYN_ACK 0x100
#define NO_TCPF_FIN_ACK 0x200
#define NO_TCPF_RST_ACK 0x400

struct no_pkt {
    struct no_flow_key key;
    __u64 ts_ns;
    __u16 eth_protocol;
    __u16 tcp_flags;
    __u8 dscp;
    __u8 src_mac[NO_ETH_ALEN];
    __u8 dst_mac[NO_ETH_ALEN];
    const void *l4_payload; /* first byte past the L4 header, or NULL */
    const void *payload_end;
    __u16 dns_id;           /* filled by the dns tracker */
    __u16 dns_flags;
    __u64 dns_latency;
};

struct no_ethhdr {
    __u8 dst[NO_ETH_ALEN];
    __u8 src[NO_ETH_ALEN];
    __u16 proto;
};

struct no_iphdr {
    __u8 ver_ihl;
    __u8 tos;
    __u16 tot_len;
    __u16 id;
    __u16 frag_off;
    __u8 ttl;
    __u8 protocol;
    __u16 check;
    __u32 saddr;
    __u32 daddr;
};

struct no_ip6hdr {
    __u32 ver_tc_fl;
    __u16 payload_len;
    __u8 next_hdr;
    __u8 hop_limit;
    __u8 saddr[16];
    __u8 daddr[16];
};

struct no_tcphdr {
    __u16 sport;
    __u16 dport;
    __u32 seq;
    __u32 ack;
    __u8 off_rsvd;  /* data offset in high nibble */
    __u8 flags;
    __u16 window;
    __u16 check;
    __u16 urg;
};

struct no_udphdr {
    __u16 sport;
    __u16 dport;
    __u16 len;
    __u16 check;
};

NO_INLINE __u16 no_classify_tcp_flags(__u8 raw) {
    __u16 flags = raw;
    if ((raw & (NO_TCPF_SYN | NO_TCPF_ACK)) == (NO_TCPF_SYN | NO_TCPF_ACK))
        flags |= NO_TCPF_SYN_ACK;
    if ((raw & (NO_TCPF_FIN | NO_TCPF_ACK)) == (NO_TCPF_FIN | NO_TCPF_ACK))
        flags |= NO_TCPF_FIN_ACK;
    if ((raw & (NO_TCPF_RST | NO_TCPF_ACK)) == (NO_TCPF_RST | NO_TCPF_ACK))
        flags |= NO_TCPF_RST_ACK;
    return flags;
}

NO_INLINE void no_v4_mapped(__u8 *dst16, __u32 addr_be) {
    __builtin_memset(dst16, 0, 10);
    dst16[10] = 0xFF;
    dst16[11] = 0xFF;
    __builtin_memcpy(dst16 + 12, &addr_be, 4);
}

/* parse L4 starting at `l4`; returns 0 on success */
NO_INLINE int no_parse_l4(const void *l4, const void *end, __u8 proto,
                          struct no_pkt *pkt) {
    struct no_flow_key *k = &pkt->key;
    k->proto = proto;
    switch (proto) {
    case PROTO_TCP: {
        const struct no_tcphdr *tcp = l4;
        if ((const void *)(tcp + 1) > end)
            return -1;
        k->src_port = no_ntohs(tcp->sport);
        k->dst_port = no_ntohs(tcp->dport);
        pkt->tcp_flags = no_classify_tcp_flags(tcp->flags);
        __u8 doff = (tcp->off_rsvd >> 4) * 4;
        const void *payload = (const __u8 *)l4 + doff;
        pkt->l4_payload = payload <= end ? payload : 0;
        break;
    }
    case PROTO_UDP: {
        const struct no_udphdr *udp = l4;
        if ((const void *)(udp + 1) > end)
            return -1;
        k->src_port = no_ntohs(udp->sport);
        k->dst_port = no_ntohs(udp->dport);
        pkt->l4_payload = (const void *)(udp + 1);
        break;
    }
    case PROTO_SCTP: {
        const __u16 *ports = l4;
        if ((const void *)(ports + 2) > end)
            return -1;
        k->src_port = no_ntohs(ports[0]);
        k->dst_port = no_ntohs(ports[1]);
        break;
    }
    case PROTO_ICMP:
    case PROTO_ICMP6: {
        const __u8 *icmp = l4;
        if (icmp + 2 > (const __u8 *)end)
            return -1;
        k->icmp_type = icmp[0];
        k->icmp_code = icmp[1];
        break;
    }
    default:
        break;
    }
    return 0;
}

/* parse a whole frame from a TC context; returns 0 when the packet is IP */
NO_INLINE int no_parse_packet(struct __sk_buff *skb, struct no_pkt *pkt) {
    const void *data = (const void *)(long)skb->data;
    const void *end = (const void *)(long)skb->data_end;
    const struct no_ethhdr *eth = data;
    if ((const void *)(eth + 1) > end)
        return -1;
    __builtin_memcpy(pkt->src_mac, eth->src, NO_ETH_ALEN);
    __builtin_memcpy(pkt->dst_mac, eth->dst, NO_ETH_ALEN);
    pkt->payload_end = end;
    __u16 proto = no_ntohs(eth->proto);
    pkt->eth_protocol = proto;
    if (proto == ETH_P_IPV4) {
        const struct no_iphdr *ip = (const void *)(eth + 1);
        if ((const void *)(ip + 1) > end)
            return -1;
        no_v4_mapped(pkt->key.src_ip, ip->saddr);
        no_v4_mapped(pkt->key.dst_ip, ip->daddr);
        pkt->dscp = ip->tos >> 2;
        __u8 ihl = (ip->ver_ihl & 0x0F) * 4;
        if (ihl < sizeof(*ip))
            return -1;
        const void *l4 = (const __u8 *)ip + ihl;
        if (l4 > end)
            return -1;
        return no_parse_l4(l4, end, ip->protocol, pkt);
    }
    if (proto == ETH_P_IPV6) {
        const struct no_ip6hdr *ip6 = (const void *)(eth + 1);
        if ((const void *)(ip6 + 1) > end)
            return -1;
        __builtin_memcpy(pkt->key.src_ip, ip6->saddr, 16);
        __builtin_memcpy(pkt->key.dst_ip, ip6->daddr, 16);
        pkt->dscp = (__u8)((no_ntohl(ip6->ver_tc_fl) >> 22) & 0x3F);
        /* no extension-header walk: next_hdr only (same tradeoff as the
         * reference takes on the fast path) */
        return no_parse_l4((const void *)(ip6 + 1), end, ip6->next_hdr, pkt);
    }
    return -1; /* non-IP traffic is not flow-tracked */
}

#endif /* NO_PARSE_H */
