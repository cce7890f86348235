/*
 * flowpath_probes.c — auxiliary kernel hooks feeding the per-CPU feature maps.
 *
 * Each hook fires on its own kernel event and writes partials keyed by the
 * same no_flow_key the TC path uses; userspace merges them at eviction.
 * Behavioral parity targets (each a fresh implementation):
 *   - TCP RTT:          fentry/tcp_rcv_established (bpf/rtt_tracker.h)
 *   - packet drops:     tracepoint/skb/kfree_skb   (bpf/pkt_drops.h)
 *   - network events:   kprobe/psample_sample_packet (bpf/network_events_monitoring.h)
 *   - NAT translation:  kprobe/nf_nat_manip_pkt    (bpf/pkt_translation.h)
 *   - IPsec:            k(ret)probe xfrm_input/xfrm_output (bpf/ipsec.h)
 *   - OpenSSL:          uprobe/SSL_write           (bpf/openssl_tracker.h)
 *
 * BUILD REQUIREMENT: this translation unit needs kernel type info — compile
 * with a distro vmlinux.h + libbpf's bpf_core_read.h on the include path and
 * -DNO_HAVE_VMLINUX. Without them only flowpath.c (the TC datapath) builds;
 * the loader attaches these hooks only when the object carries them, mirroring
 * the reference's optional-hook laddering (pkg/tracer/tracer.go:184-273).
 */
#ifdef NO_HAVE_VMLINUX

#include "vmlinux.h"
#include <bpf/bpf_core_read.h>
#include <bpf/bpf_helpers.h>
#include <bpf/bpf_tracing.h>

#include "records.h"
#include "config.h"
#include "maps.h"

char LICENSE[] SEC("license") = "GPL";

#define PROTO_TCP 6
#define PROTO_UDP 17
#define AF_INET_ 2
#define AF_INET6_ 10

static __always_inline void no_count_probe(__u32 key) {
    __u64 *val = bpf_map_lookup_elem(&global_counters, &key);
    if (val)
        __sync_fetch_and_add(val, 1);
}

static __always_inline __u16 no_sat_add16(__u16 a, __u16 b) {
    __u32 s = (__u32)a + b;
    return s > 0xFFFF ? 0xFFFF : (__u16)s;
}

/* --- shared helpers ------------------------------------------------------ */

static __always_inline void v4_mapped(__u8 *dst16, __be32 addr) {
    __builtin_memset(dst16, 0, 10);
    dst16[10] = 0xFF;
    dst16[11] = 0xFF;
    __builtin_memcpy(dst16 + 12, &addr, 4);
}

/* build a flow key from a struct sock. tcp_rcv_established fires on the
 * RECEIVE path, so the tracked flow's source is the REMOTE endpoint (the TC
 * ingress key) — remote goes in src, local in dst, matching how the TC path
 * keyed this flow. */
static __always_inline int key_from_sock_rx(struct sock *sk,
                                            struct no_flow_key *k) {
    __u16 family = BPF_CORE_READ(sk, __sk_common.skc_family);
    k->proto = PROTO_TCP;
    k->src_port = bpf_ntohs(BPF_CORE_READ(sk, __sk_common.skc_dport));
    k->dst_port = BPF_CORE_READ(sk, __sk_common.skc_num);
    if (family == AF_INET_) {
        v4_mapped(k->src_ip, BPF_CORE_READ(sk, __sk_common.skc_daddr));
        v4_mapped(k->dst_ip, BPF_CORE_READ(sk, __sk_common.skc_rcv_saddr));
        return 0;
    }
    if (family == AF_INET6_) {
        BPF_CORE_READ_INTO(&k->src_ip, sk,
                           __sk_common.skc_v6_daddr.in6_u.u6_addr8);
        BPF_CORE_READ_INTO(&k->dst_ip, sk,
                           __sk_common.skc_v6_rcv_saddr.in6_u.u6_addr8);
        return 0;
    }
    return -1;
}

/* build a flow key by re-parsing an skb's network/transport headers */
static __always_inline int key_from_skb(struct sk_buff *skb,
                                        struct no_flow_key *k,
                                        __u16 *eth_proto, __u16 *flags) {
    unsigned char *head = BPF_CORE_READ(skb, head);
    __u16 nh_off = BPF_CORE_READ(skb, network_header);
    __u16 th_off = BPF_CORE_READ(skb, transport_header);
    __u8 version;
    bpf_probe_read_kernel(&version, 1, head + nh_off);
    version >>= 4;
    __u8 proto = 0;
    if (version == 4) {
        struct iphdr ip;
        bpf_probe_read_kernel(&ip, sizeof(ip), head + nh_off);
        v4_mapped(k->src_ip, ip.saddr);
        v4_mapped(k->dst_ip, ip.daddr);
        proto = ip.protocol;
        *eth_proto = 0x0800;
    } else if (version == 6) {
        struct ipv6hdr ip6;
        bpf_probe_read_kernel(&ip6, sizeof(ip6), head + nh_off);
        bpf_probe_read_kernel(k->src_ip, 16, &ip6.saddr);
        bpf_probe_read_kernel(k->dst_ip, 16, &ip6.daddr);
        proto = ip6.nexthdr;
        *eth_proto = 0x86DD;
    } else {
        return -1;
    }
    k->proto = proto;
    if (proto == PROTO_TCP) {
        struct tcphdr tcp;
        bpf_probe_read_kernel(&tcp, sizeof(tcp), head + th_off);
        k->src_port = bpf_ntohs(tcp.source);
        k->dst_port = bpf_ntohs(tcp.dest);
        if (flags) {
            __u8 *fb = (__u8 *)&tcp + 13;
            *flags = *fb;
        }
    } else if (proto == PROTO_UDP) {
        struct udphdr udp;
        bpf_probe_read_kernel(&udp, sizeof(udp), head + th_off);
        k->src_port = bpf_ntohs(udp.source);
        k->dst_port = bpf_ntohs(udp.dest);
    }
    return 0;
}

/* --- TCP RTT (fentry with kprobe fallback section) ----------------------- */

static __always_inline int handle_rtt(struct sock *sk) {
    if (!cfg_enable_rtt || !no_do_sampling())
        return 0;
    struct no_flow_key k = {};
    if (key_from_sock_rx(sk, &k) != 0)
        return 0;
    struct tcp_sock *ts = (struct tcp_sock *)sk;
    __u32 srtt_us_8 = BPF_CORE_READ(ts, srtt_us);
    __u64 rtt_ns = ((__u64)(srtt_us_8 >> 3)) * 1000;
    __u64 now = bpf_ktime_get_ns();
    struct no_extra_rec *rec = bpf_map_lookup_elem(&flows_extra, &k);
    if (rec) {
        rec->last_seen_ns = now;
        if (rtt_ns > rec->rtt_ns)
            rec->rtt_ns = rtt_ns;
        return 0;
    }
    struct no_extra_rec fresh = {
        .first_seen_ns = now, .last_seen_ns = now, .rtt_ns = rtt_ns,
    };
    bpf_map_update_elem(&flows_extra, &k, &fresh, BPF_ANY);
    return 0;
}

SEC("fentry/tcp_rcv_established")
int BPF_PROG(rtt_fentry, struct sock *sk) { return handle_rtt(sk); }

SEC("kprobe/tcp_rcv_established")
int BPF_KPROBE(rtt_kprobe, struct sock *sk) { return handle_rtt(sk); }

/* --- packet drops (tracepoint skb/kfree_skb) ----------------------------- */

struct kfree_skb_ctx {
    __u64 _pad;
    struct sk_buff *skb;
    void *location;
    unsigned short protocol;
    int reason;
};

SEC("tracepoint/skb/kfree_skb")
int drops_tp(struct kfree_skb_ctx *ctx) {
    if (!cfg_enable_pkt_drops)
        return 0;
    /* reason <= 2 (NOT_SPECIFIED / NO_SOCKET boundary) is routine teardown;
     * filter it before paying the sampling-gate map lookup — this hook fires
     * for every freed skb on the host */
    if (ctx->reason <= 2)
        return 0;
    if (!no_do_sampling())
        return 0;
    struct no_flow_key k = {};
    __u16 eth_proto = 0, flags = 0;
    if (key_from_skb(ctx->skb, &k, &eth_proto, &flags) != 0)
        return 0;
    __u32 len = BPF_CORE_READ(ctx->skb, len);
    __u8 state = 0;
    struct sock *sk = BPF_CORE_READ(ctx->skb, sk);
    if (sk)
        state = BPF_CORE_READ(sk, __sk_common.skc_state);
    __u64 now = bpf_ktime_get_ns();
    struct no_drops_rec *rec = bpf_map_lookup_elem(&flows_drops, &k);
    if (rec) {
        rec->last_seen_ns = now;
        rec->bytes = no_sat_add16(rec->bytes, (__u16)len);
        rec->packets = no_sat_add16(rec->packets, 1);
        rec->latest_cause = ctx->reason;
        rec->latest_flags |= flags;
        rec->latest_state = state;
        return 0;
    }
    struct no_drops_rec fresh = {
        .first_seen_ns = now, .last_seen_ns = now,
        .bytes = (__u16)len, .packets = 1,
        .latest_cause = (__u32)ctx->reason, .latest_flags = flags,
        .eth_protocol = eth_proto, .latest_state = state,
    };
    bpf_map_update_elem(&flows_drops, &k, &fresh, BPF_ANY);
    return 0;
}

/* --- network events (OVN psample cookies) -------------------------------- */

SEC("kprobe/psample_sample_packet")
int BPF_KPROBE(nevents_kprobe, struct psample_group *group,
               struct sk_buff *skb, u32 sample_rate, void *md) {
    if (!cfg_enable_network_events || !no_do_sampling())
        return 0;
    __u32 group_id = BPF_CORE_READ(group, group_num);
    if (group_id != cfg_network_events_group_id) {
        no_count_probe(NO_CTR_NETWORK_EVENTS_ERR_GROUPID_MISMATCH);
        return 0;
    }
    struct no_flow_key k = {};
    __u16 eth_proto = 0;
    if (key_from_skb(skb, &k, &eth_proto, 0) != 0) {
        no_count_probe(NO_CTR_NETWORK_EVENTS_ERR);
        return 0;
    }
    /* the user cookie rides in the metadata; bounded copy */
    __u8 cookie[NO_MAX_EVENT_MD] = {};
    struct psample_metadata *meta = md;
    __u8 cookie_len = BPF_CORE_READ(meta, user_cookie_len);
    if (cookie_len > NO_MAX_EVENT_MD) {
        no_count_probe(NO_CTR_NETWORK_EVENTS_COOKIE_TOO_BIG);
        return 0;
    }
    void *cookie_src = BPF_CORE_READ(meta, user_cookie);
    if (!cookie_src || cookie_len == 0)
        return 0;
    /* read only the cookie's own length — over-reading can fault (zero-fill)
     * or capture trailing garbage that defeats the dedup memcmp */
    bpf_probe_read_kernel(cookie, cookie_len, cookie_src);
    __u32 len = BPF_CORE_READ(skb, len);
    __u64 now = bpf_ktime_get_ns();
    struct no_nevents_rec *rec = bpf_map_lookup_elem(&flows_nevents, &k);
    if (rec) {
        rec->last_seen_ns = now;
        __u8 idx = rec->n_events;
        #pragma unroll
        for (int i = 0; i < NO_MAX_NETWORK_EVENTS; i++) {
            if (__builtin_memcmp(rec->events[i], cookie,
                                 NO_MAX_EVENT_MD) == 0)
                return 0; /* duplicate event metadata */
        }
        if (idx < NO_MAX_NETWORK_EVENTS) {
            __builtin_memcpy(rec->events[idx], cookie, NO_MAX_EVENT_MD);
            rec->bytes[idx] = (__u16)len;
            rec->packets[idx] = 1;
            rec->n_events = idx + 1;
            no_count_probe(NO_CTR_NETWORK_EVENTS_GOOD);
        } else {
            no_count_probe(NO_CTR_NETWORK_EVENTS_OVERFLOW);
        }
        return 0;
    }
    struct no_nevents_rec fresh = {
        .first_seen_ns = now, .last_seen_ns = now,
        .eth_protocol = eth_proto, .n_events = 1,
    };
    __builtin_memcpy(fresh.events[0], cookie, NO_MAX_EVENT_MD);
    fresh.bytes[0] = (__u16)len;
    fresh.packets[0] = 1;
    if (bpf_map_update_elem(&flows_nevents, &k, &fresh, BPF_ANY) != 0)
        no_count_probe(NO_CTR_NETWORK_EVENTS_ERR_UPDATE_MAP_FLOWS);
    else
        no_count_probe(NO_CTR_NETWORK_EVENTS_GOOD);
    return 0;
}

/* --- NAT translation (kprobe nf_nat_manip_pkt) --------------------------- */

SEC("kprobe/nf_nat_manip_pkt")
int BPF_KPROBE(xlat_kprobe, struct sk_buff *skb, struct nf_conn *ct,
               int mtype, int dir) {
    if (!cfg_enable_pkt_translation || !no_do_sampling())
        return 0;
    struct no_flow_key k = {};
    __u16 eth_proto = 0;
    if (key_from_skb(skb, &k, &eth_proto, 0) != 0)
        return 0;
    /* post-NAT endpoints live in the reply-direction conntrack tuple */
    struct nf_conntrack_tuple reply;
    BPF_CORE_READ_INTO(&reply, ct, tuplehash[1].tuple);
    struct no_xlat_rec rec = {};
    __u64 now = bpf_ktime_get_ns();
    rec.first_seen_ns = now;
    rec.last_seen_ns = now;
    rec.eth_protocol = eth_proto;
    if (k.src_ip[10] == 0xFF && k.src_ip[11] == 0xFF) { /* v4 flow */
        v4_mapped(rec.src_ip, reply.dst.u3.ip);
        v4_mapped(rec.dst_ip, reply.src.u3.ip);
    } else {
        bpf_probe_read_kernel(rec.src_ip, 16, &reply.dst.u3.in6);
        bpf_probe_read_kernel(rec.dst_ip, 16, &reply.src.u3.in6);
    }
    rec.src_port = bpf_ntohs(reply.dst.u.all);
    rec.dst_port = bpf_ntohs(reply.src.u.all);
    __u16 zone = BPF_CORE_READ(ct, zone.id);
    rec.zone_id = zone;
    bpf_map_update_elem(&flows_xlat, &k, &rec, BPF_ANY);
    return 0;
}

/* --- IPsec (xfrm entry/return probe pairs) ------------------------------- */

static __always_inline int ipsec_entry(struct sk_buff *skb, void *map) {
    if (!cfg_enable_ipsec || !no_do_sampling())
        return 0;
    struct no_flow_key k = {};
    __u16 eth_proto = 0;
    if (key_from_skb(skb, &k, &eth_proto, 0) != 0)
        return 0;
    __u64 id = bpf_get_current_pid_tgid();
    bpf_map_update_elem(map, &id, &k, BPF_ANY);
    return 0;
}

static __always_inline int ipsec_return(int ret, void *map) {
    if (!cfg_enable_ipsec || !no_do_sampling())
        return 0;
    __u64 id = bpf_get_current_pid_tgid();
    struct no_flow_key *k = bpf_map_lookup_elem(map, &id);
    if (!k)
        return 0;
    __u64 now = bpf_ktime_get_ns();
    struct no_extra_rec *rec = bpf_map_lookup_elem(&flows_extra, k);
    if (rec) {
        rec->last_seen_ns = now;
        if (rec->ipsec_ret < ret) {
            rec->ipsec_ret = ret;
            rec->ipsec_encrypted = ret == 0;
        } else if (rec->ipsec_ret == ret && ret == 0) {
            rec->ipsec_encrypted = 1;
        }
    } else {
        struct no_extra_rec fresh = {
            .first_seen_ns = now, .last_seen_ns = now,
            .ipsec_ret = ret, .ipsec_encrypted = ret == 0,
        };
        bpf_map_update_elem(&flows_extra, k, &fresh, BPF_ANY);
    }
    bpf_map_delete_elem(map, &id);
    return 0;
}

SEC("kprobe/xfrm_input")
int BPF_KPROBE(ipsec_in_entry, struct sk_buff *skb) {
    return ipsec_entry(skb, &ipsec_ingress_inflight);
}

SEC("kretprobe/xfrm_input")
int BPF_KRETPROBE(ipsec_in_return, int ret) {
    return ipsec_return(ret, &ipsec_ingress_inflight);
}

SEC("kprobe/xfrm_output")
int BPF_KPROBE(ipsec_out_entry, struct sock *sk, struct sk_buff *skb) {
    return ipsec_entry(skb, &ipsec_egress_inflight);
}

SEC("kretprobe/xfrm_output")
int BPF_KRETPROBE(ipsec_out_return, int ret) {
    return ipsec_return(ret, &ipsec_egress_inflight);
}

/* --- OpenSSL plaintext (uprobe SSL_write) -------------------------------- */

SEC("uprobe/SSL_write")
int BPF_KPROBE(ssl_write_uprobe, void *ssl, const void *buf, int num) {
    struct no_ssl_event *ev =
        bpf_ringbuf_reserve(&ssl_events, sizeof(*ev), 0);
    if (!ev)
        return 0;
    ev->timestamp_ns = bpf_ktime_get_ns();
    ev->pid_tgid = bpf_get_current_pid_tgid();
    __u32 n = num < 0 ? 0 : (__u32)num;
    if (n > NO_MAX_SSL_DATA)
        n = NO_MAX_SSL_DATA;
    ev->data_len = n;
    ev->ssl_type = 1; /* write direction */
    /* read exactly the caller's length: over-reading past the user buffer
     * either faults (zero-filled payload) or leaks adjacent process memory */
    if (n > 0)
        bpf_probe_read_user(ev->data, n, buf);
    bpf_ringbuf_submit(ev, 0);
    return 0;
}

#endif /* NO_HAVE_VMLINUX */
