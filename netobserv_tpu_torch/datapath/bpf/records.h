/*
 * records.h — layout-pinned record structs shared between the eBPF datapath and
 * the host decoder.
 *
 * CONTRACT: every struct here must match, byte for byte, the numpy dtypes in
 * netobserv_tpu/model/binfmt.py. Parity is machine-checked by
 * tests/test_layout_parity.py, which compiles this header with the host
 * compiler and diffs offsetof/sizeof against the dtypes. All padding is
 * explicit (`__pad*`) so the layout does not depend on compiler packing
 * decisions. Fields carry the machine's native byte order (shared
 * kernel<->user structs; userspace twins in model/binfmt.py are
 * native-endian dtypes, so LE and BE targets both decode correctly).
 *
 * This header is deliberately self-contained (fixed-width types only, no
 * kernel headers) so it can be compiled both by clang -target bpf and by a
 * host compiler for the layout check.
 *
 * Reference-design analog: bpf/types.h in netobserv-ebpf-agent, where the
 * same contract was comment-enforced ("must match byte-by-byte",
 * bpf/types.h:209-215) against Go's pkg/model decoding.
 */
#ifndef NO_RECORDS_H
#define NO_RECORDS_H

#ifdef NO_HOST_BUILD
#include <stdint.h>
typedef uint8_t __u8;
typedef uint16_t __u16;
typedef uint32_t __u32;
typedef uint64_t __u64;
typedef int32_t __s32;
#endif

#define NO_IP_LEN 16
#define NO_ETH_ALEN 6
#define NO_MAX_OBSERVED_INTERFACES 6
#define NO_MAX_NETWORK_EVENTS 4
#define NO_MAX_EVENT_MD 8
#define NO_DNS_NAME_MAX_LEN 32
#define NO_MAX_PAYLOAD_SIZE 256
#define NO_MAX_SSL_DATA (16 * 1024)

/* no_flow_stats.misc_flags bits (reference: bpf/types.h:75) */
#define NO_MISC_SSL_MISMATCH 0x01

/* Flow identity: 5-tuple plus ICMP discriminator. IPv4 addresses are stored
 * v4-in-v6 mapped (::ffff/96, RFC 4038). 40 bytes. */
struct no_flow_key {
    __u8 src_ip[NO_IP_LEN];
    __u8 dst_ip[NO_IP_LEN];
    __u16 src_port;
    __u16 dst_port;
    __u8 proto;
    __u8 icmp_type;
    __u8 icmp_code;
    __u8 __pad0;
};

/* Base per-flow statistics (the aggregated_flows map value). 104 bytes.
 * `lock` is a struct bpf_spin_lock in kernel builds and a plain u32 image on
 * the host side — both are exactly 4 bytes. */
struct no_flow_stats {
    __u64 first_seen_ns; /* bpf_ktime_get_ns() of first packet */
    __u64 last_seen_ns;
    __u64 bytes;
    __u32 packets;
    __u16 eth_protocol;
    __u16 tcp_flags; /* cumulative OR, incl. synthetic SYN_ACK/FIN_ACK/RST_ACK */
    __u8 src_mac[NO_ETH_ALEN];
    __u8 dst_mac[NO_ETH_ALEN];
    __u32 if_index_first;
#ifdef NO_BPF_BUILD
    struct bpf_spin_lock lock;
#else
    __u32 lock;
#endif
    __u32 sampling;
    __u8 direction_first;
    __u8 errno_fallback; /* errno of the failed map insert that forced ringbuf */
    __u8 dscp;
    __u8 n_observed_intf;
    __u8 observed_direction[NO_MAX_OBSERVED_INTERFACES];
    __u8 __pad0[2];
    __u32 observed_intf[NO_MAX_OBSERVED_INTERFACES];
    __u16 ssl_version;
    __u16 tls_cipher_suite;
    __u16 tls_key_share;
    __u8 tls_types;
    __u8 misc_flags;
    __u8 __pad1[4];
};

/* Ringbuffer fallback payload: identity + stats in one blob. 144 bytes. */
struct no_flow_event {
    struct no_flow_key key;
    struct no_flow_stats stats;
};

/* DNS correlation result (per-CPU feature map value). 64 bytes. */
struct no_dns_rec {
    __u64 first_seen_ns;
    __u64 last_seen_ns;
    __u64 latency_ns;
    __u16 dns_id;
    __u16 dns_flags;
    __u16 eth_protocol;
    __u8 errno_code;
    char name[NO_DNS_NAME_MAX_LEN];
    __u8 __pad0[1];
};

/* Packet-drop tracker record. 32 bytes. */
struct no_drops_rec {
    __u64 first_seen_ns;
    __u64 last_seen_ns;
    __u16 bytes;
    __u16 packets;
    __u32 latest_cause;
    __u16 latest_flags;
    __u16 eth_protocol;
    __u8 latest_state;
    __u8 __pad0[3];
};

/* Network-events (psample cookie) record. 72 bytes. */
struct no_nevents_rec {
    __u64 first_seen_ns;
    __u64 last_seen_ns;
    __u8 events[NO_MAX_NETWORK_EVENTS][NO_MAX_EVENT_MD];
    __u16 bytes[NO_MAX_NETWORK_EVENTS];
    __u16 packets[NO_MAX_NETWORK_EVENTS];
    __u16 eth_protocol;
    __u8 n_events;
    __u8 __pad0[5];
};

/* NAT translation record. 56 bytes. */
struct no_xlat_rec {
    __u64 first_seen_ns;
    __u64 last_seen_ns;
    __u8 src_ip[NO_IP_LEN];
    __u8 dst_ip[NO_IP_LEN];
    __u16 src_port;
    __u16 dst_port;
    __u16 zone_id;
    __u16 eth_protocol;
};

/* RTT + IPsec record. 32 bytes. */
struct no_extra_rec {
    __u64 first_seen_ns;
    __u64 last_seen_ns;
    __u64 rtt_ns;
    __s32 ipsec_ret;
    __u16 eth_protocol;
    __u8 ipsec_encrypted;
    __u8 __pad0[1];
};

/* QUIC record. 24 bytes. */
struct no_quic_rec {
    __u64 first_seen_ns;
    __u64 last_seen_ns;
    __u32 version;
    __u16 eth_protocol;
    __u8 seen_long_hdr;
    __u8 seen_short_hdr;
};

/* LPM filter-trie key: prefix length + 16B address (v4 mapped). 20 bytes.
 * Written by the userspace rule compiler (datapath/filter_compile.py). */
struct no_filter_key {
    __u32 prefix_len;
    __u8 ip[NO_IP_LEN];
};

/* One flow-filter rule (LPM trie value). 40 bytes.
 * Written by the userspace rule compiler; matched in bpf/filter.h. */
struct no_filter_rule {
    __u8 proto;
    __u8 icmp_type;
    __u8 icmp_code;
    __u8 direction;      /* 0 ingress, 1 egress, 255 any */
    __u8 action;         /* 0 accept, 1 reject */
    __u8 want_drops;
    __u8 peer_cidr_check;
    __u8 __pad0;
    __u16 dport_start, dport_end, dport1, dport2;
    __u16 sport_start, sport_end, sport1, sport2;
    __u16 port_start, port_end, port1, port2;
    __u16 tcp_flags;
    __u8 __pad1[2];
    __u32 sample_override;
};

/* PCA captured-packet record (packet ringbuf payload). 272 bytes. */
struct no_packet_event {
    __u32 if_index;
    __u32 pkt_len; /* original length; payload truncated at NO_MAX_PAYLOAD_SIZE */
    __u64 timestamp_ns;
    __u8 payload[NO_MAX_PAYLOAD_SIZE];
};

/* OpenSSL-uprobe plaintext event (ssl ringbuf payload). 16408 bytes. */
struct no_ssl_event {
    __u64 timestamp_ns;
    __u64 pid_tgid;
    __s32 data_len;
    __u8 ssl_type;
    __u8 __pad0[3];
    __u8 data[NO_MAX_SSL_DATA];
};

#endif /* NO_RECORDS_H */
