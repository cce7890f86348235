// records.h: the flow records the host packers (flowpack.cc) read, as
// the datapath lays them out.
//
// The port's trimmed copy of netobserv_tpu/datapath/bpf/records.h (the
// constants of lines 34-44 and the structs no_flow_key, no_flow_stats,
// no_flow_event, no_dns_rec, no_drops_rec, no_nevents_rec, no_xlat_rec,
// no_extra_rec and no_quic_rec, lines 48-171),
// for host builds only: fixed-width types, explicit padding, native byte
// order. Every struct must match the numpy dtype of the same record in
// netobserv_tpu_torch/model/binfmt.py byte for byte; the packer's loader
// checks each size at load (fp_struct_sizes) and the tests compare the
// packed regions with the Python packer's.
#ifndef NO_TORCH_RECORDS_H
#define NO_TORCH_RECORDS_H

#include <stdint.h>

#define NO_IP_LEN 16
#define NO_ETH_ALEN 6
#define NO_MAX_OBSERVED_INTERFACES 6
#define NO_MAX_NETWORK_EVENTS 4
#define NO_MAX_EVENT_MD 8
#define NO_DNS_NAME_MAX_LEN 32

/* no_flow_stats.misc_flags bits */
#define NO_MISC_SSL_MISMATCH 0x01

/* Flow identity: 5-tuple plus ICMP discriminator. IPv4 addresses are stored
 * v4-in-v6 mapped (::ffff/96). 40 bytes. */
struct no_flow_key {
    uint8_t src_ip[NO_IP_LEN];
    uint8_t dst_ip[NO_IP_LEN];
    uint16_t src_port;
    uint16_t dst_port;
    uint8_t proto;
    uint8_t icmp_type;
    uint8_t icmp_code;
    uint8_t pad0;
};

/* Base per-flow statistics. 104 bytes; `lock` is the 4-byte image of the
 * datapath's spin lock. */
struct no_flow_stats {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint64_t bytes;
    uint32_t packets;
    uint16_t eth_protocol;
    uint16_t tcp_flags;
    uint8_t src_mac[NO_ETH_ALEN];
    uint8_t dst_mac[NO_ETH_ALEN];
    uint32_t if_index_first;
    uint32_t lock;
    uint32_t sampling;
    uint8_t direction_first;
    uint8_t errno_fallback;
    uint8_t dscp;
    uint8_t n_observed_intf;
    uint8_t observed_direction[NO_MAX_OBSERVED_INTERFACES];
    uint8_t pad0[2];
    uint32_t observed_intf[NO_MAX_OBSERVED_INTERFACES];
    uint16_t ssl_version;
    uint16_t tls_cipher_suite;
    uint16_t tls_key_share;
    uint8_t tls_types;
    uint8_t misc_flags;
    uint8_t pad1[4];
};

/* Identity + stats in one record. 144 bytes. */
struct no_flow_event {
    struct no_flow_key key;
    struct no_flow_stats stats;
};

/* DNS correlation result. 64 bytes. */
struct no_dns_rec {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint64_t latency_ns;
    uint16_t dns_id;
    uint16_t dns_flags;
    uint16_t eth_protocol;
    uint8_t errno_code;
    char name[NO_DNS_NAME_MAX_LEN];
    uint8_t pad0[1];
};

/* Packet-drop tracker record. 32 bytes. */
struct no_drops_rec {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint16_t bytes;
    uint16_t packets;
    uint32_t latest_cause;
    uint16_t latest_flags;
    uint16_t eth_protocol;
    uint8_t latest_state;
    uint8_t pad0[3];
};

/* Network-events record: a wrapping ring of NO_MAX_NETWORK_EVENTS
 * metadata slots. 72 bytes. */
struct no_nevents_rec {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint8_t events[NO_MAX_NETWORK_EVENTS][NO_MAX_EVENT_MD];
    uint16_t bytes[NO_MAX_NETWORK_EVENTS];
    uint16_t packets[NO_MAX_NETWORK_EVENTS];
    uint16_t eth_protocol;
    uint8_t n_events;
    uint8_t pad0[5];
};

/* NAT translation record. 56 bytes. */
struct no_xlat_rec {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint8_t src_ip[NO_IP_LEN];
    uint8_t dst_ip[NO_IP_LEN];
    uint16_t src_port;
    uint16_t dst_port;
    uint16_t zone_id;
    uint16_t eth_protocol;
};

/* RTT + IPsec record. 32 bytes. */
struct no_extra_rec {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint64_t rtt_ns;
    int32_t ipsec_ret;
    uint16_t eth_protocol;
    uint8_t ipsec_encrypted;
    uint8_t pad0[1];
};

/* QUIC record. 24 bytes. */
struct no_quic_rec {
    uint64_t first_seen_ns;
    uint64_t last_seen_ns;
    uint32_t version;
    uint16_t eth_protocol;
    uint8_t seen_long_hdr;
    uint8_t seen_short_hdr;
};

#endif  // NO_TORCH_RECORDS_H
