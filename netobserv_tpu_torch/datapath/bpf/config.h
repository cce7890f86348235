/*
 * config.h — load-time configuration constants and global counter keys.
 *
 * Every `volatile const` below is rewritten by the loader before program load
 * (reference analog: bpf/configs.h + pkg/tracer/tracer.go:2085-2183), so
 * disabled features are dead code the verifier prunes — no runtime branches.
 * The counter enum must stay in sync with netobserv_tpu/model/flow.py
 * GlobalCounter (tests pin the Python side; the C side is the same list).
 */
#ifndef NO_CONFIG_H
#define NO_CONFIG_H

/* global counter keys (PERCPU_ARRAY index) */
enum no_counter_key {
    NO_CTR_HASHMAP_FAIL_UPDATE_FLOW = 0,
    NO_CTR_HASHMAP_FAIL_CREATE_FLOW = 1,
    NO_CTR_HASHMAP_FAIL_UPDATE_DNS = 2,
    NO_CTR_FILTER_REJECT = 3,
    NO_CTR_FILTER_ACCEPT = 4,
    NO_CTR_FILTER_NOMATCH = 5,
    NO_CTR_NETWORK_EVENTS_ERR = 6,
    NO_CTR_NETWORK_EVENTS_ERR_GROUPID_MISMATCH = 7,
    NO_CTR_NETWORK_EVENTS_ERR_UPDATE_MAP_FLOWS = 8,
    NO_CTR_NETWORK_EVENTS_GOOD = 9,
    NO_CTR_NETWORK_EVENTS_OVERFLOW = 10,
    NO_CTR_NETWORK_EVENTS_COOKIE_TOO_BIG = 11,
    NO_CTR_OBSERVED_INTF_MISSED = 12,
    NO_COUNTER_MAX = 13,
};

/* loader-rewritten knobs (names are the loader's contract) */
volatile const __u32 cfg_sampling = 0;          /* 0/1 = all packets */
volatile const __u8 cfg_trace_messages = 0;
volatile const __u8 cfg_enable_rtt = 0;
volatile const __u8 cfg_enable_dns_tracking = 0;
volatile const __u16 cfg_dns_port = 53;
volatile const __u8 cfg_enable_pkt_drops = 0;
volatile const __u8 cfg_enable_flow_filtering = 0;
volatile const __u8 cfg_enable_network_events = 0;
volatile const __u8 cfg_network_events_group_id = 0;
volatile const __u8 cfg_enable_pkt_translation = 0;
volatile const __u8 cfg_enable_ipsec = 0;
volatile const __u8 cfg_enable_tls_tracking = 0;
volatile const __u8 cfg_quic_mode = 0; /* 0 off, 1 port-443, 2 any udp */
volatile const __u8 cfg_enable_ringbuf_fallback = 0;
volatile const __u8 cfg_enable_pca = 0;

/* set when any flow-filter rule carries a per-rule sampling override: the
 * sampling gate must then run AFTER filter evaluation (which may rewrite the
 * rate); when clear, sampling gates at the very top, before parsing
 * (reference: has_filter_sampling, bpf/flows.c:160-206) */
volatile const __u8 cfg_has_sampling = 0;

#endif /* NO_CONFIG_H */
