/*
 * quic.h — QUIC detection via RFC 8999 version-independent invariants,
 * inline in the TC path (reference analog: bpf/quic_tracker.h).
 *
 * Modes (cfg_quic_mode): 0 off; 1 only UDP/443; 2 any UDP port. Long headers
 * carry the version (recorded, max-merged); short headers mark an established
 * connection.
 */
#ifndef NO_QUIC_H
#define NO_QUIC_H

#include "config.h"
#include "helpers.h"
#include "maps.h"
#include "parse.h"

#define QUIC_LONG_HDR_BIT 0x80
#define QUIC_FIXED_BIT 0x40

NO_INLINE void no_track_quic(const struct no_pkt *pkt) {
    if (!cfg_quic_mode || pkt->key.proto != PROTO_UDP)
        return;
    if (cfg_quic_mode == 1 && pkt->key.src_port != 443 &&
        pkt->key.dst_port != 443)
        return;
    const __u8 *p = pkt->l4_payload;
    const void *end = pkt->payload_end;
    if (!p || p + 5 > (const __u8 *)end)
        return;
    __u8 first = p[0];
    if (!(first & QUIC_FIXED_BIT))
        return; /* fixed bit must be set in all QUIC packets */
    __u8 is_long = first & QUIC_LONG_HDR_BIT;
    __u32 version = 0;
    if (is_long) {
        version = ((__u32)p[1] << 24) | ((__u32)p[2] << 16) |
                  ((__u32)p[3] << 8) | p[4];
        if (version == 0)
            return; /* version negotiation packets carry version 0 */
    }
    struct no_quic_rec *rec = bpf_map_lookup_elem(&flows_quic, &pkt->key);
    if (rec) {
        rec->last_seen_ns = pkt->ts_ns;
        if (version > rec->version)
            rec->version = version;
        if (is_long)
            rec->seen_long_hdr = 1;
        else
            rec->seen_short_hdr = 1;
        return;
    }
    struct no_quic_rec fresh = {
        .first_seen_ns = pkt->ts_ns,
        .last_seen_ns = pkt->ts_ns,
        .version = version,
        .eth_protocol = pkt->eth_protocol,
        .seen_long_hdr = is_long ? 1 : 0,
        .seen_short_hdr = is_long ? 0 : 1,
    };
    bpf_map_update_elem(&flows_quic, &pkt->key, &fresh, BPF_ANY);
}

#endif /* NO_QUIC_H */
