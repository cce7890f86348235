/*
 * tls.h — passive TLS metadata extraction, inline in the TC path.
 *
 * Behavior (reference analog: bpf/tls_tracker.h): inspect TCP payload bytes
 * that look like TLS records; remember which record types were seen (bitfield
 * into no_flow_stats.tls_types), the negotiated version (including TLS 1.3
 * via the supported_versions extension in ServerHello), the cipher suite and
 * key-share group.
 */
#ifndef NO_TLS_H
#define NO_TLS_H

#include "config.h"
#include "helpers.h"
#include "parse.h"

#define TLS_REC_CHANGE_CIPHER 20
#define TLS_REC_ALERT 21
#define TLS_REC_HANDSHAKE 22
#define TLS_REC_APPDATA 23
#define TLS_REC_HEARTBEAT 24

#define TLS_HS_CLIENT_HELLO 1
#define TLS_HS_SERVER_HELLO 2

#define TLS_EXT_SUPPORTED_VERSIONS 43
#define TLS_EXT_KEY_SHARE 51

struct no_tls_meta {
    __u16 version;
    __u16 cipher_suite;
    __u16 key_share;
    __u8 types_seen; /* bit per record type, bit0=ChangeCipherSpec */
};

NO_INLINE __u8 no_tls_type_bit(__u8 rec_type) {
    switch (rec_type) {
    case TLS_REC_CHANGE_CIPHER:
        return 0x01;
    case TLS_REC_ALERT:
        return 0x02;
    case TLS_REC_HANDSHAKE:
        return 0x04;
    case TLS_REC_APPDATA:
        return 0x08;
    case TLS_REC_HEARTBEAT:
        return 0x10;
    default:
        return 0;
    }
}

NO_INLINE __u16 no_be16_at(const __u8 *p, const void *end) {
    if (p + 2 > (const __u8 *)end)
        return 0;
    return ((__u16)p[0] << 8) | p[1];
}

/* walk ServerHello extensions for supported_versions / key_share (bounded) */
NO_INLINE void no_tls_walk_extensions(const __u8 *ext, const void *end,
                                      struct no_tls_meta *meta) {
    #pragma unroll
    for (int i = 0; i < 8; i++) { /* bounded extension walk */
        if (ext + 4 > (const __u8 *)end)
            return;
        __u16 ext_type = no_be16_at(ext, end);
        __u16 ext_len = no_be16_at(ext + 2, end);
        if (ext_type == TLS_EXT_SUPPORTED_VERSIONS && ext_len >= 2)
            meta->version = no_be16_at(ext + 4, end);
        else if (ext_type == TLS_EXT_KEY_SHARE && ext_len >= 2)
            meta->key_share = no_be16_at(ext + 4, end);
        if (ext_len > 256)
            return; /* suspicious; bail */
        ext += 4 + ext_len;
    }
}

NO_INLINE void no_track_tls(const struct no_pkt *pkt,
                            struct no_tls_meta *meta) {
    if (!cfg_enable_tls_tracking || pkt->key.proto != PROTO_TCP)
        return;
    const __u8 *rec = pkt->l4_payload;
    const void *end = pkt->payload_end;
    if (!rec || rec + 5 > (const __u8 *)end)
        return;
    __u8 rec_type = rec[0];
    __u16 legacy_ver = no_be16_at(rec + 1, end);
    /* plausibility gate: record version must be SSL3.x */
    if ((legacy_ver & 0xFF00) != 0x0300)
        return;
    meta->types_seen |= no_tls_type_bit(rec_type);
    if (rec_type != TLS_REC_HANDSHAKE)
        return;
    const __u8 *hs = rec + 5;
    if (hs + 4 > (const __u8 *)end)
        return;
    __u8 hs_type = hs[0];
    if (hs_type != TLS_HS_SERVER_HELLO && hs_type != TLS_HS_CLIENT_HELLO)
        return;
    /* legacy_version(2) random(32) */
    const __u8 *p = hs + 4;
    __u16 hello_ver = no_be16_at(p, end);
    if (hello_ver && !meta->version)
        meta->version = hello_ver;
    p += 2 + 32;
    if (p + 1 > (const __u8 *)end)
        return;
    __u8 sid_len = p[0];
    if (sid_len > 32)
        return;
    p += 1 + sid_len;
    if (hs_type == TLS_HS_SERVER_HELLO) {
        meta->cipher_suite = no_be16_at(p, end);
        p += 2 /* cipher */ + 1 /* compression */;
        __u16 ext_total = no_be16_at(p, end);
        if (ext_total)
            no_tls_walk_extensions(p + 2, end, meta);
    }
}

#endif /* NO_TLS_H */
