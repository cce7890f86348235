// flowpack.cc: the host side of the resident feed in C++ (host code, not
// a kernel; built with g++ by ops/kernels/_build.build_host and loaded
// with ctypes by datapath/flowpack.py): the packers of the dense, compact
// and resident feeds, the per-CPU merges and the fused drain pipeline.
//
// The port's copy of the reference's native library,
// netobserv_tpu/datapath/native/flowpack.cc: feature_markers and
// fill_feature_words (:97-139), fp_pack_dense (:140-178), the compact
// layout, is_v4_mapped and fp_pack_compact (:180-274), the FP_* layout
// constants (:95, :311-315), the fingerprint dictionary key_fp64 /
// fp_dict_* (:317-404), make_kw, rtt_code11 and lat_code16 (:406-430),
// fp_pack_resident (:432-570), the per-CPU merges fp_merge_stats ...
// fp_merge_quic with their _batch forms (:572-835),
// fp_events_from_keys_stats (:837-848) and the fused drain pipeline
// fp_pipe_* / fp_drain_to_resident (:918-1576), whose pack stage calls
// fp_pack_resident above, so there is one resident layout. CRC32C
// (:850-916) is not here: the port's kafka/wire computes its checksum in
// Python. These entries are the port's own: fp_struct_sizes and
// fp_layout_words, which the loader holds against model/binfmt's dtypes,
// the ctypes mirrors of the pipeline's structs and datapath/flowpack.py's
// layout constants; fp_dict_lookup, which the checks use to read the
// dictionary; and the one-call segment pack, fp_pack_resident_segment
// with its parked helper threads (fp_workers_new / fp_workers_free), which
// packs every region of one ring-slot image through fp_pack_resident and
// whose region loop (seg_region, seg_dispatch) the fused drain's
// pipe_pack shares.
//
// Each layout is its Python twin's (datapath/flowpack.py pack_dense,
// pack_compact, pack_resident), word for word; sketch/state's
// dense_to_arrays, compact_to_arrays and resident_to_arrays unpack them on
// the device. The merges are model/accumulate's rules and the pipeline's
// join is datapath/loader._join_keys, bit for bit. C ABI only; every
// buffer is the caller's but the pipeline's own (see its section).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#if defined(__linux__)
#include <errno.h>
#include <pthread.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>
#endif

#include "records.h"

#define FP_ABI_VERSION 4

// row width of the dense feed and of the resident spill lane
#define FP_DENSE_WORDS 20
// compact (v4) row width, and bytes 8..11 of a v4-in-v6 mapped address
#define FP_COMPACT_WORDS 10
#define FP_V4_PREFIX_WORD2 0xffff0000u
#define FP_HOT_WORDS 3
#define FP_RESIDENT_HDR 4
#define FP_NK_WORDS 11
#define FP_SLOT_MASK 0xFFFFFu
#define FP_RTT_MAX_US (0xFFu << 14)

extern "C" {

uint32_t fp_abi_version(void) { return FP_ABI_VERSION; }

// The layout constants of the three feeds, in this order: dense row words,
// compact row words, resident header words, hot row words, new-key row
// words, and the v4-mapped prefix word. Writes min(n, 6) and returns 6.
uint32_t fp_layout_words(uint32_t *out, uint32_t n) {
    const uint32_t words[6] = {FP_DENSE_WORDS, FP_COMPACT_WORDS,
                               FP_RESIDENT_HDR, FP_HOT_WORDS, FP_NK_WORDS,
                               FP_V4_PREFIX_WORD2};
    for (uint32_t i = 0; i < n && i < 6; i++) out[i] = words[i];
    return 6;
}

// Feature words 16..19 of a dense row (the spill lane's rows):
//   w16 tcp_flags | dscp << 16 | markers << 24
//       (markers: bit0 QUIC seen, bit1 NAT translation observed,
//        bit2 IPsec encrypted, bit3 IPsec error)
//   w17 drop bytes | drop packets << 16
//   w18 drop latest_cause (saturated u16) | latest_state << 16
//   w19 0
static inline uint8_t feature_markers(const struct no_extra_rec *ex,
                                      const struct no_xlat_rec *xl,
                                      const struct no_quic_rec *qc,
                                      size_t i) {
    uint8_t m = 0;
    if (qc && (qc[i].version || qc[i].seen_long_hdr || qc[i].seen_short_hdr))
        m |= 1;
    if (xl) {
        // complete translation = both endpoints observed
        bool src_set = false, dst_set = false;
        for (int b = 0; b < NO_IP_LEN; b++) {
            if (xl[i].src_ip[b]) src_set = true;
            if (xl[i].dst_ip[b]) dst_set = true;
        }
        if (src_set && dst_set) m |= 2;
    }
    if (ex && ex[i].ipsec_encrypted) m |= 4;
    if (ex && ex[i].ipsec_ret != 0) m |= 8;
    return m;
}

static inline void fill_feature_words(const struct no_flow_stats *s,
                                      const struct no_extra_rec *ex,
                                      const struct no_xlat_rec *xl,
                                      const struct no_quic_rec *qc,
                                      const struct no_drops_rec *dr,
                                      size_t i, uint32_t *w16) {
    w16[0] = (s->tcp_flags & 0xFFFFu) |
             (static_cast<uint32_t>(s->dscp & 0xFFu) << 16) |
             (static_cast<uint32_t>(feature_markers(ex, xl, qc, i)) << 24);
    w16[1] = dr ? (static_cast<uint32_t>(dr[i].bytes) |
                   (static_cast<uint32_t>(dr[i].packets) << 16))
                : 0;
    // saturate, don't mask: subsystem drop reasons carry the subsystem in
    // bits 16+, and saturation lands them in the histogram's overflow bucket
    uint32_t cause = dr ? dr[i].latest_cause : 0;
    if (cause > 0xFFFFu) cause = 0xFFFFu;
    w16[2] = dr ? (cause | (static_cast<uint32_t>(dr[i].latest_state) << 16))
                : 0;
    w16[3] = 0;
}

// Dense feed: one row of FP_DENSE_WORDS per event, batch_size rows, the
// rows past n zeroed. Row (must match sketch/state.py dense_to_arrays):
//   w0..3 src ip, w4..7 dst ip (16 bytes each, as the key holds them)
//   w8 src_port << 16 | dst_port   w9 proto << 16 | icmp_type << 8 | code
//   w10 bytes f32 bitcast   w11 packets   w12 rtt_us   w13 dns latency us
//   w14 valid (1)   w15 sampling   w16..19 fill_feature_words
void fp_pack_dense(const uint8_t *events, size_t n,
                   const uint8_t *extra, const uint8_t *dns,
                   const uint8_t *drops, const uint8_t *xlat,
                   const uint8_t *quic,
                   uint32_t *out, size_t batch_size) {
    const struct no_flow_event *ev =
        reinterpret_cast<const struct no_flow_event *>(events);
    const struct no_extra_rec *ex =
        reinterpret_cast<const struct no_extra_rec *>(extra);
    const struct no_dns_rec *dn =
        reinterpret_cast<const struct no_dns_rec *>(dns);
    const struct no_drops_rec *dr =
        reinterpret_cast<const struct no_drops_rec *>(drops);
    const struct no_xlat_rec *xl =
        reinterpret_cast<const struct no_xlat_rec *>(xlat);
    const struct no_quic_rec *qc =
        reinterpret_cast<const struct no_quic_rec *>(quic);
    for (size_t i = 0; i < n; i++) {
        const struct no_flow_key *k = &ev[i].key;
        const struct no_flow_stats *s = &ev[i].stats;
        uint32_t *row = out + i * FP_DENSE_WORDS;
        std::memcpy(row, k->src_ip, 16);      // words 0..3
        std::memcpy(row + 4, k->dst_ip, 16);  // words 4..7
        row[8] = (static_cast<uint32_t>(k->src_port) << 16) | k->dst_port;
        row[9] = (static_cast<uint32_t>(k->proto) << 16) |
                 (static_cast<uint32_t>(k->icmp_type) << 8) | k->icmp_code;
        float b = static_cast<float>(s->bytes);
        std::memcpy(&row[10], &b, 4);
        row[11] = s->packets;
        row[12] = ex ? static_cast<uint32_t>(ex[i].rtt_ns / 1000) : 0;
        row[13] = dn ? static_cast<uint32_t>(dn[i].latency_ns / 1000) : 0;
        row[14] = 1;
        row[15] = s->sampling;
        fill_feature_words(s, ex, xl, qc, dr, i, row + 16);
    }
    if (n < batch_size)
        std::memset(out + n * FP_DENSE_WORDS, 0,
                    (batch_size - n) * FP_DENSE_WORDS * sizeof(uint32_t));
}

// Compact feed: v4 flows (both addresses v4-in-v6 mapped) collapse their
// 10 key words to 4; non-v4 rows, and rows carrying drop data, go to a
// full-width (FP_DENSE_WORDS) spill lane. One flat buffer:
//   [batch_size * FP_COMPACT_WORDS compact words | spill_cap * 20 words]
// Compact row (must match sketch/state.py compact_to_arrays):
//   w0 src_v4 (key word 3)   w1 dst_v4 (key word 7)   w2 ports
//   w3 bit31 = valid, low 24 = proto << 16 | icmp_type << 8 | icmp_code
//   w4 bytes f32 bitcast     w5 packets     w6 rtt_us     w7 dns us
//   w8 sampling              w9 tcp_flags | dscp << 16 | markers << 24
// Returns the spill rows used, or -1 if they would pass spill_cap (the
// caller then packs the batch dense).
static inline bool is_v4_mapped(const uint8_t *ip16) {
    uint32_t w0, w1, w2;
    std::memcpy(&w0, ip16, 4);
    std::memcpy(&w1, ip16 + 4, 4);
    std::memcpy(&w2, ip16 + 8, 4);
    return w0 == 0 && w1 == 0 && w2 == FP_V4_PREFIX_WORD2;
}

int fp_pack_compact(const uint8_t *events, size_t n,
                    const uint8_t *extra, const uint8_t *dns,
                    const uint8_t *drops, const uint8_t *xlat,
                    const uint8_t *quic,
                    uint32_t *out, size_t batch_size, size_t spill_cap) {
    const struct no_flow_event *ev =
        reinterpret_cast<const struct no_flow_event *>(events);
    const struct no_extra_rec *ex =
        reinterpret_cast<const struct no_extra_rec *>(extra);
    const struct no_dns_rec *dn =
        reinterpret_cast<const struct no_dns_rec *>(dns);
    const struct no_drops_rec *dr =
        reinterpret_cast<const struct no_drops_rec *>(drops);
    const struct no_xlat_rec *xl =
        reinterpret_cast<const struct no_xlat_rec *>(xlat);
    const struct no_quic_rec *qc =
        reinterpret_cast<const struct no_quic_rec *>(quic);
    uint32_t *spill = out + batch_size * FP_COMPACT_WORDS;
    size_t nc = 0, ns = 0;
    for (size_t i = 0; i < n; i++) {
        const struct no_flow_key *k = &ev[i].key;
        const struct no_flow_stats *s = &ev[i].stats;
        uint32_t rtt = ex ? static_cast<uint32_t>(ex[i].rtt_ns / 1000) : 0;
        uint32_t dlat = dn ? static_cast<uint32_t>(dn[i].latency_ns / 1000) : 0;
        bool has_drops = dr && (dr[i].bytes || dr[i].packets);
        if (!has_drops && is_v4_mapped(k->src_ip) && is_v4_mapped(k->dst_ip)) {
            uint32_t *row = out + nc * FP_COMPACT_WORDS;
            std::memcpy(&row[0], k->src_ip + 12, 4);
            std::memcpy(&row[1], k->dst_ip + 12, 4);
            row[2] = (static_cast<uint32_t>(k->src_port) << 16) | k->dst_port;
            row[3] = 0x80000000u | (static_cast<uint32_t>(k->proto) << 16) |
                     (static_cast<uint32_t>(k->icmp_type) << 8) | k->icmp_code;
            float b = static_cast<float>(s->bytes);
            std::memcpy(&row[4], &b, 4);
            row[5] = s->packets;
            row[6] = rtt;
            row[7] = dlat;
            row[8] = s->sampling;
            row[9] = (s->tcp_flags & 0xFFFFu) |
                     (static_cast<uint32_t>(s->dscp & 0xFFu) << 16) |
                     (static_cast<uint32_t>(feature_markers(ex, xl, qc, i))
                      << 24);
            nc++;
        } else {
            if (ns >= spill_cap)
                return -1;
            uint32_t *row = spill + ns * FP_DENSE_WORDS;
            std::memcpy(row, k->src_ip, 16);
            std::memcpy(row + 4, k->dst_ip, 16);
            row[8] = (static_cast<uint32_t>(k->src_port) << 16) | k->dst_port;
            row[9] = (static_cast<uint32_t>(k->proto) << 16) |
                     (static_cast<uint32_t>(k->icmp_type) << 8) | k->icmp_code;
            float b = static_cast<float>(s->bytes);
            std::memcpy(&row[10], &b, 4);
            row[11] = s->packets;
            row[12] = rtt;
            row[13] = dlat;
            row[14] = 1;
            row[15] = s->sampling;
            fill_feature_words(s, ex, xl, qc, dr, i, row + 16);
            ns++;
        }
    }
    if (nc < batch_size)
        std::memset(out + nc * FP_COMPACT_WORDS, 0,
                    (batch_size - nc) * FP_COMPACT_WORDS * sizeof(uint32_t));
    if (ns < spill_cap)
        std::memset(spill + ns * FP_DENSE_WORDS, 0,
                    (spill_cap - ns) * FP_DENSE_WORDS * sizeof(uint32_t));
    return static_cast<int>(ns);
}

// The key -> slot dictionary. 16-byte entries: a 64-bit key FINGERPRINT
// instead of the 40-byte key, so a probe (once per record) touches one
// cache line. A fingerprint collision (p ~ n^2/2^65, about 1e-6 at a full
// 2^18 table) maps a new flow onto an existing slot: its records fold
// under that slot's key words, a bounded mis-attribution of the order of
// a Count-Min collision. The Python dictionary keys on the 40 bytes and
// has no such collision; that is the one place the two packers can part.
struct fp_dict_entry {
    uint64_t fp;  // 0 = empty (fingerprints of 0 are remapped to 1)
    uint32_t slot;
    uint32_t pad_;
};

struct fp_dict {
    struct fp_dict_entry *tab;
    size_t mask;  // hash table size - 1 (power of two)
    uint32_t slot_cap;
    uint32_t next_slot;
};

static inline uint64_t key_fp64(const uint32_t *kw) {
    // 40 key bytes = 5 u64 lanes; murmur-style mix per lane + finalizer
    uint64_t h = 0x9E3779B97F4A7C15ull;
    for (int i = 0; i < 5; i++) {
        uint64_t k;
        std::memcpy(&k, reinterpret_cast<const uint8_t *>(kw) + i * 8, 8);
        k *= 0xC2B2AE3D27D4EB4Full;
        k = (k << 31) | (k >> 33);
        k *= 0x9E3779B185EBCA87ull;
        h ^= k;
        h = ((h << 27) | (h >> 37)) * 5 + 0x52DCE729ull;
    }
    h ^= h >> 33;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
    h *= 0xC4CEB9FE1A85EC53ull;
    h ^= h >> 33;
    return h ? h : 1;
}

void *fp_dict_new(uint32_t slot_cap) {
    if (slot_cap == 0 || slot_cap > (FP_SLOT_MASK + 1)) return nullptr;
    size_t cap = 1;
    while (cap < static_cast<size_t>(slot_cap) * 2) cap <<= 1;
    fp_dict *d = new fp_dict;
    d->tab = new fp_dict_entry[cap]();
    d->mask = cap - 1;
    d->slot_cap = slot_cap;
    d->next_slot = 0;
    return d;
}

void fp_dict_free(void *h) {
    if (!h) return;
    fp_dict *d = static_cast<fp_dict *>(h);
    delete[] d->tab;
    delete d;
}

void fp_dict_reset(void *h) {
    fp_dict *d = static_cast<fp_dict *>(h);
    std::memset(d->tab, 0, (d->mask + 1) * sizeof(fp_dict_entry));
    d->next_slot = 0;
}

uint32_t fp_dict_count(void *h) {
    return static_cast<fp_dict *>(h)->next_slot;
}

// Find the fingerprint's hash-table index; *found says whether it's there.
static inline size_t dict_probe(const fp_dict *d, uint64_t fp, bool *found) {
    size_t i = fp & d->mask;
    for (;;) {
        const fp_dict_entry *e = &d->tab[i];
        if (!e->fp) {
            *found = false;
            return i;
        }
        if (e->fp == fp) {
            *found = true;
            return i;
        }
        i = (i + 1) & d->mask;
    }
}

// The slot of each of n keys (10 packed key words each), -1 where the
// dictionary has none.
void fp_dict_lookup(void *h, const uint32_t *kw, size_t n, int64_t *out) {
    const fp_dict *d = static_cast<const fp_dict *>(h);
    for (size_t i = 0; i < n; i++) {
        bool found;
        size_t hi = dict_probe(d, key_fp64(kw + i * 10), &found);
        out[i] = found ? static_cast<int64_t>(d->tab[hi].slot) : -1;
    }
}

static inline void make_kw(const struct no_flow_key *k, uint32_t *kw) {
    std::memcpy(kw, k->src_ip, 16);
    std::memcpy(kw + 4, k->dst_ip, 16);
    kw[8] = (static_cast<uint32_t>(k->src_port) << 16) | k->dst_port;
    kw[9] = (static_cast<uint32_t>(k->proto) << 16) |
            (static_cast<uint32_t>(k->icmp_type) << 8) | k->icmp_code;
}

static inline uint32_t rtt_code11(uint32_t rtt_us) {
    // bits 0..7 mantissa, bits 8..10 exponent; value ~= m << (2*e)
    uint32_t e = 0;
    while ((rtt_us >> (2 * e)) > 0xFFu) e++;
    return ((rtt_us >> (2 * e)) & 0xFFu) | (e << 8);
}

static inline uint32_t lat_code16(uint64_t us) {
    // bits 0..11 mantissa, bits 12..15 exponent; value ~= m << e
    uint32_t e = 0;
    while ((us >> e) > 0xFFFu && e < 15) e++;
    uint64_t m = us >> e;
    if (m > 0xFFFu) m = 0xFFFu;  // saturate at ~134s
    return static_cast<uint32_t>(m) | (e << 12);
}

// Pack events[start..n) into one resident region `out` until the hot lane
// or the spill lane fills; returns the rows consumed. Every lane's unused
// tail is zeroed, so a region equals the Python packer's (which zeroes
// the whole region first) word for word. Layout: see
// datapath/flowpack.py and sketch/state.resident_to_arrays.
int64_t fp_pack_resident(const uint8_t *events, size_t start, size_t n,
                         const uint8_t *extra, const uint8_t *dns,
                         const uint8_t *drops, const uint8_t *xlat,
                         const uint8_t *quic, void *dict_h, uint32_t *out,
                         size_t batch_size, size_t dns_cap, size_t drop_cap,
                         size_t nk_cap, size_t spill_cap) {
    fp_dict *d = static_cast<fp_dict *>(dict_h);
    const struct no_flow_event *ev =
        reinterpret_cast<const struct no_flow_event *>(events);
    const struct no_extra_rec *ex =
        reinterpret_cast<const struct no_extra_rec *>(extra);
    const struct no_dns_rec *dn =
        reinterpret_cast<const struct no_dns_rec *>(dns);
    const struct no_drops_rec *dr =
        reinterpret_cast<const struct no_drops_rec *>(drops);
    const struct no_xlat_rec *xl =
        reinterpret_cast<const struct no_xlat_rec *>(xlat);
    const struct no_quic_rec *qc =
        reinterpret_cast<const struct no_quic_rec *>(quic);
    uint32_t *hot = out + FP_RESIDENT_HDR;
    uint32_t *dnsl = hot + batch_size * FP_HOT_WORDS;
    uint32_t *dropl = dnsl + dns_cap;
    uint32_t *nkl = dropl + drop_cap * 2;
    uint32_t *spill = nkl + nk_cap * FP_NK_WORDS;
    size_t nh = 0, nd = 0, nr = 0, nk = 0, ns = 0;
    uint32_t def_sampling = start < n ? ev[start].stats.sampling : 0;

    // fingerprint lookahead: compute row i+PF's fingerprint and prefetch
    // its table line while processing row i (the probe is a random access
    // into a multi-MB table)
    enum { PF = 16 };
    uint64_t fpbuf[PF];
    for (size_t j = start; j < n && j < start + PF; j++) {
        uint32_t kwp[10];
        make_kw(&ev[j].key, kwp);
        fpbuf[j % PF] = key_fp64(kwp);
        __builtin_prefetch(&d->tab[fpbuf[j % PF] & d->mask]);
    }
    size_t i = start;
    for (; i < n && nh < batch_size; i++) {
        const struct no_flow_key *k = &ev[i].key;
        const struct no_flow_stats *s = &ev[i].stats;
        // row i's fingerprint first: its ring entry is reused for row i+PF
        uint64_t fp = fpbuf[i % PF];
        if (i + PF < n) {
            uint32_t kwp[10];
            make_kw(&ev[i + PF].key, kwp);
            fpbuf[(i + PF) % PF] = key_fp64(kwp);
            __builtin_prefetch(&d->tab[fpbuf[(i + PF) % PF] & d->mask]);
        }
        uint32_t kw[10];
        make_kw(k, kw);
        // give the key a slot through the new-key lane; a full lane or
        // dictionary routes the row to spill, and a later chunk learns it
        bool found;
        size_t hi = dict_probe(d, fp, &found);
        bool have_slot = found;
        uint32_t slot = found ? d->tab[hi].slot : 0;
        if (!found && nk < nk_cap && d->next_slot < d->slot_cap) {
            slot = d->next_slot++;
            d->tab[hi].fp = fp;
            d->tab[hi].slot = slot;
            uint32_t *row = nkl + nk * FP_NK_WORDS;
            row[0] = 0x80000000u | slot;
            std::memcpy(row + 1, kw, 40);
            nk++;
            have_slot = true;
        }
        uint32_t rtt = ex ? static_cast<uint32_t>(ex[i].rtt_ns / 1000) : 0;
        uint64_t dlat = dn ? dn[i].latency_ns / 1000 : 0;
        bool has_drops = dr && (dr[i].bytes || dr[i].packets);
        bool hot_ok = have_slot && s->packets < 0x800 &&
                      s->tcp_flags < 0x800 && s->dscp < 0x40 &&
                      s->sampling == def_sampling && rtt <= FP_RTT_MAX_US &&
                      (!dlat || nd < dns_cap) &&
                      (!has_drops || nr < drop_cap);
        if (hot_ok) {
            uint32_t *row = hot + nh * FP_HOT_WORDS;
            row[0] = 0x80000000u | (rtt_code11(rtt) << 20) | slot;
            float b = static_cast<float>(s->bytes);
            std::memcpy(&row[1], &b, 4);
            row[2] = (s->packets & 0x7FFu) |
                     (static_cast<uint32_t>(s->tcp_flags & 0x7FFu) << 11) |
                     (static_cast<uint32_t>(s->dscp & 0x3Fu) << 22) |
                     (static_cast<uint32_t>(feature_markers(ex, xl, qc, i))
                      << 28);
            if (dlat) {
                dnsl[nd++] = (static_cast<uint32_t>(nh) << 16) |
                             lat_code16(dlat);
            }
            if (has_drops) {
                uint32_t cause = dr[i].latest_cause;
                if (cause > 0xFFFFu) cause = 0xFFFFu;
                uint32_t *de = dropl + nr * 2;
                de[0] = (static_cast<uint32_t>(nh) << 16) | cause;
                de[1] = (static_cast<uint32_t>(dr[i].packets) << 16) |
                        dr[i].bytes;
                nr++;
            }
            nh++;
        } else {
            if (ns >= spill_cap) break;  // chunk full: continue from row i
            uint32_t *row = spill + ns * FP_DENSE_WORDS;
            std::memcpy(row, kw, 40);
            float b = static_cast<float>(s->bytes);
            std::memcpy(&row[10], &b, 4);
            row[11] = s->packets;
            row[12] = rtt;
            row[13] = static_cast<uint32_t>(dlat);
            row[14] = 1;
            row[15] = s->sampling;
            fill_feature_words(s, ex, xl, qc, dr, i, row + 16);
            ns++;
        }
    }
    out[0] = def_sampling;
    out[1] = static_cast<uint32_t>(nk);
    out[2] = static_cast<uint32_t>(ns);
    out[3] = static_cast<uint32_t>(nd) | (static_cast<uint32_t>(nr) << 16);
    if (nh < batch_size)
        std::memset(hot + nh * FP_HOT_WORDS, 0,
                    (batch_size - nh) * FP_HOT_WORDS * sizeof(uint32_t));
    if (nd < dns_cap)
        std::memset(dnsl + nd, 0, (dns_cap - nd) * sizeof(uint32_t));
    if (nr < drop_cap)
        std::memset(dropl + nr * 2, 0, (drop_cap - nr) * 2 * sizeof(uint32_t));
    if (nk < nk_cap)
        std::memset(nkl + nk * FP_NK_WORDS, 0,
                    (nk_cap - nk) * FP_NK_WORDS * sizeof(uint32_t));
    if (ns < spill_cap)
        std::memset(spill + ns * FP_DENSE_WORDS, 0,
                    (spill_cap - ns) * FP_DENSE_WORDS * sizeof(uint32_t));
    return static_cast<int64_t>(i - start);
}

static inline void merge_times(uint64_t *dfirst, uint64_t *dlast,
                               uint64_t sfirst, uint64_t slast) {
    if (*dfirst == 0 || (sfirst != 0 && sfirst < *dfirst))
        *dfirst = sfirst;
    if (slast > *dlast)
        *dlast = slast;
}

static inline uint16_t sat_add16(uint16_t a, uint16_t b) {
    uint32_t s = static_cast<uint32_t>(a) + b;
    return s > 0xFFFF ? 0xFFFF : static_cast<uint16_t>(s);
}

// Merge per-CPU partials of the base stats struct.
// values: n_cpu consecutive no_flow_stats images for ONE map entry.
// out: one no_flow_stats. Mirrors model/accumulate.py accumulate_base.
void fp_merge_stats(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_flow_stats out;
    std::memcpy(&out, values, sizeof(out));
    // the datapath's lock-free slot reservation can leave the counter
    // TRANSIENTLY above capacity (saturation undo in flight) — clamp before
    // any indexing
    if (out.n_observed_intf > NO_MAX_OBSERVED_INTERFACES)
        out.n_observed_intf = NO_MAX_OBSERVED_INTERFACES;
    const struct no_flow_stats *v =
        reinterpret_cast<const struct no_flow_stats *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_flow_stats *s = &v[c];
        bool dst_empty = out.first_seen_ns == 0 && out.packets == 0;
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        uint64_t nb = out.bytes + s->bytes;
        out.bytes = nb < out.bytes ? UINT64_MAX : nb;  // saturate on wrap
        uint64_t np = static_cast<uint64_t>(out.packets) + s->packets;
        out.packets = np > UINT32_MAX ? UINT32_MAX
                                      : static_cast<uint32_t>(np);
        out.tcp_flags |= s->tcp_flags;
        if (s->eth_protocol) out.eth_protocol = s->eth_protocol;
        if (s->dscp) out.dscp = s->dscp;
        if (s->sampling) out.sampling = s->sampling;
        if (s->errno_fallback) out.errno_fallback = s->errno_fallback;
        bool src_mac_zero = true, dst_mac_zero = true;
        for (int i = 0; i < NO_ETH_ALEN; i++) {
            if (out.src_mac[i]) src_mac_zero = false;
            if (out.dst_mac[i]) dst_mac_zero = false;
        }
        if (src_mac_zero) std::memcpy(out.src_mac, s->src_mac, NO_ETH_ALEN);
        if (dst_mac_zero) std::memcpy(out.dst_mac, s->dst_mac, NO_ETH_ALEN);
        if (dst_empty) {
            out.if_index_first = s->if_index_first;
            out.direction_first = s->direction_first;
        }
        // ssl_version: first non-zero wins; a conflicting later version sets
        // the mismatch flag (mirrors accumulate_base / kernel entry rule)
        if (s->ssl_version) {
            if (out.ssl_version == 0)
                out.ssl_version = s->ssl_version;
            else if (out.ssl_version != s->ssl_version)
                out.misc_flags |= NO_MISC_SSL_MISMATCH;
        }
        if (s->tls_cipher_suite) out.tls_cipher_suite = s->tls_cipher_suite;
        if (s->tls_key_share) out.tls_key_share = s->tls_key_share;
        out.tls_types |= s->tls_types;
        out.misc_flags |= s->misc_flags;
        int ns_obs = s->n_observed_intf > NO_MAX_OBSERVED_INTERFACES
                         ? NO_MAX_OBSERVED_INTERFACES
                         : s->n_observed_intf;
        for (int j = 0; j < ns_obs; j++) {
            bool seen = false;
            for (int i = 0; i < out.n_observed_intf; i++) {
                if (out.observed_intf[i] == s->observed_intf[j] &&
                    out.observed_direction[i] == s->observed_direction[j]) {
                    seen = true;
                    break;
                }
            }
            if (!seen && out.n_observed_intf < NO_MAX_OBSERVED_INTERFACES) {
                out.observed_intf[out.n_observed_intf] = s->observed_intf[j];
                out.observed_direction[out.n_observed_intf] =
                    s->observed_direction[j];
                out.n_observed_intf++;
            }
        }
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// Merge per-CPU partials of the extra (rtt/ipsec) record.
void fp_merge_extra(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_extra_rec out;
    std::memcpy(&out, values, sizeof(out));
    const struct no_extra_rec *v =
        reinterpret_cast<const struct no_extra_rec *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_extra_rec *s = &v[c];
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        if (s->rtt_ns > out.rtt_ns) out.rtt_ns = s->rtt_ns;
        if (out.ipsec_ret < s->ipsec_ret) {
            out.ipsec_ret = s->ipsec_ret;
            out.ipsec_encrypted = s->ipsec_encrypted;
        } else if (out.ipsec_ret == s->ipsec_ret && s->ipsec_encrypted) {
            out.ipsec_encrypted = s->ipsec_encrypted;
        }
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// Merge per-CPU partials of the drops record.
void fp_merge_drops(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_drops_rec out;
    std::memcpy(&out, values, sizeof(out));
    const struct no_drops_rec *v =
        reinterpret_cast<const struct no_drops_rec *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_drops_rec *s = &v[c];
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        out.bytes = sat_add16(out.bytes, s->bytes);
        out.packets = sat_add16(out.packets, s->packets);
        out.latest_flags |= s->latest_flags;
        if (s->latest_cause) out.latest_cause = s->latest_cause;
        if (s->latest_state) out.latest_state = s->latest_state;
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// Merge per-CPU partials of the DNS record (max latency wins).
void fp_merge_dns(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_dns_rec out;
    std::memcpy(&out, values, sizeof(out));
    const struct no_dns_rec *v =
        reinterpret_cast<const struct no_dns_rec *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_dns_rec *s = &v[c];
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        out.dns_flags |= s->dns_flags;
        if (s->dns_id) out.dns_id = s->dns_id;
        if (out.errno_code != s->errno_code) out.errno_code = s->errno_code;
        if (s->latency_ns > out.latency_ns) out.latency_ns = s->latency_ns;
        if (s->name[0]) std::memcpy(out.name, s->name, NO_DNS_NAME_MAX_LEN);
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// Merge per-CPU partials of the network-events record: dedup-append into a
// wrapping ring of NO_MAX_NETWORK_EVENTS slots (n_events is the ring CURSOR,
// not a count — renderers scan slots keyed on packets[i] != 0). Mirrors
// model/accumulate.py accumulate_network_events.
void fp_merge_nevents(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_nevents_rec out;
    std::memcpy(&out, values, sizeof(out));
    const struct no_nevents_rec *v =
        reinterpret_cast<const struct no_nevents_rec *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_nevents_rec *s = &v[c];
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        uint8_t idx = out.n_events % NO_MAX_NETWORK_EVENTS;
        for (int j = 0; j < NO_MAX_NETWORK_EVENTS; j++) {
            if (s->packets[j] == 0)
                continue;
            bool dup = false;
            for (int i = 0; i < NO_MAX_NETWORK_EVENTS; i++) {
                if (std::memcmp(out.events[i], s->events[j],
                                NO_MAX_EVENT_MD) == 0) {
                    dup = true;
                    break;
                }
            }
            if (!dup) {
                std::memcpy(out.events[idx], s->events[j], NO_MAX_EVENT_MD);
                out.bytes[idx] = sat_add16(out.bytes[idx], s->bytes[j]);
                out.packets[idx] = sat_add16(out.packets[idx], s->packets[j]);
                idx = (idx + 1) % NO_MAX_NETWORK_EVENTS;
            }
        }
        out.n_events = idx;
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// Merge per-CPU partials of the NAT-translation record: a complete
// (both-endpoints) observation replaces. Mirrors accumulate_xlat.
void fp_merge_xlat(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_xlat_rec out;
    std::memcpy(&out, values, sizeof(out));
    const struct no_xlat_rec *v =
        reinterpret_cast<const struct no_xlat_rec *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_xlat_rec *s = &v[c];
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        bool src_set = false, dst_set = false;
        for (int i = 0; i < NO_IP_LEN; i++) {
            if (s->src_ip[i]) src_set = true;
            if (s->dst_ip[i]) dst_set = true;
        }
        if (src_set && dst_set) {
            std::memcpy(out.src_ip, s->src_ip, NO_IP_LEN);
            std::memcpy(out.dst_ip, s->dst_ip, NO_IP_LEN);
            out.src_port = s->src_port;
            out.dst_port = s->dst_port;
            out.zone_id = s->zone_id;
        }
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// Merge per-CPU partials of the QUIC record: max version wins, header-seen
// flags accumulate. Mirrors accumulate_quic.
void fp_merge_quic(const uint8_t *values, size_t n_cpu, uint8_t *out_buf) {
    struct no_quic_rec out;
    std::memcpy(&out, values, sizeof(out));
    const struct no_quic_rec *v =
        reinterpret_cast<const struct no_quic_rec *>(values);
    for (size_t c = 1; c < n_cpu; c++) {
        const struct no_quic_rec *s = &v[c];
        merge_times(&out.first_seen_ns, &out.last_seen_ns,
                    s->first_seen_ns, s->last_seen_ns);
        if (s->version > out.version) out.version = s->version;
        if (s->seen_long_hdr > out.seen_long_hdr)
            out.seen_long_hdr = s->seen_long_hdr;
        if (s->seen_short_hdr > out.seen_short_hdr)
            out.seen_short_hdr = s->seen_short_hdr;
    }
    std::memcpy(out_buf, &out, sizeof(out));
}

// ---------------------------------------------------------------------------
// Batched per-CPU merges: one call for ALL keys of a drained feature map.
// values: n_keys * n_cpu consecutive record images (the kernel's
// LOOKUP_AND_DELETE_BATCH value buffer, padding already stripped/absent —
// every record struct here is 8-byte-aligned so the per-CPU stride equals
// sizeof); out: n_keys records. One ctypes round trip replaces n_keys of
// them (columnar Python twin: model/accumulate.py COLUMNAR_MERGES; held
// against it and the reference's in tests/test_torch_evict_chain.py).
// ---------------------------------------------------------------------------
#define FP_MERGE_BATCH(name, type)                                          \
    void name##_batch(const uint8_t *values, size_t n_keys, size_t n_cpu,   \
                      uint8_t *out) {                                       \
        for (size_t k = 0; k < n_keys; k++)                                 \
            name(values + k * n_cpu * sizeof(type), n_cpu,                  \
                 out + k * sizeof(type));                                   \
    }

FP_MERGE_BATCH(fp_merge_stats, struct no_flow_stats)
FP_MERGE_BATCH(fp_merge_extra, struct no_extra_rec)
FP_MERGE_BATCH(fp_merge_drops, struct no_drops_rec)
FP_MERGE_BATCH(fp_merge_dns, struct no_dns_rec)
FP_MERGE_BATCH(fp_merge_nevents, struct no_nevents_rec)
FP_MERGE_BATCH(fp_merge_xlat, struct no_xlat_rec)
FP_MERGE_BATCH(fp_merge_quic, struct no_quic_rec)

// ---------------------------------------------------------------------------
// FLOW_EVENT interleave: compose contiguous no_flow_event rows (key 40B |
// stats 104B) from the two columns a batched map drain yields — the columnar
// eviction plane's single copy boundary done as one native pass instead of
// two strided numpy field assignments (Python twin:
// model/binfmt.py events_from_keys_stats). `out` must hold n events; tail
// rows beyond n (the loader's orphan appendix) are the caller's to zero.
// ---------------------------------------------------------------------------
void fp_events_from_keys_stats(const uint8_t *keys, const uint8_t *stats,
                               size_t n, uint8_t *out) {
    for (size_t i = 0; i < n; i++) {
        struct no_flow_event *ev =
            reinterpret_cast<struct no_flow_event *>(
                out + i * sizeof(struct no_flow_event));
        std::memcpy(&ev->key, keys + i * sizeof(struct no_flow_key),
                    sizeof(struct no_flow_key));
        std::memcpy(&ev->stats, stats + i * sizeof(struct no_flow_stats),
                    sizeof(struct no_flow_stats));
    }
}


// ===========================================================================
// Fused one-call eviction pipeline (fp_drain_to_resident). ONE native call
// owns the whole host chain of a drain: batched bpf(2) lookup-and-delete
// over every map, per-CPU columnar merge, hash-sort key join (the
// loader._join_keys twin), feature alignment, and — optionally — the direct
// resident-region pack replicating ShardedResidentStagingRing._fold_chunk.
// The call releases the GIL for its whole duration (ctypes), so drain lanes
// scale with cores instead of re-entering the interpreter between stages.
//
// SCHEDULING ONLY: the merge semantics are the very fp_merge_*_batch calls
// above (never a fifth merge form), the pack is the very fp_pack_resident
// above (never a fourth resident layout), and the join replicates
// loader._join_keys bit-exactly (stable hash sort, collision fallback to the
// lexicographic order, orphan appendix in sorted-group order, last-agg-row
// match). tests/test_torch_native_pipeline.py holds the fused output
// against the Python-orchestrated chain (datapath/loader.decode_eviction).
//
// Buffer ownership: per-map drain scratch, merged/aligned arrays, the event
// compose buffer and the chunk table live in the fp_pipe handle and are
// valid until the next fp_drain_to_resident call (the caller copies at the
// EvictedFlows boundary — the cached-buffer lifetime rule of a batched
// map drain). The packed arena is malloc'd fresh per call and
// ownership passes to the caller (fp_buf_free) because packed regions may
// outlive the next drain in the overlap handoff.
// ===========================================================================

enum {
    FPK_STATS = 0, FPK_EXTRA = 1, FPK_DNS = 2, FPK_DROPS = 3,
    FPK_NEVENTS = 4, FPK_XLAT = 5, FPK_QUIC = 6,
};

#define FP_PIPE_MAX_MAPS 8
#define FP_PIPE_MAX_LADDER 8
#define FP_BPF_LOOKUP_AND_DELETE_BATCH 25

#if defined(__linux__)
#if defined(SYS_bpf)
#define FP_SYS_BPF SYS_bpf
#elif defined(__x86_64__)
#define FP_SYS_BPF 321
#elif defined(__aarch64__) || defined(__riscv)
#define FP_SYS_BPF 280
#elif defined(__powerpc64__)
#define FP_SYS_BPF 361
#elif defined(__s390x__)
#define FP_SYS_BPF 351
#endif
#endif

struct fp_pipe_map_cfg {
    int32_t fd;            // >= 0: drain via batched bpf(2); < 0: injected
    uint32_t kind;         // FPK_*
    uint32_t value_size;   // sizeof record struct (8-aligned)
    uint32_t n_cpus;       // per-CPU images per entry (1 = plain map)
    uint32_t max_entries;  // drain capacity bound
};

struct fp_pipe_ladder {
    uint32_t k;             // superbatch ladder entry
    uint32_t nr;            // regions per k-chunk (n_shards * k * lanes)
    const uint64_t *dicts;  // [nr] fp_dict handles (ring.kdicts mapping)
};

struct fp_pipe_pack_cfg {
    uint32_t n_ladder, batch_size, batch_per_region, slot_cap;
    uint32_t dns_cap, drop_cap, nk_cap, spill_cap;
    struct fp_pipe_ladder ladder[FP_PIPE_MAX_LADDER];  // ascending k; [0].k==1
};

struct fp_pipe_chunk {
    uint64_t row_start;   // first event row of this chunk
    uint64_t rows;        // rows packed by this chunk
    uint64_t arena_off;   // word offset of the chunk's first segment
    uint32_t k, n_segs, spills, resets;
};

struct fp_pipe_result {
    uint64_t n_events, n_agg, n_orphans, packed_rows;
    uint64_t drain_ns, merge_ns, join_ns, pack_ns;   // drain/merge: summed lane CPU
    uint64_t syscalls, lex_fallback, batch_err_mask, n_chunks;
    uint64_t arena_words, spill_rows, dict_resets, segs;
    const uint8_t *events;               // [n_events] no_flow_event (handle-owned)
    uint32_t *arena;                     // packed regions (caller frees: fp_buf_free)
    const struct fp_pipe_chunk *chunks;  // [n_chunks] (handle-owned)
    const uint8_t *aligned[FP_PIPE_MAX_MAPS];  // per map; NULL when absent/empty
    uint64_t map_rows[FP_PIPE_MAX_MAPS];       // drained rows per map
};

struct fp_pipe_buf {
    uint8_t *p;
    size_t cap;
};

static int pipe_reserve(struct fp_pipe_buf *b, size_t need) {
    if (need == 0 || b->cap >= need)
        return 0;
    size_t cap = b->cap ? b->cap : 4096;
    while (cap < need)
        cap *= 2;
    uint8_t *np = static_cast<uint8_t *>(realloc(b->p, cap));
    if (!np)
        return -1;
    b->p = np;
    b->cap = cap;
    return 0;
}

struct fp_pipe_map_state {
    int32_t fd;
    uint32_t kind, value_size, n_cpus, max_entries;
    struct fp_pipe_buf keys, vals, merged, aligned;
    uint32_t n;       // drained rows this call (injected rows when fd < 0)
    int32_t err;      // last drain/merge errno (0 = ok)
    uint64_t drain_ns, merge_ns, syscalls;
    uint8_t tok_a[64], tok_b[64];  // batch iteration tokens (>= key size)
};

struct fp_pipe {
    uint32_t n_maps, lanes;
    struct fp_pipe_map_state maps[FP_PIPE_MAX_MAPS];
    struct fp_pipe_buf events, join;
    struct fp_pipe_chunk *chunks;
    size_t chunks_cap;
};

static uint64_t pipe_now_ns(void) {
#if defined(__linux__)
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
           static_cast<uint64_t>(ts.tv_nsec);
#else
    return 0;
#endif
}

void *fp_pipe_new(const struct fp_pipe_map_cfg *cfgs, uint32_t n_maps,
                  uint32_t lanes) {
    if (!cfgs || n_maps == 0 || n_maps > FP_PIPE_MAX_MAPS)
        return NULL;
    if (cfgs[0].kind != FPK_STATS || cfgs[0].n_cpus != 1)
        return NULL;  // map 0 is the aggregation map, used verbatim
    for (uint32_t i = 0; i < n_maps; i++) {
        if (cfgs[i].kind > FPK_QUIC || cfgs[i].n_cpus == 0 ||
            cfgs[i].max_entries == 0 || cfgs[i].value_size == 0 ||
            cfgs[i].value_size % 8 != 0)  // padded stride == struct size
            return NULL;
    }
    struct fp_pipe *p =
        static_cast<struct fp_pipe *>(calloc(1, sizeof(struct fp_pipe)));
    if (!p)
        return NULL;
    p->n_maps = n_maps;
    p->lanes = lanes ? lanes : 1;
    for (uint32_t i = 0; i < n_maps; i++) {
        p->maps[i].fd = cfgs[i].fd;
        p->maps[i].kind = cfgs[i].kind;
        p->maps[i].value_size = cfgs[i].value_size;
        p->maps[i].n_cpus = cfgs[i].n_cpus;
        p->maps[i].max_entries = cfgs[i].max_entries;
    }
    return p;
}

void fp_pipe_free(void *h) {
    if (!h)
        return;
    struct fp_pipe *p = static_cast<struct fp_pipe *>(h);
    for (uint32_t i = 0; i < p->n_maps; i++) {
        free(p->maps[i].keys.p);
        free(p->maps[i].vals.p);
        free(p->maps[i].merged.p);
        free(p->maps[i].aligned.p);
    }
    free(p->events.p);
    free(p->join.p);
    free(p->chunks);
    free(p);
}

void fp_buf_free(void *ptr) { free(ptr); }

// Injection for fd < 0 maps (tests and the smoke drive): pre-load one drain's (keys, vals)
// as if the batched syscall had produced them. vals layout is the kernel's:
// n rows x n_cpus images x value_size bytes, contiguous.
int fp_pipe_set_drained(void *h, uint32_t idx, const uint8_t *keys,
                        const uint8_t *vals, uint32_t n) {
    struct fp_pipe *p = static_cast<struct fp_pipe *>(h);
    if (!p || idx >= p->n_maps || p->maps[idx].fd >= 0)
        return -1;
    struct fp_pipe_map_state *m = &p->maps[idx];
    size_t ks = sizeof(struct no_flow_key);
    size_t vstride = static_cast<size_t>(m->value_size) * m->n_cpus;
    if (pipe_reserve(&m->keys, n * ks) || pipe_reserve(&m->vals, n * vstride))
        return -1;
    if (n) {
        std::memcpy(m->keys.p, keys, n * ks);
        std::memcpy(m->vals.p, vals, n * vstride);
    }
    m->n = n;
    return 0;
}

// One map's batched lookup-and-delete loop (the reference's
// syscall_bpf drain_batched_arrays: the same attr layout, token handoff
// and partial-round banking). The
// caller pre-probed batch support through the Python chain's first drain,
// so a hard error here is recorded, never retried per-key.
static void pipe_drain_map(struct fp_pipe_map_state *m) {
    m->err = 0;
    m->syscalls = 0;
    if (m->fd < 0)
        return;  // injected rows (fp_pipe_set_drained) stay as-is
    m->n = 0;
#if defined(__linux__) && defined(FP_SYS_BPF)
    const size_t ks = sizeof(struct no_flow_key);
    const size_t vstride = static_cast<size_t>(m->value_size) * m->n_cpus;
    if (pipe_reserve(&m->keys, static_cast<size_t>(m->max_entries) * ks) ||
        pipe_reserve(&m->vals, static_cast<size_t>(m->max_entries) * vstride)) {
        m->err = ENOMEM;
        return;
    }
    struct {
        uint64_t in_batch, out_batch, keys, values;
        uint32_t count, map_fd;
        uint64_t elem_flags, flags;
    } attr;
    bool first = true;
    uint32_t total = 0;
    while (total < m->max_entries) {
        std::memset(&attr, 0, sizeof(attr));
        attr.in_batch =
            first ? 0 : static_cast<uint64_t>(reinterpret_cast<uintptr_t>(m->tok_a));
        attr.out_batch =
            static_cast<uint64_t>(reinterpret_cast<uintptr_t>(m->tok_b));
        attr.keys = static_cast<uint64_t>(
            reinterpret_cast<uintptr_t>(m->keys.p + static_cast<size_t>(total) * ks));
        attr.values = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(
            m->vals.p + static_cast<size_t>(total) * vstride));
        attr.count = m->max_entries - total;
        attr.map_fd = static_cast<uint32_t>(m->fd);
        long rc = syscall(FP_SYS_BPF, FP_BPF_LOOKUP_AND_DELETE_BATCH, &attr,
                          static_cast<unsigned long>(sizeof(attr)));
        int err = rc < 0 ? errno : 0;
        m->syscalls++;
        if (rc == 0 || err == ENOENT) {
            total += attr.count;  // partial counts on ENOENT are valid
        } else {
            m->err = err;  // keep banked rounds: their entries are deleted
            break;
        }
        if (rc < 0 || attr.count == 0)
            break;  // drained to empty
        std::memcpy(m->tok_a, m->tok_b, sizeof(m->tok_a));
        first = false;
    }
    m->n = total;
#else
    m->err = 38;  // ENOSYS: no bpf(2) on this platform — fd<0 mode only
#endif
}

static void pipe_merge_map(struct fp_pipe_map_state *m) {
    if (m->kind == FPK_STATS || m->n == 0)
        return;  // aggregation rows are used verbatim (no per-CPU images)
    size_t need = static_cast<size_t>(m->n) * m->value_size;
    if (pipe_reserve(&m->merged, need)) {
        m->err = ENOMEM;
        return;
    }
    switch (m->kind) {
    case FPK_EXTRA:
        fp_merge_extra_batch(m->vals.p, m->n, m->n_cpus, m->merged.p);
        break;
    case FPK_DNS:
        fp_merge_dns_batch(m->vals.p, m->n, m->n_cpus, m->merged.p);
        break;
    case FPK_DROPS:
        fp_merge_drops_batch(m->vals.p, m->n, m->n_cpus, m->merged.p);
        break;
    case FPK_NEVENTS:
        fp_merge_nevents_batch(m->vals.p, m->n, m->n_cpus, m->merged.p);
        break;
    case FPK_XLAT:
        fp_merge_xlat_batch(m->vals.p, m->n, m->n_cpus, m->merged.p);
        break;
    case FPK_QUIC:
        fp_merge_quic_batch(m->vals.p, m->n, m->n_cpus, m->merged.p);
        break;
    default:
        break;
    }
}

static void pipe_run_map(struct fp_pipe_map_state *m) {
    uint64_t t0 = pipe_now_ns();
    pipe_drain_map(m);
    uint64_t t1 = pipe_now_ns();
    pipe_merge_map(m);
    m->drain_ns = t1 - t0;
    m->merge_ns = pipe_now_ns() - t1;
}

#if defined(__linux__)
struct fp_pipe_job {
    struct fp_pipe *p;
    uint32_t next;
    pthread_mutex_t mu;
};

static void *pipe_worker(void *arg) {
    struct fp_pipe_job *job = static_cast<struct fp_pipe_job *>(arg);
    for (;;) {
        pthread_mutex_lock(&job->mu);
        uint32_t i = job->next++;
        pthread_mutex_unlock(&job->mu);
        if (i >= job->p->n_maps)
            return NULL;
        pipe_run_map(&job->p->maps[i]);
    }
}
#endif

// loader._hash_keys_u64 twin: the join's pre-sort hash over the 5 key words.
static inline uint64_t pipe_key_hash(const uint8_t *k) {
    uint64_t w[5];
    std::memcpy(w, k, sizeof(w));
    uint64_t h = w[0];
    for (int i = 1; i < 5; i++) {
        h = (h ^ (w[i] * 0xC2B2AE3D27D4EB4FULL)) * 0x9E3779B97F4A7C15ULL;
        h ^= h >> 29;  // per-round mix, exactly like the numpy twin
    }
    return h;
}

// ===========================================================================
// One-call segment pack (fp_pack_resident_segment): one ring-slot image of
// nr regions, each fp_pack_resident above against its own dictionary, the
// regions spread over worker threads that take them through an atomic
// next-region index (a host that lends fewer cores than workers only slows
// the call). The raw fold's pack (sketch/staging.py
// ShardedResidentStagingRing._fold_chunk) makes one such call a segment,
// the interpreter lock released once; the fused drain's pipe_pack below
// runs the same region loop in its calling thread.
// ===========================================================================

struct fp_seg {
    // the chunk's bases (row 0 of region 0); absent lanes are NULL
    const uint8_t *events, *extra, *dns, *drops, *xlat, *quic;
    const uint64_t *bounds;  // [nr + 1] row bounds of the regions
    const uint64_t *dicts;   // [nr] fp_dict handles
    uint64_t *starts;        // [nr] rows each region consumed so far
    uint32_t *out;           // nr regions of region_words
    int64_t *stats;          // [nr][4] rows consumed, spill rows, reset, ns
    size_t region_words;
    uint32_t nr, batch_size, dns_cap, drop_cap, nk_cap, spill_cap, slot_cap;
    bool full_zero;  // mask an exhausted region by a full memset
    std::atomic<uint32_t> next;
    std::atomic<int64_t> err;
};

static size_t region_words_of(uint32_t batch_size, uint32_t dns_cap,
                              uint32_t drop_cap, uint32_t nk_cap,
                              uint32_t spill_cap) {
    return FP_RESIDENT_HDR + static_cast<size_t>(batch_size) * FP_HOT_WORDS +
           dns_cap + static_cast<size_t>(drop_cap) * 2 +
           static_cast<size_t>(nk_cap) * FP_NK_WORDS +
           static_cast<size_t>(spill_cap) * FP_DENSE_WORDS;
}

// datapath/flowpack.zero_resident_region: zero only the words the device
// unpack reads as validity gates (header, hot word 0, the sparse lanes,
// new-key word 0, spill word 14)
static void mask_region(uint32_t *out, size_t batch_size, size_t dns_cap,
                        size_t drop_cap, size_t nk_cap, size_t spill_cap) {
    std::memset(out, 0, FP_RESIDENT_HDR * sizeof(uint32_t));
    uint32_t *hot = out + FP_RESIDENT_HDR;
    for (size_t r = 0; r < batch_size; r++) hot[r * FP_HOT_WORDS] = 0;
    uint32_t *dnsl = hot + batch_size * FP_HOT_WORDS;
    std::memset(dnsl, 0, (dns_cap + drop_cap * 2) * sizeof(uint32_t));
    uint32_t *nkl = dnsl + dns_cap + drop_cap * 2;
    for (size_t r = 0; r < nk_cap; r++) nkl[r * FP_NK_WORDS] = 0;
    uint32_t *spill = nkl + nk_cap * FP_NK_WORDS;
    for (size_t r = 0; r < spill_cap; r++) spill[r * FP_DENSE_WORDS + 14] = 0;
}

static inline const uint8_t *lane_at(const uint8_t *base, uint64_t row,
                                     size_t size) {
    return base ? base + row * size : NULL;
}

// Region i of the segment: the per-region epoch roll when its dictionary
// is at slot_cap and the pack, or the mask of a region already exhausted.
static void seg_region(struct fp_seg *s, uint32_t i) {
    int64_t *st = s->stats + 4 * static_cast<size_t>(i);
    uint32_t *region = s->out + i * s->region_words;
    const uint64_t lo = s->bounds[i], len = s->bounds[i + 1] - lo;
    st[0] = st[1] = st[2] = st[3] = 0;
    if (s->starts[i] >= len) {
        // an exhausted region of a continuation segment ships empty, and
        // its dictionary's epoch stays
        if (s->full_zero)
            std::memset(region, 0, s->region_words * sizeof(uint32_t));
        else
            mask_region(region, s->batch_size, s->dns_cap, s->drop_cap,
                        s->nk_cap, s->spill_cap);
        return;
    }
    const uint64_t t0 = pipe_now_ns();
    fp_dict *d =
        reinterpret_cast<fp_dict *>(static_cast<uintptr_t>(s->dicts[i]));
    if (d->next_slot >= s->slot_cap) {
        fp_dict_reset(d);  // per-region epoch roll
        st[2] = 1;
    }
    const int64_t consumed = fp_pack_resident(
        lane_at(s->events, lo, sizeof(struct no_flow_event)), s->starts[i],
        len, lane_at(s->extra, lo, sizeof(struct no_extra_rec)),
        lane_at(s->dns, lo, sizeof(struct no_dns_rec)),
        lane_at(s->drops, lo, sizeof(struct no_drops_rec)),
        lane_at(s->xlat, lo, sizeof(struct no_xlat_rec)),
        lane_at(s->quic, lo, sizeof(struct no_quic_rec)), d, region,
        s->batch_size, s->dns_cap, s->drop_cap, s->nk_cap, s->spill_cap);
    if (consumed <= 0) {
        s->err.store(-3);  // no progress: caps violate the guarantee
        return;
    }
    s->starts[i] += static_cast<uint64_t>(consumed);
    st[0] = consumed;
    st[1] = region[2];
    st[3] = static_cast<int64_t>(pipe_now_ns() - t0);
}

static void seg_run(struct fp_seg *s) {
    for (;;) {
        const uint32_t i = s->next.fetch_add(1);
        if (i >= s->nr) return;
        seg_region(s, i);
    }
}

#define FP_MAX_WORKERS 64

#if defined(__linux__)
// Parked helper threads of the segment pack (fp_workers_new): started by
// the first call that wants them, asleep on `go` between calls. One call
// at a time uses them; a call that finds them busy runs in its own thread.
struct fp_workers {
    pthread_mutex_t mu;
    pthread_cond_t go, done;
    pthread_t tids[FP_MAX_WORKERS];
    uint32_t n_threads;             // helpers started
    uint64_t gen;                   // calls handed out
    struct fp_seg *job;             // the open call's segment, or NULL
    uint32_t want, joined, active;  // helpers the call wants, took, working
    bool busy, stop;
};

static void *seg_worker(void *arg) {
    struct fp_workers *w = static_cast<struct fp_workers *>(arg);
    uint64_t seen = 0;
    pthread_mutex_lock(&w->mu);
    for (;;) {
        while (!w->stop &&
               (!w->job || w->gen == seen || w->joined >= w->want))
            pthread_cond_wait(&w->go, &w->mu);
        if (w->stop) break;
        seen = w->gen;
        struct fp_seg *s = w->job;
        w->joined++;
        w->active++;
        pthread_mutex_unlock(&w->mu);
        seg_run(s);
        pthread_mutex_lock(&w->mu);
        if (--w->active == 0) pthread_cond_signal(&w->done);
    }
    pthread_mutex_unlock(&w->mu);
    return NULL;
}
#endif

void *fp_workers_new(void) {
#if defined(__linux__)
    struct fp_workers *w = new fp_workers();
    pthread_mutex_init(&w->mu, NULL);
    pthread_cond_init(&w->go, NULL);
    pthread_cond_init(&w->done, NULL);
    return w;
#else
    return NULL;
#endif
}

void fp_workers_free(void *h) {
#if defined(__linux__)
    struct fp_workers *w = static_cast<struct fp_workers *>(h);
    if (!w) return;
    pthread_mutex_lock(&w->mu);
    w->stop = true;
    pthread_cond_broadcast(&w->go);
    pthread_mutex_unlock(&w->mu);
    for (uint32_t t = 0; t < w->n_threads; t++) pthread_join(w->tids[t], NULL);
    pthread_cond_destroy(&w->done);
    pthread_cond_destroy(&w->go);
    pthread_mutex_destroy(&w->mu);
    delete w;
#else
    (void)h;
#endif
}

// Run the segment's regions over min(n_workers, nr) threads: the caller
// and parked helpers of `workers`; with one, or no `workers`, the caller.
static void seg_dispatch(struct fp_seg *s, void *workers,
                         uint32_t n_workers) {
    s->next.store(0);
    s->err.store(0);
    if (n_workers > s->nr) n_workers = s->nr;
#if defined(__linux__)
    struct fp_workers *w = static_cast<struct fp_workers *>(workers);
    if (w && n_workers > 1) {
        pthread_mutex_lock(&w->mu);
        if (!w->busy) {
            const uint32_t helpers =
                std::min<uint32_t>(n_workers - 1, FP_MAX_WORKERS);
            while (w->n_threads < helpers &&
                   pthread_create(&w->tids[w->n_threads], NULL, seg_worker,
                                  w) == 0)
                w->n_threads++;
            w->busy = true;
            w->job = s;
            w->gen++;
            w->want = helpers;
            w->joined = 0;
            pthread_cond_broadcast(&w->go);
            pthread_mutex_unlock(&w->mu);
            seg_run(s);  // the calling thread is a worker too
            pthread_mutex_lock(&w->mu);
            w->job = NULL;  // no helper joins after this
            while (w->active) pthread_cond_wait(&w->done, &w->mu);
            w->busy = false;
            pthread_mutex_unlock(&w->mu);
            return;
        }
        pthread_mutex_unlock(&w->mu);
    }
#else
    (void)workers;
#endif
    seg_run(s);
}

// Pack one segment of a chunk: region i is rows [bounds[i], bounds[i+1])
// of the chunk's events (and of each feature lane, NULL where absent),
// packed with dictionary dicts[i] from row starts[i] on (updated) into
// region i of `out`; stats[i] gets its rows consumed, spill rows, epoch
// roll (0/1) and pack nanoseconds (all 0 for an exhausted region, which is
// masked). Returns the regions with rows left (>= 0; 0 ends the chunk),
// or -2 for bad arguments, -3 when a region made no progress.
int64_t fp_pack_resident_segment(
    const uint8_t *events, const uint8_t *extra, const uint8_t *dns,
    const uint8_t *drops, const uint8_t *xlat, const uint8_t *quic,
    const uint64_t *bounds, uint32_t nr, const uint64_t *dicts,
    uint64_t *starts, uint32_t *out, uint32_t batch_size, uint32_t dns_cap,
    uint32_t drop_cap, uint32_t nk_cap, uint32_t spill_cap,
    uint32_t slot_cap, int64_t *stats, void *workers, uint32_t n_workers) {
    if (!events || !bounds || !dicts || !starts || !out || !stats ||
        nr == 0 || batch_size == 0 || batch_size > 0xFFFFu || nk_cap == 0 ||
        spill_cap == 0 || slot_cap == 0)
        return -2;
    struct fp_seg s;
    s.events = events;
    s.extra = extra;
    s.dns = dns;
    s.drops = drops;
    s.xlat = xlat;
    s.quic = quic;
    s.bounds = bounds;
    s.dicts = dicts;
    s.starts = starts;
    s.out = out;
    s.stats = stats;
    s.region_words =
        region_words_of(batch_size, dns_cap, drop_cap, nk_cap, spill_cap);
    s.nr = nr;
    s.batch_size = batch_size;
    s.dns_cap = dns_cap;
    s.drop_cap = drop_cap;
    s.nk_cap = nk_cap;
    s.spill_cap = spill_cap;
    s.slot_cap = slot_cap;
    s.full_zero = false;
    seg_dispatch(&s, workers, n_workers);
    if (s.err.load()) return s.err.load();
    int64_t left = 0;
    for (uint32_t i = 0; i < nr; i++)
        left += starts[i] < bounds[i + 1] - bounds[i];
    return left;
}

static int64_t pipe_pack(struct fp_pipe *p, const struct fp_pipe_pack_cfg *pk,
                         struct fp_pipe_result *res) {
    const uint64_t n_events = res->n_events;
    if (pk->n_ladder == 0 || pk->n_ladder > FP_PIPE_MAX_LADDER ||
        pk->ladder[0].k != 1 || pk->batch_per_region == 0 ||
        pk->spill_cap == 0 || pk->nk_cap == 0)
        return -2;
    const size_t region_words = region_words_of(
        pk->batch_per_region, pk->dns_cap, pk->drop_cap, pk->nk_cap,
        pk->spill_cap);
    // per-kind aligned feature bases the resident pack consumes (nevents
    // rides EvictedFlows only — the fold lanes never carry it)
    const uint8_t *ali[FPK_QUIC + 1] = {NULL, NULL, NULL, NULL, NULL, NULL, NULL};
    for (uint32_t i = 1; i < p->n_maps; i++)
        if (p->maps[i].n)
            ali[p->maps[i].kind] = p->maps[i].aligned.p;
    uint32_t *arena = NULL;
    size_t arena_cap_words = 0, arena_words = 0;
    uint64_t row = 0, starts[1u << 10], bounds[(1u << 10) + 1];
    int64_t *stats =
        static_cast<int64_t *>(malloc((1u << 10) * 4 * sizeof(int64_t)));
    if (!stats)
        return -1;
    struct fp_seg seg;
    seg.bounds = bounds;
    seg.starts = starts;
    seg.stats = stats;
    seg.region_words = region_words;
    seg.batch_size = pk->batch_per_region;
    seg.dns_cap = pk->dns_cap;
    seg.drop_cap = pk->drop_cap;
    seg.nk_cap = pk->nk_cap;
    seg.spill_cap = pk->spill_cap;
    seg.slot_cap = pk->slot_cap;
    // full memset, so the malloc'd arena is deterministic (the device
    // reads only the validity words either way)
    seg.full_zero = true;
    while (row < n_events) {
        const uint64_t remaining = n_events - row;
        // the ring's ladder rule: largest available k whose k*batch fits
        uint32_t sel = 0;
        for (uint32_t L = 0; L < pk->n_ladder; L++)
            if (static_cast<uint64_t>(pk->ladder[L].k) * pk->batch_size <=
                remaining)
                sel = L;
        const struct fp_pipe_ladder *lad = &pk->ladder[sel];
        const uint32_t nr = lad->nr;
        if (nr == 0 || nr > (1u << 10)) {
            free(arena);
            free(stats);
            return -2;
        }
        const uint64_t take =
            remaining < static_cast<uint64_t>(lad->k) * pk->batch_size
                ? remaining
                : static_cast<uint64_t>(lad->k) * pk->batch_size;
        // chunk bookkeeping
        if (res->n_chunks >= p->chunks_cap) {
            size_t cap = p->chunks_cap ? p->chunks_cap * 2 : 16;
            struct fp_pipe_chunk *nc = static_cast<struct fp_pipe_chunk *>(
                realloc(p->chunks, cap * sizeof(*nc)));
            if (!nc) {
                free(arena);
                free(stats);
                return -1;
            }
            p->chunks = nc;
            p->chunks_cap = cap;
        }
        struct fp_pipe_chunk *ch = &p->chunks[res->n_chunks];
        std::memset(ch, 0, sizeof(*ch));
        ch->row_start = row;
        ch->rows = take;
        ch->k = lad->k;
        ch->arena_off = arena_words;
        for (uint32_t i = 0; i < nr; i++) {
            starts[i] = 0;
            bounds[i] = take * i / nr;
        }
        bounds[nr] = take;
        seg.events = p->events.p + row * sizeof(struct no_flow_event);
        seg.extra = lane_at(ali[FPK_EXTRA], row, sizeof(struct no_extra_rec));
        seg.dns = lane_at(ali[FPK_DNS], row, sizeof(struct no_dns_rec));
        seg.drops = lane_at(ali[FPK_DROPS], row, sizeof(struct no_drops_rec));
        seg.xlat = lane_at(ali[FPK_XLAT], row, sizeof(struct no_xlat_rec));
        seg.quic = lane_at(ali[FPK_QUIC], row, sizeof(struct no_quic_rec));
        seg.dicts = lad->dicts;
        seg.nr = nr;
        bool done = false;
        while (!done) {
            // one segment = one shipped ring-slot image of nr regions (the
            // continuation loop of _fold_chunk)
            size_t need_words = arena_words + static_cast<size_t>(nr) * region_words;
            if (need_words > arena_cap_words) {
                size_t cap = arena_cap_words ? arena_cap_words : 65536;
                while (cap < need_words)
                    cap *= 2;
                uint32_t *na =
                    static_cast<uint32_t *>(realloc(arena, cap * sizeof(uint32_t)));
                if (!na) {
                    free(arena);
                    free(stats);
                    return -1;
                }
                arena = na;
                arena_cap_words = cap;
            }
            seg.out = arena + arena_words;
            seg_dispatch(&seg, NULL, 1);
            if (seg.err.load()) {
                free(arena);
                free(stats);
                return -3;  // no progress: caps violate the guarantee
            }
            done = true;
            for (uint32_t i = 0; i < nr; i++) {
                ch->spills += static_cast<uint32_t>(stats[4 * i + 1]);
                ch->resets += static_cast<uint32_t>(stats[4 * i + 2]);
                if (starts[i] < bounds[i + 1] - bounds[i])
                    done = false;
            }
            arena_words += static_cast<size_t>(nr) * region_words;
            ch->n_segs++;
        }
        res->spill_rows += ch->spills;
        res->dict_resets += ch->resets;
        res->segs += ch->n_segs;
        res->n_chunks++;
        row += take;
    }
    free(stats);
    res->arena = arena;
    res->arena_words = arena_words;
    res->packed_rows = n_events;
    res->chunks = p->chunks;
    return 0;
}

// The fused drain: every map's batched drain + per-CPU merge (fanned out
// over `lanes` worker threads), the key join + feature alignment, and —
// when `pack` is non-NULL — the resident-region pack. Returns n_events
// (>= 0) or a negative error (-1 alloc, -2 bad args, -3 pack stuck).
int64_t fp_drain_to_resident(void *h, const struct fp_pipe_pack_cfg *pack,
                             struct fp_pipe_result *res) {
    struct fp_pipe *p = static_cast<struct fp_pipe *>(h);
    if (!p || !res)
        return -2;
    std::memset(res, 0, sizeof(*res));
    // ---- drain + merge (per-map, worker fan-out) ----
    uint32_t nw = p->lanes < p->n_maps ? p->lanes : p->n_maps;
#if defined(__linux__)
    if (nw > 1) {
        struct fp_pipe_job job;
        job.p = p;
        job.next = 0;
        pthread_mutex_init(&job.mu, NULL);
        pthread_t tids[FP_PIPE_MAX_MAPS];
        uint32_t started = 0;
        for (uint32_t t = 0; t + 1 < nw; t++)
            if (pthread_create(&tids[started], NULL, pipe_worker, &job) == 0)
                started++;
        pipe_worker(&job);  // the calling thread is a worker too
        for (uint32_t t = 0; t < started; t++)
            pthread_join(tids[t], NULL);
        pthread_mutex_destroy(&job.mu);
    } else
#endif
    {
        for (uint32_t i = 0; i < p->n_maps; i++)
            pipe_run_map(&p->maps[i]);
    }
    uint64_t total = 0;
    for (uint32_t i = 0; i < p->n_maps; i++) {
        struct fp_pipe_map_state *m = &p->maps[i];
        res->drain_ns += m->drain_ns;
        res->merge_ns += m->merge_ns;
        res->syscalls += m->syscalls;
        res->map_rows[i] = m->n;
        total += m->n;
        if (m->err == ENOMEM)
            return -1;
        if (m->err)
            res->batch_err_mask |= 1ull << i;
    }
    const uint64_t n_agg = p->maps[0].n;
    // ---- join (loader._join_keys twin) + event compose + alignment ----
    uint64_t t_join = pipe_now_ns();
    const size_t ptr_sz = sizeof(const uint8_t *);
    if (pipe_reserve(&p->join, total * (2 * ptr_sz + 5 * sizeof(uint64_t))))
        return -1;
    const uint8_t **kp = reinterpret_cast<const uint8_t **>(p->join.p);
    const uint8_t **app_key = kp + total;
    uint64_t *hs = reinterpret_cast<uint64_t *>(app_key + total);
    uint64_t *ord = hs + total;
    uint64_t *feat_eidx = ord + total;
    uint64_t *app_first = feat_eidx + total;
    uint64_t *app_last = app_first + total;
    {
        uint64_t g = 0;
        for (uint32_t mi = 0; mi < p->n_maps; mi++) {
            struct fp_pipe_map_state *m = &p->maps[mi];
            for (uint32_t r = 0; r < m->n; r++, g++) {
                kp[g] = m->keys.p + static_cast<size_t>(r) * sizeof(struct no_flow_key);
                hs[g] = pipe_key_hash(kp[g]);
                ord[g] = g;
            }
        }
    }
    std::sort(ord, ord + total, [hs](uint64_t a, uint64_t b) {
        return hs[a] != hs[b] ? hs[a] < hs[b] : a < b;  // stable argsort twin
    });
    // collision check: distinct keys vs distinct hashes over the sort
    uint64_t key_groups = total ? 1 : 0, hash_groups = total ? 1 : 0;
    for (uint64_t j = 1; j < total; j++) {
        if (std::memcmp(kp[ord[j]], kp[ord[j - 1]], sizeof(struct no_flow_key)))
            key_groups++;
        if (hs[ord[j]] != hs[ord[j - 1]])
            hash_groups++;
    }
    if (key_groups != hash_groups) {
        // u64 hash collision (~never): the exact lexicographic order twin
        res->lex_fallback = 1;
        std::sort(ord, ord + total, [kp](uint64_t a, uint64_t b) {
            uint64_t wa[5], wb[5];
            std::memcpy(wa, kp[a], sizeof(wa));
            std::memcpy(wb, kp[b], sizeof(wb));
            for (int i = 0; i < 5; i++)
                if (wa[i] != wb[i])
                    return wa[i] < wb[i];
            return a < b;
        });
    }
    // group walk: stable sort puts agg members (src < n_agg) first in each
    // group, so the match is the LAST agg member; groups with none append
    // one orphan event, in sorted-group order (the searchsorted twin)
    uint64_t n_app = 0;
    {
        uint64_t a = 0;
        while (a < total) {
            uint64_t b = a + 1;
            while (b < total && !std::memcmp(kp[ord[b]], kp[ord[a]],
                                             sizeof(struct no_flow_key)))
                b++;
            int64_t agg_max = -1;
            for (uint64_t j = a; j < b && ord[j] < n_agg; j++)
                agg_max = static_cast<int64_t>(ord[j]);
            uint64_t eidx;
            if (agg_max >= 0) {
                eidx = static_cast<uint64_t>(agg_max);
            } else {
                app_key[n_app] = kp[ord[a]];
                app_first[n_app] = UINT64_MAX;
                app_last[n_app] = 0;
                eidx = n_agg + n_app++;
            }
            for (uint64_t j = a; j < b; j++)
                if (ord[j] >= n_agg)
                    feat_eidx[ord[j] - n_agg] = eidx;
            a = b;
        }
    }
    const uint64_t n_events = n_agg + n_app;
    res->n_events = n_events;
    res->n_agg = n_agg;
    res->n_orphans = n_app;
    if (pipe_reserve(&p->events, n_events * sizeof(struct no_flow_event)))
        return -1;
    std::memset(p->events.p, 0, n_events * sizeof(struct no_flow_event));
    if (n_agg)
        fp_events_from_keys_stats(p->maps[0].keys.p, p->maps[0].vals.p, n_agg,
                                  p->events.p);
    struct no_flow_event *ev =
        reinterpret_cast<struct no_flow_event *>(p->events.p);
    for (uint64_t a = 0; a < n_app; a++)
        std::memcpy(&ev[n_agg + a].key, app_key[a],
                    sizeof(struct no_flow_key));
    // feature alignment: scatter merged rows to their event row (ascending —
    // duplicate keys across drain chunks: last wins, like `out[idx] = recs`)
    uint64_t fbase = 0;
    for (uint32_t mi = 1; mi < p->n_maps; mi++) {
        struct fp_pipe_map_state *m = &p->maps[mi];
        if (m->n == 0 || n_events == 0) {
            fbase += m->n;
            continue;
        }
        const size_t vs = m->value_size;
        if (pipe_reserve(&m->aligned, n_events * vs))
            return -1;
        std::memset(m->aligned.p, 0, n_events * vs);
        for (uint32_t r = 0; r < m->n; r++) {
            const uint8_t *rec = m->merged.p + static_cast<size_t>(r) * vs;
            const uint64_t e = feat_eidx[fbase + r];
            std::memcpy(m->aligned.p + e * vs, rec, vs);
            if (e >= n_agg) {
                // orphan times: every record type leads with first/last u64s
                uint64_t ft, lt;
                std::memcpy(&ft, rec, 8);
                std::memcpy(&lt, rec + 8, 8);
                uint64_t *af = &app_first[e - n_agg];
                uint64_t *al = &app_last[e - n_agg];
                if (ft == 0)
                    ft = UINT64_MAX;  // the 0 -> U64_MAX sentinel (loader)
                if (ft < *af)
                    *af = ft;
                if (lt > *al)
                    *al = lt;
            }
        }
        res->aligned[mi] = m->aligned.p;
        fbase += m->n;
    }
    for (uint64_t a = 0; a < n_app; a++) {
        ev[n_agg + a].stats.first_seen_ns =
            app_first[a] == UINT64_MAX ? 0 : app_first[a];
        ev[n_agg + a].stats.last_seen_ns = app_last[a];
    }
    res->events = p->events.p;
    res->join_ns = pipe_now_ns() - t_join;
    // ---- resident-region pack (_fold_chunk twin) ----
    if (pack && n_events) {
        uint64_t t_pack = pipe_now_ns();
        int64_t rc = pipe_pack(p, pack, res);
        res->pack_ns = pipe_now_ns() - t_pack;
        if (rc < 0)
            return rc;
    }
    return static_cast<int64_t>(n_events);
}

// sizeof of each struct the library shares with Python, in this order:
// flow key, flow stats, flow event, extra, dns, drops, xlat, quic and
// nevents records, then the pipeline's fp_pipe_map_cfg, fp_pipe_pack_cfg,
// fp_pipe_chunk and fp_pipe_result. Writes min(n, 13) sizes and
// returns 13.
uint32_t fp_struct_sizes(uint64_t *out, uint32_t n) {
    const uint64_t sizes[13] = {
        sizeof(struct no_flow_key), sizeof(struct no_flow_stats),
        sizeof(struct no_flow_event), sizeof(struct no_extra_rec),
        sizeof(struct no_dns_rec), sizeof(struct no_drops_rec),
        sizeof(struct no_xlat_rec), sizeof(struct no_quic_rec),
        sizeof(struct no_nevents_rec), sizeof(struct fp_pipe_map_cfg),
        sizeof(struct fp_pipe_pack_cfg), sizeof(struct fp_pipe_chunk),
        sizeof(struct fp_pipe_result)};
    for (uint32_t i = 0; i < n && i < 13; i++) out[i] = sizes[i];
    return 13;
}

}  // extern "C"
