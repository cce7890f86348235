// flowpack.cc: the host packers of the dense, compact and resident feeds
// in C++ (host code, not a kernel; built with g++ by
// ops/kernels/_build.build_host and loaded with ctypes by
// datapath/flowpack.py).
//
// The port's trimmed copy of the reference's native packer,
// netobserv_tpu/datapath/native/flowpack.cc: feature_markers and
// fill_feature_words (:97-139), fp_pack_dense (:140-178), the compact
// layout, is_v4_mapped and fp_pack_compact (:180-274), the FP_* layout
// constants (:95, :311-315), the fingerprint dictionary key_fp64 /
// fp_dict_* (:317-404), make_kw, rtt_code11 and lat_code16 (:406-430)
// and fp_pack_resident (:432-570). The per-CPU merges, CRC32C and the
// fused drain are not here. Three entries are the port's own:
// fp_struct_sizes and fp_layout_words, which the loader holds against
// model/binfmt's dtypes and datapath/flowpack.py's layout constants, and
// fp_dict_lookup, which the checks use to read the dictionary.
//
// Each layout is its Python twin's (datapath/flowpack.py pack_dense,
// pack_compact, pack_resident), word for word; sketch/state's
// dense_to_arrays, compact_to_arrays and resident_to_arrays unpack them on
// the device. C ABI only; every buffer is the caller's.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "records.h"

#define FP_ABI_VERSION 2

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

// sizeof of each record the packer reads, in this order: flow key, flow
// stats, flow event, extra, dns, drops, xlat, quic. Writes min(n, 8)
// sizes and returns 8.
uint32_t fp_struct_sizes(uint64_t *out, uint32_t n) {
    const uint64_t sizes[8] = {
        sizeof(struct no_flow_key), sizeof(struct no_flow_stats),
        sizeof(struct no_flow_event), sizeof(struct no_extra_rec),
        sizeof(struct no_dns_rec), sizeof(struct no_drops_rec),
        sizeof(struct no_xlat_rec), sizeof(struct no_quic_rec)};
    for (uint32_t i = 0; i < n && i < 8; i++) out[i] = sizes[i];
    return 8;
}

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

}  // extern "C"
