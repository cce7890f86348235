/*
 * helpers.h — minimal BPF helper declarations and map-definition macros.
 *
 * Self-contained (no vendored libbpf headers): only the helpers this datapath
 * uses are declared, by their stable kernel helper IDs. For CO-RE tracing
 * paths (kprobes/fentry reading kernel structs) the build expects a
 * distro-provided vmlinux.h + bpf_core_read.h; those hooks are compiled only
 * when NO_HAVE_VMLINUX is defined (see flowpath.c).
 */
#ifndef NO_BPF_HELPERS_H
#define NO_BPF_HELPERS_H

/* When a TU already pulls in vmlinux.h + libbpf headers (the tracing-probe
 * build, flowpath_probes.c), skip everything those provide and only add this
 * project's small inline utilities (the #else branch at the bottom). */
#ifndef NO_HAVE_VMLINUX

typedef unsigned char __u8;
typedef unsigned short __u16;
typedef unsigned int __u32;
typedef unsigned long long __u64;
typedef signed char __s8;
typedef short __s16;
typedef int __s32;
typedef long long __s64;

#define SEC(name) __attribute__((section(name), used))
#define __uint(name, val) int(*name)[val]
#define __type(name, val) typeof(val) *name
#define NO_INLINE static __attribute__((always_inline)) inline

/* map types we use */
#define BPF_MAP_TYPE_HASH 1
#define BPF_MAP_TYPE_PERCPU_HASH 5
#define BPF_MAP_TYPE_PERCPU_ARRAY 6
#define BPF_MAP_TYPE_LPM_TRIE 11
#define BPF_MAP_TYPE_RINGBUF 27

#define BPF_ANY 0
#define BPF_NOEXIST 1
#define BPF_EXIST 2
#define BPF_F_NO_PREALLOC 1

#define NO_EEXIST 17
#define NO_ENOENT 2

/* TC verdicts */
#define TC_ACT_OK 0
#define TC_ACT_UNSPEC (-1)

struct bpf_spin_lock {
    __u32 val;
};

/* subset of struct __sk_buff (uapi/linux/bpf.h) accessed by the TC path */
struct __sk_buff {
    __u32 len;
    __u32 pkt_type;
    __u32 mark;
    __u32 queue_mapping;
    __u32 protocol;
    __u32 vlan_present;
    __u32 vlan_tci;
    __u32 vlan_proto;
    __u32 priority;
    __u32 ingress_ifindex;
    __u32 ifindex;
    __u32 tc_index;
    __u32 cb[5];
    __u32 hash;
    __u32 tc_classid;
    __u32 data;
    __u32 data_end;
    __u32 napi_id;
    /* remaining fields unused by this datapath */
};

/* helper IDs from uapi/linux/bpf.h */
static void *(*bpf_map_lookup_elem)(void *map, const void *key) = (void *)1;
static long (*bpf_map_update_elem)(void *map, const void *key,
                                   const void *value, __u64 flags) = (void *)2;
static long (*bpf_map_delete_elem)(void *map, const void *key) = (void *)3;
static long (*bpf_probe_read)(void *dst, __u32 size,
                              const void *src) = (void *)4;
static __u64 (*bpf_ktime_get_ns)(void) = (void *)5;
static long (*bpf_trace_printk)(const char *fmt, __u32 fmt_size,
                                ...) = (void *)6;
static __u32 (*bpf_get_prandom_u32)(void) = (void *)7;
static __u32 (*bpf_get_smp_processor_id)(void) = (void *)8;
static __u64 (*bpf_get_current_pid_tgid)(void) = (void *)14;
static long (*bpf_spin_lock)(struct bpf_spin_lock *lock) = (void *)93;
static long (*bpf_spin_unlock)(struct bpf_spin_lock *lock) = (void *)94;
static long (*bpf_probe_read_kernel)(void *dst, __u32 size,
                                     const void *src) = (void *)113;
static long (*bpf_probe_read_user)(void *dst, __u32 size,
                                   const void *src) = (void *)112;
static void *(*bpf_ringbuf_reserve)(void *ringbuf, __u64 size,
                                    __u64 flags) = (void *)131;
static void (*bpf_ringbuf_submit)(void *data, __u64 flags) = (void *)132;
static void (*bpf_ringbuf_discard)(void *data, __u64 flags) = (void *)133;
static long (*bpf_ringbuf_output)(void *ringbuf, void *data, __u64 size,
                                  __u64 flags) = (void *)130;

#else /* NO_HAVE_VMLINUX */
#define NO_INLINE static __always_inline
#define NO_EEXIST 17
#define NO_ENOENT 2
#endif /* NO_HAVE_VMLINUX */

#ifndef NO_HAVE_VMLINUX
#define no_printk(fmt, ...)                                                    \
    ({                                                                         \
        if (cfg_trace_messages) {                                              \
            const char _fmt[] = fmt;                                           \
            bpf_trace_printk(_fmt, sizeof(_fmt), ##__VA_ARGS__);               \
        }                                                                      \
    })

NO_INLINE __u16 no_bswap16(__u16 x) { return __builtin_bswap16(x); }
NO_INLINE __u32 no_bswap32(__u32 x) { return __builtin_bswap32(x); }

/* network byte order <-> host (BPF targets are little-endian on all arches we
 * ship: x86_64, arm64, ppc64le) */
#define no_ntohs(x) no_bswap16(x)
#define no_htons(x) no_bswap16(x)
#define no_ntohl(x) no_bswap32(x)
#endif /* NO_HAVE_VMLINUX */

NO_INLINE void no_atomic_add64(__u64 *dst, __u64 val) {
    __sync_fetch_and_add(dst, val);
}

NO_INLINE __u16 no_sat_add16(__u16 a, __u16 b) {
    __u32 s = (__u32)a + b;
    return s > 0xFFFF ? 0xFFFF : (__u16)s;
}

NO_INLINE __u32 no_sat_add32(__u32 a, __u32 b) {
    __u64 s = (__u64)a + b;
    return s > 0xFFFFFFFFull ? 0xFFFFFFFF : (__u32)s;
}

#endif /* NO_BPF_HELPERS_H */
