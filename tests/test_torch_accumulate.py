"""The port's merge semantics (`netobserv_tpu_torch/model/accumulate.py`)
against the JAX package's `netobserv_tpu/model/accumulate.py`, bit for
bit: each per-record `accumulate_*` on seeded random pairs, `merge_percpu`
and each columnar merge on seeded random (n_keys, n_cpus) partials, and
the named edge cases `tests/test_model.py` and
`tests/test_evict_columnar.py` pin for the reference (the u64 / u32 / u16
saturation caps, zero `first_seen_ns`, latest-non-zero fields, unset
MACs, the interface dedup cap, the network-events ring wrap and the SSL
version rule). Plain numpy, no device."""

from __future__ import annotations

import numpy as np
import pytest

from netobserv_tpu.model import accumulate as jacc
from netobserv_tpu.model import binfmt as jbin
from netobserv_tpu_torch.model import accumulate as tacc
from netobserv_tpu_torch.model import binfmt as tbin

#: kind -> (dtype name, per-record rule)
KINDS = {
    "stats": ("FLOW_STATS_DTYPE", "accumulate_base"),
    "dns": ("DNS_REC_DTYPE", "accumulate_dns"),
    "drops": ("DROPS_REC_DTYPE", "accumulate_drops"),
    "extra": ("EXTRA_REC_DTYPE", "accumulate_extra"),
    "xlat": ("XLAT_REC_DTYPE", "accumulate_xlat"),
    "quic": ("QUIC_REC_DTYPE", "accumulate_quic"),
    "nevents": ("NEVENTS_REC_DTYPE", "accumulate_network_events"),
}
SHAPES = [(1, 1), (7, 1), (9, 4), (33, 8), (0, 3)]


def _dtype(kind: str) -> np.dtype:
    return getattr(tbin, KINDS[kind][0])


def _rand(kind: str, shape: tuple, rng: np.random.Generator) -> np.ndarray:
    """Random bytes as partials of `kind`, with DNS names that start with a
    non-NUL byte or are empty (as `tests/test_evict_columnar.py` draws
    them: wire names never start with NUL)."""
    dtype = _dtype(kind)
    n = int(np.prod(shape))
    raw = rng.integers(0, 256, (n, dtype.itemsize), dtype=np.int64)
    vals = raw.astype(np.uint8).view(dtype).reshape(shape).copy()
    if kind == "dns" and n:
        first = np.frombuffer(vals["name"].tobytes(), np.uint8).reshape(
            *shape, 32)[..., 0]
        vals["name"] = np.where(first == 0, np.bytes_(b""), vals["name"])
    return vals


def _per_record(mod, kind: str, vals: np.ndarray) -> np.ndarray:
    fn = getattr(mod, KINDS[kind][1])
    out = np.zeros(len(vals), vals.dtype)
    for i in range(len(vals)):
        out[i] = mod.merge_percpu(vals[i], fn)
    return out


def _all_forms(kind: str, vals: np.ndarray) -> np.ndarray:
    """Both packages' per-record and columnar merges of `vals`, all four
    equal byte for byte; returns the port's columnar result."""
    forms = {"port_columnar": tacc.COLUMNAR_MERGES[kind](vals.copy()),
             "jax_columnar": jacc.COLUMNAR_MERGES[kind](vals.copy())}
    if len(vals):
        forms["port_per_record"] = _per_record(tacc, kind, vals.copy())
        forms["jax_per_record"] = _per_record(jacc, kind, vals.copy())
    want = forms["jax_columnar"].tobytes()
    for name, got in forms.items():
        assert got.tobytes() == want, name
    return forms["port_columnar"]


def test_constants_and_dtypes_are_the_references():
    for name in ("U16_MAX", "U32_MAX", "U64_MAX", "MISC_SSL_MISMATCH"):
        assert getattr(tacc, name) == getattr(jacc, name), name
    for name, _ in KINDS.values():
        assert getattr(tbin, name) == getattr(jbin, name), name
    assert set(tacc.COLUMNAR_MERGES) == set(jacc.COLUMNAR_MERGES) == set(KINDS)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_per_record_rules_equal_the_references(kind):
    """200 seeded random (dst, src) pairs through each package's rule: the
    merged `dst` is byte for byte the reference's, and `src` unchanged."""
    rng = np.random.default_rng(sorted(KINDS).index(kind) + 20)
    pairs = _rand(kind, (200, 2), rng)
    fn_t, fn_j = (getattr(m, KINDS[kind][1]) for m in (tacc, jacc))
    for dst, src in pairs:
        a, b = dst.copy(), dst.copy()
        s = src.copy()
        fn_t(a, s)
        fn_j(b, src.copy())
        assert a.tobytes() == b.tobytes()
        assert s.tobytes() == src.tobytes()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_merges_equal_the_references(kind, shape):
    """`merge_percpu` with each rule and each columnar merge, in both
    packages, on seeded random partials (one CPU, several, no key)."""
    rng = np.random.default_rng(1000 * sorted(KINDS).index(kind)
                                + 10 * shape[0] + shape[1])
    _all_forms(kind, _rand(kind, shape, rng))


def _u64_u32_saturation():
    vals = np.zeros((2, 3), tbin.FLOW_STATS_DTYPE)
    vals[0, 0]["bytes"] = 2**64 - 10
    vals[0, 1]["bytes"] = 100
    vals[0, 2]["bytes"] = 5
    vals[0, 0]["packets"] = 2**32 - 3
    vals[0, 1]["packets"] = 7
    vals[1, 0]["bytes"] = 11
    vals[1, 1]["bytes"] = 31
    vals[1, 0]["tcp_flags"] = 0x02
    vals[1, 2]["tcp_flags"] = 0x10

    def check(out):
        assert int(out[0]["bytes"]) == 2**64 - 1
        assert int(out[0]["packets"]) == 2**32 - 1
        assert int(out[1]["bytes"]) == 42
        assert int(out[1]["tcp_flags"]) == 0x12
    return "stats", vals, check


def _u16_drop_saturation():
    vals = np.zeros((1, 3), tbin.DROPS_REC_DTYPE)
    vals[0]["bytes"] = [0xFFF0, 0x0100, 1]
    vals[0]["packets"] = [2, 3, 4]
    vals[0, 1]["latest_cause"] = 77
    vals[0, 0]["latest_flags"], vals[0, 2]["latest_flags"] = 0x02, 0x10

    def check(out):
        assert int(out[0]["bytes"]) == 0xFFFF
        assert int(out[0]["packets"]) == 9
        assert int(out[0]["latest_cause"]) == 77
        assert int(out[0]["latest_flags"]) == 0x12
    return "drops", vals, check


def _mac_fill_if_unset():
    vals = np.zeros((2, 3), tbin.FLOW_STATS_DTYPE)
    vals[0, 1]["src_mac"] = [1, 2, 3, 4, 5, 6]
    vals[0, 2]["src_mac"] = [9, 9, 9, 9, 9, 9]
    vals[1, 0]["dst_mac"] = [7, 7, 7, 7, 7, 7]
    vals[1, 1]["dst_mac"] = [8, 8, 8, 8, 8, 8]

    def check(out):
        assert out[0]["src_mac"].tolist() == [1, 2, 3, 4, 5, 6]
        assert out[1]["dst_mac"].tolist() == [7, 7, 7, 7, 7, 7]
        assert not out[1]["src_mac"].any()
    return "stats", vals, check


def _latest_non_zero():
    vals = np.zeros((2, 3), tbin.FLOW_STATS_DTYPE)
    vals[0]["dscp"] = [10, 46, 0]
    vals[0]["eth_protocol"] = [0x0800, 0, 0x86DD]
    vals[0]["sampling"] = [0, 50, 0]
    vals[1]["tls_cipher_suite"] = [0x1301, 0, 0]
    vals[1]["errno_fallback"] = [0, 0, 5]
    vals[1, 0]["packets"] = 1
    vals[1, 0]["if_index_first"], vals[1, 1]["if_index_first"] = 3, 9

    def check(out):
        assert int(out[0]["dscp"]) == 46
        assert int(out[0]["eth_protocol"]) == 0x86DD
        assert int(out[0]["sampling"]) == 50
        assert int(out[1]["tls_cipher_suite"]) == 0x1301
        assert int(out[1]["errno_fallback"]) == 5
        assert int(out[1]["if_index_first"]) == 3  # cpu 0 was not empty
    return "stats", vals, check


def _times_zero_means_unset():
    vals = np.zeros((1, 3), tbin.EXTRA_REC_DTYPE)
    vals[0]["first_seen_ns"] = [0, 500, 100]
    vals[0]["last_seen_ns"] = [0, 7, 9]
    vals[0]["rtt_ns"] = [3, 1, 2]

    def check(out):
        assert int(out[0]["first_seen_ns"]) == 100
        assert int(out[0]["last_seen_ns"]) == 9
        assert int(out[0]["rtt_ns"]) == 3
    return "extra", vals, check


def _interface_dedup_cap():
    cap = tbin.FLOW_STATS_DTYPE["observed_intf"].shape[0]
    vals = np.zeros((2, 2), tbin.FLOW_STATS_DTYPE)
    vals[0, 0]["n_observed_intf"] = cap + 3
    vals[0, 0]["observed_intf"][:] = np.arange(cap) + 1
    vals[0, 1]["n_observed_intf"] = 2
    vals[0, 1]["observed_intf"][:2] = [1, 99]
    vals[0, 1]["observed_direction"][:2] = [0, 1]
    vals[1, 0]["n_observed_intf"] = 1
    vals[1, 0]["observed_intf"][0] = 3
    vals[1, 1]["n_observed_intf"] = 2
    vals[1, 1]["observed_intf"][:2] = [3, 3]
    vals[1, 1]["observed_direction"][:2] = [0, 1]

    def check(out):
        assert int(out[0]["n_observed_intf"]) == cap
        assert int(out[1]["n_observed_intf"]) == 2
        assert out[1]["observed_direction"][:2].tolist() == [0, 1]
    return "stats", vals, check


def _nevents_ring_wrap():
    cap = tbin.NEVENTS_REC_DTYPE["events"].shape[0]
    vals = np.zeros((1, 2), tbin.NEVENTS_REC_DTYPE)
    for j in range(cap):
        vals[0, 0]["events"][j] = [j + 1] * 8
        vals[0, 0]["packets"][j] = 1
    vals[0, 0]["n_events"] = 1
    vals[0, 1]["events"][0] = [1] * 8
    vals[0, 1]["events"][1] = [99] * 8
    vals[0, 1]["packets"][:2] = 1
    vals[0, 1]["bytes"][:2] = 0xFFFF
    vals[0, 1]["n_events"] = 2

    def check(out):
        assert out[0]["events"][1].tolist() == [99] * 8
        assert int(out[0]["n_events"]) == 2
    return "nevents", vals, check


def _ssl_version_first_wins():
    vals = np.zeros((2, 3), tbin.FLOW_STATS_DTYPE)
    vals[0]["ssl_version"] = [0, 0x0303, 0x0304]
    vals[1]["ssl_version"] = [0x0304, 0, 0x0304]

    def check(out):
        assert int(out[0]["ssl_version"]) == 0x0303
        assert int(out[0]["misc_flags"]) & tacc.MISC_SSL_MISMATCH
        assert int(out[1]["ssl_version"]) == 0x0304
        assert not int(out[1]["misc_flags"]) & tacc.MISC_SSL_MISMATCH
    return "stats", vals, check


def _dns_latest_errno_and_name():
    vals = np.zeros((1, 3), tbin.DNS_REC_DTYPE)
    vals[0]["latency_ns"] = [500, 1500, 700]
    vals[0]["errno"] = [3, 0, 0]
    vals[0, 1]["name"] = b"example.com"
    vals[0]["dns_flags"] = [1, 2, 4]

    def check(out):
        assert int(out[0]["latency_ns"]) == 1500
        assert int(out[0]["errno"]) == 0
        assert bytes(out[0]["name"]).rstrip(b"\x00") == b"example.com"
        assert int(out[0]["dns_flags"]) == 7
    return "dns", vals, check


EDGES = {f.__name__[1:]: f for f in (
    _u64_u32_saturation, _u16_drop_saturation, _mac_fill_if_unset,
    _latest_non_zero, _times_zero_means_unset, _interface_dedup_cap,
    _nevents_ring_wrap, _ssl_version_first_wins, _dns_latest_errno_and_name)}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_cases_equal_the_references(case):
    kind, vals, check = EDGES[case]()
    check(_all_forms(kind, vals))


def test_accumulate_base_into_an_empty_entry_adopts_the_identity():
    """A zero `dst` takes `src`'s first-seen interface and direction, in
    both packages (`tests/test_model.py`'s into-empty case)."""
    src = np.zeros(1, tbin.FLOW_STATS_DTYPE)[0]
    src["bytes"], src["packets"] = 50, 2
    src["first_seen_ns"], src["last_seen_ns"] = 50, 150
    src["if_index_first"], src["direction_first"] = 7, 1
    a = np.zeros(1, tbin.FLOW_STATS_DTYPE)[0]
    b = np.zeros(1, tbin.FLOW_STATS_DTYPE)[0]
    tacc.accumulate_base(a, src)
    jacc.accumulate_base(b, src)
    assert a.tobytes() == b.tobytes()
    assert int(a["if_index_first"]) == 7 and int(a["first_seen_ns"]) == 50
