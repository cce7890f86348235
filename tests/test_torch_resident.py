"""The port's resident feed (netobserv_tpu_torch/model/binfmt.py,
datapath/flowpack.py, sketch/state.resident_to_arrays and ingest_resident,
sketch/staging.py, sketch/carry's key table, TorchSketchExporter.fold_events)
against the JAX package's, on the CPU.

Everything here is held bit for bit: the packer word by word and chunk by
chunk (rows consumed, dictionary contents and count), the device unpack
array by array and the key table row by row, and the ring's state tables,
key table and counters after whole folds. The masses are integer-valued
with per-cell sums below 2^24, so add order cannot change a bit.

Sizes: B = 512 (one unpack case at B = 40,000, so that row indices reach
bit 31 of their words), a small sketch geometry."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu.datapath.replay import SyntheticFetcher
from netobserv_tpu.model import binfmt as jbin
from netobserv_tpu.model import flow as jflow
from netobserv_tpu.sketch import state as js
from netobserv_tpu.sketch.staging import ResidentStagingRing as JRing
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.exporter.report import report_numpy, report_to_json
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.model import binfmt as tbin
from netobserv_tpu_torch.model import flow as tflow
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch.staging import ResidentStagingRing

B = 512
GEOM = dict(cm_width=2048, hll_precision=10, perdst_buckets=256,
            perdst_precision=5, persrc_buckets=256, persrc_precision=5,
            topk=128, hist_buckets=256, ewma_buckets=512)
DTYPES = ("FLOW_KEY_DTYPE", "FLOW_STATS_DTYPE", "FLOW_EVENT_DTYPE",
          "EXTRA_REC_DTYPE", "DNS_REC_DTYPE", "DROPS_REC_DTYPE",
          "XLAT_REC_DTYPE", "QUIC_REC_DTYPE")


def _layout(dt: np.dtype):
    """Every field's name, offset, shape and base layout, recursively."""
    if dt.fields is None:
        return dt.str, dt.shape
    return [(name, off, _layout(sub)) for name, (sub, off) in
            sorted(dt.fields.items(), key=lambda f: f[1][1])]


@pytest.mark.parametrize("name", DTYPES)
def test_binfmt_dtypes_equal_the_reference(name):
    got, want = getattr(tbin, name), getattr(jbin, name)
    assert got.descr == want.descr
    assert got.itemsize == want.itemsize
    assert _layout(got) == _layout(want)
    assert tflow.MAX_OBSERVED_INTERFACES == jflow.MAX_OBSERVED_INTERFACES


def test_binfmt_functions_equal_the_reference():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 7 * tbin.FLOW_EVENT_DTYPE.itemsize,
                       dtype=np.uint8).tobytes()
    got, want = tbin.decode_flow_events(raw), jbin.decode_flow_events(raw)
    assert got.tobytes() == want.tobytes()
    assert tbin.encode_flow_events(got) == jbin.encode_flow_events(want)
    for n_total in (None, 9):
        a = tbin.events_from_keys_stats(got["key"], got["stats"], n_total)
        b = jbin.events_from_keys_stats(want["key"], want["stats"], n_total)
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        tbin.decode_flow_events(raw[:-1])


def _events(rng, n, n_distinct=300, dns_share=0.1, drop_share=0.05,
            sampling=0):
    """Flow events over a universe of v4 and v6 keys, with every feature
    lane: rtt and IPsec in extra, DNS latency and drops on a share of rows,
    NAT translations and QUIC."""
    uni = np.zeros(n_distinct, tbin.FLOW_KEY_DTYPE)
    uni["src_ip"] = rng.integers(0, 256, (n_distinct, 16))
    uni["dst_ip"] = rng.integers(0, 256, (n_distinct, 16))
    v4 = rng.random(n_distinct) < 0.5
    for f in ("src_ip", "dst_ip"):
        uni[f][v4, :10] = 0
        uni[f][v4, 10:12] = 0xFF
    uni["src_port"] = rng.integers(0, 65536, n_distinct)
    uni["dst_port"] = rng.integers(0, 65536, n_distinct)
    uni["proto"] = rng.choice([1, 6, 17], n_distinct)
    ev = np.zeros(n, tbin.FLOW_EVENT_DTYPE)
    ev["key"] = uni[np.minimum(rng.zipf(1.2, n) - 1, n_distinct - 1)]
    st = ev["stats"]
    st["bytes"] = rng.integers(64, 9000, n)
    st["packets"] = rng.integers(1, 12, n)
    st["tcp_flags"] = rng.integers(0, 1 << 9, n)
    st["dscp"] = rng.integers(0, 64, n)
    st["sampling"] = sampling
    extra = np.zeros(n, tbin.EXTRA_REC_DTYPE)
    extra["rtt_ns"] = rng.integers(0, 5_000_000, n)
    extra["ipsec_ret"] = rng.random(n) < 0.1
    extra["ipsec_encrypted"] = rng.random(n) < 0.1
    dns = np.zeros(n, tbin.DNS_REC_DTYPE)
    hit = rng.random(n) < dns_share
    dns["latency_ns"][hit] = rng.integers(1, 5_000_000_000, hit.sum())
    drops = np.zeros(n, tbin.DROPS_REC_DTYPE)
    hit = rng.random(n) < drop_share
    drops["bytes"][hit] = rng.integers(1, 65536, hit.sum())
    drops["packets"][hit] = rng.integers(1, 65536, hit.sum())
    drops["latest_cause"][hit] = rng.integers(0, 1 << 20, hit.sum())
    drops["latest_state"][hit] = rng.integers(0, 256, hit.sum())
    xlat = np.zeros(n, tbin.XLAT_REC_DTYPE)
    hit = rng.random(n) < 0.1
    xlat["src_ip"][hit, 3] = 1
    xlat["dst_ip"][hit & (rng.random(n) < 0.8), 5] = 7
    quic = np.zeros(n, tbin.QUIC_REC_DTYPE)
    quic["version"][rng.random(n) < 0.1] = 1
    quic["seen_short_hdr"][rng.random(n) < 0.1] = 1
    return ev, dict(extra=extra, dns=dns, drops=drops, xlat=xlat, quic=quic)


def _case(name, rng):
    """(events, feature lanes, caps, slot_cap) of one packer case."""
    caps = tfp.default_resident_caps(B)
    slot_cap = 1 << 12
    if name == "cold_key_flood":
        ev, f = _events(rng, 3 * B, n_distinct=5000)
    elif name == "dns_and_drop_lane_overflow":
        ev, f = _events(rng, 2 * B, dns_share=0.6, drop_share=0.5)
        caps = tfp.ResidentCaps(dns=16, drop=8, nk=64, spill=32)
    elif name == "rtt_past_the_code":
        ev, f = _events(rng, B)
        f["extra"]["rtt_ns"][::7] = (tfp.RTT_MAX_US + 1) * 1000
        f["extra"]["rtt_ns"][1::7] = tfp.RTT_MAX_US * 1000
        f["extra"]["rtt_ns"][2::7] = (1 << 32) * 1000 + 5000  # u32 wrap
    elif name == "sampling_change":
        ev, f = _events(rng, 2 * B, sampling=4)
        ev["stats"]["sampling"][B // 3:] = 8
        ev["stats"]["sampling"][B // 2::5] = 4
    elif name == "same_key_twice":
        ev, f = _events(rng, B, n_distinct=40)
        ev[1::2] = ev[::2][:len(ev[1::2])]
    elif name == "full_dictionary":
        ev, f = _events(rng, 2 * B, n_distinct=2000)
        slot_cap = 100
    elif name == "dns_latency_wraps_u32":
        ev, f = _events(rng, B)
        f["dns"]["latency_ns"][:6] = ((1 << 32) + 7) * 1000
        ev["stats"]["packets"][:3] = 0x900  # spill: the u32 cast lives there
    elif name == "wide_fields":
        ev, f = _events(rng, B, drop_share=0.3)
        f["drops"]["packets"][::3] = rng.integers(1 << 15, 1 << 16,
                                                  len(ev[::3]))
        f["extra"]["ipsec_ret"][::2] = -1  # marker bit 3: hot word 2 bit 31
        ev["stats"]["tcp_flags"][::11] = 0x900  # spills: flags past 11 bits
        ev["stats"]["dscp"][5::13] = 0x50
    else:
        raise ValueError(name)
    return ev, f, caps, slot_cap


PACK_CASES = ("cold_key_flood", "dns_and_drop_lane_overflow",
              "rtt_past_the_code", "sampling_change", "same_key_twice",
              "full_dictionary", "dns_latency_wraps_u32", "wide_fields")


def _pack_both(ev, f, caps, slot_cap):
    """Pack events with both packers chunk by chunk from the same start;
    assert each chunk equal and return the chunks."""
    kd_j = jfp.KeyDict(slot_cap, use_native=False)
    kd_t = tfp.KeyDict(slot_cap)
    chunks = []
    start = 0
    while start < len(ev):
        bj, cj = jfp.pack_resident(ev, B, kd_j, caps, start=start, **f)
        bt, ct = tfp.pack_resident(ev, B, kd_t, caps, start=start, **f)
        assert ct == cj and ct > 0, (start, ct, cj)
        np.testing.assert_array_equal(bt, bj, err_msg=f"chunk at {start}")
        assert kd_t.count() == kd_j.count()
        assert kd_t.slots == kd_j._py
        chunks.append(bt.copy())
        start += ct
    return chunks, kd_t


@pytest.mark.parametrize("name", PACK_CASES)
def test_packer_equals_the_reference_chunk_by_chunk(name):
    ev, f, caps, slot_cap = _case(name, np.random.default_rng(7))
    chunks, kd = _pack_both(ev, f, caps, slot_cap)
    spilled = sum(int(c[2]) for c in chunks)
    if name == "cold_key_flood":
        assert len(chunks) > 3  # continuations
    if name == "dns_and_drop_lane_overflow":
        assert max(int(c[3]) & 0xFFFF for c in chunks) == caps.dns
        assert max(int(c[3]) >> 16 for c in chunks) == caps.drop
    if name in ("rtt_past_the_code", "sampling_change",
                "dns_latency_wraps_u32", "wide_fields"):
        assert spilled > 0
    if name == "full_dictionary":
        assert kd.count() == slot_cap and spilled > 0
    if name == "same_key_twice":
        assert kd.count() < 40


def test_packer_rejects_bad_arguments():
    ev, f, caps, _ = _case("rtt_past_the_code", np.random.default_rng(1))
    kd = tfp.KeyDict(64)
    with pytest.raises(ValueError, match="16-bit"):
        tfp.pack_resident(ev, 1 << 16, kd, caps)
    with pytest.raises(ValueError, match="start"):
        tfp.pack_resident(ev, B, kd, caps, start=len(ev) + 1)
    with pytest.raises(ValueError, match="progress"):
        tfp.pack_resident(ev, B, kd, tfp.ResidentCaps(8, 8, 0, 8))
    with pytest.raises(ValueError, match="slot_cap"):
        tfp.KeyDict(1 << 21)
    assert tfp.resident_buf_len(B, caps) == jfp.resident_buf_len(B, caps)
    assert tuple(tfp.default_resident_caps(16384)) == tuple(
        jfp.default_resident_caps(16384))
    for v in (0, 1, 255, 256, 4095, 1 << 20, tfp.RTT_MAX_US):
        assert tfp._rtt_code11(v) == jfp._rtt_code11(v)
    for v in (0, 1, 4095, 4096, 2_000_000, 0xFFF << 15, (0xFFF << 15) * 10):
        assert tfp._lat_code16(v) == jfp._lat_code16(v)


def test_zero_resident_region_equals_the_reference():
    caps = tfp.ResidentCaps(dns=16, drop=8, nk=8, spill=4)
    n = tfp.resident_buf_len(64, caps)
    a = np.random.default_rng(2).integers(0, 2**32, n, dtype=np.uint32)
    b = a.copy()
    tfp.zero_resident_region(a, 64, caps)
    jfp.zero_resident_region(b, 64, caps)
    np.testing.assert_array_equal(a, b)


def _unpack_both(buf, batch, caps, slot_cap, jtable=None):
    """Unpack one region with both packages from the same key table; assert
    every array and the key table equal."""
    if jtable is None:
        jtable = js.init_key_table(slot_cap)
    ttable = carry.key_table_from_numpy(np.asarray(jtable), "cpu")
    want, jtable = js.resident_to_arrays(jnp.asarray(buf), jtable, batch,
                                         caps)
    got, ttable2 = ts.resident_to_arrays(
        torch.from_numpy(buf.view(np.int32)), ttable, batch, caps)
    assert ttable2 is ttable  # in place
    assert got.keys() == want.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k == "keys":
            g = g.astype(np.uint32)
        if k == "bytes":
            g, w = g.view(np.uint32), w.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_array_equal(carry.key_table_to_numpy(ttable),
                                  np.asarray(jtable))
    return got, jtable


@pytest.mark.parametrize("name", PACK_CASES)
def test_device_unpack_equals_the_reference(name):
    """Every chunk the packer makes, unpacked against a key table that
    carries over from chunk to chunk."""
    ev, f, caps, slot_cap = _case(name, np.random.default_rng(8))
    chunks, _ = _pack_both(ev, f, caps, slot_cap)
    jtable = None
    seen = {"markers": 0, "drop_packets": 0}
    for c in chunks:
        got, jtable = _unpack_both(c, B, caps, slot_cap, jtable)
        for k in seen:
            seen[k] = max(seen[k], int(got[k].max()))
    if name == "wide_fields":
        assert seen["markers"] >= 8 and seen["drop_packets"] >= 1 << 15


def test_device_unpack_of_every_bit_pattern():
    """A synthetic region at B = 40,000 with random words in every field
    (row indices past 2^15, so bit 31 of the DNS and drop words is set;
    every top bit of the hot and drop words; undefined new-key rows)."""
    rng = np.random.default_rng(9)
    batch, slot_cap = 40_000, 1024
    caps = tfp.ResidentCaps(dns=256, drop=256, nk=64, spill=16)
    buf = rng.integers(0, 2**32, tfp.resident_buf_len(batch, caps),
                       dtype=np.uint64).astype(np.uint32)
    hot_off = tfp.RESIDENT_HDR
    dns_off = hot_off + batch * tfp.HOT_WORDS
    drop_off = dns_off + caps.dns
    nk_off = drop_off + caps.drop * 2
    hot = buf[hot_off:dns_off].reshape(batch, tfp.HOT_WORDS)
    hot[:, 0] = (hot[:, 0] & 0xFFF00000) | rng.integers(0, slot_cap, batch)
    rows = rng.integers(1 << 15, batch, caps.dns + caps.drop)
    buf[dns_off:drop_off] = ((rows[:caps.dns].astype(np.uint32) << 16)
                             | (buf[dns_off:drop_off] & 0xFFFF))
    drop = buf[drop_off:nk_off].reshape(caps.drop, 2)
    drop[:, 0] = ((rows[caps.dns:].astype(np.uint32) << 16)
                  | (drop[:, 0] & 0xFFFF))
    nk = buf[nk_off:nk_off + caps.nk * tfp.NK_WORDS].reshape(caps.nk,
                                                             tfp.NK_WORDS)
    nk[:, 0] = ((rng.random(caps.nk) < 0.7).astype(np.uint32) << 31
                | rng.permutation(slot_cap)[:caps.nk])
    got, _ = _unpack_both(buf, batch, caps, slot_cap)
    assert int(got["markers"].max()) >= 8
    assert int(got["dns_latency_us"][1 << 15:].max()) > 0
    assert int(got["drop_packets"].max()) >= 1 << 15


def _make_feed(n_batches, n_distinct=200, seed=5):
    """The reference's resident-test feed: synthetic eviction batches (one
    event per key) with DNS on 5 % and drops on 2 % of rows."""
    fetcher = SyntheticFetcher(flows_per_eviction=B, n_distinct=n_distinct,
                               seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ev = fetcher.lookup_and_delete()
        events, extra = ev.events[:B].copy(), ev.extra[:B].copy()
        n = len(events)
        dn = np.zeros(n, jbin.DNS_REC_DTYPE)
        dn["latency_ns"][rng.random(n) < 0.05] = rng.integers(1, 3_000_000)
        dr = np.zeros(n, jbin.DROPS_REC_DTYPE)
        hit = rng.random(n) < 0.02
        dr["bytes"][hit] = rng.integers(1, 3000)
        dr["packets"][hit] = 1
        dr["latest_cause"][hit] = 2
        out.append((events, dict(extra=extra, dns=dn, drops=dr)))
    return out


@pytest.mark.parametrize("slot_cap", [1 << 12, 150])
def test_ring_folds_equal_the_reference_ring(slot_cap):
    """Six batches through the JAX ring (scatter form, Python packer) and
    the port's ring with its Python packer: state tables, key table and
    counters equal; slot_cap 150 under 200 keys forces dictionary epochs.
    (`tests/test_torch_native_pack.py` holds the native packer's ring to
    this one.)"""
    caps = jfp.default_resident_caps(B)
    jring = JRing(B, js.make_ingest_resident_fn(B, caps, with_token=True,
                                                use_pallas=False),
                  caps=caps, slot_cap=slot_cap)
    jring.kdict = jfp.KeyDict(slot_cap, use_native=False)
    tring = ResidentStagingRing(B, caps=tfp.ResidentCaps(*caps),
                                slot_cap=slot_cap, device="cpu",
                                packer="python")
    jstate = js.init_state(js.SketchConfig(**GEOM))
    tstate = ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
    for events, feats in _make_feed(6):
        jstate = jring.fold(jstate, events, **feats)
        assert tring.fold(tstate, events, **feats) is tstate
    jring.drain()
    tring.drain()
    want = {k: np.asarray(v) for k, v in js.state_tables(jstate).items()}
    got = ts.state_tables(tstate)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(carry.key_table_to_numpy(tring.key_table),
                                  np.asarray(jring.key_table))
    for c in ("continuations", "dict_resets", "spill_rows"):
        assert getattr(tring, c) == getattr(jring, c), c
    assert tring.kdict.slots == jring.kdict._py
    assert tring.chunks == 6 + tring.continuations
    if slot_cap == 150:
        assert tring.dict_resets > 0
    assert float(tstate.total_records) == sum(
        len(e) for e, _ in _make_feed(6))
    tring.close()


def test_fold_events_then_roll_equals_ring_then_roll_window():
    """The exporter's resident entry against a ring driven by hand: the
    four evictions (353 rows, under one batch) wait in the pending buffer
    and fold at the roll as one chunk, as one hand fold of all their rows
    does; the same report, and the key table carries across. At one lane
    and the ladder (1,) the exporter's ring ships what
    `ResidentStagingRing` ships."""
    cfg = ts.SketchConfig(**GEOM)
    exp = TorchSketchExporter(cfg, batch_size=B, device="cpu",
                              pack_threads=1, superbatch=(1,))
    ring = ResidentStagingRing(B, device="cpu")
    state = ts.init_state(cfg, device="cpu")
    feed = _make_feed(4, seed=6)
    for events, feats in feed:
        assert exp.fold_events(events, **feats) is None
    assert exp.folds == 0 and len(exp.pending) == sum(len(e) for e, _ in
                                                      feed)
    ring.fold(state, np.concatenate([e for e, _ in feed]),
              **{k: np.concatenate([f[k] for _, f in feed])
                 for k in feed[0][1]})
    got = exp.roll()
    assert exp.folds == ring.chunks == 1 + ring.continuations
    _, rep = ts.roll_window(state, cfg)
    assert got == report_to_json(report_numpy(rep))
    assert got["Records"] == float(sum(len(e) for e, _ in feed))
    assert exp.records == got["Records"]
    assert exp.ring.key_tables.shape == (1, (1 << 18) + 1, 10)
    table = carry.key_table_to_numpy(exp.ring.key_tables[0])
    np.testing.assert_array_equal(table,
                                  carry.key_table_to_numpy(ring.key_table))
    back = carry.key_table_from_numpy(table, "cpu")
    assert back.shape == ((1 << 18) + 1, 10) and not back[-1].any()
    assert torch.equal(back, exp.ring.key_tables[0])
    with pytest.raises(ValueError):
        carry.key_table_from_numpy(table.astype(np.int64), "cpu")
    exp.close()
    with pytest.raises(RuntimeError, match="closed"):
        exp.fold_events(feed[0][0])


def test_key_table_carries_from_jax_and_back():
    """A JAX key table with live slots carried into the port unpacks the
    next chunk's hot rows to the same keys."""
    caps = jfp.default_resident_caps(B)
    feed = _make_feed(2, seed=8)
    kd_j = jfp.KeyDict(1 << 10, use_native=False)
    kd_t = tfp.KeyDict(1 << 10)
    jtable = js.init_key_table(1 << 10)
    for i, (events, feats) in enumerate(feed):
        bj, cj = jfp.pack_resident(events, B, kd_j, caps, **feats)
        bt, ct = tfp.pack_resident(events, B, kd_t, caps, **feats)
        assert cj == ct == len(events)
        if i == 0:
            _, jtable = js.resident_to_arrays(jnp.asarray(bj), jtable, B,
                                              caps)
        else:
            _unpack_both(bt, B, caps, 1 << 10, jtable)
