"""The port's staging layer (netobserv_tpu_torch/sketch/staging.py:
PendingEventBuffer, ShardedResidentStagingRing, DenseStagingRing; the lane
and compact unpacks of sketch/state.py; the lane key tables of
sketch/carry.py; TorchSketchExporter's feeds) against the JAX package's,
on the CPU.

Everything is held bit for bit: the pending buffer's fold calls row for
row, the unpacks array by array and the key tables row by row, and after
whole schedules the rings' state tables, key tables and counters. The
masses are integer-valued with per-cell sums below 2^24 (bytes 1-63 a
record), so add order cannot change a bit. The one exception is the
bounded difference of ROADMAP C5 (tests/test_torch_state.py): torch's and
XLA's f32 log can put a sample on a bucket edge one bucket apart. So the
RTT and DNS histograms are held to equal totals, and to no more samples
moved one bucket than the feed has samples that either library buckets
apart (as its raw value or as its hot-row code's value; the DNS lane's
12-bit codes put many samples on one value). The rings' `stalls` count
waits on a device that is still busy and depends on timing, so it is
left out.

Sizes: B = 512, at most 4 lanes, the small sketch geometry."""

import sys

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu.ops import quantile as jq
from netobserv_tpu.sketch import staging as jstg
from netobserv_tpu.sketch import state as js
from netobserv_tpu.sketch import tiered as jt
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.ops import quantile as tq
from netobserv_tpu_torch.ops.kernels import countmin_kernel
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import staging as tstg
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered as tt
from tests.test_torch_resident import GEOM, _events

B = 512
LANES = ("extra", "dns", "drops", "xlat", "quic")
COUNTERS = ("continuations", "dict_resets", "spill_rows", "superbatch_folds")


def _feed(rng, n, n_distinct=300, v4_share=0.5):
    """Flow events with every feature lane (tests/test_torch_resident.py
    `_events`), bytes cut to 1-63 to stay in the integer regime; with
    `v4_share` the share of v4-mapped keys."""
    ev, f = _events(rng, n, n_distinct=n_distinct)
    ev["stats"]["bytes"] = rng.integers(1, 64, n)
    if v4_share != 0.5:
        v6 = rng.random(n) >= v4_share
        for side in ("src_ip", "dst_ip"):
            ev["key"][side][~v6, :10] = 0
            ev["key"][side][~v6, 10:12] = 0xFF
            ev["key"][side][v6, 0] = 0x20
    return ev, f


class _Samples:
    """The RTT and DNS samples (us) of every fed event, to bound the
    histograms' edge moves (module docstring)."""

    def __init__(self):
        self.us = {"hist_rtt": [], "hist_dns": []}

    def add(self, f: dict) -> None:
        for k, col, name in (("hist_rtt", "extra", "rtt_ns"),
                             ("hist_dns", "dns", "latency_ns")):
            v = (f[col][name] // 1000).astype(np.int64)
            self.us[k].append(v[v > 0])

    def edge_prone(self, k: str, nb: int) -> int:
        """Samples whose raw value or hot-row code value one library
        buckets apart from the other."""
        v = np.concatenate(self.us[k] or [np.zeros(0, np.int64)])
        code = (tfp._rtt_code11 if k == "hist_rtt" else tfp._lat_code16)
        uniq, counts = np.unique(v, return_counts=True)
        dec = np.array([(c & 0xFF) << (2 * (c >> 8)) if k == "hist_rtt"
                        else (c & 0xFFF) << (c >> 12)
                        for c in map(code, uniq.tolist())], np.int64)
        cand = np.unique(np.concatenate([uniq, dec]))
        cand = cand[cand < 2 ** 31].astype(np.int32)
        gamma = jq.gamma_for(nb)
        want = np.asarray(jax.jit(lambda x: jq.bucket_of(x, nb, gamma))(
            jnp.asarray(cand)))
        got = tq.bucket_of(torch.from_numpy(cand), nb, gamma).numpy()
        off = cand[got != want]
        return int(counts[np.isin(uniq, off) | np.isin(dec, off)].sum())


def _assert_tables(port_state, jstate, where="", samples=None):
    got = ts.state_tables(port_state)
    want = {k: np.asarray(v) for k, v in js.state_tables(jstate).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, where)
        if samples is not None and k in samples.us:
            assert got[k].sum() == want[k].sum(), (k, where)
            moved = np.abs(np.cumsum(got[k].astype(np.float64) - want[k]))
            assert moved.sum() <= samples.edge_prone(k, len(want[k])), (
                k, where, moved.sum())
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {where}")


# ------------------------------------------------------ PendingEventBuffer


def _evictions(rng, superbatch_max):
    """A seeded schedule of evictions: sub-batch, batch-aligned and
    multi-batch sizes, with every feature lane present, absent or short."""
    out = []
    for i in range(14):
        n = int(rng.choice([0, 37, 200, B, 2 * B, 3 * B + 41,
                            superbatch_max * B + 5]))
        ev, f = _feed(rng, n)
        kind = i % 4
        lanes = {}
        for name in LANES:
            col = f[name]
            if kind == 1 and name in ("dns", "xlat"):
                col = None  # absent
            elif kind == 2 and name == "extra":
                col = col[:n // 2]  # short: zero rows past its end
            elif kind == 3 and name == "quic":
                col = col[:0]  # empty: absent
            lanes[name] = col
        out.append((ev, lanes))
    return out


def _lane_bytes(name, v):
    """A lane's bytes as the fold reads them. The DNS name is blanked: where
    the reference zero-pads a lane (`lane[lo:hi] = 0`), numpy writes the
    character "0" into that bytes field; the port writes zero bytes. No
    feed reads the name."""
    if name == "dns":
        v = v.copy()
        v["name"] = b""
    return v.tobytes()


def _recording_fold(calls, raise_at=()):
    def fold(events, feats):
        calls.append((events.tobytes(),
                      {k: (None if v is None else _lane_bytes(k, v))
                       for k, v in sorted(feats.items())}))
        if len(calls) in raise_at:
            raise RuntimeError("fold failed")
    return fold


@pytest.mark.parametrize("superbatch_max", [1, 4])
def test_pending_buffer_makes_the_reference_fold_calls(superbatch_max):
    """The same evictions through both buffers give the same fold calls,
    rows and lane values, the direct path included; a fold that raises
    (the 3rd and 7th) drops only its rows in both. The port's buffer, given
    a metrics facade, counts its direct rows in
    `sketch_direct_fold_rows_total`."""
    rng = np.random.default_rng(11 + superbatch_max)
    schedule = _evictions(rng, superbatch_max)
    got_calls, want_calls = [], []
    metrics = Metrics()
    tbuf = tstg.PendingEventBuffer(B, superbatch_max, metrics=metrics)
    jbuf = jstg.PendingEventBuffer(B, superbatch_max)
    for ev, lanes in schedule:
        for buf, calls, mk in ((tbuf, got_calls, EvictedFlows),
                               (jbuf, want_calls, jfetch.EvictedFlows)):
            try:
                buf.append(mk(ev, **lanes), _recording_fold(calls, (3, 7)))
            except RuntimeError:
                pass
        assert len(tbuf) == len(jbuf)
    for buf, calls in ((tbuf, got_calls), (jbuf, want_calls)):
        buf.flush_to(_recording_fold(calls))
    assert len(got_calls) == len(want_calls) > 4
    assert got_calls == want_calls
    assert tbuf.direct_rows == jbuf.direct_rows > 0
    assert (metrics.sketch_direct_fold_rows_total._value.get()
            == tbuf.direct_rows)


def test_pick_lanes_and_spill_cap_equal_the_reference():
    for per_unit in (1, 7, 512, 16384, 2 * 3 * 5 * 7):
        for want in (1, 2, 3, 4, 5, 8, 9):
            assert tstg.pick_lanes(per_unit, want) == jstg.pick_lanes(
                per_unit, want)
    for b in (8, 512, 16384):
        assert tstg.default_spill_cap(b) == jstg.default_spill_cap(b)
    assert tconfig.parse_superbatch_ladder("4,1,2,2") == (1, 2, 4)
    assert tconfig.parse_superbatch_ladder((1,)) == (1,)
    for bad in ("2,4", "1,x", "1,128", (0, 1)):
        with pytest.raises(ValueError):
            tconfig.parse_superbatch_ladder(bad)


# ------------------------------------------------------ the device unpacks


def _lane_regions(ev, f, n_lanes, bpl, caps, slot_cap, kdicts):
    """One chunk of `n_lanes` regions packed by the JAX package's Python
    packer (one dictionary a region), concatenated."""
    n = len(ev)
    bounds = [n * i // n_lanes for i in range(n_lanes + 1)]
    regions = []
    for i in range(n_lanes):
        lo, hi = bounds[i], bounds[i + 1]
        buf, _ = jfp.pack_resident(ev[lo:hi], bpl, kdicts[i], caps,
                                   **{k: v[lo:hi] for k, v in f.items()})
        regions.append(buf.copy())
    return np.concatenate(regions)


@pytest.mark.parametrize("n_lanes", [1, 3])
def test_resident_lane_arrays_equal_the_reference(n_lanes):
    """Three chunks of regions unpacked against key tables of 4 rows (more
    than the chunk's regions, as the ladder's are) carried from chunk to
    chunk: every array, and the key tables row by row."""
    rng = np.random.default_rng(20 + n_lanes)
    bpl, slot_cap, rows = 128, 256, 4
    caps = jfp.default_resident_caps(bpl)
    kdicts = [jfp.KeyDict(slot_cap, use_native=False) for _ in range(rows)]
    jtables = js.init_key_tables(rows, slot_cap)
    ttables = carry.key_table_from_numpy(np.asarray(jtables), "cpu")
    for chunk in range(3):
        ev, f = _feed(rng, n_lanes * bpl - 9, n_distinct=400)
        flat = _lane_regions(ev, f, n_lanes, bpl, caps, slot_cap, kdicts)
        want, jtables = js.resident_lane_arrays(
            jnp.asarray(flat), jtables, bpl, caps, n_lanes)
        got, back = ts.resident_lane_arrays(
            torch.from_numpy(flat.view(np.int32)), ttables, bpl,
            tfp.ResidentCaps(*caps), n_lanes)
        assert back is ttables  # in place
        assert got.keys() == want.keys()
        for k in want:
            w, g = np.asarray(want[k]), got[k].numpy()
            if k == "keys":
                g = g.astype(np.uint32)
            if k == "bytes":
                g, w = g.view(np.uint32), w.view(np.uint32)
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=f"{k} chunk {chunk}")
        np.testing.assert_array_equal(carry.key_table_to_numpy(ttables),
                                      np.asarray(jtables))
    assert int(got["dns_latency_us"].max()) > 0
    assert int(got["drop_cause"].max()) > 0


def test_compact_to_arrays_equals_the_reference():
    """A compact buffer of v4 rows with a spill lane of v6 and drop rows:
    every array, and the compact word whose top bit is the valid bit kept
    as bits."""
    rng = np.random.default_rng(31)
    spill_cap = tstg.default_spill_cap(B)
    ev, f = _feed(rng, B - 20, v4_share=0.97)
    f["extra"]["ipsec_ret"][::5] = -1  # markers past bit 2
    buf = jfp.pack_compact(ev, B, spill_cap, use_native=False, **f)
    assert buf is not None and buf[B * tfp.COMPACT_WORDS + 14] == 1
    want = js.compact_to_arrays(jnp.asarray(buf), B, spill_cap)
    got = ts.compact_to_arrays(torch.from_numpy(buf.view(np.int32)), B,
                               spill_cap)
    assert got.keys() == want.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k == "keys":
            assert (g[:, 2] == tfp.V4_PREFIX_WORD2).sum() > B // 2
            g = g.astype(np.uint32)
        if k == "bytes":
            g, w = g.view(np.uint32), w.view(np.uint32)
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
    assert int(got["markers"].max()) >= 8
    with pytest.raises(ValueError, match="compact feed"):
        ts.compact_to_arrays(torch.zeros(7, dtype=torch.int32), B, spill_cap)


def test_lane_key_tables_round_trip_through_carry():
    """(R, slot_cap, 10) u32 lane tables into the port (a sink row added to
    each) and back, and the port's own out and in."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 2**32, (3, 40, 10), dtype=np.uint64).astype(
        np.uint32)
    t = carry.key_table_from_numpy(arr, "cpu")
    assert t.shape == (3, 41, 10) and not t[:, -1].any()
    np.testing.assert_array_equal(carry.key_table_to_numpy(t), arr)
    port = ts.init_key_tables(2, 16, "cpu")
    port[:, :-1] = torch.from_numpy(arr[:2, :16].view(np.int32))
    assert torch.equal(carry.key_table_from_numpy(
        carry.key_table_to_numpy(port), "cpu"), port)
    for bad in (arr.astype(np.int64), arr[0, 0], arr[..., :9]):
        with pytest.raises(ValueError):
            carry.key_table_from_numpy(bad, "cpu")


# ------------------------------------------------------------- the rings


def _jax_lane_ring(lanes, ladder, slot_cap, cfg_kw=None, lazy=True):
    bpl = B // lanes
    caps = jfp.default_resident_caps(bpl)
    ingests = {k: js.make_ingest_resident_lanes_fn(bpl, caps, k * lanes,
                                                   use_pallas=False)
               for k in ladder}
    ring = jstg.ShardedResidentStagingRing(
        B, 1, ingests, key_tables=js.init_key_tables(max(ladder) * lanes,
                                                     slot_cap),
        put=jax.device_put, caps=caps, slot_cap=slot_cap, lanes=lanes,
        ladder=ladder, lazy_ladder=lazy)
    ring.kdicts = [jfp.KeyDict(slot_cap, use_native=False)
                   for _ in ring.kdicts]
    return ring


def _assert_ring_counters(tring, jring):
    for c in COUNTERS:
        assert getattr(tring, c) == getattr(jring, c), c
    assert tring.chunks == sum(jring.superbatch_folds.values())


@pytest.mark.parametrize("lanes", [1, 4])
def test_lane_ring_equals_the_reference_ring(lanes):
    """Folds of 1-4+ batches through ladder (1, 2, 4) with a lazy ladder:
    entry 1 alone until entry 2, then 4, is marked warm; a cold key flood
    past the new-key lane (continuations, exhausted regions) and a small
    dictionary (epochs). State tables, lane key tables and counters equal
    the JAX ring's."""
    rng = np.random.default_rng(40 + lanes)
    slot_cap, ladder = 300, (1, 2, 4)
    jring = _jax_lane_ring(lanes, ladder, slot_cap)
    tring = tstg.ShardedResidentStagingRing(
        B, slot_cap=slot_cap, device="cpu", packer="python", lanes=lanes,
        ladder=ladder, lazy_ladder=True, pack_threads=lanes)
    cfg = dict(GEOM)
    jstate = js.init_state(js.SketchConfig(**cfg))
    tstate = ts.init_state(ts.SketchConfig(**cfg), device="cpu")
    plan = [(2 * B + 7, None), (B, 2), (3 * B, None), (4 * B + 100, 4),
            (5 * B - 3, None), (B // 3, None)]
    samples = _Samples()
    for n, warm in plan:
        if warm:
            jring.mark_warm(warm)
            tring.mark_warm(warm)
        ev, f = _feed(rng, n, n_distinct=5000)
        if n == 3 * B:  # a cold key flood: every row a new key
            ev["key"]["src_port"] = np.arange(n)
        samples.add(f)
        jstate = jring.fold(jstate, ev, **f)
        assert tring.fold(tstate, ev, **f) is tstate
    jring.drain()
    _assert_tables(tstate, jstate, samples=samples)
    np.testing.assert_array_equal(carry.key_table_to_numpy(tring.key_tables),
                                  np.asarray(jring.key_tables))
    _assert_ring_counters(tring, jring)
    assert set(tring.superbatch_folds) == {1, 2, 4}
    assert tring.continuations > 0 and tring.dict_resets > 0
    assert tring.captures == [] and tring.pack_seconds > 0
    tring.close()


def test_tiered_lane_ring_equals_the_reference_ring():
    """A tiered state (interior form) through two lanes and ladder (1, 2):
    the decoded tables and the tier arrays equal the JAX ring's."""
    rng = np.random.default_rng(50)
    jring = _jax_lane_ring(2, (1, 2), 1 << 10, lazy=False)
    tring = tstg.ShardedResidentStagingRing(
        B, slot_cap=1 << 10, device="cpu", packer="python", lanes=2,
        ladder=(1, 2))
    jstate = js.init_state(js.SketchConfig(**GEOM, tiered=jt.TierSpec()))
    tcfg = ts.SketchConfig(**GEOM, tiered=tt.TierSpec())
    assert ts.tiered_fold_form(tcfg) == "interior"
    tstate = ts.init_state(tcfg, device="cpu")
    samples = _Samples()
    for n in (2 * B, B + 17, 3 * B):
        ev, f = _feed(rng, n)
        samples.add(f)
        jstate = jring.fold(jstate, ev, **f)
        tring.fold(tstate, ev, **f)
    jring.drain()
    _assert_tables(tstate, jstate, samples=samples)
    got = carry.state_to_numpy(tstate)
    for path in carry.TIER_DTYPES:
        want = jstate
        for part in path.split("."):
            want = getattr(want, part)
        np.testing.assert_array_equal(got[path], np.asarray(want),
                                      err_msg=path)
    _assert_ring_counters(tring, jring)
    assert tring.superbatch_folds[2] > 0


def test_threaded_lane_packs_equal_one_thread():
    """Eight lanes packed by 16 threads (more than this host's cores), with
    a short interpreter switch interval, against one thread: the same
    state tables, key tables and counters, so no region's dictionary,
    start row or counters lost an update."""
    rng = np.random.default_rng(45)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rings = [tstg.ShardedResidentStagingRing(
            B, slot_cap=40, device="cpu", lanes=8, ladder=(1, 2, 4),
            pack_threads=t) for t in (1, 16)]
        states = [ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
                  for _ in rings]
        for n in (4 * B + 50, 3 * B, 2 * B - 5):
            ev, f = _feed(rng, n, n_distinct=5000)
            ev["key"]["src_port"][::2] = np.arange(0, n, 2)  # new keys
            for ring, state in zip(rings, states):
                ring.fold(state, ev, **f)
    finally:
        sys.setswitchinterval(old)
    a, b = (ts.state_tables(st) for st in states)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert torch.equal(rings[0].key_tables, rings[1].key_tables)
    for c in COUNTERS + ("chunks",):
        assert getattr(rings[0], c) == getattr(rings[1], c), c
    assert rings[0].dict_resets > 0


def _jax_dense_ring(spill_cap):
    if spill_cap is None:
        return jstg.DenseStagingRing(B, js.make_ingest_dense_fn(
            with_token=True, use_pallas=False))
    return jstg.DenseStagingRing(
        B, js.make_ingest_compact_fn(B, spill_cap, with_token=True,
                                     use_pallas=False),
        spill_cap=spill_cap, ingest_fallback=js.make_ingest_dense_fn(
            with_token=True, use_pallas=False))


@pytest.mark.parametrize("feed", ["dense", "compact"])
def test_dense_ring_equals_the_reference_ring(feed):
    """Batches of mostly v4 keys, one of them v6-heavy past the spill lane,
    through the dense or compact ring (two pack threads): state tables and
    fallbacks equal the JAX ring's."""
    rng = np.random.default_rng(60)
    spill_cap = tstg.default_spill_cap(B) if feed == "compact" else None
    jring = _jax_dense_ring(spill_cap)
    tring = tstg.DenseStagingRing(B, spill_cap=spill_cap, device="cpu",
                                  pack_threads=2)
    jstate = js.init_state(js.SketchConfig(**GEOM))
    tstate = ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
    samples = _Samples()
    for share in (0.97, 0.95, 0.5, 0.99, 0.96):
        ev, f = _feed(rng, B - 13, v4_share=share)
        f["drops"][:] = 0
        f["drops"]["bytes"][::40] = 9  # drop rows ride the spill lane
        samples.add(f)
        jstate = jring.fold(jstate, ev, **f)
        tring.fold(tstate, ev, **f)
    jring.drain()
    _assert_tables(tstate, jstate, samples=samples)
    assert tring.dense_fallbacks == jring.dense_fallbacks
    assert tring.dense_fallbacks == (1 if feed == "compact" else 0)
    assert tring.chunks == 5 and tring.captures == []
    tring.close()


# -------------------------------------------------------------- fault C7


def test_sub_batch_evictions_fold_as_the_reference_folds_them():
    """Fault C7: evictions of 5,000-row-like sub-batch sizes (here 300 of
    B = 512) and a few large ones through the default exporter fold in the
    reference's batch boundaries: the JAX PendingEventBuffer in front of
    the JAX lane ring with the exporter's lanes and ladder gives the same
    dispatch count and tables, window after window."""
    rng = np.random.default_rng(70)
    cfg = ts.SketchConfig(**GEOM)
    slots = 1 << 12  # the default lanes and ladder, smaller key tables
    exp = TorchSketchExporter(cfg, batch_size=B, device="cpu",
                              resident_slots=slots)
    jstate = js.init_state(js.SketchConfig(**GEOM))
    jbuf = jring = None
    total = 0
    for window in range(2):
        samples = _Samples()
        for i in range(12):
            # a window's first eviction finds the buffer empty: the
            # direct path
            n = 300 if i and rng.random() < 0.75 else int(rng.integers(
                2 * B, 5 * B))
            ev, f = _feed(rng, n, n_distinct=2000)
            total += n
            samples.add(f)
            exp.fold_events(ev, **f)
            if jring is None:
                ring = exp.ring
                jring = _jax_lane_ring(getattr(ring, "lanes", 1),
                                       getattr(ring, "ladder", (1,)),
                                       slots, lazy=False)
                jbuf = jstg.PendingEventBuffer(B, jring.superbatch_max)

            def jfold(events, feats):
                nonlocal jstate
                jstate = jring.fold(jstate, events, **feats)
            jbuf.append(jfetch.EvictedFlows(ev, **f), jfold)
        jbuf.flush_to(jfold)
        exp._drain_pending()  # the tail, without closing the window
        jring.drain()
        _assert_tables(exp.state, jstate, f"window {window}", samples)
        assert exp.folds == sum(jring.superbatch_folds.values())
        exp.roll()
        jstate, _ = jax.jit(lambda s: js.roll_window(
            s, js.SketchConfig(**GEOM)))(jstate)
    assert exp.ring.superbatch_folds == jring.superbatch_folds
    assert exp.pending.direct_rows == jbuf.direct_rows > 0
    assert exp.records == total
    exp.close()


def test_exporter_feeds_and_flush():
    """Each feed of the exporter folds only whole batches until `flush`
    folds the tail, closes the window and publishes its report to the sink
    (the reference's `flush`); `folds` counts dispatches and `records`
    rows; `close` publishes one more, empty, window; an unknown feed, a
    bad ladder and a mesh raise."""
    rng = np.random.default_rng(80)
    ev, f = _feed(rng, 5 * B + 100, v4_share=0.97)
    for feed, rings in (("resident", tstg.ShardedResidentStagingRing),
                        ("compact", tstg.DenseStagingRing),
                        ("dense", tstg.DenseStagingRing)):
        reports = []
        exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                                  device="cpu", feed=feed, pack_threads=2,
                                  superbatch="1,2", sink=reports.append)
        exp.fold_events(ev[:100], **{k: v[:100] for k, v in f.items()})
        assert exp.folds == 0 and isinstance(exp.ring, rings)
        exp.fold_events(ev[100:], **{k: v[100:] for k, v in f.items()})
        want = {"resident": 3, "compact": 5, "dense": 5}[feed]
        assert exp.folds == want and exp.records == 5 * B
        assert exp.flush() is None
        assert exp.folds == want + 1 and exp.records == len(ev)
        assert exp.rolls == 1 and len(reports) == 1
        assert reports[0]["Records"] == float(len(ev))
        assert reports[0]["Window"] == 0
        exp.close()
        assert [r["Records"] for r in reports] == [float(len(ev)), 0.0]
    with pytest.raises(ValueError, match="feed"):
        TorchSketchExporter(batch_size=B, device="cpu", feed="fast")
    with pytest.raises(ValueError, match="ladder"):
        TorchSketchExporter(batch_size=B, device="cpu", superbatch=(2, 4))
    with pytest.raises(NotImplementedError, match="A6"):
        tstg.ShardedResidentStagingRing(B, 2, device="cpu")


def test_wrapper_gates_admit_the_ladder_shapes():
    """A k = 4 ingest of the default feed (8 lanes of 2,048 rows at B =
    16,384, each with 32 spill rows) is 66,560 rows; every kernel gate of
    the wide and tiered paths admits it."""
    caps = tfp.default_resident_caps(16384 // 8)
    rows = 4 * 8 * (16384 // 8 + caps.spill)
    assert rows == 66560
    cfg = ts.SketchConfig()
    assert countmin_kernel.fold_fits(cfg.cm_depth, cfg.cm_width, rows)
    spec = tt.TierSpec()
    assert countmin_kernel.tiered_eligible(cfg.cm_width, spec)
    assert countmin_kernel.tier2_fits(cfg.cm_depth, cfg.cm_width, spec)
    assert cfg.cm_depth * rows < 2 ** 31  # kernel 6's int32 bin entries
