"""The one-call segment pack (netobserv_tpu_torch/csrc/flowpack.cc
`fp_pack_resident_segment`, datapath/flowpack.pack_resident_segment) and
the resident lane ring that packs through it, on the CPU.

The segment pack is held word for word against the per-region loop it
replaces (`pack_resident_native` a region, the ring's epoch roll and
`zero_resident_region`), with equal rows consumed, spill rows, epoch rolls
and dictionaries, segment after segment: k in {1, 2, 4} at 8 lanes, 1, 2
and 8 worker threads, cold dictionaries (the new-key and spill lanes fill,
so continuation segments follow and regions run out inside them) and a
small slot cap (epoch rolls inside a chunk), over a dirty slot buffer.
The ring with the native packer is held against the ring with the Python
packer (state tables, key tables, counters); its engagement counter and
its `pack_lane` observations are counted."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import staging as tstg
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import tracing
from tests.test_torch_resident import GEOM
from tests.test_torch_staging import LANES, _feed

#: rows a region, and caps small enough that cold dictionaries fill the
#: new-key and spill lanes
BPR = 64
CAPS = tfp.ResidentCaps(dns=8, drop=8, nk=12, spill=6)


@pytest.fixture(scope="module")
def native():
    return tfp.native_lib()


def _loop_segment(ev, f, bounds, dicts, starts, out, slot_cap):
    """The per-region loop: each region's rows consumed, spill rows and
    epoch roll, packed region by region with `pack_resident_native`."""
    rw = tfp.resident_buf_len(BPR, CAPS)
    stats = np.zeros((len(dicts), 3), np.int64)
    for i, kd in enumerate(dicts):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        region = out[i * rw:(i + 1) * rw]
        if starts[i] >= hi - lo:
            tfp.zero_resident_region(region, BPR, CAPS)
            continue
        if kd.count() >= slot_cap:
            kd.reset()
            stats[i, 2] = 1
        _, consumed = tfp.pack_resident_native(
            ev[lo:hi], BPR, kd, CAPS, start=int(starts[i]), out=region,
            **{k: v[lo:hi] for k, v in f.items()})
        starts[i] += consumed
        stats[i, :2] = consumed, region[2]
    return stats


@pytest.mark.parametrize("slot_cap", [1 << 12, 40], ids=["warm", "rolls"])
@pytest.mark.parametrize("workers", [1, 2, 8])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_the_segment_pack_equals_the_per_region_loop(native, k, workers,
                                                     slot_cap):
    rng = np.random.default_rng(3000 + 10 * k + workers)
    nr = 8 * k
    rw = tfp.resident_buf_len(BPR, CAPS)
    got_dicts = [tfp.NativeKeyDict(slot_cap) for _ in range(nr)]
    want_dicts = [tfp.NativeKeyDict(slot_cap) for _ in range(nr)]
    handles = np.array([d._live_handle() for d in got_dicts], np.uint64)
    pool = tfp.PackWorkers() if workers > 1 else None
    segs = exhausted = rolls = 0
    try:
        # a full chunk from cold dictionaries, then a short one and a full
        # one against what they learned
        for n in (nr * BPR, nr * BPR // 2 + 5, nr * BPR):
            ev, f = _feed(rng, n, n_distinct=2000)
            bounds = np.array([n * i // nr for i in range(nr + 1)],
                              np.uint64)
            lanes = tuple(tfp._fit_rows(f[name], n, dt)
                          for name, dt in zip(LANES, tfp._LANE_DTYPES))
            got_starts = np.zeros(nr, np.uint64)
            want_starts = np.zeros(nr, np.uint64)
            stats = np.zeros((nr, 4), np.int64)
            left = nr
            while left:
                dirty = rng.integers(0, 1 << 32, nr * rw, dtype=np.uint32)
                got, want = dirty.copy(), dirty.copy()
                exhausted += int(np.sum(want_starts >= np.diff(bounds)))
                left = tfp.pack_resident_segment(
                    ev, lanes, bounds, handles, got_starts, got, BPR, CAPS,
                    slot_cap, stats, pool, workers)
                ref = _loop_segment(ev, f, bounds, want_dicts, want_starts,
                                    want, slot_cap)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"segment {segs}")
                np.testing.assert_array_equal(stats[:, :3], ref)
                np.testing.assert_array_equal(got_starts, want_starts)
                assert (stats[:, 3] > 0).tolist() == (ref[:, 0] > 0).tolist()
                assert left == int(np.sum(want_starts < np.diff(bounds)))
                assert [d.count() for d in got_dicts] == \
                    [d.count() for d in want_dicts]
                rolls += int(ref[:, 2].sum())
                segs += 1
    finally:
        if pool is not None:
            pool.close()
        for d in got_dicts + want_dicts:
            d.close()
    assert segs > 3  # continuation segments ran
    assert exhausted > 0  # regions ran out inside a continuation segment
    assert (rolls > 0) == (slot_cap == 40)


def test_the_segment_pack_refuses_what_it_cannot_pack(native):
    ev, f = _feed(np.random.default_rng(3100), 4 * BPR)
    bounds = np.array([0, BPR, 2 * BPR, 3 * BPR, 4 * BPR], np.uint64)
    dicts = [tfp.NativeKeyDict(1 << 10) for _ in range(4)]
    handles = np.array([d._live_handle() for d in dicts], np.uint64)
    out = np.zeros(4 * tfp.resident_buf_len(BPR, CAPS), np.uint32)
    starts = np.zeros(4, np.uint64)
    stats = np.zeros((4, 4), np.int64)
    lanes = (None,) * 5
    try:
        with pytest.raises(ValueError, match="out"):
            tfp.pack_resident_segment(ev, lanes, bounds, handles, starts,
                                      out[:-1], BPR, CAPS, 1 << 10, stats)
        with pytest.raises(ValueError, match="past"):
            tfp.pack_resident_segment(ev[:-1], lanes, bounds, handles,
                                      starts, out, BPR, CAPS, 1 << 10, stats)
        with pytest.raises(ValueError, match="uint64"):
            tfp.pack_resident_segment(ev, lanes, bounds.astype(np.int64),
                                      handles, starts, out, BPR, CAPS,
                                      1 << 10, stats)
        with pytest.raises(ValueError, match="refused"):
            tfp.pack_resident_segment(ev, lanes, bounds, handles, starts,
                                      out, BPR, CAPS, 0, stats)
        assert tfp.pack_resident_segment(ev, lanes, bounds, handles, starts,
                                         out, BPR, CAPS, 1 << 10,
                                         stats) >= 0
    finally:
        for d in dicts:
            d.close()


class _Counted:
    """Counts the regions each native segment call packed."""

    def __init__(self, monkeypatch):
        self.packed = 0
        real = tfp.pack_resident_segment

        def counted(*args, **kw):
            left = real(*args, **kw)
            stats = args[9]
            self.packed += int(np.sum(stats[:, 0] > 0))
            return left

        monkeypatch.setattr(tfp, "pack_resident_segment", counted)


@pytest.mark.parametrize("threads,slot_cap", [(1, 1 << 12), (4, 1 << 12),
                                              (4, 150)])
def test_the_native_ring_equals_the_python_ring(native, monkeypatch, threads,
                                                slot_cap):
    """A lane ring (4 lanes, ladder 1, 2, 4) folds the same state, key
    tables and counters with either packer; with the native packer every
    dispatch packed in one native call, and a traced fold observes one
    `pack_lane` a packed region in `stage_seconds`."""
    counted = _Counted(monkeypatch)
    caps = tfp.ResidentCaps(dns=16, drop=16, nk=24, spill=8)
    rings, states, metrics = [], [], []
    for packer in ("native", "python"):
        m = Metrics()
        rings.append(tstg.ShardedResidentStagingRing(
            512, caps=caps, slot_cap=slot_cap, device="cpu", lanes=4,
            ladder=(1, 2, 4), pack_threads=threads, packer=packer,
            metrics=m))
        states.append(ts.init_state(ts.SketchConfig(**GEOM), device="cpu"))
        metrics.append(m)
    rng = np.random.default_rng(3200 + threads)
    feed = [_feed(rng, n, n_distinct=1500) for n in (300, 4 * 512 + 7,
                                                     2 * 512, 3 * 512 + 1)]
    tm = Metrics()
    tracing.configure(1.0)
    tracing.set_metrics(tm)
    try:
        for ev, f in feed:
            for ring, state in zip(rings, states):
                assert ring.fold(state, ev, **f) is state
    finally:
        tracing.configure(0.0)
        tracing.set_metrics(None)
    native_ring, python_ring = rings
    try:
        got, want = (ts.state_tables(s) for s in states)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(
            carry.key_table_to_numpy(native_ring.key_tables),
            carry.key_table_to_numpy(python_ring.key_tables))
        for c in ("continuations", "dict_resets", "spill_rows",
                  "superbatch_folds", "chunks"):
            assert getattr(native_ring, c) == getattr(python_ring, c), c
        assert [d.count() for d in native_ring.kdicts] == \
            [d.count() for d in python_ring.kdicts]
        assert native_ring.continuations > 0
        assert set(native_ring.superbatch_folds) == {1, 2, 4}
        assert (native_ring.dict_resets > 0) == (slot_cap == 150)
        assert native_ring.native_segments == native_ring.chunks
        assert python_ring.native_segments == 0
        assert [m.sketch_resident_native_segments_total._value.get()
                for m in metrics] == [native_ring.chunks, 0]
        # the native ring observes a packed region once; the Python ring
        # opens a span on every region of every segment
        regions = sum(4 * k * n
                      for k, n in python_ring.superbatch_folds.items())
        assert counted.packed < regions  # exhausted regions were masked
        count, = [s.value for s in tm.stage_seconds.collect()[0].samples
                  if s.name.endswith("_count")
                  and s.labels.get("stage") == "pack_lane"]
        assert count == counted.packed + regions
    finally:
        for r in rings:
            r.close()
