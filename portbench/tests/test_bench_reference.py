"""The plain reference on a tiny stream: its hash arithmetic and its
window tables against the program's CPU fold of the same rows, and its
histogram envelope."""

import numpy as np
import pytest
import torch

from portbench import generator, harness
from portbench.reference import hashing, judge, sketch
from portbench.tests.helpers import ROOT, small_mix

CPU = torch.device("cpu")


def _stream(name="fullmap", flows=1500, pool=3):
    mix = small_mix(generator.load_mix(ROOT / "portbench", name),
                    flows=flows, pool=pool)
    return generator.make_pool(mix, 2**33 + 17, harness._dtypes())


def _geo(config="node-dense"):
    cfg = harness.load_json(ROOT / "portbench" / "configs" /
                            f"{config}.json")
    return sketch.Geometry.from_dict(cfg["geometry"])


def test_frozen_hashes_equal_the_programs():
    from netobserv_tpu_torch.ops.hashing import base_hashes_multi_np
    pool = _stream()
    words = sketch.columns(pool.events[0], pool.lanes[0])["words"]
    ours = hashing.multi_hashes(torch.as_tensor(words))
    theirs = base_hashes_multi_np(words.astype(np.uint32))
    for k in hashing.FAMILIES:
        assert np.array_equal(ours[k].numpy(), theirs[k].astype(np.int64)), k


def _program_tables(pool, order, batch=1024):
    """The program's tables after its CPU fold of the evictions `order`."""
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.sketch import state as sk
    st = sk.init_state(sk.SketchConfig(), "cpu")
    for i in order:
        ev, ln = pool.events[i], pool.lanes[i]
        for a in range(0, len(ev), batch):
            dense = flowpack.pack_dense(
                ev[a:a + batch], batch_size=batch, native=False,
                **{k: v[a:a + batch] for k, v in ln.items()})
            sk.ingest(st, sk.dense_to_arrays(torch.as_tensor(
                dense.reshape(-1).view(np.int32))))
    return sk.state_tables(st)


def test_reference_matches_the_programs_cpu_fold():
    pool = _stream()
    geo = _geo()
    order = [0, 1, 2, 0]
    evs = [(sketch.eviction_tables(sketch.columns(e, l), geo, "dense", CPU),
            torch.as_tensor(ids), len(e))
           for e, l, ids in zip(pool.events, pool.lanes, pool.flow_ids)]
    tables = _program_tables(pool, order)
    num = judge.judge(geo, evs, order, [{"tables": tables, "report": None}],
                      CPU)
    assert num["sum_gap"] < 1e-6
    assert num["hll_diff"] == 0 and num["hist_out"] == 0
    assert num["evictions_lost"] == 0
    assert num["heavy_gap"] < 1e-6


def test_reference_sums_by_hand():
    """Count-Min and DSCP cells of a 3-row stream, added up by hand."""
    pool = _stream(flows=3, pool=1)
    geo = _geo()
    cols = sketch.columns(pool.events[0], pool.lanes[0])
    t = sketch.eviction_tables(cols, geo, "dense", CPU)
    h = hashing.multi_hashes(torch.as_tensor(cols["words"]))
    cm = np.zeros(geo.cm_depth * geo.cm_width)
    dscp = np.zeros(sketch.N_DSCP)
    for r in range(3):
        for d in range(geo.cm_depth):
            col = (int(h["h1"][r]) + d * int(h["h2"][r])) % geo.cm_width
            cm[d * geo.cm_width + col] += cols["bytes"][r]
        dscp[cols["dscp"][r]] += cols["bytes"][r]
    assert np.array_equal(t["cm_bytes"].numpy(), cm)
    assert np.array_equal(t["dscp_bytes"].numpy(), dscp)
    assert float(t["scalars"][0]) == 3


def test_window_tables_weigh_and_maximise():
    pool = _stream(flows=200, pool=2)
    geo = _geo()
    evs = [sketch.eviction_tables(sketch.columns(e, l), geo, "dense", CPU)
           for e, l in zip(pool.events, pool.lanes)]
    w = sketch.window_tables(evs, [2, 1])
    assert torch.equal(w["cm_bytes"], evs[0]["cm_bytes"] * 2
                       + evs[1]["cm_bytes"])
    assert torch.equal(w["hll_src"], torch.maximum(evs[0]["hll_src"],
                                                   evs[1]["hll_src"]))


def test_the_resident_envelope_admits_the_hot_lane_codes():
    geo = _geo()
    us = torch.arange(1, 6000, dtype=torch.int64)
    must_d, may_d, n = sketch._envelope([us], geo)
    must_r, may_r, _ = sketch._envelope([us, sketch.rtt_hot(us)], geo)
    assert n == len(us)
    assert (must_r <= must_d).all() and (may_r >= may_d).all()
    # exact below 256 us, at most 1/64 below the value above
    hot = sketch.rtt_hot(us)
    assert torch.equal(hot[:255], us[:255])
    assert ((us - hot) * 64 <= us).all()


@pytest.mark.parametrize("records,want", [
    ([3000.0, 6000.0, 0.0, 3000.0], ([(0, 1), (1, 3), (3, 3), (3, 4)], 0)),
    ([3000.0, 3000.0], ([(0, 1), (1, 2)], 2)),
])
def test_windows_split_at_evictions(records, want):
    assert judge.split_windows([3000] * 4, records) == want
