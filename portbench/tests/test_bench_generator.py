"""The traffic generator: each eviction a drained map (distinct flows),
the churn mix's recurrence, and one pool a seed."""

import numpy as np
import pytest

from portbench import generator, harness
from portbench.reference import sketch
from portbench.tests.helpers import ROOT, small_mix


def _pool(name, seed=2**40 + 3, **kw):
    mix = small_mix(generator.load_mix(ROOT / "portbench", name), **kw)
    return mix, generator.make_pool(mix, seed, harness._dtypes())


@pytest.mark.parametrize("name", ["fullmap", "churn", "smallmap"])
def test_each_eviction_holds_each_flow_once(name):
    mix, pool = _pool(name)
    for ev, lanes, ids in zip(pool.events, pool.lanes, pool.flow_ids):
        assert len(ev) == mix["flows_per_eviction"]
        assert len(np.unique(ids)) == len(ids)
        words = sketch.columns(ev, lanes)["words"]
        assert len(np.unique(words, axis=0)) == len(ids)


def test_churn_flows_recur_only_after_the_whole_universe():
    mix, pool = _pool("churn", flows=500, pool=6)
    seen = np.concatenate(pool.flow_ids)
    assert len(np.unique(seen)) == mix["universe"] == len(seen)


def test_fullmap_heavy_flows_recur_each_tick():
    mix, pool = _pool("fullmap", flows=2000, pool=4)
    common = set(pool.flow_ids[0])
    for ids in pool.flow_ids[1:]:
        common &= set(ids)
    assert len(common) > 0.1 * mix["flows_per_eviction"]


@pytest.mark.parametrize("name", ["fullmap", "churn", "smallmap"])
def test_a_seed_gives_one_pool(name):
    _, a = _pool(name, seed=2**35 + 1)
    _, b = _pool(name, seed=2**35 + 1)
    _, c = _pool(name, seed=2**35 + 2)
    for x, y in zip(a.events, b.events):
        assert x.tobytes() == y.tobytes()
    assert any(x.tobytes() != z.tobytes() for x, z in zip(a.events, c.events))


def test_bytes_follow_the_flow_rate_and_floor():
    mix, pool = _pool("fullmap")
    b = np.concatenate([e["stats"]["bytes"] for e in pool.events])
    assert b.min() >= mix["rate_floor_bytes"]
    # a Pareto law of alpha 1.2: elephants far above the median
    assert b.max() > 100 * np.median(b)
