"""The fused drain's seam (ROADMAP A7) on the CPU: the port's exporter fed
the regions its lanes ring's dictionaries were packed into at drain time
(`resident_pack_surface`, `evicted.packed`,
`ShardedResidentStagingRing.fold_packed`), against the JAX package's
`TpuSketchExporter` fed the same fused drains by its own gate, and
against the port's exporter fed the same evictions raw.

The drains are injected maps (fd < 0) that split flow events with their
extra, DNS and drop lanes into an aggregation map and per-CPU feature
maps at 8 CPUs, whose integer partials merge to the events' values, with
about 2 % of the feature rows orphans (keys the aggregation map lacks).
Each package's gate (`NativeEvictPipeline`, four lanes) is bound to its
exporter's pack surface: drain 1 runs the Python chain, every later one
is fused and carries `packed`. The schedule mixes fused and raw
evictions, a raw eviction of a whole batch between a pack and its ship
(the arena's epoch is then stale: it is freed, `outstanding` is back to 0
and its rows fold raw), a window rolled, and a sub-batch tail left in the
pending buffer until the drain. The tables are held bit for bit (the RTT
and DNS histograms of port and reference within
`tests/test_torch_staging`'s edge bound, as everywhere in these tests).

Also: a wedged slot wait in the middle of `fold_packed` adopts the state
the segments before it folded and invalidates the surface; the agent
binds the surface when the fetcher and the exporter both have their
hook, and not otherwise; with a Python packer or overload control the
exporter offers no surface.
"""

from __future__ import annotations

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu.datapath import loader as jloader
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.agent import FlowsAgent
from netobserv_tpu_torch.datapath import fetcher as tfetch
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.datapath import loader as tloader
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.model import binfmt as tbin
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import tracing
from tests.test_torch_overload import NeverReady
from tests.test_torch_staging import B, GEOM, _assert_tables, _feed, _Samples

N_CPUS = 8
#: the feature maps the drains carry
KINDS = ("extra", "dns", "drops")


def split_maps(rng, events, feats, orphan_share=0.02) -> list:
    """An eviction as injected maps: [(keys (n, 40) u8, values (n, n_cpus)
    records)], the aggregation map's stats first (one CPU), then each
    feature map at N_CPUS CPUs: its rows' partials merge to the record
    (the drop counters split over the CPUs, every other field on each),
    and about `orphan_share` of its rows carry a key the aggregation map
    lacks."""
    keys = np.ascontiguousarray(events["key"]).view(np.uint8).reshape(
        len(events), 40)
    maps = [(keys, np.ascontiguousarray(events["stats"])[:, None])]
    for kind in KINDS:
        rec = feats[kind]
        fk = keys.copy()
        orphan = rng.random(len(rec)) < orphan_share
        fk[orphan, 36:38] = rng.integers(0, 256, (int(orphan.sum()), 2))
        fk[orphan, 39] = 0xA5  # the key's pad byte: never an agg key's
        parts = np.repeat(rec[:, None], N_CPUS, axis=1)
        if kind == "drops":
            for col in ("bytes", "packets"):
                total = rec[col].astype(np.int64)
                cut = np.sort(rng.integers(0, total[:, None] + 1,
                                           (len(rec), N_CPUS - 1)), axis=1)
                edges = np.concatenate([np.zeros((len(rec), 1), np.int64),
                                        cut, total[:, None]], axis=1)
                parts[col] = np.diff(edges, axis=1)
        maps.append((fk, np.ascontiguousarray(parts)))
    return maps


def _eviction(rng, n):
    ev, f = _feed(rng, n, v4_share=0.97)
    f["drops"]["bytes"] = rng.integers(0, 600, n)
    f["drops"]["packets"] = rng.integers(0, 9, n)
    return ev, f


class _Map:
    def __init__(self, dtype, n_cpus):
        self.fd, self.n_cpus, self.max_entries = -1, n_cpus, 1 << 16
        self._no_batch_ops, self._pad_vs = False, dtype.itemsize


class _Fetcher:
    """The kernel fetchers' duck type over injected maps, with the gate's
    binding hook (`bind_pack_surface`)."""

    def __init__(self, loader, lanes=4):
        self._agg = _Map(tbin.FLOW_STATS_DTYPE, 1)
        self._features = {k: (_Map(tfp.PIPE_DTYPES[k], N_CPUS),
                              tfp.PIPE_DTYPES[k]) for k in KINDS}
        self.gate = loader.NativeEvictPipeline(self, lanes)
        self._loader = loader

    def bind_pack_surface(self, surface) -> None:
        self.gate.bind_pack_surface(surface)

    def drain(self, maps: list):
        """One drain of `maps`: fused once the gate is engaged, else the
        Python chain."""
        gate = self.gate
        if gate._drains >= 1:
            if gate._pipe is None:
                assert gate._build()
            for i, (k, v) in enumerate(maps):
                gate._pipe.set_drained(i, k, v)
        out = gate.drain(tracing.NULL_TRACE, 0.0)
        if out is None:
            out = self._loader.decode_eviction(
                maps[0][0], maps[0][1],
                {kind: maps[i + 1] for i, kind in enumerate(KINDS)})
        return out


def _exporters():
    """The port's exporter (lanes 4, ladder (1, 2)), its raw twin, and the
    reference's, shown one device, its ladder warmed."""
    kw = dict(batch_size=B, window_s=3600.0, pack_threads=4,
              superbatch=(1, 2), resident_slots=1 << 12,
              sink=lambda r: None)
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), device="cpu", **kw)
    raw = TorchSketchExporter(ts.SketchConfig(**GEOM), device="cpu", **kw)
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        jexp = TpuSketchExporter(
            sketch_cfg=js.SketchConfig(**GEOM, use_pallas=False), **kw)
    finally:
        jax.devices = devices
    jexp.warm_superbatch_ladder(block=True)
    return exp, raw, jexp


def _unpacked(ev) -> tfetch.EvictedFlows:
    return tfetch.EvictedFlows(ev.events, extra=ev.extra, dns=ev.dns,
                               drops=ev.drops)


@pytest.mark.parametrize("against", ["reference", "raw"])
def test_fused_and_raw_evictions_fold_the_reference_tables(against):
    """`reference`: the schedule as it comes, a raw tail still pending
    when a fused eviction ships at once (its rows go first, as in the
    reference), held against the JAX exporter. `raw`: every exporter's
    pending rows drained before a fused eviction ships, so that the raw
    twin folds the same batches in the same order; held against the raw
    twin and the JAX exporter."""
    rng = np.random.default_rng(7)
    exp, raw, jexp = _exporters()
    ours, ref = _Fetcher(tloader), _Fetcher(jloader)
    samples = _Samples()
    try:
        ours.bind_pack_surface(exp.resident_pack_surface())
        ref.bind_pack_surface(jexp.resident_pack_surface())
        surface = exp.resident_pack_surface()
        assert surface is exp._pack_surface and exp.ring.lanes == 4
        kinds = []

        def feed(n, fused=True):
            if fused and against == "raw" and len(exp.pending) and \
                    ours.gate._drains:
                # before the pack: a raw fold after it would stale it
                for x in (exp, raw):
                    with x._lock:
                        x._drain_pending()
                with jexp._lock:
                    jexp._drain_pending_locked()
            ev, f = _eviction(rng, n)
            samples.add(f)
            maps = split_maps(rng, ev, f)
            a = ours.drain(maps) if fused else tloader.decode_eviction(
                maps[0][0], maps[0][1],
                {k: maps[i + 1] for i, k in enumerate(KINDS)})
            b = ref.drain(maps) if fused else jloader.decode_eviction(
                maps[0][0], maps[0][1],
                {k: maps[i + 1] for i, k in enumerate(KINDS)})
            assert a.events.tobytes() == b.events.tobytes()
            for k in KINDS:
                assert getattr(a, k).tobytes() == getattr(b, k).tobytes()
            assert (a.packed is None) == (b.packed is None)
            if a.packed is not None:
                assert a.packed.arena.tobytes() == b.packed.arena.tobytes()
            kinds.append("fused" if a.packed is not None else "raw")
            return a, b

        twin = raw.resident_pack_surface()

        def export(a, b):
            shipped = a.packed is not None and \
                a.packed.epoch == surface.epoch
            raw.export_evicted(_unpacked(a))
            if shipped:
                # a shipped arena folds its rows at once, the last partial
                # batch too: the raw twin folds them as its pending buffer
                # drains
                with raw._lock:
                    raw._drain_pending()
            exp.export_evicted(a)
            jexp.export_evicted(b)

        for n in (300, 2 * B + 70, B + 5, 3 * B + 11):
            export(*feed(n))
        export(*feed(B + 40, fused=False))
        export(*feed(190))
        # a raw fold between a pack and its ship: the arena is stale
        held = feed(B + 3)
        assert surface.outstanding == 1
        resets = exp.ring.dict_resets
        # the raw twin's dictionaries take the same epoch roll
        twin.outstanding += 1
        export(*feed(2 * B, fused=False))
        assert twin.epoch == 1
        assert surface.outstanding == 0 and surface.epoch == 1
        assert exp.ring.dict_resets == resets + len(exp.ring.kdicts)
        arena = held[0].packed
        export(*held)
        assert arena.arena is None  # freed, its rows refolded raw
        for w in range(2):
            if w:
                for x in (exp, raw, jexp):
                    x.flush()
                for n in (B + 17, 2 * B + 2):
                    export(*feed(n))
            export(*feed(61, fused=False))  # a raw sub-batch tail
            assert len(exp.pending) > 0
        assert kinds[0] == "raw" and kinds.count("fused") == 7
        with exp._lock:
            exp._drain_pending()
        with raw._lock:
            raw._drain_pending()
        with jexp._lock:
            jexp._drain_pending_locked()
        _assert_tables(exp.state, jexp._state, "vs reference", samples)
        if against == "raw":
            got, want = (ts.state_tables(x.state) for x in (exp, raw))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert exp.records == raw.records and exp.ingest_errors == 0
        assert exp.ring.superbatch_folds.keys() == {1, 2}
    finally:
        for x in (exp, raw, jexp):
            x.close()
        ours.gate.close()
        ref.gate.close()


def test_a_wedge_inside_fold_packed_adopts_the_state_and_invalidates():
    rng = np.random.default_rng(3)
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", pack_threads=4,
                              superbatch=(1, 2), resident_slots=1 << 12,
                              sink=lambda r: None)
    fetcher = _Fetcher(tloader)
    try:
        fetcher.bind_pack_surface(exp.resident_pack_surface())
        surface = exp._pack_surface
        ev, f = _eviction(rng, 200)
        exp.export_evicted(fetcher.drain(split_maps(rng, ev, f)))
        ev, f = _eviction(rng, 3 * B)
        fused = fetcher.drain(split_maps(rng, ev, f))
        assert fused.packed is not None and fused.packed.segs >= 2
        ring = exp.ring
        state, chunks = exp.state, ring.chunks
        ring.slot_wait_budget_s = 0.05
        wedged = (ring._slot + 1) % len(ring._bufs)
        ring._copied[wedged] = NeverReady()
        arena, epoch = fused.packed, surface.epoch
        exp.export_evicted(fused)
        assert exp.ingest_errors == 1 and ring.chunks == chunks + 1
        assert exp.state is state  # the segment before the wedge folded
        assert surface.epoch == epoch + 1 and surface.outstanding == 0
        assert arena.arena is None
        assert all(d.count() == 0 for d in ring.kdicts)
        ring._copied[wedged] = None
        ev, f = _eviction(rng, B + 9)
        again = fetcher.drain(split_maps(rng, ev, f))
        assert again.packed.epoch == surface.epoch
        exp.export_evicted(again)
        assert ring.chunks > chunks + 1 and exp.ingest_errors == 1
    finally:
        exp.close()
        fetcher.gate.close()


class _Exp:
    """An exporter stand-in with or without the surface hook."""

    name = "stand-in"

    def __init__(self, surface):
        self._surface = surface

    def resident_pack_surface(self):
        return self._surface

    def export_batch(self, records):
        pass


class _BareFetcher(tfetch.FakeFetcher):
    pass


class _HookedFetcher(tfetch.FakeFetcher):
    def __init__(self):
        super().__init__()
        self.bound = []

    def bind_pack_surface(self, surface):
        self.bound.append(surface)


def test_the_agent_binds_the_surface_only_when_both_sides_hook():
    cfg = tcfg.load_config({"EXPORT": "tpu-sketch", "AGENT_IP": "10.9.9.9"})
    real = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                               device="cpu", pack_threads=4,
                               sink=lambda r: None)
    try:
        for exporter, want in ((real, real.resident_pack_surface()),
                               (_Exp(object()), "stand-in"),
                               (_Exp(None), None)):
            fetcher = _HookedFetcher()
            FlowsAgent(cfg, fetcher, exporter)
            if want is None:
                assert fetcher.bound == []
            else:
                assert len(fetcher.bound) == 1
                if exporter is real:
                    assert fetcher.bound[0] is real._pack_surface
        FlowsAgent(cfg, _BareFetcher(), real)  # no hook: nothing to bind
        bare = _HookedFetcher()
        FlowsAgent(cfg, bare, type("E", (), {
            "name": "x", "export_batch": lambda s, r: None})())
        assert bare.bound == []
    finally:
        real.close()
    # EVICT_NATIVE_PIPELINE is taken now that the kernel fetchers build
    # the gate (`datapath/loader.BpfmanFetcher`, `MinimalKernelFetcher`)
    native = tcfg.load_config({"EXPORT": "tpu-sketch",
                               "EVICT_NATIVE_PIPELINE": "true"})
    native.validate()
    assert native.evict_native_pipeline


@pytest.mark.parametrize("kw", [dict(packer="python"),
                                dict(shed_watermark=0.5),
                                dict(feed="dense")],
                         ids=["python-packer", "overload", "dense-feed"])
def test_no_surface_without_native_lanes_or_with_overload(kw):
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", pack_threads=4,
                              sink=lambda r: None, **kw)
    try:
        assert exp.resident_pack_surface() is None
    finally:
        exp.close()
    assert jfp.native_available()
