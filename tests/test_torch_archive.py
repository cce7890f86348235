"""The port's archive plane (netobserv_tpu_torch/archive: segment.py,
store.py, query.py and the facade, config.ArchiveSettings, and the
exporter's and aggregator's archive seams) against the JAX package's, on
the CPU.

- The segment codec: the golden byte for byte, seeded snapshots (raw and
  zlib) equal to the reference encoder's bytes, each package decoding the
  other's segments, and every rejection of tests/test_archive_golden.py
  with the same error class and message.
- The store: the schedules of tests/test_archive.py:112-207 leave the
  same directory (file names and bytes) under both packages.
- The engine: a port-written store queried by both engines gives the same
  body on every view and error (`merge_seconds` aside; report floats as
  tests/test_torch_query_plane.py holds them), raw ranges bit-exact
  against the union roll, padded and chained ranges exact, compacted
  ranges within the widened Count-Min bars, the same compaction schedule
  leaving byte-identical segment files, and no retrace.
- The exporter and the aggregator: each closed window archived as the JAX
  exporter archives it (a wedged archive disk losing the segment, never
  the report), `/query/range` and `/federation/range` wired through, and
  no archive object without an archive directory.

No test waits on a clock: windows close by `flush()`. Sizes: the
geometry of tests/test_torch_federation.py (tests/test_federation.py's at
half width) for the engine, and the JAX engine's ladder at most 2 wide
(its unrolled merges compile slowly on the CPU)."""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from netobserv_tpu import archive as jarch
from netobserv_tpu import config as jconfig
from netobserv_tpu.archive import segment as jseg
from netobserv_tpu.archive import store as jstore
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.federation import query as rquery
from netobserv_tpu.federation import statemerge as rmerge
from netobserv_tpu.federation.aggregator import (
    FederationAggregator as RefAggregator,
)
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.ops import hll as jhll
from netobserv_tpu.sketch import state as js
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu_torch import archive as tarch
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.archive import segment as tseg
from netobserv_tpu_torch.archive import store as tstore
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.federation import query as pquery
from netobserv_tpu_torch.federation.aggregator import FederationAggregator
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.ops.hashing import base_hashes_multi_np
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.utils import faultinject, retrace
from tests import test_archive_golden as golden
from tests.test_federation import make_arrays
from tests.test_torch_federation import (
    DIMS, GAMMA, JCFG, TCFG, _agent_tables, _frame, _serve,
)
from tests.test_torch_query_plane import _assert_report, _timeless
from tests.test_torch_resident import GEOM
from tests.test_torch_staging import B, _feed, _Samples
from tests.test_torch_window import _jax_exporter, _port_exporter

#: the engine tests' archived windows
N_WINDOWS = 10


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()


def _host(tables) -> dict:
    return {k: np.asarray(v) for k, v in tables.items()}


@pytest.fixture(scope="module")
def windows():
    """N_WINDOWS windows of 2 batches each over one 40-key universe (at
    most topk keys, so no merge order truncates the slot table), folded
    and rolled by the JAX package: (per-window tables, per-window batches,
    universe)."""
    rng = np.random.default_rng(7)
    universe = rng.integers(0, 2**32, (40, 10), dtype=np.uint32)
    roll = js.make_roll_fn(JCFG, with_tables=True)
    s = js.init_state(JCFG)
    tables, batches = [], []
    for _ in range(N_WINDOWS):
        bs = [make_arrays(rng, universe) for _ in range(2)]
        for arrays in bs:
            s = js.ingest(s, arrays)
        s, _, t = roll(s)
        tables.append(_host(t))
        batches.append(bs)
    return tables, batches, universe


def _port_archive(path, tables, raw_windows=64, compact_group=8,
                  max_levels=3, ladder_max=16, metrics=None):
    store = tstore.ArchiveStore(str(path), raw_windows=raw_windows,
                                compact_group=compact_group,
                                max_levels=max_levels, metrics=metrics)
    arch = tarch.SketchArchive(store, TCFG, metrics=metrics, agent_id="t",
                               ladder_max=ladder_max, device="cpu")
    for w, t in enumerate(tables):
        arch.write_window(t, window=w, ts_ms=1_000 + w)
    return arch


def _union(batch_lists):
    union = js.init_state(JCFG)
    for bs in batch_lists:
        for arrays in bs:
            union = js.ingest(union, arrays)
    return union


def _replay(table_dicts):
    """The table-merge replay oracle, through the JAX merge."""
    state = js.init_state(JCFG)
    for t in table_dicts:
        state = rmerge.merge_tables(
            state, {k: jnp.asarray(np.ascontiguousarray(v))
                    for k, v in t.items()})
    return state


def _dir_bytes(path) -> dict:
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


# ----------------------------------------------------------------- segment


def test_segment_encodes_the_golden_bytes():
    want = bytes.fromhex(open(golden.GOLDEN).read().strip())
    got = tseg.encode_segment(
        golden.golden_tables(), agent_id="golden-agent", level=0,
        window_from=42, window_to=42, n_windows=1, ts_ms=1_700_000_000_123,
        dims=golden.DIMS, codec=tseg.CODEC_RAW)
    assert got == want
    seg = tseg.decode_segment(want)
    assert seg._replace(tables={}) == \
        jseg.decode_segment(want)._replace(tables={})
    for name, v in golden.golden_tables().items():
        np.testing.assert_array_equal(seg.tables[name], v, err_msg=name)
    assert tseg.SEGMENT_FORMAT_VERSION == jseg.SEGMENT_FORMAT_VERSION == 1


@pytest.mark.parametrize("codec", ["raw", "zlib"])
def test_seeded_segments_equal_the_reference_and_cross_decode(windows,
                                                              codec):
    tables = windows[0]
    kw = dict(agent_id="agent-7", level=1, window_from=3, window_to=10,
              n_windows=8, ts_ms=1_700_000_000_999, dims=DIMS)
    code = {"raw": tseg.CODEC_RAW, "zlib": tseg.CODEC_ZLIB}[codec]
    for t in (tables[0], tables[-1]):
        got = tseg.encode_segment(t, codec=code, **kw)
        want = jseg.encode_segment(t, codec=code, **kw)
        assert got == want
        for data, dec in ((got, jseg.decode_segment),
                          (want, tseg.decode_segment)):
            seg = dec(data)
            assert (seg.agent_id, seg.level, seg.window_from,
                    seg.window_to, seg.n_windows, seg.ts_ms, seg.dims) == (
                "agent-7", 1, 3, 10, 8, 1_700_000_000_999, DIMS)
            for name, dt in tseg.fdelta.TABLE_SPEC:
                np.testing.assert_array_equal(
                    seg.tables[name], np.asarray(t[name], dt), err_msg=name)


def _forge_header(data: bytes, **changes) -> bytes:
    hdr_len = struct.unpack("<I", data[12:16])[0]
    header = json.loads(data[16:16 + hdr_len])
    for k, v in changes.items():
        if v is None:
            header.pop(k)
        else:
            header[k] = v
    new = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    return data[:12] + struct.pack("<I", len(new)) + new + \
        data[16 + hdr_len:]


def _first_tensor(data: bytes) -> int:
    return 16 + struct.unpack("<I", data[12:16])[0]


def _bomb(data: bytes) -> bytes:
    """cm_bytes (2x8 f32 = 64 B declared) replaced by a zlib stream of
    4 KiB."""
    off = _first_tensor(data)
    bomb = zlib.compress(b"\x00" * 4096, 1)
    head = struct.pack("<BBH", tseg.CODEC_ZLIB, 1, 2) + \
        struct.pack("<2I", 2, 8) + struct.pack("<I", len(bomb))
    plen = struct.unpack("<I", data[off + 12:off + 16])[0]
    return data[:off] + head + bomb + data[off + 16 + plen:]


REJECTIONS = {
    "magic": lambda g: b"WRONGMAG" + g[8:],
    "version": lambda g: g[:8] + b"\x63\x00\x00\x00" + g[12:],
    "truncated": lambda g: g[:-5],
    "trailing": lambda g: g + b"\x00",
    "crc": lambda g: _forge_header(g, table_crc=12345),
    "header_key": lambda g: _forge_header(g, ts_ms=None),
    "header_json": lambda g: g[:16] + b"!" + g[17:],
    "dtype": lambda g: (g[:_first_tensor(g) + 1] + b"\x02"
                        + g[_first_tensor(g) + 2:]),
    "dtype_code": lambda g: (g[:_first_tensor(g) + 1] + b"\x09"
                             + g[_first_tensor(g) + 2:]),
    "bomb": _bomb,
    "empty": lambda g: b"",
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_raise_the_reference_error(case):
    data = REJECTIONS[case](bytes.fromhex(open(golden.GOLDEN)
                                          .read().strip()))
    with pytest.raises(Exception) as want:
        jseg.decode_segment(data)
    with pytest.raises(tseg.ArchiveSegmentError) as got:
        tseg.decode_segment(data)
    assert type(want.value) is jseg.ArchiveSegmentError
    assert str(got.value) == str(want.value)


def test_encode_refuses_a_short_snapshot_as_the_reference():
    tables = dict(golden.golden_tables())
    del tables["hll_src"], tables["scalars"]
    kw = dict(agent_id="a", level=0, window_from=0, window_to=0,
              n_windows=1, ts_ms=0, dims=golden.DIMS)
    with pytest.raises(jseg.ArchiveSegmentError) as want:
        jseg.encode_segment(tables, **kw)
    with pytest.raises(tseg.ArchiveSegmentError) as got:
        tseg.encode_segment(tables, **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- store


def _schedule_manifest(mod, d):
    store = mod.ArchiveStore(d, raw_windows=4, compact_group=2)
    for w in range(3):
        store.append(b"x" * (10 + w), 0, w, w)
    sel = [s.window_from for s in store.select(1, 2)]
    store2 = mod.ArchiveStore(d, raw_windows=4, compact_group=2)
    return sel, [s.name for s in store2.segments()], store.total_bytes()


def _schedule_torn_manifest(mod, d):
    store = mod.ArchiveStore(d, raw_windows=4, compact_group=2)
    store.append(b"payload", 0, 7, 7)
    with open(os.path.join(d, "MANIFEST.json"), "w") as fh:
        fh.write('{"segments": [{"trunc')
    return [s.window_from for s in
            mod.ArchiveStore(d, raw_windows=4, compact_group=2).segments()]


def _schedule_crash_mid_replace(mod, d):
    store = mod.ArchiveStore(d, raw_windows=2, compact_group=2)
    for w in range(2):
        store.append(b"raw", 0, w, w)
    with open(os.path.join(d, mod.segment_filename(1, 0, 1)), "wb") as fh:
        fh.write(b"merged")
    healed = mod.ArchiveStore(d, raw_windows=2, compact_group=2)
    return [(s.level, s.window_from, s.window_to) for s in healed.segments()]


def _schedule_restarted_counter(mod, d):
    store = mod.ArchiveStore(d, raw_windows=4, compact_group=2)
    store.append(b"old-0", 0, 0, 0)
    store.append(b"old-1", 0, 1, 1)
    store.replace(store.segments(), b"old-merged", 1, 0, 1)
    store.append(b"new-0", 0, 0, 0)
    store.append(b"new-0b", 0, 0, 0)
    store2 = mod.ArchiveStore(d, raw_windows=4, compact_group=2)
    return [(s.level, s.window_from) for s in store2.segments()], \
        store.read(store.segments()[0])


def _schedule_retention(mod, d):
    store = mod.ArchiveStore(d, raw_windows=2, compact_group=2,
                             max_levels=1)
    dropped = []
    for w in range(12):
        store.append(b"s%d" % w, 0, w, w)
        while store.pending_compaction() is not None:
            level, group = store.pending_compaction()
            store.replace(group, b"m%d" % w, level + 1,
                          group[0].window_from, group[-1].window_to)
        dropped.append(store.enforce_top_level_retention())
    return dropped, store.stats(), store.coverage()


STORE_SCHEDULES = {
    "manifest": _schedule_manifest,
    "torn_manifest": _schedule_torn_manifest,
    "crash_mid_replace": _schedule_crash_mid_replace,
    "restarted_counter": _schedule_restarted_counter,
    "retention": _schedule_retention,
}


@pytest.mark.parametrize("case", sorted(STORE_SCHEDULES))
def test_store_schedule_leaves_the_reference_directory(tmp_path, case):
    """tests/test_archive.py:112-207 on both stores: the same answers and
    the same directory, file names and bytes (the manifest included)."""
    run = STORE_SCHEDULES[case]
    got = run(tstore, str(tmp_path / "port"))
    want = run(jstore, str(tmp_path / "ref"))
    assert got == want
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")


def test_store_counts_the_reference_metrics(tmp_path):
    tm, jm = Metrics(), jreg.Metrics(jreg.MetricsSettings())
    for mod, m, sub in ((tstore, tm, "port"), (jstore, jm, "ref")):
        store = mod.ArchiveStore(str(tmp_path / sub), raw_windows=2,
                                 compact_group=2, metrics=m)
        for w in range(3):
            store.append(b"y" * (w + 1), 0, w, w)
    for name in ("ebpf_agent_archive_segments_total",
                 "ebpf_agent_archive_bytes_total"):
        assert tm.registry.get_sample_value(name) == \
            jm.registry.get_sample_value(name) > 0, name


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def compacted(windows, tmp_path_factory):
    """The same N_WINDOWS tables written through a port archive and a JAX
    archive with retention that compacts twice over (2 raw windows, groups
    of 2, 2 levels, ladder 2), and a JAX engine over the port's store."""
    tables = windows[0]
    root = tmp_path_factory.mktemp("compacted")
    tm = Metrics()
    port = _port_archive(root / "port", tables, raw_windows=2,
                         compact_group=2, max_levels=2, ladder_max=2,
                         metrics=tm)
    jstore_ = jstore.ArchiveStore(str(root / "ref"), raw_windows=2,
                                  compact_group=2, max_levels=2)
    ref = jarch.SketchArchive(jstore_, JCFG, agent_id="t", ladder_max=2)
    for w, t in enumerate(tables):
        ref.write_window(t, window=w, ts_ms=1_000 + w)
    jm = jreg.Metrics(jreg.MetricsSettings())
    reader = jarch.ArchiveQueryEngine(
        jstore.ArchiveStore(str(root / "port"), raw_windows=2,
                            compact_group=2, max_levels=2), JCFG,
        metrics=jm, ladder_max=2)
    # the writer's compiled ladder serves the reader (same config)
    reader._merge_fns = ref.engine._merge_fns
    return port, ref, reader, root, tm, jm


def test_same_compaction_schedule_same_segment_files(compacted):
    port, ref, _reader, root, _tm, _jm = compacted
    segs = port.engine._store.segments()
    assert {s.level for s in segs} == {0, 1, 2}
    assert _dir_bytes(root / "port") == _dir_bytes(root / "ref")
    assert port.stats()["segments"] == ref.stats()["segments"]


def _requests():
    return [
        ({"from": "0", "to": "9"}, None), ({"from": "0", "to": "8"}, "topk"),
        ({"from": "2", "to": "5", "n": "3"}, "topk"),
        ({"from": "7", "to": "8"}, "cardinality"),
        ({"from": "0", "to": "3"}, "victims"),
        ({"from": "0", "to": "8", "src": "10.0.0.1", "dst": "10.0.0.2",
          "src_port": "80", "proto": "6"}, "frequency"),
        ({"from": "8", "to": "8"}, "summary"),
        ({}, None), ({"from": "3", "to": "1"}, None),
        ({"from": "x", "to": "1"}, None),
        ({"from": "0", "to": "1"}, "bogus"),
        ({"from": "50", "to": "60"}, None),
        ({"from": "0", "to": "1", "src": "a"}, "frequency"),
    ]


@pytest.mark.parametrize("i", range(13))
def test_range_bodies_equal_the_reference(compacted, i):
    """A port-written store queried by both engines: the same status and
    body on every view and error, `merge_seconds` aside."""
    port, _ref, reader, _root, _tm, _jm = compacted
    params, view = _requests()[i]
    got = port.route_payload(dict(params), view)
    want = reader.route_payload(dict(params), view)
    assert got[0] == want[0]
    for code, body in (got, want):
        if code == 200:
            assert body["range"].pop("merge_seconds") >= 0
    _assert_report(got[1], want[1], GAMMA)


def test_range_requests_are_counted_as_the_reference(compacted):
    port, _ref, reader, _root, tm, jm = compacted
    for params, view in _requests():
        port.route_payload(dict(params), view)
        reader.route_payload(dict(params), view)
    for result in ("ok", "bad_request", "not_found"):
        labels = {"result": result}
        name = "ebpf_agent_archive_range_requests_total"
        assert tm.registry.get_sample_value(name, labels) >= \
            jm.registry.get_sample_value(name, labels) > 0, result
    assert tm.registry.get_sample_value(
        "ebpf_agent_archive_compactions_total") == 5


def test_raw_range_bit_exact_vs_union_roll(windows, tmp_path):
    tables, batches, _ = windows
    arch = _port_archive(tmp_path, tables[:4], ladder_max=16)
    snap = arch.engine.range_snapshot(0, 3)
    assert snap["range"]["merge_dispatches"] == 1
    assert arch.engine._ladder_fit(4) == 4
    union = _union(batches[:4])
    for k in ("cm_bytes", "cm_pkts"):
        np.testing.assert_array_equal(snap[k],
                                      np.asarray(getattr(union, k).counts))
    rep = snap["report"]
    for key, field in (("Records", "total_records"), ("Bytes", "total_bytes"),
                       ("DropBytes", "total_drop_bytes"),
                       ("QuicRecords", "quic_records")):
        assert rep[key] == float(getattr(union, field)), key
    assert rep["DistinctSrcEstimate"] == pytest.approx(float(
        np.asarray(jhll.estimate(union.hll_src.regs))), rel=1e-5)
    # the slot table against the table-merge replay oracle
    _, oracle = js.roll_window(_replay(tables[:4]), JCFG)
    from netobserv_tpu.exporter.tpu_sketch import (
        report_to_json as jreport_to_json,
    )

    def entries(r):
        return {(e["SrcAddr"], e["DstAddr"], e["SrcPort"], e["DstPort"],
                 e["Proto"], e["EstBytes"]) for e in r["HeavyHitters"]}
    assert entries(rep) == entries(jreport_to_json(oracle))


def test_partial_range_pads_and_chained_range_stays_exact(windows,
                                                          tmp_path):
    """3 segments pad to the 4-wide entry with zero tables; a ladder of 2
    chains 5 segments through 4 dispatches; both equal the union and the
    replay oracle's heavy hitters."""
    tables, batches, _ = windows
    from netobserv_tpu.exporter.tpu_sketch import (
        report_to_json as jreport_to_json,
    )
    for ladder_max, lo, hi, dispatches in ((4, 1, 3, 1), (2, 0, 4, 4)):
        arch = _port_archive(tmp_path / f"l{ladder_max}", tables[:5],
                             ladder_max=ladder_max)
        snap = arch.engine.range_snapshot(lo, hi)
        assert snap["range"]["segments_merged"] == hi - lo + 1
        assert snap["range"]["merge_dispatches"] == dispatches
        union = _union(batches[lo:hi + 1])
        np.testing.assert_array_equal(snap["cm_bytes"],
                                      np.asarray(union.cm_bytes.counts))
        assert snap["report"]["Records"] == float(union.total_records)
        _, oracle = js.roll_window(_replay(tables[lo:hi + 1]), JCFG)
        want = [(e["SrcAddr"], e["SrcPort"], e["EstBytes"])
                for e in jreport_to_json(oracle)["HeavyHitters"]]
        got = [(e["SrcAddr"], e["SrcPort"], e["EstBytes"])
               for e in snap["report"]["HeavyHitters"]]
        assert sorted(got) == sorted(want)


def test_compacted_range_within_widened_cm_bars(compacted, windows):
    """Over super-windows every key's CM estimate is one-sided within the
    widened bound: true <= est <= true + (e/w) * merged mass."""
    port = compacted[0]
    tables, batches, universe = windows
    snap = port.engine.range_snapshot(0, N_WINDOWS - 1)
    assert snap["range"]["compacted"]
    cm = snap["cm_bytes"]
    d, w = cm.shape
    bound = np.e / w * float(np.sum(cm[0]))
    true: dict[bytes, float] = {}
    for bs in batches:
        for arrays in bs:
            for key, nb in zip(arrays["keys"], arrays["bytes"]):
                true[key.tobytes()] = true.get(key.tobytes(), 0.0) + float(nb)
    h = base_hashes_multi_np(universe)
    for j, key in enumerate(universe):
        with np.errstate(over="ignore"):
            idx = (h["h1"][j] + np.arange(d, dtype=np.uint32) * h["h2"][j]) \
                & np.uint32(w - 1)
        est = float(np.min(cm[np.arange(d), idx]))
        t = true.get(key.tobytes(), 0.0)
        assert t <= est <= t + bound, (j, t, est, bound)
    assert snap["report"]["Records"] == N_WINDOWS * 2 * 32


def test_no_retrace_across_ladder_and_compaction(windows, tmp_path):
    tables = windows[0]
    before = retrace.total_retraces()
    arch = _port_archive(tmp_path, tables, raw_windows=2, compact_group=2,
                         max_levels=2, ladder_max=4)
    for lo, hi in ((0, 0), (0, 2), (0, 5), (0, 8), (3, 8)):
        code, _ = arch.route_payload({"from": str(lo), "to": str(hi)})
        assert code == 200
    watched = {w["fn"]: w for w in retrace.snapshot()
               if w["fn"].startswith("archive_merge_x")}
    assert {"archive_merge_x1", "archive_merge_x2",
            "archive_merge_x4"} <= set(watched)
    assert all(w["retraces"] == 0 and w["compiles"] <= 1
               for w in watched.values())
    assert retrace.total_retraces() == before
    assert arch.stats()["warmed"] == [1, 2, 4]


def test_engine_refuses_what_the_reference_refuses(tmp_path):
    store = tstore.ArchiveStore(str(tmp_path))
    with pytest.raises(ValueError, match="power of two"):
        tarch.ArchiveQueryEngine(store, TCFG, ladder_max=3, device="cpu")
    with pytest.raises(ValueError, match="compact_group"):
        tstore.ArchiveStore(str(tmp_path), compact_group=1)
    with pytest.raises(ValueError, match="raw_windows"):
        tstore.ArchiveStore(str(tmp_path), raw_windows=2, compact_group=4)
    # a segment of another geometry is refused at decode, as the reference
    other = _port_archive(tmp_path / "other", [], ladder_max=1)
    wide = ts.state_tables(ts.init_state(TCFG._replace(cm_width=1024),
                                         "cpu"))
    other._store.append(tseg.encode_segment(
        wide, agent_id="x", level=0, window_from=0, window_to=0,
        n_windows=1, ts_ms=0, dims={**DIMS, "cm_width": 1024}), 0, 0, 0)
    code, body = other.route_payload({"from": "0", "to": "0"})
    assert code == 500 and "different SketchConfig" in body["error"]


# ------------------------------------------------------ exporter, aggregator


def test_exporter_archives_each_closed_window_as_the_reference(tmp_path):
    """The same evictions through the JAX exporter and the port, each with
    an archive; window 1's archive write is made to fail in both. Every
    report reaches the sink, the same windows are archived, and their
    tables agree (the RTT and DNS histograms to the bound of
    tests/test_torch_staging.py); `/query/range` and the status block
    answer from the port's archive."""
    rng = np.random.default_rng(41)
    reports, jreports, samples = [], [], _Samples()
    parch = tarch.SketchArchive(
        tstore.ArchiveStore(str(tmp_path / "port"), raw_windows=8,
                            compact_group=2),
        ts.SketchConfig(**GEOM), agent_id="a1", ladder_max=2, device="cpu")
    rarch = jarch.SketchArchive(
        jstore.ArchiveStore(str(tmp_path / "ref"), raw_windows=8,
                            compact_group=2),
        js.SketchConfig(**GEOM, use_pallas=False), agent_id="a1",
        ladder_max=2)
    jexp, _ = _jax_exporter(sink=jreports.append, archive=rarch)
    exp, tm = _port_exporter(sink=reports.append, archive=parch)
    try:
        for w in range(3):
            for n in (300, 2 * B + 50):
                ev, f = _feed(rng, n, n_distinct=900)
                samples.add(f)
                exp.export_evicted(EvictedFlows(ev, **f))
                jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
            if w == 1:
                faultinject.arm("sketch.archive_write", "crash", times=1)
                jfault.arm("sketch.archive_write", "crash", times=1)
            exp.flush()
            jexp.flush()
        assert faultinject.hits["sketch.archive_write"] >= 1
        code, body = exp.query_routes.handle("/query/range",
                                             {"from": "0", "to": "2"})
        assert code == 200 and body["range"]["covered"] == [0, 2]
        assert body["range"]["windows_merged"] == 2
        assert exp.query_status()["archive"]["segments"] == 2
        assert tm.registry.get_sample_value(
            "ebpf_agent_errors_total",
            {"component": "tpu-sketch-archive", "severity": "error"}) == 1
    finally:
        exp.close()
        jexp.close()
    assert len(reports) == len(jreports) == 4  # close publishes a fourth
    segs = parch.engine._store.segments()
    jsegs = rarch.engine._store.segments()
    assert [(s.level, s.window_from) for s in segs] == \
        [(s.level, s.window_from) for s in jsegs] == [(0, 0), (0, 2), (0, 3)]
    for s, j in zip(segs, jsegs):
        got = tseg.decode_segment(parch.engine._store.read(s))
        want = jseg.decode_segment(rarch.engine._store.read(j))
        assert (got.agent_id, got.dims, got.n_windows) == \
            (want.agent_id, want.dims, want.n_windows)
        for k, v in want.tables.items():
            g = got.tables[k]
            if k in samples.us:
                assert g.sum() == v.sum()
                moved = np.abs(np.cumsum(g.astype(np.float64) - v)).sum()
                assert moved <= samples.edge_prone(k, len(v)), k
                continue
            np.testing.assert_array_equal(g, v, err_msg=k)


def test_archive_unset_builds_no_archive_object():
    assert tarch.maybe_archive(tconfig.ArchiveSettings(), TCFG) is None
    assert tarch.tenant_archives(tconfig.ArchiveSettings(), TCFG, 2) is None
    exp = _port_exporter(feed="dense")[0]
    try:
        assert exp._archive is None
        code, body = exp.query_routes.handle("/query/range",
                                             {"from": "0", "to": "1"})
        assert code == 404 and "ARCHIVE_DIR" in body["error"]
        assert "archive" not in exp.query_status()
    finally:
        exp.close()


def test_maybe_archive_builds_the_configured_store(tmp_path):
    settings = tconfig.ArchiveSettings(archive_dir=str(tmp_path / "a"),
                                       archive_raw_windows=4,
                                       archive_compact_group=2,
                                       archive_max_levels=1,
                                       archive_merge_ladder_max=4)
    arch = tarch.maybe_archive(settings, TCFG, agent_id="me", device="cpu")
    st = arch.stats()
    assert (st["raw_windows"], st["compact_group"], st["max_levels"],
            st["ladder"]) == (4, 2, 1, [1, 2, 4])
    assert os.path.isfile(tmp_path / "a" / "MANIFEST.json")
    with pytest.raises(RuntimeError, match="cuda"):
        tarch.maybe_archive(settings, TCFG)


def test_federation_range_through_the_aggregator(windows, tmp_path):
    """Both aggregators archive each merged window; `/federation/range`
    over a real socket gives the same answers."""
    rng = np.random.default_rng(9)
    universe = windows[2]
    parch = tarch.SketchArchive(tstore.ArchiveStore(str(tmp_path / "p")),
                                TCFG, agent_id="federation", ladder_max=1,
                                device="cpu")
    rarch = jarch.SketchArchive(jstore.ArchiveStore(str(tmp_path / "r")),
                                JCFG, agent_id="federation", ladder_max=1)
    aggs = (FederationAggregator(TCFG, window_s=3600.0, device="cpu",
                                 archive=parch),
            RefAggregator(sketch_cfg=JCFG, window_s=3600.0, archive=rarch))
    servers = [_serve(m, a) for m, a in zip((pquery, rquery), aggs)]
    try:
        for a in range(3):
            f = _frame(_agent_tables(rng, universe), f"agent-{a}", 0, 1)
            for agg in aggs:
                assert agg.ingest_frame(f).accepted == 1
        for agg in aggs:
            agg.flush()
        assert "archive" in aggs[0].status()
        assert aggs[0].status()["archive"]["segments"] == 1
        for path in ("/federation/range?from=0&to=0",
                     "/federation/range/topk?from=0&to=0&n=5",
                     "/federation/range/cardinality?from=0&to=0",
                     "/federation/range?from=1&to=0",
                     "/federation/range?from=5&to=9"):
            (code, body), (jcode, jbody) = (get(path) for _, get in servers)
            assert code == jcode, path
            for b in (body, jbody):
                b.get("range", {}).pop("merge_seconds", None)
            _assert_report(_timeless(body), _timeless(jbody), GAMMA)
    finally:
        for srv, _ in servers:
            srv.shutdown()
            srv.server_close()
        for agg in aggs:
            agg.close()
    got = tseg.decode_segment(parch.engine._store.read(
        parch.engine._store.segments()[0])).tables
    want = jseg.decode_segment(rarch.engine._store.read(
        rarch.engine._store.segments()[0])).tables
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_tenant_archive_set_routes_as_the_reference(tmp_path):
    def make(mod, store_mod, cfg, sub, **kw):
        return mod.TenantArchiveSet([
            mod.SketchArchive(store_mod.ArchiveStore(
                str(tmp_path / sub / f"tenant-{t}")), cfg, **kw)
            for t in range(2)])
    port = make(tarch, tstore, TCFG, "p", device="cpu")
    ref = make(jarch, jstore, JCFG, "r")
    assert port.n_tenants == ref.n_tenants == 2
    for params in ({"from": "0", "to": "1"},
                   {"from": "0", "to": "1", "tenant": "x"},
                   {"from": "0", "to": "1", "tenant": "5"},
                   {"from": "0", "to": "1", "tenant": "1"}):
        assert port.route_payload(dict(params)) == \
            ref.route_payload(dict(params))
    t = ts.state_tables(ts.init_state(TCFG, "cpu"))
    port.write_tenant_window(t, window=0, ts_ms=5, tenant=1)
    ref.write_tenant_window(t, window=0, ts_ms=5, tenant=1)
    assert port.stats()["segments"] == ref.stats()["segments"] == 1
    assert _dir_bytes(tmp_path / "p" / "tenant-1") == \
        _dir_bytes(tmp_path / "r" / "tenant-1")


ENVS = [
    {}, {"ARCHIVE_DIR": "/var/lib/arch", "ARCHIVE_RAW_WINDOWS": "16",
         "ARCHIVE_COMPACT_GROUP": "4", "ARCHIVE_MAX_LEVELS": "2",
         "ARCHIVE_MERGE_LADDER_MAX": "8"},
    {"ARCHIVE_MERGE_LADDER_MAX": "3"}, {"ARCHIVE_MERGE_LADDER_MAX": "128"},
    {"ARCHIVE_COMPACT_GROUP": "1"}, {"ARCHIVE_RAW_WINDOWS": "4"},
    {"ARCHIVE_MAX_LEVELS": "0"}, {"ARCHIVE_RAW_WINDOWS": ""},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_archive_settings_equal_the_reference(env):
    try:
        want = jconfig.load_config({"EXPORT": "stdout", **env})
        want.validate()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tconfig.ArchiveSettings.from_env(env)
        assert str(got.value) == str(exc)
        return
    got = tconfig.ArchiveSettings.from_env(env)
    for name in tconfig.ArchiveSettings.__dataclass_fields__:
        assert getattr(got, name) == getattr(want, name), name
    if not env.get("ARCHIVE_DIR"):
        assert tarch.maybe_archive(got, TCFG) is None
        assert jarch.maybe_archive(want, JCFG) is None
