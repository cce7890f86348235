"""The port's merges and delta wire (netobserv_tpu_torch/ops merges,
federation/pbwire.py, delta.py, statemerge.py, aggregator.py, query.py
and the exporter's delta seam) against the JAX package's, on the CPU.

- The codec: the v1/v2/v3 goldens byte for byte, seeded frames equal to
  the reference encoder's bytes, acks equal to the generated protobuf's,
  every rejection of tests/test_federation.py with the same error class,
  and 500 seeded mutations of a valid frame decoded alike (both decoders
  give equal frames, or both raise).
- The merges: `merge_slot_tables` and `merge_tables` bit for bit in the
  integer regime (integer-valued masses, sums below 2^24).
- The aggregator: the port's and the JAX one fed one frame schedule give
  the same acks, ledger, reports, snapshots and status. Report floats
  (HLL estimates, quantiles) are held as tests/test_torch_query_plane.py
  holds them: 1e-5 relative, one histogram bucket.
- The union: four port exporters with delta sinks into one port
  aggregator equal a union exporter (tests/test_federation.py:203-296).
- The exporter seam, the query routes, the settings and the trace groups.

No test waits on a clock: windows close through `flush()`, and the
aggregators' window threads never reach a deadline (3600 s windows).
Sizes: the small geometry of tests/test_federation.py for the frames, and
B = 512 at tests/test_torch_resident.py's geometry for the exporters."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu import config as jconfig
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.federation import delta as rd
from netobserv_tpu.federation import query as rquery
from netobserv_tpu.federation import statemerge as rmerge
from netobserv_tpu.federation.aggregator import (
    FederationAggregator as RefAggregator,
)
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.ops import countmin as jcm
from netobserv_tpu.ops import hll as jhll
from netobserv_tpu.ops import quantile as jq
from netobserv_tpu.ops import topk as jtopk
from netobserv_tpu.pb import sketch_delta_pb2 as pb
from netobserv_tpu.sketch import state as js
from netobserv_tpu.utils import faultinject as jfault
from netobserv_tpu.utils import tracing as jtracing
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.federation import delta as pd
from netobserv_tpu_torch.federation import pbwire
from netobserv_tpu_torch.federation import query as pquery
from netobserv_tpu_torch.federation import statemerge as pmerge
from netobserv_tpu_torch.federation.aggregator import FederationAggregator
from netobserv_tpu_torch.metrics.registry import Metrics
from netobserv_tpu_torch.ops import countmin as tcm
from netobserv_tpu_torch.ops import hll as thll
from netobserv_tpu_torch.ops import quantile as tq
from netobserv_tpu_torch.ops import topk as ttopk
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.utils import faultinject, tracing
from tests import test_federation_golden as golden
from tests.test_federation import CFG as FEDERATION_CFG
from tests.test_federation import DIMS as FEDERATION_DIMS
from tests.test_federation import make_arrays
from tests.test_torch_query_plane import _assert_report, _timeless
from tests.test_torch_staging import B, GEOM, _feed, _Samples
from tests.test_torch_window import _jax_exporter, _port_exporter

#: tests/test_federation.py's geometry at half its width. Not the same:
#: a JAX aggregator made here at that file's geometry would leave its
#: jitted merge in JAX's trace cache, and that file's aggregator, made
#: later in the same process, would then compile nothing
#: (test_zero_postwarmup_retraces counts exactly one compile)
JCFG = FEDERATION_CFG._replace(cm_width=512)
DIMS = {**FEDERATION_DIMS, "cm_width": 512}
#: the port's twin of JCFG
TCFG = ts.SketchConfig(cm_depth=3, cm_width=512, hll_precision=8,
                       perdst_buckets=64, perdst_precision=5,
                       persrc_buckets=64, persrc_precision=5, topk=64,
                       hist_buckets=128, ewma_buckets=64)
GAMMA = tq.gamma_for(TCFG.hist_buckets)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (faultinject, jfault):
        mod.clear()
        mod.hits.clear()
    for mod in (tracing, jtracing):
        mod.configure(0.0)
        mod.recorder.clear()


def _host_tables(state) -> dict:
    return {k: np.asarray(v) for k, v in js.state_tables(state).items()}


def _agent_tables(rng, universe, n_batches=1, n=32) -> dict:
    """One agent window's tables from the JAX fold (integer-valued)."""
    s = js.init_state(JCFG)
    for _ in range(n_batches):
        s = js.ingest(s, make_arrays(rng, universe, n))
    return _host_tables(s)


@pytest.fixture(scope="module")
def universe():
    return np.random.default_rng(11).integers(0, 2**32, (48, 10),
                                              dtype=np.uint32)


def _same_frame(a, b) -> bool:
    if a._replace(tables={}) != b._replace(tables={}):
        return False
    return a.tables.keys() == b.tables.keys() and all(
        a.tables[k].dtype == b.tables[k].dtype
        and np.array_equal(a.tables[k], b.tables[k]) for k in a.tables)


# ----------------------------------------------------------------- codec


@pytest.mark.parametrize("version", [1, 2, 3])
def test_goldens_encode_byte_for_byte(version):
    path = {1: golden.GOLDEN_V1, 2: golden.GOLDEN_V2, 3: golden.GOLDEN}
    want = bytes.fromhex(open(path[version]).read().strip())
    spec = pd.spec_for_version(version)
    shapes = golden.SHAPES if version == 3 else golden.SHAPES_V2
    got = pd.encode_frame(
        golden.golden_tables(spec, shapes), agent_id="golden-agent",
        window=42, ts_ms=1_700_000_000_123, dims=golden.DIMS,
        codec=pd.CODEC_RAW, window_seq=42, frame_uuid="cafe0042feedbeef",
        agent_epoch=1_700_000_000_000_000_000, version=version)
    assert got == want
    assert pd.table_spec_fingerprint() == rd.table_spec_fingerprint()


@pytest.mark.parametrize("version", [1, 2, 3])
def test_goldens_decode_to_the_reference_frame(version):
    path = {1: golden.GOLDEN_V1, 2: golden.GOLDEN_V2, 3: golden.GOLDEN}
    data = bytes.fromhex(open(path[version]).read().strip())
    got, want = pd.decode_frame(data), rd.decode_frame(data)
    assert _same_frame(got, want)
    assert all(not t.flags.writeable for t in got.tables.values())
    up, rup = pd.upgrade_tables(got), rd.upgrade_tables(want)
    assert up.keys() == rup.keys()
    for k in rup:
        np.testing.assert_array_equal(up[k], rup[k], err_msg=k)
        assert up[k].dtype == rup[k].dtype


def _extras(kind):
    if kind == "none":
        return {}
    return {"trace_ctx": tracing.TraceContext("00c0ffee0badcafe", "window@a",
                                              kind != "unsampled"),
            "telemetry": {"shed_factor": -0.0 if kind == "all" else 4.0,
                          "conditions": ["OVERLOADED", "ALERTING"],
                          "host_records_per_s": 12345.5,
                          "map_occupancy": 0.0, "windows_published": 9},
            "tenant": (0, 0) if kind == "all" else (2, 5)}


@pytest.mark.parametrize("codec", [0, 1], ids=["raw", "zlib"])
@pytest.mark.parametrize("extras", ["none", "all", "unsampled"])
@pytest.mark.parametrize("window", [0, 7])
def test_seeded_frames_equal_the_reference_encoder(universe, codec, extras,
                                                   window):
    rng = np.random.default_rng(100 + window)
    tables = _agent_tables(rng, universe, n_batches=2)
    kw = dict(agent_id="agent-ü" if extras == "all" else "a",
              window=window, ts_ms=0 if window == 0 else 1_700_000_000_001,
              dims=DIMS, codec=codec, frame_uuid="u" * (window + 1),
              agent_epoch=window * (1 << 60), **_extras(extras))
    got = pd.encode_frame(tables, **kw)
    want = rd.encode_frame(tables, **kw)
    assert got == want
    assert _same_frame(pd.decode_frame(got), rd.decode_frame(want))


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_frames_equal_the_reference_encoder(universe, version):
    tables = _agent_tables(np.random.default_rng(3), universe)
    kw = dict(agent_id="old", window=3, ts_ms=5, dims=DIMS,
              frame_uuid="f", agent_epoch=9, version=version)
    assert pd.encode_frame(tables, **kw) == rd.encode_frame(tables, **kw)


def test_golden_geometry_frames_equal_the_reference_encoder():
    """The golden tables' tiny shapes, zlib, every optional block."""
    kw = dict(agent_id="g", window=1, ts_ms=2, dims=golden.DIMS,
              frame_uuid="x", **_extras("all"))
    tables = golden.golden_tables()
    assert pd.encode_frame(tables, **kw) == rd.encode_frame(tables, **kw)


def test_minus_zero_double_is_written_as_protobuf_writes_it():
    got = pbwire.AgentTelemetry(shed_factor=-0.0).SerializeToString()
    assert got == bytes.fromhex("090000000000000080")
    assert got == pb.AgentTelemetry(shed_factor=-0.0).SerializeToString()
    assert pbwire.AgentTelemetry(shed_factor=0.0).SerializeToString() == b""


@pytest.mark.parametrize("fields", [
    {}, {"accepted": 1, "version": 3},
    {"accepted": 1, "version": 3, "duplicate": 1,
     "reason": rd.ACK_REASON_DUPLICATE},
    {"accepted": 1, "version": 3, "duplicate": 1,
     "reason": rd.ACK_REASON_STALE},
    {"accepted": 0, "version": 3, "reason": "tensor 'x': ünknown"}],
    ids=["empty", "ok", "duplicate", "stale", "rejected"])
def test_acks_equal_the_generated_protobuf(fields):
    got = pbwire.DeltaAck(**fields).SerializeToString()
    assert got == pb.DeltaAck(**fields).SerializeToString()
    back = pbwire.DeltaAck.FromString(got)
    assert back.SerializeToString() == got
    for name, value in fields.items():
        assert getattr(back, name) == value, name


def _valid_msg():
    tables = {k: np.asarray(v) for k, v in
              js.state_tables(js.init_state(JCFG)).items()}
    data = rd.encode_frame(tables, agent_id="a", window=0, ts_ms=0,
                           dims=DIMS)
    return pb.SketchDelta.FromString(data)


def _mutate_version(msg):
    msg.version = rd.DELTA_FORMAT_VERSION + 1


def _mutate_missing(msg):
    del msg.tensors[0]


def _mutate_dtype(msg):
    msg.tensors[0].dtype = 2


def _mutate_name(msg):
    msg.tensors[0].name = "evil_extra"


def _mutate_bomb(msg):
    import zlib
    msg.tensors[0].codec = rd.CODEC_ZLIB
    msg.tensors[0].data = zlib.compress(b"\x00" * (64 << 20), 1)


def _mutate_oversize(msg):
    del msg.tensors[0].shape[:]
    msg.tensors[0].shape.extend([1 << 16, 1 << 16])


@pytest.mark.parametrize("mutate,err", [
    (_mutate_version, "DeltaVersionError"), (_mutate_missing, None),
    (_mutate_dtype, "dtype"), (_mutate_name, None), (_mutate_bomb, "inflates"),
    (_mutate_oversize, "cap"), (None, None)],
    ids=["version", "missing", "dtype", "unknown", "bomb", "oversize",
         "garbage"])
def test_rejections_raise_the_reference_error_class(mutate, err):
    """tests/test_federation.py:113-190's cases through both decoders."""
    if mutate is None:
        data = b"\xff" * 64
    else:
        msg = _valid_msg()
        mutate(msg)
        data = msg.SerializeToString()
    with pytest.raises(rd.DeltaFrameError) as want:
        rd.decode_frame(data)
    with pytest.raises(pd.DeltaFrameError) as got:
        pd.decode_frame(data)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    if err is not None and err != "DeltaVersionError":
        assert err in str(got.value)


# the mutation fuzz: a valid frame with every optional block, in five kinds
# of mutation, 100 each


def _fuzz_base() -> bytes:
    tables = golden.golden_tables()
    return rd.encode_frame(tables, agent_id="fz", window=5, ts_ms=9,
                           dims=golden.DIMS, codec=rd.CODEC_RAW,
                           frame_uuid="u1", **_extras("all"))


def _fields(data: bytes) -> list[bytes]:
    """The top-level fields of a frame, each as its wire bytes."""
    buf, pos, out = memoryview(data), 0, []
    while pos < len(data):
        start = pos
        _, wire, pos = pbwire._read_tag(buf, pos, len(data))
        pos = pbwire._skip(buf, pos, len(data), 0, wire, 100)
        out.append(bytes(data[start:pos]))
    return out


def _unpacked_shapes(field: bytes) -> bytes:
    """A Tensor field with its packed shape rewritten unpacked."""
    buf = memoryview(field)
    _, _, pos = pbwire._read_tag(buf, 0, len(field))
    end, pos = pbwire._read_len(buf, pos, len(field))
    body = b""
    while pos < end:
        start = pos
        number, wire, pos = pbwire._read_tag(buf, pos, end)
        nxt = pbwire._skip(buf, pos, end, number, wire, 100)
        if number == 3 and wire == 2:
            stop, p = pbwire._read_len(buf, pos, end)
            while p < stop:
                v, p = pbwire._read_varint(buf, p, stop)
                body += pbwire._tag(3, 0) + pbwire._varint(v)
        else:
            body += bytes(field[start:nxt])
        pos = nxt
    return pbwire._tag(10, 2) + pbwire._varint(len(body)) + body


def _mutant(rng, base: bytes, kind: str) -> bytes:
    b = bytearray(base)
    if kind == "truncate":
        return bytes(b[:rng.integers(0, len(b))])
    if kind == "flip":
        for _ in range(rng.integers(1, 4)):
            j = int(rng.integers(0, len(b)))
            if rng.random() < 0.5:
                b[j] ^= 1 << int(rng.integers(0, 8))
            else:
                b[j] = int(rng.integers(0, 256))
        return bytes(b)
    fields = _fields(base)
    if kind == "duplicate":
        for _ in range(rng.integers(1, 3)):
            j = int(rng.integers(0, len(fields)))
            fields.insert(int(rng.integers(0, len(fields) + 1)), fields[j])
    elif kind == "reorder":
        fields = [fields[i] for i in rng.permutation(len(fields))]
    else:  # unpacked shapes, some tensors, and a stray unknown field
        fields = [_unpacked_shapes(f) if f[0] == 0x52 and rng.random() < 0.5
                  else f for f in fields]
        fields.insert(int(rng.integers(0, len(fields) + 1)),
                      pbwire._tag(int(rng.integers(17, 40)), 0) + b"\x05")
    return b"".join(fields)


@pytest.mark.parametrize("kind", ["truncate", "flip", "duplicate",
                                  "reorder", "unpacked"])
def test_mutated_frames_decode_alike(kind):
    rng = np.random.default_rng(["truncate", "flip", "duplicate", "reorder",
                                 "unpacked"].index(kind))
    base = _fuzz_base()
    decoded = 0
    for _ in range(100):
        data = _mutant(rng, base, kind)
        try:
            want = rd.decode_frame(data)
        except rd.DeltaFrameError as exc:
            with pytest.raises(pd.DeltaFrameError) as got:
                pd.decode_frame(data)
            assert type(got.value).__name__ == type(exc).__name__
            continue
        got = pd.decode_frame(data)
        assert _same_frame(got, want), data.hex()
        decoded += 1
    if kind in ("reorder", "unpacked"):
        assert decoded == 100


def test_wire_type_mismatch_is_skipped_as_protobuf_skips_it():
    """A known field in another wire type is an unknown field to upb."""
    data = bytes([0x0A, 0x01, 0x41, 0x13, 0x08, 0x01, 0x14])
    assert pbwire.SketchDelta.FromString(data).version == 0
    assert pb.SketchDelta.FromString(data).version == 0
    for bad in (b"\x14", b"\x12\x01\xff", b"\x08", b"\x12\x05ab",
                b"\x0f\x00", b"\x00\x01"):
        with pytest.raises(pbwire.WireError):
            pbwire.SketchDelta.FromString(bad)
        with pytest.raises(Exception):
            pb.SketchDelta.FromString(bad)


def test_delta_helpers_equal_the_reference(universe):
    tables = _agent_tables(np.random.default_rng(5), universe)
    data = rd.encode_frame(tables, agent_id="h", window=2, ts_ms=3,
                           dims=DIMS, version=2, tenant=None)
    got, want = pd.decode_frame(data), rd.decode_frame(data)
    assert pd.source_key(got) == rd.source_key(want) == "h"
    tenant = rd.decode_frame(rd.encode_frame(
        tables, agent_id="h", window=2, ts_ms=3, dims=DIMS, tenant=(3, 4)))
    assert pd.source_key(pd.decode_frame(rd.encode_frame(
        tables, agent_id="h", window=2, ts_ms=3, dims=DIMS,
        tenant=(3, 4)))) == rd.source_key(tenant) == "h#t3"
    for fn in ("upgrade_tables",):
        a, b = getattr(pd, fn)(got), getattr(rd, fn)(want)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    up = rd.upgrade_tables(want)
    a, b = pd.localize_churn(up, 6), rd.localize_churn(up, 6)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    assert pd.expected_shapes(tables) == rd.expected_shapes(tables)
    for mod in (pd, rd):
        shapes = mod.expected_shapes(tables)
        shapes["cm_bytes"] = (1, 1)
        with pytest.raises(mod.DeltaFrameError, match="shape"):
            mod.validate_shapes(mod.decode_frame(data)._replace(
                tables=mod.upgrade_tables(mod.decode_frame(data))), shapes)
    for name in ("TABLE_SPEC", "TABLE_SPEC_V2", "SCALAR_FIELDS",
                 "SCALAR_FIELDS_V2", "DELTA_FORMAT_VERSION",
                 "SUPPORTED_VERSIONS", "ACK_REASON_DUPLICATE",
                 "ACK_REASON_STALE", "DIM_FIELDS", "MAX_TENSOR_BYTES"):
        assert getattr(pd, name) == getattr(rd, name), name


# ---------------------------------------------------------------- merges


def _slot_case(rng, case: str, n: int):
    """A stacked slot table: duplicate identities, invalid rows, tied
    estimates."""
    ids = rng.integers(0, 2**32, (max(2, n // 3), 2), dtype=np.uint32)
    if case == "ties":
        ids[:, 0] = ids[0, 0]  # equal h1, ordered by h2
    pick = rng.integers(0, len(ids), n)
    valid = rng.random(n) < (0.5 if case == "invalid" else 0.9)
    h1 = np.where(valid, ids[pick, 0], 0).astype(np.uint32)
    h2 = np.where(valid, ids[pick, 1], 0).astype(np.uint32)
    return dict(
        words=rng.integers(0, 2**32, (n, 10), dtype=np.uint32), h1=h1,
        h2=h2, counts=rng.integers(0, 60, n).astype(np.float32),
        prev_counts=rng.integers(0, 60, n).astype(np.float32),
        first_seen=rng.integers(0, 2**31 - 1, n).astype(np.int32),
        epoch=rng.integers(0, 9, n).astype(np.int32), valid=valid)


def _port_slots(d: dict) -> ttopk.SlotTable:
    return ttopk.SlotTable(**{
        k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32
                            else v) for k, v in d.items()})


@pytest.mark.parametrize("case,k", [
    ("duplicates", 64), ("invalid", 64), ("ties", 64), ("duplicates", 8),
    ("invalid", 16), ("ties", 128)])
def test_merge_slot_tables_bit_exact(case, k):
    """k < n, and k = n (every row kept, invalid ones zeroed); one stacked
    size, so the reference compiles its ops once."""
    n = 128
    rng = np.random.default_rng(k * 7 + len(case))
    for _ in range(3):
        d = _slot_case(rng, case, n)
        # few distinct CM values: many tied estimates
        cm = rng.integers(0, 4 if case == "ties" else 30,
                          (3, 256)).astype(np.float32)
        want = jtopk.merge_slot_tables(
            jtopk.SlotTable(**{k_: jnp.asarray(v) for k_, v in d.items()}),
            jcm.CountMin(jnp.asarray(cm)), k)
        got = ttopk.merge_slot_tables(_port_slots(d),
                                      tcm.CountMin(torch.from_numpy(cm)), k)
        for f in jtopk.SlotTable._fields:
            a = getattr(got, f).numpy()
            w = np.asarray(getattr(want, f))
            np.testing.assert_array_equal(a.astype(w.dtype), w, err_msg=f)
            assert a.dtype == (np.int64 if w.dtype == np.uint32 else w.dtype)


@pytest.mark.parametrize("op", ["countmin", "hll", "quantile"])
def test_pure_and_in_place_merges_equal_the_reference(op):
    rng = np.random.default_rng(["countmin", "hll", "quantile"].index(op))
    if op == "hll":
        a, b = (rng.integers(0, 30, (64, 32)).astype(np.int32)
                for _ in range(2))
        want = np.asarray(jhll.merge_regs(jnp.asarray(a), jnp.asarray(b)))
        ta = torch.from_numpy(a.copy())
        assert np.array_equal(thll.merge_regs(ta, torch.from_numpy(b)), want)
        assert thll.merge_regs_(ta, torch.from_numpy(b)) is ta
        assert np.array_equal(ta.numpy(), want)
        return
    a, b = (rng.integers(0, 999, (3, 128)).astype(np.float32)
            for _ in range(2))
    if op == "countmin":
        want = np.asarray(jcm.merge(jcm.CountMin(jnp.asarray(a)),
                                    jcm.CountMin(jnp.asarray(b))).counts)
        mk, pure, inplace = tcm.CountMin, tcm.merge, tcm.merge_
    else:
        a, b = a[0], b[0]
        want = np.asarray(jq.merge(jq.LogHist(jnp.asarray(a)),
                                   jq.LogHist(jnp.asarray(b))).counts)
        mk, pure, inplace = tq.LogHist, tq.merge, tq.merge_
    ta, tb = mk(torch.from_numpy(a.copy())), mk(torch.from_numpy(b))
    assert np.array_equal(pure(ta, tb).counts.numpy(), want)
    assert np.array_equal(ta.counts.numpy(), a)
    assert inplace(ta, tb) is ta
    assert np.array_equal(ta.counts.numpy(), want)


def _jax_flat(state) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(p.name for p in path): np.asarray(v)
            for path, v in leaves}


def _port_tables(host: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.int64)
                                if v.dtype == np.uint32 else np.array(v))
            for k, v in host.items()}


@pytest.mark.parametrize("start", ["fresh", "carried"])
def test_merge_tables_bit_exact_from_one_carried_state(universe, start):
    """Both packages start from one state (the port's carried across by
    sketch/carry), then merge the same frames; every field agrees."""
    rng = np.random.default_rng(21)
    jstate = js.init_state(JCFG)
    if start == "carried":
        for _ in range(2):
            jstate = js.ingest(jstate, make_arrays(rng, universe))
        jstate, _ = js.make_roll_fn(JCFG)(jstate)
        jstate = js.ingest(jstate, make_arrays(rng, universe))
    tstate = carry.state_from_numpy(_jax_flat(jstate), device="cpu")
    for w in range(4):
        data = rd.encode_frame(_agent_tables(rng, universe, 2),
                               agent_id=f"a{w}", window=w, ts_ms=0,
                               dims=DIMS, version=3 if w % 2 else 2)
        host = rd.localize_churn(rd.upgrade_tables(rd.decode_frame(data)),
                                 w)
        jstate = rmerge.merge_tables(
            jstate, {k: jnp.asarray(np.ascontiguousarray(v))
                     for k, v in host.items()})
        assert pmerge.merge_tables(tstate, _port_tables(host)) is tstate
    got, want = carry.state_to_numpy(tstate), _jax_flat(jstate)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_merge_tables_refuses_a_tiered_state():
    state = ts.init_state(TCFG._replace(tiered=tiered.TierSpec(
        mid_group=32, top_group=256)), "cpu")
    with pytest.raises(TypeError, match="wide"):
        pmerge.merge_tables(state, {})


# ------------------------------------------------------------ aggregator


def _frame(tables, agent, window, epoch, uid=None, version=None, **kw):
    return rd.encode_frame(tables, agent_id=agent, window=window,
                           ts_ms=1_700_000_000_000 + window, dims=DIMS,
                           agent_epoch=epoch, frame_uuid=uid or f"{agent}-"
                           f"{window}-{uuid.uuid4().hex[:6]}",
                           version=version, **kw)


def _schedule(universe):
    """Frame bytes in delivery order, window by window ("flush" closes a
    window): 4 agents x 3 windows (agent-2 with trace context and
    telemetry), a redelivered frame, a stale one, v2 and v1 frames, a
    wrong geometry and garbage."""
    rng = np.random.default_rng(77)
    other = js.SketchConfig(cm_depth=2, cm_width=512, hll_precision=6,
                            perdst_buckets=32, perdst_precision=4,
                            persrc_buckets=32, persrc_precision=4, topk=32,
                            hist_buckets=64, ewma_buckets=32)
    skewed = rd.encode_frame(
        _host_tables(js.init_state(other)), agent_id="skewed", window=0,
        ts_ms=0, dims={"cm_depth": 2, "cm_width": 512, "hll_precision": 6,
                       "topk": 32, "ewma_buckets": 32})
    out = []
    for w in range(3):
        sent = []
        for a in range(4):
            kw = {}
            if a == 2:
                kw = {"telemetry": {"conditions": ["ALERTING"] if w else [],
                                    "host_records_per_s": 10.0 * w,
                                    "windows_published": w + 1},
                      "trace_ctx": tracing.TraceContext(
                          f"feed{w:04x}", "window@agent-2", True)}
            f = _frame(_agent_tables(rng, universe, 1 + a % 2), f"agent-{a}",
                       w, 1000 + a, **kw)
            sent.append(f)
            out.append(f)
        out.append(sent[1])                                  # duplicate
        out.append(_frame(_agent_tables(rng, universe), "agent-0",
                          max(w - 1, 0), 1000))              # stale
        out.append(_frame(_agent_tables(rng, universe), "old-v2", w, 5,
                          version=2))
        out.append(_frame(_agent_tables(rng, universe), "old-v1", w, 0,
                          version=1))
        out += [skewed, b"\x00garbage" * (w + 1)]
        if w == 2:  # a dead epoch's straggler
            out.append(_frame(_agent_tables(rng, universe), "agent-3", 9,
                              999))
        out.append("flush")
    return out


def _timeless_agents(view: dict) -> dict:
    return {a: {k: v for k, v in info.items()
                if k not in ("last_ms", "staleness_s")}
            for a, info in view.items()}


def test_aggregator_equals_the_reference(universe):
    tracing.configure(1.0)
    jtracing.configure(1.0)
    reports, jreports = [], []
    tm, jm = Metrics(), jreg.Metrics(jreg.MetricsSettings())
    agg = FederationAggregator(TCFG, window_s=3600.0, metrics=tm,
                               sink=reports.append, device="cpu")
    ref = RefAggregator(sketch_cfg=JCFG, window_s=3600.0, metrics=jm,
                        sink=jreports.append)
    try:
        verdicts = []
        for item in _schedule(universe):
            if item == "flush":
                agg.flush()
                ref.flush()
                got, want = agg.snapshot(), ref.snapshot()
                for k in ("window", "seq", "total_records", "total_bytes"):
                    assert got[k] == want[k], k
                _assert_report(got["report"], want["report"], GAMMA)
                for k in ("cm_bytes", "cm_pkts"):
                    np.testing.assert_array_equal(got[k], want[k])
                for k, v in want["heavy"].items():
                    np.testing.assert_array_equal(got["heavy"][k],
                                                  np.asarray(v), err_msg=k)
                assert _timeless_agents(got["agents"]) == \
                    _timeless_agents(want["agents"])
                continue
            ack = agg.ingest_frame(item)
            want = ref.ingest_frame(item)
            assert ack.SerializeToString() == want.SerializeToString()
            verdicts.append((ack.accepted, ack.duplicate, ack.reason[:20]))
            assert agg._ledger == ref._ledger
            assert agg._window_host == ref._window_host
        assert len(reports) == len(jreports) == 3
        for got, want in zip(reports, jreports):
            _assert_report(got, want, GAMMA)
        assert [r["Agents"] for r in reports] == [
            ["agent-0", "agent-1", "agent-2", "agent-3", "old-v1", "old-v2"]
        ] * 3
        st, jst = agg.status(), ref.status()
        for k in jst:
            if k == "agents":
                assert _timeless_agents(st[k]) == _timeless_agents(jst[k])
            else:
                assert st[k] == jst[k], k
        assert _timeless(agg.fleet()["counts"]) == ref.fleet()["counts"]
        for name in ("ok", "legacy", "duplicate", "stale", "shape_mismatch",
                     "decode_error"):
            labels = {"result": name}
            assert tm.registry.get_sample_value(
                "ebpf_agent_federation_deltas_total", labels) == \
                jm.registry.get_sample_value(
                    "ebpf_agent_federation_deltas_total", labels), name
        # agent-2's sampled trace continued and parked into each window
        spans = [s["stage"] for t in tracing.snapshot(trace_id="feed0001")
                 for s in t["stages"]]
        jspans = [s["stage"] for t in jtracing.snapshot(trace_id="feed0001")
                  for s in t["stages"]]
        assert "delta_h2d" in spans
        assert [s for s in spans if s != "delta_h2d"] == jspans
        assert st["frames_total"] == 18 and agg._window_host == 3
    finally:
        agg.close()
        ref.close()


@pytest.mark.parametrize("kw,err", [
    ({"mesh_shape": "4x1"}, None), ({"checkpoint_dir": "ck"}, None),
    ({"archive": "archive"}, None),
    ({"sketch_cfg": TCFG._replace(tiered=tiered.TierSpec())}, "tiered")],
    ids=["mesh", "checkpoint", "archive", "tiered"])
def test_aggregator_refuses_what_this_slice_does_not_port(kw, err,
                                                          tmp_path):
    """A tiered aggregate is refused; since the archive and checkpoint
    slice, `checkpoint_dir` and `archive` are taken
    (tests/test_torch_checkpoint.py, tests/test_torch_archive.py), and
    since the mesh slice `mesh_shape`, on the CPU repeated
    (tests/test_torch_mesh_planes.py)."""
    kw = {"sketch_cfg": TCFG, **kw}
    if "mesh_shape" in kw:
        kw["devices"] = ["cpu"] * 4
    if err is not None:
        with pytest.raises((NotImplementedError, ValueError), match=err):
            FederationAggregator(device="cpu", window_s=3600.0, **kw)
        return
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    if "archive" in kw:
        from netobserv_tpu_torch.archive import ArchiveStore, SketchArchive
        kw["archive"] = SketchArchive(ArchiveStore(str(tmp_path / "a")),
                                      TCFG, ladder_max=1, device="cpu")
    agg = FederationAggregator(device="cpu", window_s=3600.0, **kw)
    try:
        st = agg.status()
        assert st["checkpointing"] is ("checkpoint_dir" in kw)
        assert ("archive" in st) is ("archive" in kw)
        assert st["mesh"] is ("mesh_shape" in kw)
    finally:
        agg.close()


def test_reference_rejects_each_frame_of_a_tiered_aggregate(universe):
    """What the reference does with a tiered sketch_cfg, which the port
    refuses at construction: every merge raises, and the frame is
    rejected as a merge error."""
    from netobserv_tpu.sketch import tiered as jt
    ref = RefAggregator(sketch_cfg=JCFG._replace(tiered=jt.TierSpec()),
                        window_s=3600.0, sink=lambda obj: None)
    try:
        ack = ref.ingest_frame(_frame(_agent_tables(
            np.random.default_rng(1), universe), "t", 0, 1))
        assert ack.accepted == 0
    finally:
        ref.kill()


def test_ttl_eviction_drops_the_agent_and_its_series(universe):
    tm = Metrics()
    agg = FederationAggregator(TCFG, window_s=3600.0, metrics=tm,
                               agent_ttl_s=30.0, device="cpu")
    try:
        agg.ingest_frame(_frame(_agent_tables(np.random.default_rng(2),
                                              universe), "gone", 0, 1))
        agg._update_staleness()
        get = tm.registry.get_sample_value
        assert get("ebpf_agent_federation_agent_staleness_seconds",
                   {"agent": "gone"}) is not None
        agg._agents["gone"]["last_mono"] -= 60.0
        agg._evict_stale_agents()
        assert "gone" not in agg._agents and "gone" not in agg._ledger
        assert get("ebpf_agent_federation_agent_staleness_seconds",
                   {"agent": "gone"}) is None
        assert get("ebpf_agent_federation_agent_evictions_total") == 1
    finally:
        agg.close()


def test_delta_ingest_fault_point_corrupts_into_a_rejection(universe):
    agg = FederationAggregator(TCFG, window_s=3600.0, device="cpu")
    try:
        faultinject.arm("federation.delta_ingest", "corrupt", times=1)
        data = _frame(_agent_tables(np.random.default_rng(4), universe),
                      "c", 0, 1)
        assert agg.ingest_frame(data).accepted == 0
        assert faultinject.hits["federation.delta_ingest"] == 1
        assert agg.ingest_frame(data).accepted == 1
    finally:
        agg.close()


def test_report_queue_sheds_the_oldest_past_four():
    tm = Metrics()
    agg = FederationAggregator(TCFG, window_s=3600.0, metrics=tm,
                               device="cpu")
    try:
        with agg._lock:
            for _ in range(6):
                agg._close_window_locked()
        assert len(agg._reports) == 4
        assert [r[0].window for r in agg._reports] == [2, 3, 4, 5]
        assert tm.registry.get_sample_value(
            "ebpf_agent_errors_total",
            {"component": "federation", "severity": "error"}) == 2
    finally:
        agg.close()


# ----------------------------------------------------------------- union


def _union_agents(universe):
    """Four port agents (agent-3 tiered), each folding its own evictions,
    and a union exporter folding all of them; two windows."""
    rng = np.random.default_rng(404)
    frames, reports, jreports = [], [], []
    cfg = ts.SketchConfig(**GEOM)
    agg = FederationAggregator(cfg, window_s=3600.0, sink=jreports.append,
                               device="cpu")
    spec = tiered.TierSpec(bytes_unit=1)
    agents = [TorchSketchExporter(
        cfg._replace(tiered=spec) if a == 3 else cfg, batch_size=B,
        device="cpu", pack_threads=2, superbatch=(1, 2),
        resident_slots=1 << 12, sink=reports.append, agent_id=f"agent-{a}",
        delta_sink=lambda f, a=a: (frames.append((a, f)),
                                   agg.ingest_frame(f))[1])
        for a in range(4)]
    # the tiered agent's wide twin: its tables are what it must send
    twin = TorchSketchExporter(cfg, batch_size=B, device="cpu",
                               pack_threads=2, superbatch=(1, 2),
                               resident_slots=1 << 12, sink=lambda o: None)
    union = TorchSketchExporter(cfg, batch_size=B, device="cpu",
                                pack_threads=2, superbatch=(1, 2),
                                resident_slots=1 << 12, sink=lambda o: None)
    windows = []
    for w in range(2):
        for a, exp in enumerate(agents):
            for n in (B + 37, 300) if a != 3 else (120,):
                ev, f = _feed(rng, n, n_distinct=60)
                exp.export_evicted(EvictedFlows(ev, **f))
                union.export_evicted(EvictedFlows(ev, **f))
                if a == 3:
                    twin.export_evicted(EvictedFlows(ev, **f))
        twin_tables = twin.state_tables()
        tier_tables = agents[3].state_tables()
        union._drain_pending()
        union_tables = union.state_tables()
        for exp in agents:
            exp.flush()
        agg_state = carry.state_to_numpy(agg._state)
        agg_tables = ts.state_tables(agg._state)
        agg.flush()
        twin.flush()
        windows.append(dict(union=union_tables, agg=agg_tables,
                            agg_state=agg_state, twin=twin_tables,
                            tiered=tier_tables, union_report=union.roll()))
    for exp in (*agents, twin, union):
        exp.close()
    return agg, windows, frames, reports, jreports


@pytest.fixture(scope="module")
def union_run(universe):
    agg, windows, frames, reports, jreports = _union_agents(universe)
    yield agg, windows, frames, reports, jreports
    agg.close()


def test_union_tiered_agent_sends_its_wide_tables(union_run):
    """Precondition of the union: the tiered agent's decoded tables equal
    its wide twin's bit for bit (no counter past the u8 base tier)."""
    for w in union_run[1]:
        for k, v in w["twin"].items():
            np.testing.assert_array_equal(w["tiered"][k], v, err_msg=k)


LINEAR = ("cm_bytes", "cm_pkts", "hll_src", "hll_per_dst", "hll_per_src",
          "hist_rtt", "hist_dns", "ddos_rate", "syn_rate", "synack",
          "drops_rate", "drop_causes", "dscp_bytes", "conv_fwd", "conv_rev")


def test_union_linear_and_max_structures_bit_exact(union_run):
    for w in union_run[1]:
        for k in LINEAR:
            np.testing.assert_array_equal(w["agg"][k], w["union"][k],
                                          err_msg=k)
        np.testing.assert_array_equal(w["agg"]["scalars"][:6],
                                      w["union"]["scalars"][:6])


def test_union_heavy_table_equals_the_sequential_merge(union_run):
    """The aggregate's slot table equals merge_tables of the same frames,
    in their order, into a fresh state (the reference's oracle)."""
    agg, windows, frames, _, _ = union_run
    oracle = ts.init_state(agg._cfg, "cpu")
    for w, want in enumerate(windows):
        for _, data in frames:
            if pd.decode_frame(data).window != w:
                continue
            host = pd.localize_churn(
                pd.upgrade_tables(pd.decode_frame(data)), w)
            pmerge.merge_tables(oracle, _port_tables(host))
        got = want["agg_state"]
        for k, v in carry.state_to_numpy(oracle).items():
            if k.startswith("heavy."):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
        ts.roll_window(oracle, agg._cfg)


def test_union_heavy_recall(union_run):
    for w in union_run[1]:
        def top(t, n):
            order = np.argsort(-np.where(t["heavy_valid"],
                                         t["heavy_counts"], -1.0))[:n]
            return {t["heavy_words"][i].tobytes() for i in order
                    if t["heavy_valid"][i]}
        n = 16
        assert len(top(w["agg"], n) & top(w["union"], n)) / n >= 0.9


def test_union_cluster_reports_sum_the_agents(union_run):
    _, windows, _, reports, jreports = union_run
    assert len(jreports) == len(windows)
    for w, rep in enumerate(jreports):
        agents = [r for r in reports if r["Window"] == w]
        assert len(agents) == 4
        assert rep["Records"] == sum(r["Records"] for r in agents)
        assert rep["Records"] == windows[w]["union_report"]["Records"]
        assert rep["Bytes"] == windows[w]["union_report"]["Bytes"]
        assert rep["Type"] == "federation_window_report"
        assert rep["Agents"] == [f"agent-{a}" for a in range(4)]
        assert rep["DistinctSrcEstimate"] == \
            windows[w]["union_report"]["DistinctSrcEstimate"]


def test_union_frames_carry_the_exporters_headers(union_run):
    agg, _, frames, _, _ = union_run
    for a, data in frames:
        f = pd.decode_frame(data)
        assert f.agent_id == f"agent-{a}" and f.version == 3
        assert f.window_seq == f.window and len(f.frame_uuid) == 32
        assert f.telemetry["shed_factor"] == 1.0
        assert f.telemetry["windows_published"] == f.window + 1
    # the agents' close() sent a third, empty window
    assert agg._ledger["agent-0"]["window_seq"] == 2
    assert agg._fold.calls == len(frames) == 12 and agg._roll.calls >= 2


# --------------------------------------------------------- exporter seam


def test_exporter_frame_equals_the_reference():
    """The same evictions through the JAX exporter and the port: the
    decoded frames' tables agree bit for bit (the RTT and DNS histograms
    to the bound of tests/test_torch_staging.py), the headers but the
    uuid, time and epoch exactly, and those in form."""
    rng = np.random.default_rng(31)
    frames, jframes, samples = [], [], _Samples()
    for mod in (tracing, jtracing):
        mod.configure(sample=1.0, capacity=256)
    jexp, _ = _jax_exporter(agent_id="a1", delta_sink=jframes.append)
    exp, _ = _port_exporter(agent_id="a1", delta_sink=frames.append)
    try:
        for w in range(2):
            for n in (300, 2 * B + 50, 700):
                ev, f = _feed(rng, n, n_distinct=900)
                samples.add(f)
                exp.export_evicted(EvictedFlows(ev, **f))
                jexp.export_evicted(jfetch.EvictedFlows(ev, **f))
            exp.flush()
            jexp.flush()
    finally:
        exp.close()
        jexp.close()
    assert len(frames) == len(jframes) == 3  # close publishes a third

    def window_spans(mod):
        return sorted({s["stage"] for t in mod.snapshot()
                       if t["kind"] == "window" for s in t["stages"]})
    assert window_spans(tracing) == window_spans(jtracing)
    assert {"report_serialize", "delta_push"} <= set(window_spans(tracing))
    for data, jdata in zip(frames, jframes):
        got, want = rd.decode_frame(data), rd.decode_frame(jdata)
        for k in ("version", "agent_id", "window", "dims", "window_seq",
                  "tenant"):
            assert getattr(got, k) == getattr(want, k), k
        assert got.trace_ctx.origin == want.trace_ctx.origin == \
            "window@a1" and got.trace_ctx.sampled
        tel, jtel = dict(got.telemetry), dict(want.telemetry)
        assert tel.pop("host_records_per_s") >= 0.0
        jtel.pop("host_records_per_s")
        assert tel == jtel
        assert len(got.frame_uuid) == 32 and got.frame_uuid != \
            want.frame_uuid
        assert abs(got.ts_ms - want.ts_ms) < 600_000
        assert 0 < got.agent_epoch and got.agent_epoch != want.agent_epoch
        for k, v in want.tables.items():
            g = got.tables[k]
            if k in samples.us:
                assert g.sum() == v.sum()
                moved = np.abs(np.cumsum(g.astype(np.float64) - v)).sum()
                assert moved <= samples.edge_prone(k, len(v)), k
                continue
            np.testing.assert_array_equal(g, v, err_msg=k)


def test_exporter_refuses_the_delta_sink_in_decay_mode():
    closed = []

    class Sink:
        def __call__(self, f):
            raise AssertionError("no frame in decay mode")

        def close(self):
            closed.append(True)
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", sink=lambda o: None,
                              decay_factor=0.5, delta_sink=Sink())
    try:
        assert exp._delta_sink is None and closed == [True]
    finally:
        exp.close()


def test_failing_delta_sink_keeps_the_report():
    def boom(frame):
        raise RuntimeError("aggregator exploded")
    reports = []
    tm = Metrics()
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", sink=reports.append,
                              delta_sink=boom, metrics=tm, pack_threads=2)
    try:
        ev, f = _feed(np.random.default_rng(6), 400)
        exp.export_evicted(EvictedFlows(ev, **f))
        exp.flush()
        assert len(reports) == 1 and reports[0]["Records"] == 400
        assert tm.registry.get_sample_value(
            "ebpf_agent_errors_total",
            {"component": "federation", "severity": "error"}) == 1
    finally:
        exp.close()


def test_delta_export_fault_point_loses_the_frame_not_the_report():
    frames, reports, closed = [], [], []

    class Sink(list):
        def __call__(self, f):
            frames.append(f)

        def close(self):
            closed.append(True)
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", sink=reports.append,
                              delta_sink=Sink(), pack_threads=2)
    faultinject.arm("sketch.delta_export", "crash", times=1)
    ev, f = _feed(np.random.default_rng(7), 200)
    exp.export_evicted(EvictedFlows(ev, **f))
    exp.flush()
    assert faultinject.hits.get("sketch.delta_export") == 1
    assert reports and not frames
    exp.close()
    # the disarmed close-time window sends its (empty) frame, and close
    # closes the sink
    assert len(frames) == 1 and closed == [True]
    assert pd.decode_frame(frames[0]).tables["scalars"][0] == 0.0


def test_sampled_window_stamps_its_trace_context():
    tracing.configure(1.0)
    tm = Metrics()
    frames = []
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                              device="cpu", sink=lambda o: None,
                              delta_sink=frames.append, agent_id="node-7",
                              metrics=tm, pack_threads=2)
    try:
        exp.flush()
    finally:
        exp.close()
    ctx = pd.decode_frame(frames[0]).trace_ctx
    assert ctx.origin == "window@node-7" and ctx.sampled
    assert any(t["trace_id"] == ctx.trace_id
               for t in tracing.snapshot())
    assert tm.registry.get_sample_value(
        "ebpf_agent_trace_context_propagated_total",
        {"result": "stamped"}) == 2


# ---------------------------------------------------------------- routes


def _serve(module, agg):
    srv = module.start_query_server(
        agg, port=0, address="127.0.0.1",
        health_source=lambda: {"status": "Started", "degraded": False,
                               "stages": {}})
    port = srv.server_address[1]

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = e.read()
            return e.code, (json.loads(body) if e.headers.get_content_type()
                            == "application/json" else None)
    return srv, get


ROUTES = ("/federation/topk?n=5", "/federation/churn",
          "/federation/cardinality", "/federation/victims",
          "/federation/frequency", "/federation/alerts",
          "/federation/range", "/federation/nope", "/readyz", "/healthz",
          "/federation", "FREQ")


@pytest.fixture(scope="module")
def served(universe):
    aggs = (FederationAggregator(TCFG, window_s=3600.0, device="cpu"),
            RefAggregator(sketch_cfg=JCFG, window_s=3600.0))
    servers = [_serve(m, a) for m, a in zip((pquery, rquery), aggs)]
    before = [[s[1]("/federation/topk"), s[1]("/federation/fleet")]
              for s in servers]
    rng = np.random.default_rng(8)
    for a in range(4):
        f = _frame(_agent_tables(rng, universe, 2), f"agent-{a}", 0, 1)
        for agg in aggs:
            assert agg.ingest_frame(f).accepted == 1
    for agg in aggs:
        agg.flush()
    yield aggs, servers, before
    for srv, _ in servers:
        srv.shutdown()
        srv.server_close()
    for agg in aggs:
        agg.close()


@pytest.mark.parametrize("path", ROUTES)
def test_routes_equal_the_reference(served, path):
    aggs, servers, before = served
    assert before[0] == before[1]
    if path == "FREQ":
        top = aggs[1].snapshot()["report"]["HeavyHitters"][0]
        path = (f"/federation/frequency?src={top['SrcAddr']}&dst="
                f"{top['DstAddr']}&src_port={top['SrcPort']}&dst_port="
                f"{top['DstPort']}&proto={top['Proto']}")
    (tc, tb), (jc, jb) = servers[0][1](path), servers[1][1](path)
    assert tc == jc, path
    _assert_report(_timeless(tb), _timeless(jb), GAMMA, path)


def test_status_fleet_and_debug_routes_equal_the_reference(served):
    _, servers, _ = served
    for path in ("/federation/status", "/federation/fleet"):
        (tc, tb), (jc, jb) = servers[0][1](path), servers[1][1](path)
        assert tc == jc == 200
        assert _timeless_agents(tb["agents"]) == \
            _timeless_agents(jb["agents"])
    for path in ("/debug/traces?limit=1", "/debug/executables"):
        (tc, tb), (jc, jb) = servers[0][1](path), servers[1][1](path)
        assert tc == jc == 200 and tb.keys() == jb.keys()
    names = {e["fn"] for e in servers[0][1]("/debug/executables")[1][
        "executables"]}
    assert {"federation_merge", "federation_roll"} <= names


# --------------------------------------------------- settings and traces


@pytest.mark.parametrize("env", [
    {}, {"FEDERATION_WINDOW": "1m30s", "FEDERATION_STALE_AFTER": "45s",
         "FEDERATION_AGENT_TTL": "0", "FEDERATION_AGENT_ID": "node-a"},
    {"FEDERATION_WINDOW": "250ms", "FEDERATION_AGENT_TTL": ""}])
def test_federation_settings_equal_the_reference(env):
    want = jconfig.load_config(dict(env))
    got = tconfig.FederationSettings.from_env(env)
    for name in ("federation_window", "federation_stale_after",
                 "federation_agent_ttl", "federation_agent_id"):
        assert getattr(got, name) == getattr(want, name), name
    with pytest.raises(ValueError):
        tconfig.FederationSettings.from_env({"FEDERATION_WINDOW": "5x"})


def test_trace_groups_and_continuation_behave_as_the_reference():
    for mod in (tracing, jtracing):
        mod.configure(0.0)
        assert mod.continue_trace(mod.TraceContext("ab", "o", True)) is \
            mod.NULL_TRACE
        mod.configure(1.0)
        assert mod.group() is mod.NULL_TRACE
        assert mod.continue_trace(None) is mod.NULL_TRACE
        assert mod.continue_trace(mod.TraceContext("ab", "o", False)) is \
            mod.NULL_TRACE
        cont = mod.continue_trace(mod.TraceContext("ab", "o", True), "k")
        own = mod.start_trace("w")
        assert mod.group(own) is own and mod.group(mod.NULL_TRACE,
                                                   cont) is cont
        g = mod.group(own, cont, mod.NULL_TRACE)
        assert isinstance(g, mod.TraceGroup) and len(g.traces) == 2
        with g.stage("roll_dispatch"):
            pass
        g.finish()
        got = mod.snapshot(trace_id="ab")
        assert [s["stage"] for s in got[0]["stages"]] == ["roll_dispatch"]
        assert got[0]["origin"] == "o"
