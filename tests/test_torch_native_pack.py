"""The port's native packers (netobserv_tpu_torch/csrc/flowpack.cc:
datapath/flowpack.NativeKeyDict and pack_resident_native, and the staging
ring that takes them; pack_dense, pack_dense_sharded and pack_compact)
against the port's Python packers and the JAX package's Python twins, on
the CPU.

The library is built with the host C++ compiler once per module (a failed
build fails these tests: nothing skips). Everything is held bit for bit:
each chunk's region word for word, its rows consumed and the dictionary's
count, chunk by chunk, on the eight packer cases of
`tests/test_torch_resident.py`; the ring's state tables, key table and
counters after whole folds; the dense and compact buffers word for word
(a dirty output buffer included). Sizes: B = 512, a small sketch
geometry."""

import ctypes

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu.model import binfmt as jbin
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.model import binfmt as tbin
from netobserv_tpu_torch.ops.kernels import _build
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch.staging import ResidentStagingRing
from tests.test_torch_resident import B, GEOM, PACK_CASES, _case, _make_feed


@pytest.fixture(scope="module")
def native():
    """The packer's library, built (or found built) and checked."""
    return tfp.native_lib()


def _pack_three(ev, f, caps, slot_cap):
    """Pack events chunk by chunk with the native packer, the port's Python
    packer and the reference's Python twin, each continuing from its own
    stop row; assert every chunk equal. Returns (chunks, native dict,
    Python dict)."""
    kd_n = tfp.NativeKeyDict(slot_cap)
    kd_t = tfp.KeyDict(slot_cap)
    kd_j = jfp.KeyDict(slot_cap, use_native=False)
    out = np.full(tfp.resident_buf_len(B, caps), 0xDEADBEEF, np.uint32)
    chunks = []
    start = 0
    while start < len(ev):
        # a dirty output buffer: the native packer zeroes every lane tail
        bn, cn = tfp.pack_resident_native(ev, B, kd_n, caps, start=start,
                                          out=out, **f)
        bt, ct = tfp.pack_resident(ev, B, kd_t, caps, start=start, **f)
        bj, cj = jfp.pack_resident(ev, B, kd_j, caps, start=start, **f)
        assert bn is out
        assert cn == ct == cj and cn > 0, (start, cn, ct, cj)
        np.testing.assert_array_equal(bn, bt, err_msg=f"chunk at {start}")
        np.testing.assert_array_equal(bn, bj, err_msg=f"chunk at {start}")
        assert kd_n.count() == kd_t.count() == kd_j.count()
        chunks.append(bn.copy())
        out[:] = 0xDEADBEEF
        start += cn
    return chunks, kd_n, kd_t


@pytest.mark.parametrize("name", PACK_CASES)
def test_native_packer_equals_both_python_packers_chunk_by_chunk(native,
                                                                 name):
    ev, f, caps, slot_cap = _case(name, np.random.default_rng(7))
    chunks, kd_n, kd_t = _pack_three(ev, f, caps, slot_cap)
    # the same keys on the same slots
    words = np.frombuffer(b"".join(kd_t.slots), np.uint32).reshape(-1, 10)
    np.testing.assert_array_equal(kd_n.slots_of(words),
                                  np.fromiter(kd_t.slots.values(), np.int64))
    spilled = sum(int(c[2]) for c in chunks)
    if name == "cold_key_flood":
        assert len(chunks) > 3  # continuations
    if name == "full_dictionary":
        assert kd_n.count() == slot_cap and spilled > 0
    kd_n.close()


def test_native_dictionary_count_reset_lookup_and_close(native):
    ev, f, caps, _ = _case("same_key_twice", np.random.default_rng(3))
    kd = tfp.NativeKeyDict(64)
    assert kd.count() == 0 and kd.slot_cap == 64
    tfp.pack_resident_native(ev, B, kd, caps, **f)
    words = tfp.pack_key_words(ev["key"])
    slots = kd.slots_of(words)
    assert kd.count() == len(np.unique(slots)) > 0 and slots.min() >= 0
    assert (kd.slots_of(np.zeros((3, 10), np.uint32)) == -1).all()
    kd.reset()
    assert kd.count() == 0 and (kd.slots_of(words) == -1).all()
    kd.close()
    kd.close()
    with pytest.raises(ValueError, match="closed"):
        kd.count()
    with pytest.raises(ValueError, match="slot_cap"):
        tfp.NativeKeyDict(1 << 21)
    with pytest.raises(ValueError, match="slot_cap"):
        tfp.NativeKeyDict(0)


def test_native_library_reports_its_abi_and_the_binfmt_record_sizes(
        native, monkeypatch):
    assert native.fp_abi_version() == tfp.ABI_VERSION
    sizes = np.zeros(13, np.uint64)
    assert native.fp_struct_sizes(sizes.ctypes.data, 13) == 13
    names = ("FLOW_KEY_DTYPE", "FLOW_STATS_DTYPE", "FLOW_EVENT_DTYPE",
             "EXTRA_REC_DTYPE", "DNS_REC_DTYPE", "DROPS_REC_DTYPE",
             "XLAT_REC_DTYPE", "QUIC_REC_DTYPE", "NEVENTS_REC_DTYPE")
    want = [getattr(tbin, n).itemsize for n in names]
    assert sizes.tolist()[:9] == want == [getattr(jbin, n).itemsize
                                          for n in names]
    # then the fused pipeline's structs, as their ctypes mirrors lay out
    assert sizes.tolist()[9:] == [ctypes.sizeof(c)
                                  for c in tfp._PIPE_STRUCTS]
    tfp._check_abi(native, "lib")
    monkeypatch.setattr(tfp, "ABI_VERSION", tfp.ABI_VERSION + 1)
    with pytest.raises(RuntimeError, match="ABI version"):
        tfp._check_abi(native, "lib")
    monkeypatch.undo()
    monkeypatch.setattr(tfp, "_NATIVE_RECORDS",
                        (tbin.FLOW_KEY_DTYPE,) * 8)
    with pytest.raises(RuntimeError, match="record sizes"):
        tfp._check_abi(native, "lib")
    monkeypatch.undo()
    words = np.zeros(6, np.uint32)
    assert native.fp_layout_words(words.ctypes.data, 6) == 6
    assert words.tolist() == [jfp.DENSE_WORDS, jfp.COMPACT_WORDS,
                              jfp.RESIDENT_HDR, jfp.HOT_WORDS, jfp.NK_WORDS,
                              jfp._V4_PREFIX_WORD2]
    monkeypatch.setattr(tfp, "_NATIVE_LAYOUT", (20, 11, 4, 3, 11,
                                                0xFFFF0000))
    with pytest.raises(RuntimeError, match="layout words"):
        tfp._check_abi(native, "lib")


def _bad_calls(ev, f, caps):
    """(keyword arguments, exception, message) the packers must refuse."""
    good = dict(events_raw=ev, batch_size=B, caps=caps, **f)
    total = tfp.resident_buf_len(B, caps)
    return [
        (dict(good, batch_size=1 << 16), ValueError, "16-bit"),
        (dict(good, start=len(ev) + 1), ValueError, "start"),
        (dict(good, start=-1), ValueError, "start"),
        (dict(good, caps=tfp.ResidentCaps(8, 8, 0, 8)), ValueError,
         "progress"),
        (dict(good, caps=tfp.ResidentCaps(8, 8, 8, 0)), ValueError,
         "progress"),
        (dict(good, out=np.zeros(total - 1, np.uint32)), ValueError, "out"),
        (dict(good, out=np.zeros(total, np.int32)), ValueError, "out"),
        (dict(good, out=np.zeros(2 * total, np.uint32)[::2]), ValueError,
         "out"),
        (dict(good, events_raw=ev.tobytes()[:-1]), ValueError, None),
    ]


def test_native_packer_refuses_what_the_python_packer_refuses(native):
    ev, f, caps, _ = _case("rtt_past_the_code", np.random.default_rng(1))
    kd_n, kd_t = tfp.NativeKeyDict(64), tfp.KeyDict(64)
    for kwargs, exc, msg in _bad_calls(ev, f, caps):
        for pack, kd in ((tfp.pack_resident_native, kd_n),
                         (tfp.pack_resident, kd_t)):
            with pytest.raises(exc, match=msg):
                pack(kdict=kd, **kwargs)
    assert kd_n.count() == kd_t.count() == 0
    # bytes in, as the Python form takes them
    bn, cn = tfp.pack_resident_native(ev.tobytes(), B, kd_n, caps, **f)
    bt, ct = tfp.pack_resident(ev.tobytes(), B, kd_t, caps, **f)
    assert cn == ct and np.array_equal(bn, bt)
    # the dictionaries do not mix
    with pytest.raises(TypeError, match="NativeKeyDict"):
        tfp.pack_resident(ev, B, kd_n, caps)
    with pytest.raises(TypeError, match="NativeKeyDict"):
        tfp.pack_resident_native(ev, B, kd_t, caps)
    kd_n.close()
    with pytest.raises(ValueError, match="closed"):
        tfp.pack_resident_native(ev, B, kd_n, caps)


def test_failed_packer_build_raises(native, tmp_path, monkeypatch):
    """$CXX pointing at a path that is not there raises, and so does a
    compiler that fails. Nothing falls back; a library already built is
    found by its digest whatever $CXX says."""
    built = _build.host_lib_path(tfp.NATIVE_SOURCE)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    assert _build.build_host(tfp.NATIVE_SOURCE) == built
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="not found"):
        _build.build_host(tfp.NATIVE_SOURCE)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_host(tfp.NATIVE_SOURCE)
    assert not list(tmp_path.rglob("*.so"))


def test_host_build_is_keyed_on_source_header_and_flags(native, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    a = _build.host_lib_path(tfp.NATIVE_SOURCE)
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-g",))
    assert _build.host_lib_path(tfp.NATIVE_SOURCE) != a
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS[:-1])
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (tfp.NATIVE_SOURCE, "records.h"):
        (csrc / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.host_lib_path(tfp.NATIVE_SOURCE) == a
    header = (csrc / "records.h").read_bytes()
    (csrc / "records.h").write_text("// edited\n")
    assert _build.host_lib_path(tfp.NATIVE_SOURCE) != a
    (csrc / "records.h").write_bytes(header)
    lib = ctypes.CDLL(str(_build.build_host(tfp.NATIVE_SOURCE)))
    assert lib.fp_abi_version() == tfp.ABI_VERSION
    assert [p.name for p in tmp_path.glob("*.so")] == [a.name]


@pytest.mark.parametrize("slot_cap", [1 << 12, 150])
def test_native_ring_folds_equal_the_python_ring(native, slot_cap):
    """The `test_ring_folds_equal_the_reference_ring` schedule through two
    of the port's rings, native and Python packer: state tables, key table
    and counters equal; slot_cap 150 under 200 keys forces dictionary
    epochs."""
    caps = tfp.default_resident_caps(B)
    rings = [ResidentStagingRing(B, caps=caps, slot_cap=slot_cap,
                                 device="cpu", packer=p)
             for p in ("native", "python")]
    assert isinstance(rings[0].kdict, tfp.NativeKeyDict)
    assert isinstance(rings[1].kdict, tfp.KeyDict)
    states = [ts.init_state(ts.SketchConfig(**GEOM), device="cpu")
              for _ in rings]
    for events, feats in _make_feed(6):
        for ring, state in zip(rings, states):
            assert ring.fold(state, events, **feats) is state
    got, want = (ts.state_tables(s) for s in states)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(carry.key_table_to_numpy(rings[0].key_table),
                                  carry.key_table_to_numpy(rings[1].key_table))
    for c in ("continuations", "dict_resets", "spill_rows", "chunks"):
        assert getattr(rings[0], c) == getattr(rings[1], c), c
    assert rings[0].kdict.count() == rings[1].kdict.count()
    if slot_cap == 150:
        assert rings[0].dict_resets > 0
    for r in rings:
        r.close()


def test_ring_and_exporter_take_the_packer_they_are_given(native):
    (events, feats), = _make_feed(1)
    for packer, kind in (("native", tfp.NativeKeyDict),
                         ("python", tfp.KeyDict)):
        kw = {} if packer == "native" else {"packer": packer}
        exp = TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                                  device="cpu", **kw)
        assert exp.ring is None  # a dense-only exporter builds no packer
        exp.fold_events(events, **feats)
        assert all(isinstance(kd, kind) for kd in exp.ring.kdicts)
        exp.close()
    with pytest.raises(ValueError, match="packer"):
        ResidentStagingRing(B, device="cpu", packer="rust")
    with pytest.raises(ValueError, match="packer"):
        TorchSketchExporter(ts.SketchConfig(**GEOM), batch_size=B,
                            device="cpu", packer="rust")


def _dense_compact_cases():
    """(name, events, feature lanes) of the dense and compact packers:
    every lane, short and absent lanes, v6 and drop rows, wrapping rtt and
    DNS latency, and an empty batch."""
    from tests.test_torch_resident import _events
    rng = np.random.default_rng(90)
    out = []
    ev, f = _events(rng, B - 3)
    out.append(("every_lane", ev, f))
    ev, f = _events(rng, B, drop_share=0.0)
    for side in ("src_ip", "dst_ip"):
        ev["key"][side][:, :10] = 0
        ev["key"][side][:, 10:12] = 0xFF
    ev["key"]["src_ip"][::12, 0] = 0x20  # v6 rows spill
    f["extra"]["rtt_ns"][::5] = ((1 << 32) + 3) * 1000  # u32 wrap
    f["dns"]["latency_ns"][1::5] = ((1 << 32) + 9) * 1000
    f["drops"]["bytes"][2::50] = 7  # drop rows spill
    out.append(("v4_with_spills", ev, f))
    ev, f = _events(rng, 100)
    out.append(("short_and_absent_lanes", ev,
                dict(f, extra=f["extra"][:40], dns=None, quic=f["quic"][:0])))
    ev, f = _events(rng, 0)
    out.append(("empty", ev, f))
    return out


@pytest.mark.parametrize("case", range(4))
def test_native_dense_and_compact_packers_equal_the_python_twins(native,
                                                                 case):
    name, ev, f = _dense_compact_cases()[case]
    out = np.full((B, tfp.DENSE_WORDS), 0xDEADBEEF, np.uint32)
    got = tfp.pack_dense(ev, B, out=out, **f)
    assert got is out
    np.testing.assert_array_equal(got, tfp.pack_dense(ev, B, native=False,
                                                      **f), err_msg=name)
    np.testing.assert_array_equal(got, jfp.pack_dense(ev, B, use_native=False,
                                                      **f), err_msg=name)
    for threads in (2, 3, 8):
        sharded = np.full_like(out, 0xDEADBEEF)
        tfp.pack_dense_sharded(ev, B, threads, out=sharded, **f)
        np.testing.assert_array_equal(sharded, got, err_msg=name)
    for spill_cap in (64, 8):
        buf = np.full(tfp.compact_buf_len(B, spill_cap), 0xDEADBEEF,
                      np.uint32)
        got = tfp.pack_compact(ev, B, spill_cap, out=buf, **f)
        twin = tfp.pack_compact(ev, B, spill_cap, native=False, **f)
        want = jfp.pack_compact(ev, B, spill_cap, use_native=False, **f)
        assert (got is None) == (twin is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got, twin, err_msg=name)
            np.testing.assert_array_equal(got, want, err_msg=name)
    if name == "v4_with_spills":
        assert tfp.pack_compact(ev, B, 8, **f) is None
        assert tfp.pack_compact(ev, B, 64, **f) is not None
    with pytest.raises(ValueError, match="exceed"):
        tfp.pack_dense(np.zeros(B + 1, tbin.FLOW_EVENT_DTYPE), B)
    with pytest.raises(ValueError, match="out"):
        tfp.pack_compact(ev, B, 64, out=np.zeros(7, np.uint32))
