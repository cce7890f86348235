"""The port's tiered counter planes (netobserv_tpu_torch/sketch/tiered.py,
kernels 6 and 7's plain twins in ops/kernels/countmin_kernel.py and
signal_kernel.py, the tiered branches of sketch/state.py, sketch/carry.py
and exporter/torch_sketch.py) against the JAX package's, on the CPU.

Geometry and schedule are the reference's own (tests/test_tiered.py):
`_interior_cfg` (d=2, W=512, HLL p=6, grids 32x16, K=16, EWMA m=32) under
the specs `u1` (mid 8, top 32, unit 1) and `u64` (mid 8, top 64, unit 64),
and `_boundary_batches`, whose folds cross base -> mid -> top while every
decoded cell plus its fold sum stays an integer below 2^24. Kernel 6's
twin is also held on the seeded contract cases of
`netobserv_tpu_torch/ops/kernels/cases.py` (d=4, W = 512 and 2048, the
default TierSpec), and kernel 7's on its own (m = 128 and 16,384, packed
banks of 64 and 4,096 registers).

Tolerance: bit-exact. Every table value here is an integer-valued f32
below 2^24 (masses, per-fold group sums, decoded cells, slot counts), so
no add order can change a bit, and the tier arithmetic (ceil, saturation,
the u32 saturating add) is exact. Tier arrays, packed banks, `est` and
every table of `state_tables` are compared with `assert_array_equal`
after the dtypes are checked. Two values lie outside that regime and are
not tier-covered: the window's byte total (`scalars[1]`; the u64 schedule
folds 96 rows of up to 400,000 bytes, past 2^24 in one fold), a sum of n
row values whose order XLA and torch choose differently, held to
2 * (n - 1) * 2^-24 relative with n the rows folded since the last reset;
and, after a roll, the EWMA baselines (mean, var: f32 pow/sqrt in two
libraries), which `state_tables` leaves out and the report check holds to
the tolerances of `tests/test_torch_state.py`."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.ops import countmin as jcm
from netobserv_tpu.ops import hashing as jhash
from netobserv_tpu.ops import hll as jhll
from netobserv_tpu.ops.pallas import countmin_kernel as jcmk
from netobserv_tpu.ops.pallas import signal_kernel as jsig
from netobserv_tpu.sketch import state as js
from netobserv_tpu.sketch import tiered as jt
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.ops.kernels import _build, cases
from netobserv_tpu_torch.ops.kernels import countmin_kernel as tcmk
from netobserv_tpu_torch.ops.kernels import signal_kernel as tsig
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered as tt
from tests.test_tiered import (
    INTERIOR_SPECS, SMALL_TIERS, _batch, _boundary_batches, _dev,
    _interior_cfg,
)
from tests.test_tiered_twin import fuzz_deltas, twin_decode, twin_plane_add
from tests.test_torch_state import (
    _assert_json_close, _assert_report_close, _assert_tables_equal,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MODES = {"reset": (True, None), "decay": (False, 0.5), "keep": (False, None)}


def _tspec(spec) -> tt.TierSpec:
    return tt.TierSpec(spec.mid_group, spec.top_group, spec.bytes_unit)


def _port_cfg(jcfg) -> ts.SketchConfig:
    fields = {f: getattr(jcfg, f) for f in ts.SketchConfig._fields
              if f != "tiered"}
    return ts.SketchConfig(**fields, tiered=(
        None if jcfg.tiered is None else _tspec(jcfg.tiered)))


def _to_port(batch) -> dict[str, torch.Tensor]:
    return ts.batch_to_device({k: np.array(v) for k, v in batch.items()},
                              CPU)


def _jax_flat(jstate) -> dict[str, np.ndarray]:
    """A JAX TieredState as carry's dotted paths ("tables.*", "rest.*")."""
    out = {}
    for prefix, tree in (("tables", jstate.tables), ("rest", jstate.rest)):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, v in leaves:
            out[prefix + "." + ".".join(p.name for p in path)] = \
                np.asarray(v)
    return out


def _assert_tiers_equal(port_state, jstate, where):
    got = carry.state_to_numpy(port_state)
    want = _jax_flat(jstate)
    assert got.keys() == want.keys()
    for k in carry.TIER_DTYPES:
        assert got[k].dtype == want[k].dtype, (k, where)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{k} {where}")


def _jax_tables(jstate):
    return {k: np.asarray(v) for k, v in js.state_tables(jstate).items()}


def _assert_state_tables(port_state, jstate, n_rows: int, where: str):
    """`state_tables` bit-exact, but for the byte total (scalars[1]) under
    the add-order bound of the module docstring."""
    got, want = ts.state_tables(port_state), _jax_tables(jstate)
    bound = 2 * (n_rows - 1) * 2.0 ** -24 * abs(float(want["scalars"][1]))
    assert abs(float(got["scalars"][1]) - float(want["scalars"][1])) \
        <= bound, where
    got["scalars"][1] = want["scalars"][1]
    _assert_tables_equal(got, want, where)


@functools.lru_cache(maxsize=None)
def _jax_ingest(use_pallas: bool):
    return jax.jit(lambda s, b: js.ingest(s, b, use_pallas=use_pallas))


@functools.lru_cache(maxsize=None)
def _jax_roll(jcfg, mode):
    reset, decay = MODES[mode]
    return jax.jit(lambda s: js.roll_window(s, jcfg, reset, decay))


@functools.lru_cache(maxsize=None)
def _jax_schedule(spec, use_pallas: bool, **kw):
    """JAX states after each fold of the boundary schedule."""
    jcfg = _interior_cfg(spec, **kw)
    s = js.init_state(jcfg)
    out = []
    for b in _boundary_batches(spec):
        s = _jax_ingest(use_pallas)(s, b)
        out.append(s)
    return out


# ------------------------------------------------------------ constants


def test_tier_constants_match_reference_twin_and_cuda_header():
    """One value of each tier constant in the JAX package, the numpy twin,
    the port and the CUDA header both kernels include."""
    import tests.test_tiered_twin as twin
    header = (ROOT / "netobserv_tpu_torch/csrc/tier_tiles.cuh").read_text()
    cuda = {name: int(v) for name, v in re.findall(
        r"constexpr\s+\w+\s+(BASE_MAX|MID_MAX|TOP_MAX)\s*=\s*(\d+)u?;",
        header)}
    assert cuda.keys() == {"BASE_MAX", "MID_MAX", "TOP_MAX"}
    for name in cuda:
        assert (getattr(tt, name) == getattr(jt, name) == getattr(twin, name)
                == cuda[name]), name
    assert tt.TierSpec() == _tspec(jt.TierSpec())
    assert tcmk.TILE_W == jcmk.TILE_W
    assert tsig.TILE_R == jsig.TILE_R


# ------------------------------------------------- planes and packed banks


@pytest.mark.parametrize("spec", INTERIOR_SPECS)
def test_plane_functions_fuzz_bit_exact(spec):
    """encode/plane_add/decay/decode over the twin's boundary-biased fuzz
    and random boundary-straddling deltas: the port equals the JAX package
    and the numpy oracle of tests/test_tiered_twin.py, fold by fold."""
    unit = spec.bytes_unit
    sp = _tspec(spec)
    rng = np.random.default_rng(7)
    d, w = 2, 256
    jp = jt.init_plane(d, w, spec)
    tp = tt.init_plane(d, w, sp, CPU)
    twin = tuple(np.asarray(x) for x in jp)
    for fold in range(8):
        delta = fuzz_deltas(fold, d, w, unit)
        if fold % 2:
            delta = (rng.integers(0, 300, (d, w)) * unit).astype(np.float32)
        jp = jt.plane_add(jp, jnp.asarray(delta), spec, unit)
        tp = tt.plane_add(tp, torch.from_numpy(delta), sp, unit)
        twin = twin_plane_add(twin, delta, spec, unit)
        for name, j, t, o in zip(tt.TieredPlane._fields, jp, tp, twin):
            assert t.numpy().dtype == np.asarray(j).dtype == o.dtype, name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{name} fold {fold}")
            np.testing.assert_array_equal(t.numpy(), o, err_msg=name)
        dec = tt.decode_plane(tp, sp, unit).numpy()
        np.testing.assert_array_equal(
            dec, np.asarray(jt.decode_plane(jp, spec, unit)))
        np.testing.assert_array_equal(dec, twin_decode(twin, spec, unit))
    assert (tp.base.numpy() == tt.BASE_MAX).any()
    assert (tp.mid.numpy() == tt.MID_MAX).any()
    assert (tp.top.numpy() > 0).any()
    for factor in (0.5, 0.3, 0.0):
        for j, t in zip(jt.decay_plane(jp, factor),
                        tt.decay_plane(tp, factor)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    wide = (rng.random((d, w)) * rng.choice([10.0, 1e5, 3e9], (d, w))
            ).astype(np.float32)
    for j, t in zip(jt.encode_plane(jnp.asarray(wide), spec, unit),
                    tt.encode_plane(torch.from_numpy(wide), sp, unit)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_top_tier_saturates_and_stays_clamped():
    """A spill past 2^32 units clamps at TOP_MAX before the cast, and the
    cell stays there, as the reference's u32 saturating add does."""
    sp, spec = _tspec(SMALL_TIERS), SMALL_TIERS
    delta = np.zeros((1, 32), np.float32)
    delta[0, 5] = 2.0 ** 33
    jp, tp = jt.init_plane(1, 32, spec), tt.init_plane(1, 32, sp, CPU)
    for _ in range(3):
        jp = jt.plane_add(jp, jnp.asarray(delta), spec, 1)
        tp = tt.plane_add(tp, torch.from_numpy(delta), sp, 1)
        for j, t in zip(jp, tp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(tp.top[0, 0]) == tt.TOP_MAX


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_pack_unpack_hll_bit_exact(lead):
    rng = np.random.default_rng(len(lead))
    regs = rng.integers(0, 34, (*lead, 256)).astype(np.int32)
    packed = tt.pack_hll(torch.from_numpy(regs))
    want = np.asarray(jt.pack_hll(jnp.asarray(regs)))
    assert packed.dtype == torch.uint8 and packed.numpy().dtype == want.dtype
    np.testing.assert_array_equal(packed.numpy(), want)
    back = tt.unpack_hll(packed)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), regs)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jt.unpack_hll(jnp.asarray(want))))


# ------------------------------------------------------------- kernel twins


@pytest.mark.parametrize("spec", INTERIOR_SPECS)
def test_kernel6_twin_matches_pallas_interpret(spec):
    """Kernel 6's twin against `countmin_kernel.update_two_tiered` in
    interpret mode, fold by fold over the boundary schedule (one in three
    rows invalid): tier arrays and est bit-exact."""
    sp = _tspec(spec)
    fold = jax.jit(lambda a, b, h1, h2, va, vb, v: jcmk.update_two_tiered(
        a, b, h1, h2, va, vb, v, spec, interpret=True))
    ja, jb = jt.init_plane(2, 512, spec), jt.init_plane(2, 512, spec)
    ta, tb = tt.init_plane(2, 512, sp, CPU), tt.init_plane(2, 512, sp, CPU)
    for i, b in enumerate(_boundary_batches(spec)):
        mh = jhash.base_hashes_multi(b["keys"])
        valid = np.arange(96) % 3 != i % 3
        vb_raw = np.asarray(b["packets"]).astype(np.float32)
        ja, jb, jest = fold(ja, jb, mh.h1, mh.h2, b["bytes"],
                            jnp.asarray(vb_raw), jnp.asarray(valid))
        h1, h2 = (torch.from_numpy(np.asarray(h).astype(np.int64))
                  for h in (mh.h1, mh.h2))
        tv = torch.from_numpy(valid)
        est = tcmk.update_two_tiered(
            ta, tb, h1, h2,
            torch.where(tv, torch.from_numpy(np.array(b["bytes"])), 0.0),
            torch.where(tv, torch.from_numpy(vb_raw), 0.0), sp)
        np.testing.assert_array_equal(est.numpy(), np.asarray(jest),
                                      err_msg=f"est fold {i}")
        for name, j, t in zip(("a.base", "a.mid", "a.top", "b.base",
                               "b.mid", "b.top"), (*ja, *jb), (*ta, *tb)):
            assert t.numpy().dtype == np.asarray(j).dtype, name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{name} fold {i}")
    assert (ta.base.numpy() == tt.BASE_MAX).any()
    assert (ta.mid.numpy() == tt.MID_MAX).any()
    assert (ta.top.numpy() > 0).any()


CM_CASE_NAMES = [name for name, _ in cases.countmin_cases(512)]


def _jax_tier2_scatter(ja, jb, h1, h2, va, vb, spec):
    """Kernel 6's function in the JAX package's scatter form: decode both
    planes, `countmin.update_two`, `plane_add` of the delta, and the min
    over rows of the post-fold bytes view at each record's columns."""
    d, w = ja.base.shape
    dec = [jt.decode_plane(p, spec, u)
           for p, u in ((ja, spec.bytes_unit), (jb, 1))]
    na, nb = jcm.update_two(jcm.CountMin(dec[0]), jcm.CountMin(dec[1]), h1,
                            h2, va, vb, jnp.ones(va.shape[0], bool))
    idx = jhash.row_indices(h1, h2, d, w)
    est = jnp.take_along_axis(na.counts, idx.astype(jnp.int32), 1).min(
        axis=0)
    return (jt.plane_add(ja, na.counts - dec[0], spec, spec.bytes_unit),
            jt.plane_add(jb, nb.counts - dec[1], spec, 1), est)


@pytest.mark.parametrize("w", [512, 2048])
@pytest.mark.parametrize("name", CM_CASE_NAMES)
def test_kernel6_twin_bit_exact_vs_jax_on_contract_cases(name, w):
    """Kernel 6's twin (the wrapper on CPU tensors) on the contract cases of
    cases.py, at the default TierSpec (unit 256) onto pre-fold tiers with
    saturated bases, against the JAX scatter form and, for B > 0,
    `update_two_tiered` in interpret mode (whose chunk walk cannot take an
    empty batch): tier arrays and est bit-exact."""
    spec = jt.TierSpec()
    c = dict(cases.countmin_cases(w))[name]
    planes = cases.tier_planes(4, w, spec.mid_group, spec.top_group)
    ta, tb = (tt.TieredPlane(*(torch.from_numpy(x.copy()) for x in p))
              for p in planes)
    est = tcmk.update_two_tiered(
        ta, tb, *(torch.from_numpy(c[f]) for f in ("h1", "h2", "va", "vb")),
        _tspec(spec))
    ja, jb = (jt.TieredPlane(*(jnp.asarray(x) for x in p)) for p in planes)
    h1, h2 = (jnp.asarray(c[f].astype(np.uint32)) for f in ("h1", "h2"))
    va, vb = jnp.asarray(c["va"]), jnp.asarray(c["vb"])
    refs = [_jax_tier2_scatter(ja, jb, h1, h2, va, vb, spec)]
    if len(c["va"]):
        refs.append(jcmk.update_two_tiered(
            ja, jb, h1, h2, va, vb, jnp.ones(len(c["va"]), bool), spec,
            interpret=True))
    top = float(jt.decode_plane(refs[0][0], spec, spec.bytes_unit).max())
    assert top < 2 ** 24
    for ra, rb, rest in refs:
        np.testing.assert_array_equal(est.numpy(), np.asarray(rest))
        for field, t, j in zip(("a.base", "a.mid", "a.top", "b.base",
                                "b.mid", "b.top"), (*ta, *tb), (*ra, *rb)):
            assert t.numpy().dtype == np.asarray(j).dtype, field
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"{name}: {field}")
    if name == "every_row_one_key":
        assert (ta.mid.numpy() != planes[0][1]).any()  # the cascade moved


@pytest.mark.parametrize("m_hll", [64, 4096])
def test_kernel7_twin_matches_pallas_interpret(m_hll):
    """Kernel 7's twin against `signal_kernel.update_tiered` in interpret
    mode on integer masses (one tile of 16 triples at m = 64, two tiles of
    512 at m = 4096): packed bank and all eight signal tables bit-exact,
    invalid rows a no-op."""
    rng = np.random.default_rng(m_hll)
    m, n = 128, 1500
    tables = [rng.integers(0, 1000, m).astype(np.float32) for _ in range(6)]
    tables += [rng.integers(0, 1000, k).astype(np.float32)
               for k in (ts.N_DSCP, ts.N_DROP_CAUSES)]
    regs = rng.integers(0, 20, m_hll).astype(np.int32)
    packed = np.asarray(jt.pack_hll(jnp.asarray(regs)))
    idx = np.stack([rng.integers(0, k, n) for k in
                    (m, m, m, ts.N_DSCP, ts.N_DROP_CAUSES)]).astype(np.int32)
    vals = (rng.integers(0, 9000, (8, n)) * (rng.random((8, n)) < 0.7)
            ).astype(np.float32)
    keys = rng.integers(0, 2**32, (n, 10), dtype=np.uint32)
    mh = jhash.base_hashes_multi(jnp.asarray(keys))
    src_h1 = np.array(mh.src_h1)
    src_h2 = np.array(mh.src_h2)
    src_h2[:40] = 0  # rank 33
    valid = rng.random(n) < 0.8
    hll_idx = (src_h1 & np.uint32(m_hll - 1)).astype(np.int32)
    hll_rank = np.where(valid, np.asarray(jhll._rank(jnp.asarray(src_h2))),
                        0).astype(np.int32)
    jplanes, jpacked = jsig.update_tiered(
        jsig.SignalPlanes(*map(jnp.asarray, tables)), jnp.asarray(packed),
        jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(hll_idx),
        jnp.asarray(hll_rank), interpret=True)
    tplanes = tsig.SignalPlanes(*(torch.from_numpy(t.copy())
                                  for t in tables))
    tpacked = torch.from_numpy(packed.copy())
    tsig.update_tiered(tplanes, tpacked, torch.from_numpy(idx).long(),
                       torch.from_numpy(vals),
                       torch.from_numpy(src_h1.astype(np.int64)),
                       torch.from_numpy(src_h2.astype(np.int64)),
                       torch.from_numpy(valid))
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked))
    assert (tpacked.numpy() != packed).any()
    for name, t, j in zip(tsig.SignalPlanes._fields, tplanes, jplanes):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert tsig.hll_fusible(m_hll)


KERNEL7_M_HLL = (64, 4096)
K7_CASE_NAMES = [name for name, _ in cases.tiered_signal_cases(128, 64)]


def _jax_tiered_scatter(planes, packed, idx, vals, h1, h2, valid):
    """Kernel 7's function in the JAX package's scatter form: the signal
    tables' scatter chain, and the bank unpacked, `hll.update` and packed
    back."""
    out = [t.at[idx[tsig.FAMILY[j]]].add(vals[j], mode="drop")
           for j, t in enumerate(planes)]
    regs = jhll.update(jhll.HLL(jt.unpack_hll(packed)), h1, h2, valid).regs
    return jsig.SignalPlanes(*out), jt.pack_hll(regs)


@pytest.mark.parametrize("m_hll", KERNEL7_M_HLL)
@pytest.mark.parametrize("name", K7_CASE_NAMES)
def test_kernel7_twin_bit_exact_vs_jax_on_contract_cases(name, m_hll):
    """Kernel 7's twin (the wrapper on CPU tensors) on its contract cases
    (cases.py) onto tables of small integers and a packed bank of small
    ranks, against the JAX scatter form and, for B > 0,
    `signal_kernel.update_tiered` in interpret mode (whose chunk walk
    cannot take an empty batch): packed bank and all eight tables
    bit-exact."""
    c = dict(cases.tiered_signal_cases(128, m_hll))[name]
    rng = np.random.default_rng(11)
    sizes = (c["m"],) * 6 + (ts.N_DSCP, ts.N_DROP_CAUSES)
    start = [rng.integers(0, 50, k).astype(np.float32) for k in sizes]
    packed = np.asarray(jt.pack_hll(jnp.asarray(c["regs"])))
    tplanes = tsig.SignalPlanes(*(torch.from_numpy(t.copy()) for t in start))
    tpacked = torch.from_numpy(packed.copy())
    tsig.update_tiered(tplanes, tpacked, *(torch.from_numpy(c[f]) for f in
                                           ("idx", "vals", "h1", "h2",
                                            "valid")))
    jplanes = jsig.SignalPlanes(*map(jnp.asarray, start))
    idx, vals = jnp.asarray(c["idx"].astype(np.int32)), jnp.asarray(c["vals"])
    h1, h2 = (jnp.asarray(c[f].astype(np.uint32)) for f in ("h1", "h2"))
    valid = jnp.asarray(c["valid"])
    refs = [_jax_tiered_scatter(jplanes, jnp.asarray(packed), idx, vals, h1,
                                h2, valid)]
    if len(c["valid"]):
        rank = jnp.where(valid, jhll._rank(h2), 0)
        refs.append(jsig.update_tiered(
            jplanes, jnp.asarray(packed), idx, vals,
            (h1 & np.uint32(m_hll - 1)).astype(jnp.int32), rank,
            interpret=True))
    for rplanes, rpacked in refs:
        np.testing.assert_array_equal(tpacked.numpy(), np.asarray(rpacked),
                                      err_msg=f"{name}: packed bank")
        for field, t, r in zip(tsig.SignalPlanes._fields, tplanes, rplanes):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r),
                                          err_msg=f"{name}: {field}")
    assert max(float(t.max()) for t in tplanes) < 2 ** 24
    regs = tt.unpack_hll(tpacked).numpy()
    if name == "all_rows_invalid":
        np.testing.assert_array_equal(regs, c["regs"])
    elif name == "h2_zero_rank_33":
        assert regs.max() == 33
    elif name == "every_valid_row_one_register":
        hot = m_hll // 2 + 3
        assert (regs != c["regs"]).sum() == (regs[hot] != c["regs"][hot])
    if len(c["valid"]) > 1 and name != "all_rows_invalid":
        assert (regs != c["regs"]).any()


def test_kernel7_wrapper_has_no_table_width_bound(monkeypatch):
    """On a CUDA tensor, `update_tiered` launches at any table width: at
    m = 16,384, past the 9,600 buckets where kernel 7's first design ran
    out of shared memory, it makes one launch of the shape
    `launch_shape_tiered` states, whose shared memory is the HLL tile's
    alone; an empty batch makes none."""
    seen = []
    monkeypatch.setattr(tsig, "on_cuda", lambda t: True)
    monkeypatch.setattr(tsig, "check", lambda *a: None)
    monkeypatch.setattr(tsig.KERNEL_TIERED, "launch",
                        lambda ptrs, ints, dev: seen.append((ptrs, ints)))
    c = dict(cases.tiered_signal_cases(128, 4096))["table_width_16384"]
    planes = tsig.SignalPlanes(*(torch.zeros(k) for k in (
        (16384,) * 6 + (ts.N_DSCP, ts.N_DROP_CAUSES))))
    packed = torch.zeros(3072, dtype=torch.uint8)
    args = [torch.from_numpy(c[f]) for f in ("idx", "vals", "h1", "h2",
                                             "valid")]
    tsig.update_tiered(planes, packed, *args)
    (ptrs, ints), = seen
    n = c["vals"].shape[1]
    assert len(ptrs) == 14 and all(p is t for p, t in zip(
        ptrs, [*planes, *args[:2], packed, *args[2:]]))
    assert ints == [n, 16384, ts.N_DSCP, ts.N_DROP_CAUSES, 3072]
    shape = tsig.launch_shape_tiered(n, 3072)
    assert shape.smem == 4 * tsig.TILE_R * 4
    assert shape.clusters == 2 + -(-n // tsig.TIERED_THREADS)
    tsig.update_tiered(planes, packed, *(a[..., :0] for a in args))
    assert len(seen) == 1


# ------------------------------------------------------ the slice as a whole


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("spec", INTERIOR_SPECS)
def test_tiered_slice_matches_jax_interior_and_scatter(spec, mode):
    """Port tiered ingest (interior form, the kernels' twins) over the
    boundary schedule, one roll in `mode`, then one more fold: tier arrays
    (through carry) and state_tables bit-exact against the JAX package's
    interior form (Pallas in interpret mode) and its scatter form after
    every fold and after the roll; the roll's report within the
    tolerances of tests/test_torch_state.py."""
    jcfg = _interior_cfg(spec)
    tcfg = _port_cfg(jcfg)
    assert ts.tiered_fold_form(tcfg) == "interior"
    batches = _boundary_batches(spec)
    forms = {"interior": _jax_schedule(spec, True),
             "scatter": _jax_schedule(spec, False)}
    state = ts.init_state(tcfg, device="cpu")
    n = len(batches[0]["valid"])
    for i, b in enumerate(batches):
        ts.ingest(state, _to_port(b))
        for form, jstates in forms.items():
            _assert_tiers_equal(state, jstates[i], f"{form} fold {i}")
            _assert_state_tables(state, jstates[i], n * (i + 1),
                                 f"{form} fold {i}")
    t = state.tables.cm_bytes
    assert (t.base.numpy() == tt.BASE_MAX).any()
    assert (t.mid.numpy() == tt.MID_MAX).any()
    assert (t.top.numpy() > 0).any()
    reset, decay = MODES[mode]
    _, trep = ts.roll_window(state, tcfg, reset, decay)
    jstate, jrep = _jax_roll(jcfg, mode)(forms["scatter"][-1])
    _assert_report_close(trep, jrep, 2 ** jcfg.hll_precision)
    _assert_tiers_equal(state, jstate, f"after {mode} roll")
    _assert_state_tables(state, jstate, n * len(batches),
                         f"after {mode} roll")
    if mode == "keep":
        want = _jax_flat(forms["scatter"][-1])
        for k in carry.TIER_DTYPES:
            np.testing.assert_array_equal(
                carry.state_to_numpy(state)[k], want[k], err_msg=k)
    else:
        assert not state.tables.hll_src.any()
    jstate = _jax_ingest(False)(jstate, batches[0])
    ts.ingest(state, _to_port(batches[0]))
    _assert_tiers_equal(state, jstate, f"fold after {mode} roll")
    _assert_state_tables(state, jstate, n * (len(batches) + 1),
                         f"fold after {mode} roll")


@pytest.mark.parametrize("spec", INTERIOR_SPECS)
def test_decay_state_matches_jax(spec):
    """`decay_state` on a tiered state, after the boundary schedule: the
    tiers scale elementwise (saturated cells stay), the HLL banks reset,
    and the decayed tables equal the JAX package's."""
    jcfg = _interior_cfg(spec)
    state = ts.init_state(_port_cfg(jcfg), device="cpu")
    batches = _boundary_batches(spec)
    for b in batches:
        ts.ingest(state, _to_port(b))
    jstate = jax.jit(lambda s: js.decay_state(s, 0.5))(
        _jax_schedule(spec, False)[-1])
    assert ts.decay_state(state, 0.5) is state
    _assert_tiers_equal(state, jstate, "decay_state")
    _assert_state_tables(state, jstate, 96 * len(batches), "decay_state")
    assert (state.tables.cm_bytes.base.numpy() == tt.BASE_MAX).any()
    assert not state.tables.hll_per_dst.any()


def test_fused_hll_lane_matches_jax(monkeypatch):
    """EWMA m = 128 makes the signal planes eligible, so the interior fold
    folds the packed global-src bank in kernel 7 (its twin here), on both
    sides; m = 32 declines and the bank unpacks for kernel 3. Both stay
    bit-exact against the JAX interior and scatter forms."""
    spec = INTERIOR_SPECS[1].values[0]
    calls = []
    orig = tsig.update_tiered
    monkeypatch.setattr(tsig, "update_tiered",
                        lambda *a: (calls.append(1), orig(*a))[1])
    for ewma, fused in ((128, True), (32, False)):
        jcfg = _interior_cfg(spec, ewma_buckets=ewma)
        calls.clear()
        state = ts.init_state(_port_cfg(jcfg), device="cpu")
        ji, jsct = js.init_state(jcfg), js.init_state(jcfg)
        for i in range(2):
            b = _dev(_batch(96, seed=i, max_bytes=2_000_000))
            ji = _jax_ingest(True)(ji, b)
            jsct = _jax_ingest(False)(jsct, b)
            ts.ingest(state, _to_port(b))
        assert bool(calls) == fused, ewma
        for jstate in (ji, jsct):
            _assert_tiers_equal(state, jstate, f"ewma {ewma}")
            _assert_state_tables(state, jstate, 2 * 96, f"ewma {ewma}")


def test_decode_form_on_an_ineligible_width_matches_jax():
    """W = 256 fails the interior gate: the port decodes, folds wide and
    promotes, and agrees bit for bit with the JAX package (whose gate
    declines too)."""
    jcfg = _interior_cfg(SMALL_TIERS, cm_width=256)
    tcfg = _port_cfg(jcfg)
    assert ts.tiered_fold_form(tcfg) == "decode"
    assert js.tiered_fold_form(jcfg._replace(use_pallas=True)) == "decode"
    state = ts.init_state(tcfg, device="cpu")
    jstate = js.init_state(jcfg)
    for i, b in enumerate(_boundary_batches(SMALL_TIERS, folds=3)):
        jstate = _jax_ingest(False)(jstate, b)
        ts.ingest(state, _to_port(b))
        _assert_tiers_equal(state, jstate, "decode form")
        _assert_state_tables(state, jstate, 96 * (i + 1), "decode form")
    assert (state.tables.cm_bytes.mid.numpy() > 0).any()


def test_decode_form_past_the_tile_bound_matches_jax():
    """A narrow width at the least depth whose kernel-6 tile passes one
    block's shared memory (`tier2_fits`) takes the decode form, as the
    gate sends every shape the CUDA wrapper would refuse, and agrees bit
    for bit with the JAX package, whose own gate has no such bound."""
    depth = next(d for d in range(1, 64)
                 if not tcmk.tier2_fits(d, 512, SMALL_TIERS))
    assert tcmk.tier2_fits(depth - 1, 512, SMALL_TIERS)
    jcfg = _interior_cfg(SMALL_TIERS, cm_depth=depth)
    tcfg = _port_cfg(jcfg)
    assert ts.tiered_fold_form(tcfg) == "decode"
    assert js.tiered_fold_form(jcfg._replace(use_pallas=True)) == "interior"
    state = ts.init_state(tcfg, device="cpu")
    jstate = js.init_state(jcfg)
    for i, b in enumerate(_boundary_batches(SMALL_TIERS, folds=3)):
        jstate = _jax_ingest(False)(jstate, b)
        ts.ingest(state, _to_port(b))
        _assert_tiers_equal(state, jstate, f"depth {depth}")
        _assert_state_tables(state, jstate, 96 * (i + 1), f"depth {depth}")
    assert (state.tables.cm_bytes.mid.numpy() > 0).any()


@pytest.mark.parametrize("w", [512, 65536, 1 << 23, 1 << 24])
@pytest.mark.parametrize("spec", [
    tt.TierSpec(), tt.TierSpec(mid_group=2, top_group=4, bytes_unit=1),
    tt.TierSpec(mid_group=8, top_group=32, bytes_unit=1)],
    ids=["default", "m2_t4", "m8_t32"])
def test_tier2_fits_agrees_with_the_wrapper(monkeypatch, spec, w):
    """Over depths 1-40 at width w: kernel 6's CUDA wrapper raises exactly
    where `tier2_fits` fails, with the message of the limit it passes (the
    tensors are stand-ins of the right shapes, the launch recorded)."""
    seen = []
    monkeypatch.setattr(tcmk, "on_cuda", lambda t: True)
    monkeypatch.setattr(tcmk, "check", lambda *a: None)
    monkeypatch.setattr(tcmk.KERNEL_TIER2, "launch",
                        lambda ptrs, ints, dev: seen.append(ints))
    h = torch.zeros(4, dtype=torch.int64)
    v = torch.zeros(4)
    fits = []
    for d in range(1, 41):
        plane = tt.TieredPlane(*(torch.zeros(1, dtype=dt).expand(d, w // g)
                                 for dt, g in ((torch.uint8, 1),
                                               (torch.uint16, spec.mid_group),
                                               (torch.uint32, spec.top_group))))
        ok = tcmk.tier2_fits(d, w, spec)
        fits.append(ok)
        if ok:
            tcmk.update_two_tiered(plane, plane, h, h, v, v, spec)
            assert seen[-1][:3] == [4, d, w]
            continue
        tile = tcmk.tier2_smem(d, spec.mid_group, spec.top_group) \
            > _build.SMEM_LIMIT
        with pytest.raises(ValueError, match="a tile does not fit" if tile
                           else "per-tile tables do not fit"):
            tcmk.update_two_tiered(plane, plane, h, h, v, v, spec)
    assert len(seen) == sum(fits)
    if w < 1 << 24:
        assert fits[0] and not fits[-1]  # the depth bound lies in the grid
    else:
        assert not any(fits)  # the width bound, at every depth


def test_tiered_fold_form_gate():
    """The static gate, as tests/test_tiered.py pins it for the reference,
    but on the port's device rule: interior wherever the width tiles, a
    tile holds whole top groups and kernel 6 can launch at the depth and
    width (`tier2_fits`), on CUDA and the CPU alike."""
    cfg = _port_cfg(_interior_cfg(SMALL_TIERS))
    assert ts.tiered_fold_form(ts.SketchConfig()) is None
    assert ts.tiered_fold_form(cfg) == "interior"
    assert ts.tiered_fold_form(cfg._replace(cm_width=256)) == "decode"
    wide_top = tt.TierSpec(mid_group=8, top_group=1024, bytes_unit=1)
    assert ts.tiered_fold_form(cfg._replace(cm_width=2048,
                                            tiered=wide_top)) == "decode"
    assert ts.tiered_fold_form(ts.SketchConfig(tiered=tt.TierSpec())) \
        == "interior"
    assert tcmk.tier2_smem(25, 32, 256) > _build.SMEM_LIMIT
    assert ts.tiered_fold_form(ts.SketchConfig(cm_depth=25,
                                               tiered=tt.TierSpec())) \
        == "decode"
    assert ts.tiered_fold_form(ts.SketchConfig(cm_depth=24,
                                               tiered=tt.TierSpec())) \
        == "interior"
    assert ts.tiered_fold_form(ts.SketchConfig(cm_width=1 << 24,
                                               tiered=tt.TierSpec())) \
        == "decode"
    assert ts.tiered_fold_form(ts.SketchConfig(ewma_buckets=16384,
                                               tiered=tt.TierSpec())) \
        == "interior"
    with pytest.raises(ValueError, match="ineligible"):
        state = ts.init_state(cfg._replace(cm_width=256), device="cpu")
        z = torch.zeros(4, dtype=torch.int64)
        tcmk.update_two_tiered(state.tables.cm_bytes, state.tables.cm_pkts,
                               z, z, z.float(), z.float(), state.spec)
    with pytest.raises(ValueError, match="power of two"):
        ts.init_state(cfg._replace(tiered=tt.TierSpec(mid_group=6)),
                      device="cpu")
    with pytest.raises(NotImplementedError):
        ts.ingest(ts.init_state(cfg, device="cpu"),
                  _to_port(_batch(8)), sketch_shard=(0, 2))


def test_carry_round_trip_of_a_jax_tiered_state_then_fold():
    """A JAX TieredState carried across by dotted path with its spec (tier
    arrays keep uint8/uint16/uint32), back out unchanged, and one more
    fold on each side agrees."""
    spec = INTERIOR_SPECS[1].values[0]
    jstate = _jax_schedule(spec, False)[2]
    flat = _jax_flat(jstate)
    state = carry.state_from_numpy(flat, device="cpu", spec=_tspec(spec))
    assert isinstance(state, tt.TieredState)
    assert state.tables.cm_bytes.mid.dtype == torch.uint16
    assert state.tables.cm_bytes.top.dtype == torch.uint32
    back = carry.state_to_numpy(state)
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    b = _boundary_batches(spec)[3]
    jstate = _jax_ingest(True)(jstate, b)
    ts.ingest(state, _to_port(b))
    _assert_tiers_equal(state, jstate, "carried")
    bad = dict(flat)
    bad["tables.cm_bytes.mid"] = flat["tables.cm_bytes.mid"].astype(np.int32)
    with pytest.raises(TypeError, match="uint16"):
        carry.state_from_numpy(bad, device="cpu", spec=_tspec(spec))


def test_exporter_tiered_dense_path_matches_jax():
    """TorchSketchExporter with a tiered config on the bench traffic at the
    small geometry of tests/test_torch_state.py (the signal planes and the
    HLL are eligible, so kernels 6 and 7's twins both run): state tables
    bit-exact against the JAX package's tiered scatter form before each
    roll, the rendered reports within that file's tolerances, and the
    resident bytes those of the narrow arrays."""
    from netobserv_tpu.exporter import tpu_sketch as jexp
    from tests.test_torch_state import GEOM, _pool
    jcfg = js.SketchConfig(**GEOM, tiered=jt.TierSpec())
    tcfg = ts.SketchConfig(**GEOM, tiered=tt.TierSpec())
    assert ts.tiered_fold_form(tcfg) == "interior"
    _, pool = _pool(seed=6, n_batches=2, sampling_max=3)
    exp = TorchSketchExporter(tcfg, batch_size=2048, device="cpu")
    jing = jax.jit(lambda s, d: js.ingest(s, js.dense_to_arrays(d),
                                          use_pallas=False))
    jroll = jax.jit(lambda s: js.roll_window(s, jcfg))
    jstate, jprev = js.init_state(jcfg), None
    for w in range(2):
        for dense in traffic.dense_pool(pool):
            jstate = jing(jstate, jnp.asarray(dense))
            exp.fold_dense(dense)
        _assert_tables_equal(exp.state_tables(), _jax_tables(jstate),
                             f"window {w}")
        _assert_tiers_equal(exp.state, jstate, f"window {w}")
        jstate, jrep = jroll(jstate)
        got = exp.roll()
        # the publish stamps the reference's TimestampMs
        assert isinstance(got.pop("TimestampMs"), int)
        _assert_json_close(got, jexp.report_to_json(
            jrep, prev_heavy_index=jprev))
        jprev = jexp.heavy_identity_index(jrep)
    got = exp.counter_table_bytes()
    assert got == jt.counter_table_bytes(jstate)
    wide = tt.counter_table_bytes(ts.init_state(tcfg._replace(tiered=None),
                                                device="cpu"))
    assert sum(wide.values()) > 4 * sum(got.values())
    exp.close()
