"""The port's multi-host tier (netobserv_tpu_torch/parallel/distributed.py
and the multi-process paths of parallel/, sketch/staging.py,
sketch/checkpoint.py, the exporter and the aggregator) on the CPU.

(i) The environment contract of `maybe_initialize_distributed`, held
against the reference's on the same environments without initialising
anything: the reference's `jax.distributed.initialize` and the port's
process group are stand-ins that record the call.

(ii) Two real processes (tests/torch_distributed_worker.py) join one gloo
group on 127.0.0.1 and run the sharded dense and resident ingests and two
rolls of a mesh that spans them: 2x2 with two CPU devices a rank, 2x1 and
1x2 (the sketch axis across the ranks) with one. Each rank's `dist_tables` before and after every roll, its merged
report and its merged pre-roll tables are held against the JAX package's
single-process `parallel.merge` at the same shape on the first devices of
tests/conftest.py's 8 virtual CPU devices, with tests/test_torch_mesh.py's
comparisons (integer masses, so every table, sum and register bit for
bit; the EWMA baselines and the report's estimates to that file's
bounds), and the two ranks against each other bit for bit.

(iii) The exporter and the aggregator in two processes (the aggregator
reading the FEDERATION_ variables), windows closed by call, against a
one-process mesh of the same shape in this process: the reports (as
tests/test_torch_query_plane.py holds reports), the tables and the
aggregator's acks, ledgers and snapshots; the query refresh turned off
with the reference's warning; the two-rank checkpoint files byte-equal to
the one-process mesh's, restored, and refused on both ranks by a mesh of
another shape before any tensor is written; an aggregator checkpoint
directory of a refused format refused on both ranks, moved aside by rank
0 alone, with checkpoints going on into a fresh one.

Every case's two children have their own free port and 120 s between
them, and are killed when the case fails or hangs.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax

from netobserv_tpu.datapath import flowpack as jfp
from netobserv_tpu.parallel import MeshSpec as JMeshSpec
from netobserv_tpu.parallel import distributed as jdistributed
from netobserv_tpu.parallel import make_mesh as jmake_mesh
from netobserv_tpu.parallel import merge as jm
from netobserv_tpu_torch.datapath import flowpack as tfp
from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.federation.aggregator import FederationAggregator
from netobserv_tpu_torch.parallel import distributed as tdist
from netobserv_tpu_torch.parallel import merge as tm
from netobserv_tpu_torch.sketch import state as ts
from tests.test_parallel import make_arrays
from tests.test_torch_federation import (
    GAMMA as FED_GAMMA, TCFG as FED_TCFG, _schedule,
)
from tests.test_torch_mesh import (
    EWMA_FLOAT, JCFG, TCFG, _jax_flat, _report_close,
)
from tests.test_torch_query_plane import _assert_report
from tests.test_torch_staging import B, GEOM, _feed

WORKER = Path(__file__).with_name("torch_distributed_worker.py")
TIMEOUT_S = 120
GAMMA = ts.quantile.gamma_for(GEOM["hist_buckets"])
ENV_KEYS = ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID")


# ------------------------------------------------ (i) environment contract


class _FakeGroup:
    """The port's process group, recorded: `init_process_group` counts its
    calls and keeps its arguments; the group is then initialised."""

    def __init__(self):
        self.calls: list = []

    def is_initialized(self):
        return bool(self.calls)

    def init_process_group(self, backend, init_method, world_size, rank):
        self.calls.append((backend, init_method, world_size, rank))


@pytest.fixture
def contract(monkeypatch):
    """Both packages' `maybe_initialize_distributed` with their inits
    recorded, on an environment with no SKETCH_/FEDERATION_ setting."""
    for p in ("SKETCH_", "FEDERATION_"):
        for k in ENV_KEYS:
            monkeypatch.delenv(p + k, raising=False)
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    jcalls: list = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: jcalls.append(kw))
    group = _FakeGroup()
    monkeypatch.setattr(tdist, "dist", group)
    monkeypatch.setattr(tdist, "all_gather_object", lambda obj: [obj])

    def both(env: dict, prefixes=("SKETCH_",)):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        try:
            want = jdistributed.maybe_initialize_distributed(prefixes)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                tdist.maybe_initialize_distributed(prefixes,
                                                   devices=["cpu"])
            assert str(got.value) == str(exc)
            assert not group.calls
            return None
        got = tdist.maybe_initialize_distributed(prefixes, devices=["cpu"])
        assert got is want
        if not want:
            assert not jcalls and not group.calls
            return None
        (kw,), (call,) = jcalls, group.calls
        assert call == ("gloo", "tcp://" + kw["coordinator_address"],
                        kw["num_processes"], kw["process_id"])
        return call

    both.group = group
    return both


def _env(prefix: str, coord="127.0.0.1:7000", n="2", pid="1") -> dict:
    out = {}
    for k, v in zip(ENV_KEYS, (coord, n, pid)):
        if v is not None:
            out[prefix + k] = v
    return out


def test_no_configuration_is_a_no_op(contract):
    assert contract({}) is None
    assert contract({}, ("FEDERATION_", "SKETCH_")) is None


def test_the_agent_reads_its_own_prefix(contract):
    call = contract(_env("SKETCH_", "10.0.0.1:9", "4", "3"))
    assert call == ("gloo", "tcp://10.0.0.1:9", 4, 3)


def test_an_agent_ignores_the_federation_variables(contract):
    assert contract(_env("FEDERATION_")) is None


def test_the_first_prefix_with_a_coordinator_wins(contract):
    env = {**_env("FEDERATION_", "fed:1", "2", "0"),
           **_env("SKETCH_", "agent:2", "8", "5")}
    call = contract(env, ("FEDERATION_", "SKETCH_"))
    assert call == ("gloo", "tcp://fed:1", 2, 0)


def test_the_aggregator_falls_back_to_the_sketch_prefix(contract):
    call = contract(_env("SKETCH_", "agent:2", "8", "5"),
                    ("FEDERATION_", "SKETCH_"))
    assert call == ("gloo", "tcp://agent:2", 8, 5)


@pytest.mark.parametrize("env", [
    _env("SKETCH_", n=None),
    _env("SKETCH_", pid=None),
    # never mixed across prefixes: the count and id come from the winner
    {**_env("FEDERATION_", n=None, pid=None), **_env("SKETCH_")},
], ids=["no-count", "no-id", "mixed-prefixes"])
def test_both_errors_carry_the_reference_messages(contract, env):
    assert contract(env, ("FEDERATION_", "SKETCH_")) is None


def test_a_second_call_returns_true_without_a_second_init(contract):
    contract(_env("SKETCH_"))
    assert tdist.maybe_initialize_distributed(devices=["cpu"]) is True
    assert len(contract.group.calls) == 1


def test_the_backend_follows_the_devices_or_the_caller(contract,
                                                       monkeypatch):
    assert tdist.pick_backend(["cpu", "cpu"]) == "gloo"
    assert tdist.pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        tdist.pick_backend(["cpu", "cuda:0"])
    for k, v in _env("SKETCH_").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="backend must be one of"):
        tdist.maybe_initialize_distributed(backend="mpi")
    if not torch.cuda.is_available():
        # a CUDA request without CUDA raises; nothing falls back to gloo
        with pytest.raises(RuntimeError, match="is_available"):
            tdist.maybe_initialize_distributed(devices=["cuda:0"])
        assert not contract.group.calls
    assert tdist.maybe_initialize_distributed(backend="gloo",
                                              devices=["cpu"]) is True
    assert contract.group.calls[0][0] == "gloo"


def test_the_tpu_pod_detection_has_no_counterpart(contract, monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    assert tdist.maybe_initialize_distributed(devices=["cpu"]) is False
    assert not contract.group.calls


def test_one_process_answers_without_a_group():
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    t = torch.arange(4.0)
    assert tdist.all_reduce_sum_(t) is t and tdist.all_gather(t) == [t]
    assert tdist.all_gather_object(3) == [3]


def test_a_fold_never_closes_a_multi_process_window():
    """On a multi-process mesh a fold past the window's deadline leaves
    the roll (a collective) to the window thread, `roll` and `flush`; one
    process's exporter rolls there as before."""
    for multi in (False, True):
        exp = TorchSketchExporter(
            ts.SketchConfig(**GEOM), batch_size=B, device="cpu",
            sink=lambda r: None, packer="python", pack_threads=1)
        try:
            exp._multiprocess = multi
            exp._deadline = 0.0  # long past
            ev, f = _feed(np.random.default_rng(5), B, v4_share=0.97)
            exp.export_evicted(EvictedFlows(ev, **f))
            assert exp.rolls == (0 if multi else 1)
        finally:
            exp._multiprocess = False
            exp.close()


# ------------------------------------------------------ two real processes


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(scenario: str, spec: dict, tmp_path: Path,
         prefix: str = "SKETCH_") -> list[dict]:
    """Run the worker's `scenario` as two ranks over `spec`; every rank's
    results, in rank order. A rank that fails or outlives TIMEOUT_S fails
    the case, and every rank left is killed."""
    spec = dict(spec, prefix=prefix)
    inp, outp = tmp_path / f"{scenario}.in", tmp_path / f"{scenario}.out"
    with open(inp, "wb") as fh:
        pickle.dump(spec, fh)
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("SKETCH_", "FEDERATION_"))}
    procs, logs = [], [tmp_path / f"{scenario}.log{r}" for r in range(2)]
    for rank in range(2):
        env = dict(base, OMP_NUM_THREADS="2",
                   **_env(prefix, f"127.0.0.1:{port}", "2", str(rank)))
        with open(logs[rank], "w") as log:  # a file: no pipe fills up
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), scenario, str(inp),
                 str(outp)], env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:  # a hung rank must not outlive the case
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        out = logs[rank].read_text()
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "DIST_OK" in out, f"rank {rank}:\n{out}"
    results = []
    for rank in range(2):
        with open(f"{outp}.{rank}", "rb") as fh:
            results.append(pickle.load(fh))
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["process_count"] == 2 for r in results)
    return results


def _assert_same(a, b, path="") -> None:
    """Two ranks' results, bit for bit (nested dicts, lists, arrays)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


class _Report:
    """A worker's report (nested dicts of numpy) as `_report_close` reads
    a port report: fields of tensors."""

    def __init__(self, d: dict):
        for k, v in d.items():
            setattr(self, k, _Report(v) if isinstance(v, dict)
                    else torch.from_numpy(np.asarray(v)))


def _assert_dist_tables(got: dict, jdist, where: str) -> None:
    want = _jax_flat(jdist)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, (k, where)
        if k in EWMA_FLOAT:
            np.testing.assert_allclose(got[k], want[k], rtol=EWMA_FLOAT[k],
                                       atol=0, err_msg=f"{k} {where}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} {where}")


def _regions(ev, f, kdicts, bpl, caps) -> np.ndarray:
    """The resident feed's regions of one batch as the staging ring packs
    them: `len(kdicts)` contiguous row blocks, each its own dictionary's
    region (every row must fit: no continuation chunk)."""
    nr, n = len(kdicts), len(ev)
    rw = tfp.resident_buf_len(bpl, caps)
    buf = np.zeros(nr * rw, np.uint32)
    bounds = [n * i // nr for i in range(nr + 1)]
    for i in range(nr):
        rows = slice(bounds[i], bounds[i + 1])
        _, used = tfp.pack_resident(
            ev[rows], batch_size=bpl, kdict=kdicts[i], caps=caps,
            out=buf[i * rw:(i + 1) * rw],
            **{k: v[rows] for k, v in f.items()})
        assert used == bounds[i + 1] - bounds[i]
    return buf


@pytest.mark.parametrize("shape,per_rank", [((2, 2), 2), ((2, 1), 1),
                                            ((1, 2), 1)],
                         ids=["2x2", "2x1", "1x2"])
def test_two_ranks_ingest_and_roll_as_the_reference(tmp_path, shape,
                                                    per_rank):
    nd, ns = shape
    lanes, bpl, slot_cap = 2, 64, 1 << 10
    caps = tfp.default_resident_caps(bpl)
    rng = np.random.default_rng(31)
    kdicts = [tfp.KeyDict(slot_cap) for _ in range(nd * lanes)]
    windows = []
    for _ in range(2):
        dense = ts.arrays_to_dense(make_arrays(nd * 96, rng,
                                               n_distinct=300))
        ev, f = _feed(rng, nd * lanes * bpl - 7, n_distinct=200,
                      v4_share=0.97)
        windows.append((dense, _regions(ev, f, kdicts, bpl, caps)))
    spec = {"shape": shape, "cfg": TCFG, "lanes": lanes, "bpl": bpl,
            "caps": tuple(caps), "slot_cap": slot_cap, "windows": windows,
            "devices": [["cpu"] * per_rank] * 2}
    ranks = _run("merge", spec, tmp_path)
    for key in ("pre0", "report0", "post0", "pre1", "report1", "post1"):
        _assert_same(ranks[0][key], ranks[1][key], key)
    # the mesh spans both ranks in rank order: a data row each on 2x2 and
    # 2x1, a sketch column each on 1x2 (its owner-sharded planes cross)
    owner = tuple(tuple((d * ns + s) // per_rank for s in range(ns))
                  for d in range(nd))
    assert ranks[0]["ranks"] == owner
    assert ranks[1]["addressable"] == [
        (d, s) for d in range(nd) for s in range(ns) if owner[d][s] == 1]

    jmesh = jmake_mesh(JMeshSpec(nd, ns), jax.devices()[:nd * ns])
    jdense = jm.make_sharded_ingest_fn(jmesh, JCFG, donate=False, dense=True)
    jres = jm.make_sharded_ingest_resident_fn(
        jmesh, JCFG, bpl, jfp.ResidentCaps(*tuple(caps)), donate=False,
        lanes=lanes)
    jroll = jm.make_merge_fn(jmesh, JCFG, with_tables=ns == 1)
    jdist = jm.init_dist_state(JCFG, jmesh)
    jtables = jm.init_resident_tables(jmesh, slot_cap, lanes=lanes)
    for w, (dense, regions) in enumerate(windows):
        jdist = jdense(jdist, jm.shard_dense(jmesh, dense))
        jdist, jtables, _ = jres(jdist, jtables,
                                 jm.shard_dense(jmesh, regions))
        _assert_dist_tables(ranks[0][f"pre{w}"], jdist, f"pre-roll {w}")
        out = jroll(jdist)
        jdist, jrep = out[0], out[1]
        _report_close(_Report(ranks[0][f"report{w}"]), jrep)
        if ns == 1:
            got = ranks[0][f"tables{w}"]
            for k, v in out[2].items():
                np.testing.assert_array_equal(got[k], np.asarray(v),
                                              err_msg=k)
            _assert_same(got, ranks[1][f"tables{w}"], f"tables{w}")
        _assert_dist_tables(ranks[0][f"post{w}"], jdist, f"post-roll {w}")
    assert int(ranks[0]["post1"]["window"][0]) == 2
    assert float(ranks[0]["report1"]["total_records"]) > 0


def _exporter(devices, mesh_shape, ckpt_dir, reports, **kw):
    return TorchSketchExporter(
        ts.SketchConfig(**GEOM), batch_size=B, device="cpu", devices=devices,
        mesh_shape=mesh_shape, pack_threads=8, superbatch=(1, 2),
        resident_slots=1 << 12, sink=reports.append, checkpoint_dir=ckpt_dir,
        checkpoint_every=1, **kw)


def _ckpt_files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_two_rank_exporter_equals_a_one_process_mesh(tmp_path):
    rng = np.random.default_rng(41)
    windows = [[_feed(rng, n, v4_share=0.97) for n in (B + 37, 3 * B, 190)]
               for _ in range(2)]
    spec = {"geom": GEOM, "batch": B, "mesh_shape": "2",
            "ckpt_dir": str(tmp_path / "two"), "windows": windows,
            "devices": [["cpu"]] * 2}
    ranks = _run("exporter", spec, tmp_path)
    _assert_same([_strip(r) for r in ranks[0]["reports"]],
                 [_strip(r) for r in ranks[1]["reports"]], "reports")
    for key in ("tables", "dist", "restored"):
        _assert_same(ranks[0][key], ranks[1][key], key)
    for r in ranks:
        # the refresh is off, with the reference's warning; the ring and
        # its ladder were made in the constructor
        assert r["refresh_s"] == 0.0 and r["ring_made"]
        assert any("SKETCH_QUERY_REFRESH disabled on multi-process" in m
                   for m in r["warnings"])
        _assert_same(r["restored"], r["dist"], "restored")
        # a 4x1 mesh over the ranks refuses the 2x1 file on both, and no
        # tensor of it was written
        assert "refused on rank(s) 0: " in r["refused"] and \
            "; 1: " in r["refused"] and r["untouched"]

    reports: list = []
    one = _exporter(["cpu", "cpu"], "2", str(tmp_path / "one"), reports)
    try:
        assert one.mesh.ranks is None and one.mesh.data == 2
        for window in windows:
            for ev, f in window:
                one.export_evicted(EvictedFlows(ev, **f))
            one.roll()
        tables = one.state_tables()
    finally:
        one.close()
    got = ranks[0]["reports"]
    assert len(got) == len(reports) == 3  # two rolls and close's window
    for g, w in zip(got, reports):
        _assert_report(g, w, GAMMA)
    for k, v in tables.items():
        np.testing.assert_array_equal(ranks[0]["tables"][k], v, err_msg=k)
    _assert_same(ranks[0]["dist"], tm.dist_tables(one.state), "dist")
    # rank 0 wrote every file; each equals the one-process mesh's
    two, want = ranks[0]["ckpt_files"], _ckpt_files(tmp_path / "one")
    assert two.keys() == want.keys() and any(
        k.endswith("state.npz") for k in want)
    for k in want:
        assert two[k] == want[k], k


def _strip(report: dict) -> dict:
    return {k: v for k, v in report.items() if k != "TimestampMs"}


def test_two_rank_aggregator_equals_a_one_process_mesh(tmp_path):
    universe = np.random.default_rng(11).integers(0, 2**32, (48, 10),
                                                  dtype=np.uint32)
    schedule = _schedule(universe)
    # a shared checkpoint directory stamped with a refused format: both
    # ranks refuse it together, rank 0 moves it aside, both checkpoint on
    ckpt = tmp_path / "agg"
    (ckpt / "0").mkdir(parents=True)
    np.savez(ckpt / "0" / "state.npz", x=np.zeros(1))
    (ckpt / "FORMAT.json").write_text('{"format_version": 2}')
    spec = {"cfg": FED_TCFG, "mesh_shape": "2", "schedule": schedule,
            "devices": [["cpu"]] * 2, "ckpt_dir": str(ckpt)}
    ranks = _run("aggregator", spec, tmp_path, prefix="FEDERATION_")
    for r in ranks:
        assert r["ckpt_on"], r["warnings"]
        assert any("refused on rank(s) 0: " in m and "; 1: " in m
                   for m in r["warnings"]), r["warnings"]
    assert len(ranks[0]["corrupt"]) == 1 and ranks[0]["steps"]
    for key in ("acks", "ledgers"):
        _assert_same(ranks[0][key], ranks[1][key], key)
    reports: list = []
    one = FederationAggregator(FED_TCFG, window_s=3600.0, device="cpu",
                               devices=["cpu", "cpu"], mesh_shape="2",
                               sink=reports.append)
    snaps, acks, ledgers = [], [], []
    try:
        for item in schedule:
            if item == "flush":
                one.flush()
                snaps.append(one.snapshot())
                continue
            acks.append(one.ingest_frame(item).SerializeToString())
            ledgers.append(dict(one._ledger))
    finally:
        one.close()
    assert ranks[0]["acks"] == acks and ranks[0]["ledgers"] == ledgers
    for r in ranks:
        assert r["ranks"] == ((0,), (1,))
        assert len(r["snapshots"]) == len(snaps) == 3
        for got, want in zip(r["snapshots"], snaps):
            for k in ("window", "seq", "total_records", "total_bytes"):
                assert got[k] == want[k], k
            _assert_report(got["report"], want["report"], FED_GAMMA)
            for k in ("cm_bytes", "cm_pkts"):
                np.testing.assert_array_equal(got[k], want[k])
            for k, v in want["heavy"].items():
                np.testing.assert_array_equal(got["heavy"][k], v,
                                              err_msg=k)
        assert len(r["reports"]) == len(reports) == 4  # and close's
        for got, want in zip(r["reports"], reports):
            _assert_report(got, want, FED_GAMMA)
