"""Rules of the PyTorch port (netobserv_tpu_torch) that hold on any box:
it imports neither JAX nor the JAX package, nor protobuf or gRPC (the
card's machine has neither), its entry points default to
CUDA and never quietly fall back to the CPU, and a kernel wrapper takes its
plain version only for a CPU tensor, without counting a launch."""

import ast
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.ops.kernels import (
    _build, countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
)
from netobserv_tpu_torch.scenarios import traffic
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.sketch.staging import (
    DenseStagingRing, ResidentStagingRing, ShardedResidentStagingRing,
)
from netobserv_tpu_torch.utils.platform import pick_device

ROOT = Path(__file__).resolve().parents[1]
#: every kernel of the port: kernels 1-4, the single-plane CM fold 5, the
#: tiered kernels 6-7, the HLL grid fold 8 and the HLL folds launch
KERNELS = (countmin_kernel.KERNEL, hll_kernel.KERNEL, topk_kernel.KERNEL,
           signal_kernel.KERNEL, countmin_kernel.KERNEL_ONE,
           countmin_kernel.KERNEL_TIER2, signal_kernel.KERNEL_TIERED,
           hll_kernel.KERNEL_GRID, hll_kernel.KERNEL_FOLDS)
#: modules each slice added, which the import scan must reach
SLICE_MODULES = ("model/binfmt.py", "datapath/flowpack.py",
                 "sketch/staging.py", "sketch/tiered.py", "sketch/state.py",
                 "datapath/fetcher.py", "config.py", "sketch/capture.py",
                 "utils/faultinject.py", "utils/tracing.py",
                 "metrics/registry.py", "query/core.py", "query/snapshot.py",
                 "query/routes.py", "alerts/rules.py", "alerts/engine.py",
                 "alerts/sinks.py", "metrics/server.py", "server/debug.py",
                 "utils/tensorcodec.py", "federation/pbwire.py",
                 "federation/delta.py", "federation/statemerge.py",
                 "federation/aggregator.py", "federation/query.py",
                 "utils/atomicio.py", "archive/__init__.py",
                 "archive/segment.py", "archive/store.py",
                 "archive/query.py", "sketch/checkpoint.py",
                 "sketch/overload.py", "agent/__init__.py",
                 "agent/supervisor.py", "kafka/__init__.py",
                 "kafka/wire.py", "kafka/producer.py", "exporter/report.py",
                 "exporter/base.py", "exporter/__init__.py",
                 "model/flow.py", "model/record.py", "utils/dnsnames.py",
                 "flow/__init__.py", "flow/map_tracer.py", "flow/limiter.py",
                 "datapath/replay.py", "model/packet_record.py",
                 "scenarios/synth.py", "agent/agent.py", "__main__.py",
                 "sketch/tenancy.py", "parallel/mesh.py",
                 "parallel/merge.py", "parallel/distributed.py",
                 "model/accumulate.py", "flow/ringbuf_tracer.py",
                 "flow/accounter.py", "scenarios/zoo.py",
                 "scenarios/runner.py", "pb/__init__.py", "pb/flow.py",
                 "exporter/pb_convert.py", "exporter/stdout_json.py",
                 "exporter/kafka.py", "exporter/ipfix.py",
                 "exporter/grpc_flow.py", "exporter/federation.py",
                 "grpc/__init__.py", "grpc/h2.py", "grpc/flow.py",
                 "grpc/federation.py", "exporter/flp_tables.py",
                 "exporter/flp_map.py", "exporter/flp_enrich.py",
                 "exporter/direct_flp.py", "pb/packet.py", "grpc/packet.py",
                 "exporter/grpc_packets.py", "flow/perf_buffer.py",
                 "agent/packets_agent.py")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    files = sorted((ROOT / "netobserv_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for rel in SLICE_MODULES:
        assert ROOT / "netobserv_tpu_torch" / rel in files, rel
    for f in files:
        for name in _imported_modules(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "netobserv_tpu",
                               "orbax"), (f, name)


def test_port_imports_neither_protobuf_nor_grpc():
    """The delta wire is the port's own proto3 writer and parser
    (federation/pbwire.py): no module imports `google.protobuf`, `grpc`
    or the generated messages, at any level."""
    files = sorted((ROOT / "netobserv_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for name in _imported_modules(f):
            assert name.split(".")[0] not in ("grpc", "grpcio"), (f, name)
            assert not name.startswith("google"), (f, name)
            assert "_pb2" not in name, (f, name)
        assert "import_module(\"google" not in f.read_text(), f


def test_port_imports_no_torch_distributed():
    """Only the multi-host tier's module (`parallel/distributed.py`)
    imports `torch.distributed`: every other module of the port (and
    chip_smoke.py) reaches the process group through it, and names it in
    no import and no attribute, at any level."""
    only = ROOT / "netobserv_tpu_torch" / "parallel" / "distributed.py"
    files = sorted((ROOT / "netobserv_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert only in files
    assert "torch.distributed" in _imported_modules(only)
    for f in files:
        if f == only:
            continue
        for name in _imported_modules(f):
            assert not name.startswith("torch.distributed"), (f, name)
        assert "torch.distributed" not in f.read_text(), f


def test_only_the_metrics_facade_imports_prometheus_client():
    """`prometheus_client` is optional where the port runs: no module
    imports it at module level, and the metrics facade imports it only
    when a `Metrics` is made."""
    for f in sorted((ROOT / "netobserv_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text(), str(f))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert "prometheus_client" not in names, f
        if f.name != "registry.py":
            assert "prometheus_client" not in _imported_modules(f), f


def test_only_the_direct_flp_exporter_imports_yaml():
    """PyYAML is on the card's machine, and FLP_CONFIG is YAML: the
    direct-flp exporter imports it only where it parses a non-empty
    FLP_CONFIG (inside `DirectFLPExporter.__init__`), and no other module
    of the port imports it. (chip_smoke.py's device phase imports it to
    print the card machine's answer, and it is no module of the port.)"""
    only = ROOT / "netobserv_tpu_torch" / "exporter" / "direct_flp.py"
    files = sorted((ROOT / "netobserv_tpu_torch").rglob("*.py"))
    assert only in files
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        top = [a.name for n in tree.body if isinstance(n, ast.Import)
               for a in n.names]
        top += [n.module for n in tree.body
                if isinstance(n, ast.ImportFrom) and n.module]
        assert "yaml" not in [t.split(".")[0] for t in top], f
        if f != only:
            assert "yaml" not in [m.split(".")[0]
                                  for m in _imported_modules(f)], f
    init = next(n for n in ast.walk(ast.parse(only.read_text()))
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
                and "flp_config" in [a.arg for a in n.args.args])
    assert "yaml" in [a.name for n in ast.walk(init)
                      if isinstance(n, ast.Import) for a in n.names]


def test_port_sources_include_no_header_of_the_jax_package():
    """Every C, C++ and CUDA source of the port includes system headers
    and headers of its own csrc/ only: it keeps copies (records.h), never
    a path into netobserv_tpu/."""
    csrc = ROOT / "netobserv_tpu_torch" / "csrc"
    files = sorted(f for f in csrc.iterdir()
                   if f.suffix in (".cu", ".cuh", ".cc", ".h"))
    assert {"flowpack.cc", "records.h"} <= {f.name for f in files}
    for f in files:
        for inc in re.findall(r'^\s*#\s*include\s*([<"][^>"]+[>"])',
                              f.read_text(), re.M):
            assert "netobserv_tpu" not in inc and ".." not in inc, (f, inc)
            if inc.startswith('"'):
                assert "/" not in inc and (csrc / inc[1:-1]).is_file(), (
                    f, inc)


def test_a_failed_packer_build_raises_and_nothing_falls_back(monkeypatch,
                                                             tmp_path):
    """With no host compiler the native packer cannot build: every ring,
    and the exporter at its first fold of events on each feed, raise
    rather than take a Python packer, which the resident rings use only
    when it is asked for. The pre-packed dense entry needs no packer."""
    from netobserv_tpu_torch.datapath import flowpack
    monkeypatch.setattr(flowpack, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="compiler"):
        ResidentStagingRing(64, device="cpu")
    for ring in (ShardedResidentStagingRing, DenseStagingRing):
        with pytest.raises(RuntimeError, match="compiler"):
            ring(64, device="cpu")
    with pytest.raises(RuntimeError, match="compiler"):
        DenseStagingRing(64, spill_cap=64, device="cpu")
    for feed in ("resident", "compact", "dense"):
        exp = TorchSketchExporter(ts.SketchConfig(topk=128), batch_size=64,
                                  device="cpu", feed=feed)
        exp.fold_dense(np.zeros(64 * ts.DENSE_WORDS, np.uint32))
        with pytest.raises(RuntimeError, match="compiler"):
            exp.fold_events(np.zeros(0, traffic.binfmt.FLOW_EVENT_DTYPE))
        assert exp.ring is None and exp.pending is None
    assert flowpack._LIB is None and not list(tmp_path.iterdir())
    ring = ResidentStagingRing(64, device="cpu", packer="python")
    assert isinstance(ring.kdict, flowpack.KeyDict)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        assert ts.init_state(ts.SketchConfig(topk=128)).window.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ts.init_state()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSketchExporter(batch_size=64)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSketchExporter(ts.SketchConfig(tiered=tiered.TierSpec()),
                            batch_size=64)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.init_state(ts.SketchConfig(tiered=tiered.TierSpec()))
    with pytest.raises(RuntimeError, match="cuda"):
        ResidentStagingRing(64)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.init_key_table(64)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.init_key_tables(2, 64)
    for ring in (ShardedResidentStagingRing, DenseStagingRing):
        with pytest.raises(RuntimeError, match="cuda"):
            ring(64)
    with pytest.raises(RuntimeError, match="cuda"):
        traffic.device_pool(traffic.make_pool(np.random.default_rng(0),
                                              batch=8, n_batches=1)[1])
    assert pick_device("cpu").type == "cpu"


def test_the_agent_entry_refuses_to_run_on_the_cpu_unasked():
    """`python -m netobserv_tpu_torch` with SKETCH_DEVICES unset folds on
    the card: on a box without CUDA it exits 2 naming CUDA, before any
    window is published; only SKETCH_DEVICES=cpu runs it on the CPU
    (tests/test_torch_entry.py)."""
    import os
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a CUDA box runs the agent on its card")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SKETCH_", "DATAPATH", "EXPORT"))}
    env.update(PYTHONPATH=str(ROOT), AGENT_IP="127.0.0.1",
               EXPORT="tpu-sketch", DATAPATH="synthetic")
    proc = subprocess.run([sys.executable, "-m", "netobserv_tpu_torch"],
                          cwd=str(ROOT), env=env, capture_output=True,
                          timeout=60)
    assert proc.returncode == 2
    assert b"torch.cuda.is_available() is False" in proc.stderr
    assert proc.stdout == b""


def test_the_aggregator_defaults_to_cuda_and_never_falls_back():
    """`FederationAggregator()` names no device: it takes CUDA, captures
    its merge there, and raises on a box without CUDA (before any window
    thread starts); `device="cpu"` merges eagerly."""
    import threading

    from netobserv_tpu_torch.federation.aggregator import (
        FederationAggregator,
    )
    cfg = ts.SketchConfig(cm_width=1024, topk=64, ewma_buckets=64)
    if torch.cuda.is_available():
        agg = FederationAggregator(cfg, window_s=3600.0)
        try:
            assert agg.device.type == "cuda"
            assert agg._fold.captures == 1
        finally:
            agg.close()
        return
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="cuda"):
        FederationAggregator(cfg, window_s=3600.0)
    assert threading.active_count() == before
    agg = FederationAggregator(cfg, window_s=3600.0, device="cpu")
    try:
        assert agg._state.window.device.type == "cpu"
        assert agg._fold.name == "federation_merge"
    finally:
        agg.close()


def test_archive_and_checkpoint_entry_points_default_to_cuda(tmp_path):
    """`ArchiveQueryEngine`, `SketchArchive` and `SketchCheckpointer.
    restore` name no device: they take CUDA (the engine capturing its
    ladder there) and raise on a box without CUDA; `device="cpu"` runs
    on the CPU."""
    from netobserv_tpu_torch.archive import (
        ArchiveQueryEngine, ArchiveStore, SketchArchive,
    )
    from netobserv_tpu_torch.sketch.checkpoint import SketchCheckpointer
    cfg = ts.SketchConfig(cm_width=1024, topk=64, ewma_buckets=64)
    store = ArchiveStore(str(tmp_path / "a"))
    ck = SketchCheckpointer(str(tmp_path / "ck"))
    ck.save(0, ts.init_state(cfg, device="cpu"))
    if torch.cuda.is_available():
        eng = ArchiveQueryEngine(store, cfg, ladder_max=2)
        assert eng.device.type == "cuda"
        assert [e.captures for e in eng._entries.values()] == [1, 1]
        assert ck.restore(cfg).window.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ArchiveQueryEngine(store, cfg, ladder_max=2)
    with pytest.raises(RuntimeError, match="cuda"):
        SketchArchive(store, cfg, ladder_max=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ck.restore(cfg)
    assert ArchiveQueryEngine(store, cfg, ladder_max=2,
                              device="cpu").device.type == "cpu"
    assert ck.restore(cfg, device="cpu").window.device.type == "cpu"
    ck.close()


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    """Wide and tiered (interior form, kernels 6 and 7 engaged) ingest of a
    batch, the same batch through the resident feed, and kernel 5."""
    for k in KERNELS:
        k.launches = 0
    cfg = ts.SketchConfig(cm_width=1024, hll_precision=10, perdst_buckets=64,
                          persrc_buckets=64, topk=128, hist_buckets=64,
                          ewma_buckets=256)
    _, pool = traffic.make_pool(np.random.default_rng(1), batch=300,
                                n_batches=1)
    batch = traffic.device_pool(pool, "cpu")[0]
    for c in (cfg, cfg._replace(tiered=tiered.TierSpec())):
        state = ts.init_state(c, device="cpu")
        ts.ingest(state, batch)
        wide = state.rest if c.tiered else state
        assert float(wide.total_records) == 300.0
    (events, feats), = traffic.event_pool(pool, np.random.default_rng(2))
    ring = ResidentStagingRing(256, device="cpu")
    state = ring.fold(ts.init_state(cfg, device="cpu"), events, **feats)
    assert float(state.total_records) == 300.0 and ring.chunks == 2
    counts = torch.zeros((2, 64))
    countmin_kernel.update(counts, batch["keys"][:, 0], batch["keys"][:, 1],
                           batch["bytes"])
    assert float(counts[0].sum()) == float(batch["bytes"].sum())
    assert ts.tiered_fold_form(cfg._replace(tiered=tiered.TierSpec())) \
        == "interior"
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_kernel_launch_without_a_toolchain_raises():
    """With no nvcc the first launch raises: nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA box builds the kernels; this checks the "
                    "no-toolchain path")
    try:
        _build.nvcc_path()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        hll_kernel.KERNEL.launch([], [0, 0], torch.device("cpu"))
    assert hll_kernel.KERNEL.launches == 0


def test_wrappers_reject_other_devices():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="device"):
        hll_kernel.update(meta.to(torch.int32), meta.long(), meta.long(),
                          meta.bool())
    with pytest.raises(ValueError, match="device"):
        hll_kernel.update_per_dst(meta.reshape(2, 2).to(torch.int32),
                                  meta.long(), meta.long(), meta.long(),
                                  meta.bool())
    with pytest.raises(ValueError, match="device"):
        countmin_kernel.update(meta.reshape(2, 2), meta.long(), meta.long(),
                               meta)


def _c_entry_body(source: str, symbol: str) -> str:
    """The body of the `extern "C"` function `symbol` of csrc/`source`."""
    text = (ROOT / "netobserv_tpu_torch" / "csrc" / source).read_text()
    start = text.index(f'extern "C" int {symbol}(')
    i = text.index("{", text.index(")", start))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(f"{symbol}: unbalanced braces")


@pytest.mark.parametrize("source,symbol", [("topk_reduce.cu", "topk_reduce"),
                                           ("signal_fold.cu", "signal_fold"),
                                           ("countmin_fold2.cu", "cm_fold2"),
                                           ("countmin_fold2.cu", "cm_fold"),
                                           ("signal_fold_tiered.cu",
                                            "signal_fold_tiered")])
def test_redesigned_kernels_make_one_launch_per_call(source, symbol):
    body = _c_entry_body(source, symbol)
    launches = (body.count("<<<") + body.count("cudaLaunchKernelEx")
                + body.count("launch_clusters("))
    assert launches == 1, (source, launches)


def _defined(text: str, macro: str) -> list[int]:
    """Values of `#define macro v` or `const int macro = v;` lines (v an
    integer or "(a / b)")."""
    vals = []
    for m in re.finditer(rf"^\s*(?:#define {macro} (.+)|const int {macro} = "
                         rf"(.+);)$", text, re.M):
        value = (m.group(1) or m.group(2)).split("//")[0].strip()
        value = value.replace("(", "").replace(")", "")
        a, _, b = value.partition(" / ")
        vals.append(int(a) // int(b) if b else int(a))
    return vals


def _defining_source(mod, macros) -> str:
    """The first of the module's sources, then of the headers they include,
    that defines every macro."""
    csrc = ROOT / "netobserv_tpu_torch" / "csrc"
    files = [getattr(mod, a) for a in sorted(dir(mod))
             if a.startswith("SOURCE")]
    files += [h for f in list(files)
              for h in re.findall(r'#include "(\w+\.cuh)"',
                                  (csrc / f).read_text())]
    for f in files:
        text = (csrc / f).read_text()
        if all(_defined(text, m) for m in macros):
            return text
    raise AssertionError(f"no source of {mod.__name__} defines {macros}")


@pytest.mark.parametrize("mod,macros", [
    (topk_kernel, {"TOPK_CLUSTER": "CLUSTER", "TOPK_THREADS": "THREADS",
                   "TOPK_TILE": "TILE"}),
    (signal_kernel, {"SIGNAL_THREADS": "THREADS"}),
    (countmin_kernel, {"CM2_THREADS": "THREADS"}),
    (countmin_kernel, {"TILE_W": "TILE_W", "TIER2_THREADS": "TIER2_THREADS",
                       "BIN_THREADS": "BIN_THREADS",
                       "EST_THREADS": "EST_THREADS"}),
    (signal_kernel, {"TIERED_THREADS": "TIERED_THREADS",
                     "HLL_UNROLL": "HLL_UNROLL", "TILE_R": "TILE_R"}),
    (hll_kernel, {"HLL_THREADS": "THREADS", "HLL_MAX_FOLDS": "MAX_FOLDS"})])
def test_launch_shapes_agree_with_their_sources(mod, macros):
    """The wrapper sizes the grid, the slot split, the launch floor and the
    contract cases from the same cluster, block and tile sizes the kernel
    was compiled with."""
    text = _defining_source(mod, macros)
    for macro, const in macros.items():
        assert set(_defined(text, macro)) == {getattr(mod, const)}, macro


@pytest.mark.parametrize("mod", [topk_kernel, signal_kernel, countmin_kernel,
                                 hll_kernel])
def test_redesigned_wrappers_catch_nothing_around_the_launch(mod):
    tree = ast.parse(Path(mod.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_topk_reduce_allocates_only_its_outputs(monkeypatch):
    """On a CUDA tensor the wrapper makes one launch whose pointers are the
    three outputs it returns and the three inputs: no scratch, whatever K
    (a K past one tile of slots still fits one CTA's shared memory)."""
    seen = []
    monkeypatch.setattr(topk_kernel, "on_cuda", lambda t: True)
    monkeypatch.setattr(topk_kernel, "check", lambda *a: None)
    monkeypatch.setattr(topk_kernel.KERNEL, "launch",
                        lambda ptrs, ints, dev: seen.append((ptrs, ints)))
    mslot = torch.zeros(5, dtype=torch.int64)
    est = torch.ones(5)
    out = topk_kernel.reduce(mslot, mslot, est, 1024)
    (ptrs, ints), = seen
    assert len(ptrs) == 6 and all(p is o for p, o in zip(ptrs, out))
    assert ptrs[3] is mslot and ptrs[5] is est and ints == [5, 1024]
    assert len(topk_kernel.KERNEL.argtypes) == 6 + 2 + 1
    big = 3 * topk_kernel.TILE + 5
    out = topk_kernel.reduce(mslot, mslot, est, big)
    assert len(seen) == 2 and seen[1][1] == [5, big]
    assert [tuple(o.shape) for o in out] == [(big,)] * 3
    assert topk_kernel.launch_shape(big).smem <= _build.SMEM_LIMIT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_c_entry_has_a_chip_smoke_kernel_spec():
    """chip_smoke.py builds, checks and times each C entry of every kernel
    source (csrc/*.cu but the launch floor's) through its own spec and
    launch counter: the HLL folds launch and the entries of kernels 3 and
    8, which share its body, included."""
    specs = _chip_smoke().kernel_specs()
    have = {(s["kernel"].source, s["kernel"].symbol) for s in specs}
    csrc = ROOT / "netobserv_tpu_torch" / "csrc"
    want = {(f.name, sym) for f in sorted(csrc.glob("*.cu"))
            if f.name != "launch_floor.cu"
            for sym in re.findall(r'extern "C" int (\w+)\(', f.read_text())}
    assert ("hll_fold.cu", "hll_fold_folds") in want
    assert have == want
    assert len(specs) == len(have)


def test_hll_entries_launch_one_fold_body():
    """Kernels 3 and 8 and the folds launch are one __global__, launched at
    one place; each C entry goes through it."""
    text = (ROOT / "netobserv_tpu_torch" / "csrc"
            / hll_kernel.SOURCE).read_text()
    assert text.count("__global__ void") == 1 and text.count("<<<") == 1
    for symbol in ("hll_fold", "hll_fold_grid", "hll_fold_folds"):
        assert "return launch(folds, " in _c_entry_body(hll_kernel.SOURCE,
                                                        symbol)
    assert len(hll_kernel.KERNEL_FOLDS.argtypes) == (
        5 * hll_kernel.MAX_FOLDS + 2 + 2 * hll_kernel.MAX_FOLDS + 1)
    assert hll_kernel.launch_shape(16384, 3) == (3 * 64, 1, 256, 0)


def test_countmin_entries_launch_one_fold_body():
    """Kernels 1 and 5 are one __global__ template on the number of planes,
    in one source: `cm_fold2` launches it with two planes and `cm_fold`
    with one, each once. The single-plane source of its own is gone."""
    csrc = ROOT / "netobserv_tpu_torch" / "csrc"
    assert not (csrc / "countmin_fold.cu").exists()
    text = (csrc / countmin_kernel.SOURCE).read_text()
    assert text.count("__global__ void") == 1
    assert "template <int NP>\n__global__ void cm_fold2_kernel(" in text
    for symbol, planes in (("cm_fold2", 2), ("cm_fold", 1)):
        body = _c_entry_body(countmin_kernel.SOURCE, symbol)
        assert body.count("<<<") == 1
        assert f"cm_fold2_kernel<{planes}><<<" in body, symbol
    assert countmin_kernel.KERNEL.source == countmin_kernel.SOURCE
    assert countmin_kernel.KERNEL_ONE.source == countmin_kernel.SOURCE
    assert (countmin_kernel.KERNEL.symbol,
            countmin_kernel.KERNEL_ONE.symbol) == ("cm_fold2", "cm_fold")


def test_kernels_4_and_7_share_one_per_record_body():
    """Kernel 7's first table body (a private shared-memory copy of the
    tables, `signal_body.cuh`) is gone; kernels 4 and 7 both fold through
    the warp-aggregated per-record body of `signal_agg.cuh`."""
    csrc = ROOT / "netobserv_tpu_torch" / "csrc"
    assert not (csrc / "signal_body.cuh").exists()
    for f in sorted(csrc.glob("*.cu*")):
        assert "signal_body.cuh" not in f.read_text(), f.name
    for source in (signal_kernel.SOURCE, signal_kernel.SOURCE_TIERED):
        text = (csrc / source).read_text()
        assert '#include "signal_agg.cuh"' in text, source
        assert "signal_fold_record(" in text, source


def test_signal_launch_shape_takes_one_thread_per_record():
    for n, blocks in ((0, 1), (1, 1), (129, 2), (16384, 128)):
        assert signal_kernel.launch_shape(n) == (blocks, 1, 128, 0)


def test_kernel6_makes_the_launches_its_source_note_states():
    """One C entry makes TIER2_LAUNCHES kernel launches and one memset, as
    the source note says, and the wrapper has a grid for each."""
    text = (ROOT / "netobserv_tpu_torch" / "csrc"
            / countmin_kernel.SOURCE_TIER2).read_text()
    said = re.search(r"(\w+) launches and one\W+memset", text).group(1)
    words = {"Three": 3, "Four": 4, "Five": 5}
    body = _c_entry_body(countmin_kernel.SOURCE_TIER2, "cm_tier2")
    assert words[said] == body.count("<<<") == countmin_kernel.TIER2_LAUNCHES
    assert body.count("cudaMemsetAsync") == 1
    assert "launch_clusters(" not in body and "cudaLaunchKernelEx" not in body
    assert len(countmin_kernel.launch_shapes_tier2(
        16384, 4, 65536, 32, 256)) == countmin_kernel.TIER2_LAUNCHES


@pytest.mark.parametrize("w", [512, 65536, 1 << 20])
def test_kernel6_allocates_only_q_est_counts_and_entries(monkeypatch, w):
    """On a CUDA tensor the wrapper makes one C call whose new tensors are
    q [d, B], est [B], the per-tile counts and cursors [2 W / TILE_W] and
    the bins' entries [d B]: nothing of W f32 counters, whatever W."""
    seen, made = [], []
    monkeypatch.setattr(countmin_kernel, "on_cuda", lambda t: True)
    monkeypatch.setattr(countmin_kernel, "check", lambda *a: None)
    monkeypatch.setattr(countmin_kernel.KERNEL_TIER2, "launch",
                        lambda ptrs, ints, dev: seen.append((ptrs, ints)))
    for name in ("empty", "zeros", "full", "empty_like", "zeros_like"):
        real = getattr(torch, name)

        def alloc(*a, _real=real, **k):
            t = _real(*a, **k)
            made.append(t)
            return t
        monkeypatch.setattr(torch, name, alloc)
    spec = tiered.TierSpec()
    d, n = 4, 300
    planes = [tiered.init_plane(d, w, spec, torch.device("cpu"))
              for _ in range(2)]
    h = torch.zeros(n, dtype=torch.int64)
    v = torch.ones(n)
    made.clear()
    est = countmin_kernel.update_two_tiered(*planes, h, h, v, v, spec)
    (ptrs, ints), = seen
    assert len(ptrs) == 14 == len(countmin_kernel.KERNEL_TIER2.argtypes) - 8
    assert ptrs[:6] == [*planes[0], *planes[1]]
    q, est_p, counts, entries = ptrs[10:]
    assert est_p is est and len(made) == 4
    assert all(m is t for m, t in zip(made, (q, est, counts, entries)))
    assert [tuple(t.shape) for t in made] == [
        (d, n), (n,), (2 * w // countmin_kernel.TILE_W,), (d * n,)]
    assert counts.dtype == entries.dtype == torch.int32
    assert ints == [n, d, w, spec.mid_group, spec.top_group,
                    spec.bytes_unit, 1]


def test_countmin_launch_shapes():
    """Kernels 1 and 5: one thread per (row, record); kernel 6: count and
    scatter one thread per record, one fold block per tile, est one thread
    per record."""
    assert countmin_kernel.launch_shape(16384, 4) == (256, 1, 256, 0)
    assert countmin_kernel.launch_shape(0, 4) == (1, 1, 256, 0)
    # kernel 5 at the wide path's kernel-1 inputs, as chip_smoke.py's
    # launch floor takes its grid
    spec = next(s for s in _chip_smoke().kernel_specs()
                if s["name"] == "countmin_fold")
    meta = {"device": "meta"}
    args = (torch.empty((4, 65536), **meta),
            *(torch.empty(16384, dtype=torch.int64, **meta) for _ in "12"),
            torch.empty(16384, **meta))
    assert _chip_smoke().launch_shapes(spec, args) == ([(256, 1, 256, 0)],
                                                       0)
    count, scatter, fold, est = countmin_kernel.launch_shapes_tier2(
        16384, 4, 65536, 32, 256)
    assert count == (64, 1, 256, 4 * 128)
    assert scatter == (64, 1, 256, 3 * 4 * 128)
    cells = 2 * 4 * 512  # both planes' tiles
    mids, tops = cells // 32, cells // 256
    assert fold == (128, 1, 1024, (2 * cells + 2 * mids) * 4 + tops * 4
                    + mids * 2 + cells)
    assert est == (64, 1, 256, 0)
    assert hll_kernel.launch_shape(16384) == (64, 1, 256, 0)
    # kernel 7: one HLL block per tile of 512 triples, holding its
    # registers, then one signal block per 1,024 records
    assert signal_kernel.launch_shape_tiered(16384, 12288) == (
        8 + 16, 1, 1024, 4 * 512 * 4)
    assert signal_kernel.launch_shape_tiered(16384, 3072) == (
        2 + 16, 1, 1024, 4 * 512 * 4)
    assert signal_kernel.launch_shape_tiered(100, 48) == (1 + 1, 1, 1024,
                                                          4 * 16 * 4)
