"""One rank of tests/test_torch_distributed.py: a process of a mesh that
spans processes over the port's process group (gloo on the CPU,
`netobserv_tpu_torch/parallel/distributed.py`), on the pattern of
tests/distributed_worker.py.

    python tests/torch_distributed_worker.py SCENARIO INPUT OUTPUT

with SKETCH_COORDINATOR, SKETCH_NUM_PROCESSES and SKETCH_PROCESS_ID set
(the `aggregator` scenario reads the FEDERATION_ ones). INPUT is a pickle
the test wrote (every rank reads the same one: the same global batches),
OUTPUT a path this rank suffixes with `.<rank>` and writes its results to
as a pickle. Scenarios:

- `merge`: the sharded dense and resident ingests and two rolls of a
  spanning mesh, with `dist_tables` before and after each roll, the
  merged report and (on an Nx1 mesh) the merged pre-roll tables;
- `exporter`: a `TorchSketchExporter` over the spanning mesh, its windows
  closed by `roll()`, with a query refresh asked for (it must be turned
  off), checkpoints every roll into a directory the ranks share, a
  second exporter restored from them, and a restore into a mesh of
  another shape, which every rank must refuse;
- `aggregator`: a `FederationAggregator` over the spanning mesh fed a
  frame schedule, its windows closed by `flush()`, with its acks,
  ledgers, snapshots and reports; it starts on a checkpoint directory
  the ranks share and cannot restore, which rank 0 moves aside.

The worker imports no JAX; it prints DIST_OK when it ends well.
"""

import logging
import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from netobserv_tpu_torch.parallel import distributed  # noqa: E402


class _Warnings(logging.Handler):
    """Every warning the port logs, by message."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _numpy(x):
    """A report (a NamedTuple of tensors, nested) as nested dicts of
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return {f: _numpy(getattr(x, f)) for f in x._fields}


def _merge(spec: dict, devices: list) -> dict:
    from netobserv_tpu_torch.parallel import MeshSpec, make_mesh
    from netobserv_tpu_torch.parallel import merge as tm

    assert distributed.maybe_initialize_distributed(devices=devices)
    # a second configured call joins nothing new and answers True
    assert distributed.maybe_initialize_distributed(devices=devices)
    nd, ns = spec["shape"]
    cfg, lanes, bpl = spec["cfg"], spec["lanes"], spec["bpl"]
    mesh = make_mesh(MeshSpec(nd, ns), devices)
    from netobserv_tpu_torch.datapath import flowpack as tfp
    caps = tfp.ResidentCaps(*spec["caps"])
    dist = tm.init_dist_state(cfg, mesh)
    dense_fn = tm.make_sharded_ingest_fn(mesh, cfg, dense=True)
    res_fn = tm.make_sharded_ingest_resident_fn(mesh, cfg, bpl, caps,
                                                lanes=lanes)
    tables = tm.init_resident_tables(mesh, spec["slot_cap"], lanes=lanes)
    roll = tm.make_merge_fn(mesh, cfg, with_tables=ns == 1)
    out = {"ranks": mesh.ranks, "addressable": mesh.addressable(),
           "world": mesh.world}
    for w, (dense, regions) in enumerate(spec["windows"]):
        dense_fn(dist, tm.shard_dense(mesh, dense))
        res_fn(dist, tables, tm.shard_dense_per_device(mesh, regions))
        out[f"pre{w}"] = tm.dist_tables(dist)
        rolled = roll(dist)
        out[f"report{w}"] = _numpy(rolled[1])
        if ns == 1:
            out[f"tables{w}"] = rolled[2]
        out[f"post{w}"] = tm.dist_tables(dist)
    return out


def _exporter(spec: dict, devices: list) -> dict:
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.parallel import merge as tm
    from netobserv_tpu_torch.sketch import state as ts

    def make(reports):
        return TorchSketchExporter(
            ts.SketchConfig(**spec["geom"]), batch_size=spec["batch"],
            device="cpu", devices=devices, mesh_shape=spec["mesh_shape"],
            pack_threads=8, superbatch=(1, 2), resident_slots=1 << 12,
            sink=reports.append, query_refresh_s=0.5,
            checkpoint_dir=spec["ckpt_dir"], checkpoint_every=1)

    reports: list = []
    exp = make(reports)
    out = {"ranks": exp.mesh.ranks, "refresh_s": exp._query_refresh_s,
           "ring_made": exp.ring is not None}
    for window in spec["windows"]:
        for ev, f in window:
            exp.export_evicted(EvictedFlows(ev, **f))
        exp.roll()
    out["tables"] = exp.state_tables()
    exp.close()
    out["reports"] = reports
    out["dist"] = tm.dist_tables(exp.state)
    if distributed.process_index() == 0:
        # what rank 0 wrote, before the restored exporter rolls again
        root = Path(spec["ckpt_dir"])
        out["ckpt_files"] = {p.relative_to(root).as_posix(): p.read_bytes()
                             for p in sorted(root.rglob("*"))
                             if p.is_file()}
    again = make([])
    out["restored"] = tm.dist_tables(again.state)
    again.close()
    # a mesh of another shape (4x1 over the ranks) is refused on every
    # rank before any tensor is written
    from netobserv_tpu_torch.parallel import MeshSpec, make_mesh
    from netobserv_tpu_torch.sketch.checkpoint import SketchCheckpointer
    other = tm.init_dist_state(ts.SketchConfig(**spec["geom"]), make_mesh(
        MeshSpec(4), devices * 2))
    try:
        SketchCheckpointer(spec["ckpt_dir"]).restore(other)
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    out["untouched"] = all(float(s.total_records) == 0 and
                           not bool(s.heavy.valid.any())
                           for s in other.flat())
    return out


def _aggregator(spec: dict, devices: list) -> dict:
    from netobserv_tpu_torch.federation.aggregator import (
        FederationAggregator,
    )

    reports: list = []
    agg = FederationAggregator(spec["cfg"], window_s=3600.0,
                               mesh_shape=spec["mesh_shape"], device="cpu",
                               devices=devices, sink=reports.append,
                               checkpoint_dir=spec["ckpt_dir"],
                               checkpoint_every=1)
    out = {"ranks": agg.mesh.ranks, "acks": [], "ledgers": [],
           "snapshots": [], "ckpt_on": agg._ckpt is not None}
    for item in spec["schedule"]:
        if item == "flush":
            agg.flush()
            out["snapshots"].append(agg.snapshot())
            continue
        out["acks"].append(agg.ingest_frame(item).SerializeToString())
        out["ledgers"].append(dict(agg._ledger))
    agg.close()
    out["reports"] = reports
    root = Path(spec["ckpt_dir"])
    out["corrupt"] = sorted(p.name for p in root.parent.iterdir()
                            if p.name.startswith(root.name + ".corrupt-"))
    out["steps"] = sorted(int(p.name) for p in root.iterdir()
                          if p.name.isdigit())
    return out


SCENARIOS = {"merge": _merge, "exporter": _exporter,
             "aggregator": _aggregator}


def main(scenario: str, inp: str, outp: str) -> int:
    warnings = _Warnings()
    logging.getLogger().addHandler(warnings)
    with open(inp, "rb") as fh:
        spec = pickle.load(fh)
    devices = spec["devices"][int(os.environ.get(
        spec.get("prefix", "SKETCH_") + "PROCESS_ID", "0"))]
    out = SCENARIOS[scenario](spec, devices)
    rank = distributed.process_index()
    out["rank"] = rank
    out["process_count"] = distributed.process_count()
    out["warnings"] = warnings.messages
    with open(f"{outp}.{rank}", "wb") as fh:
        pickle.dump(out, fh)
    distributed.destroy()
    print(f"DIST_OK rank={rank} scenario={scenario}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
