"""One run of one cell: the node agent's exporter under a closed loop of
map evictions, then the comparison with the plain reference.

The entry the window drives is the agent's own: the exporter that
`TorchSketchExporter.from_config` makes from the configuration's
environment, its window timer started as the agent starts it, and a
generator thread of the harness that hands it the pool's evictions
through `export_evicted`, the next when the call returns, as the agent's
eviction thread does.

Set-up: the pool and the order it is handed in are made from the seed
(`generator.py`), the exporter is built (its kernels built or loaded,
its graphs captured), and the first pass over the pool is handed over,
or as many evictions as the cell's settings say (`warmup_evictions`),
which warms every shape the traffic uses and brings the staging ring's
key dictionaries to their steady state; a flush then closes that window,
so the measured window starts on a fresh one, with the eviction after
the last one handed. Set-up ends at the first timed eviction.

Window: `seconds` long; the last call may end past it. The device is
synchronised at its end. With `trace`, a flush follows and a slice of
`SLICE_ROWS` rows more runs under `torch.profiler` (`profile.py`).

Every window the exporter closes (the set-up's, the measured ones, the
flush's and the one `close` publishes) reaches the harness twice: its
rendered report through the report sink, and its pre-roll tables through
the archive seam, which the harness fills with an in-memory store
(`WindowTap`). An exporter with an archive copies its whole tables to the
host at each roll, as one with ARCHIVE_DIR set does. After the run the
exporter is closed and freed, and `reference/judge.py` holds every window
against the reference, on the same device.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import generator, profile, roofline
from portbench.reference import judge, sketch
from portbench.tally import Tally

#: rows the profiled slice of a traced run hands over
SLICE_ROWS = 400_000


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its files read."""

    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    settings: dict
    end_to_end: list
    per_layer: list

    @property
    def limits(self) -> dict:
        """The limit of each number the comparison gives."""
        return self.settings["limits"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, its configuration, mix
    and settings (`cells/<name>.json`: the limits of the comparison and
    the evictions set-up hands over) found by name under the benchmark's
    folder, and the metrics
    it reports: an end-to-end metric without `workloads` is every cell's;
    a per-layer metric is the cells' it lists, or without the key every
    cell's that reports the metric it moves."""
    bench = load_json(root / "BENCHMARK.json")
    here = Path(__file__).resolve().parent
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, conf["name"], w["traffic"], int(w["chips"]),
                load_json(root / conf["file"]),
                generator.load_mix(here, w["traffic"]),
                load_json(here / "cells" / f"{name}.json"), e2e, layer)


def reader(name: str):
    """The `read(run)` function of metric `name`, from
    `metrics/<name>.py`, or where there is no such file from the file of
    the name's first part (`records_per_s.resident` reads as
    `records_per_s`: the same quantity in other cells)."""
    here = Path(__file__).resolve().parent / "metrics"
    path = here / f"{name}.py"
    if not path.is_file():
        path = here / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class WindowTap:
    """The archive seam's in-memory store: each closed window's pre-roll
    tables, by window id, in the order they close."""

    def __init__(self):
        self._lock = threading.Lock()
        self.windows: list[tuple[int, dict]] = []

    def write_window(self, tables: dict, window: int, ts_ms: int) -> None:
        with self._lock:
            self.windows.append((int(window), tables))


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    device: torch.device
    batch_size: int
    records: int = 0
    seconds: float = 0.0
    cpu_s: float = 0.0
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    latencies: list = field(default_factory=list)
    before: dict = field(default_factory=dict)
    after: dict = field(default_factory=dict)
    slice: profile.Slice | None = None
    slice_rows: int = 0
    slice_cols: list = field(default_factory=list)
    peak: dict = field(default_factory=dict)
    pool: generator.Pool | None = None

    @property
    def geometry(self) -> sketch.Geometry:
        return sketch.Geometry.from_dict(self.cell.config["geometry"])

    def delta(self, key: str) -> float:
        return self.after[key] - self.before[key]

    def tally_delta(self, key: tuple, what: str = "total") -> float:
        i = 0 if what == "count" else 1
        return self.after["tally"][i].get(key, 0) - \
            self.before["tally"][i].get(key, 0)


def _counters(exp, tally: Tally) -> dict:
    ring = exp.ring
    return {"pack_seconds": ring.pack_seconds,
            "dict_resets": getattr(ring, "dict_resets", 0),
            "superbatch_folds": dict(getattr(ring, "superbatch_folds", {})),
            "folds": exp.folds, "rolls": exp.rolls, "tally": tally.snapshot()}


def _dtypes() -> dict:
    from netobserv_tpu_torch.model import binfmt
    return {"event": binfmt.FLOW_EVENT_DTYPE, "extra": binfmt.EXTRA_REC_DTYPE,
            "dns": binfmt.DNS_REC_DTYPE, "drops": binfmt.DROPS_REC_DTYPE,
            "xlat": binfmt.XLAT_REC_DTYPE, "quic": binfmt.QUIC_REC_DTYPE}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             process_start: float, env: dict | None = None,
             peak: dict | None = None) -> dict:
    """One run (module docstring). Returns {"run": Run, "numbers": the
    judge's numbers, "windows": closed windows, "attempted", "failed"}.
    `env` overrides the configuration's environment (tests)."""
    from netobserv_tpu_torch.config import load_config
    from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.utils import tracing

    pool = generator.make_pool(cell.mix, seed, _dtypes())
    evs = [EvictedFlows(e, **lanes) for e, lanes in zip(pool.events,
                                                         pool.lanes)]
    cfg = load_config({**cell.config["env"], **(env or {})})
    cfg.validate()
    tracing.configure(1.0 if trace else 0.0)
    tally, tap, reports = Tally(), WindowTap(), {}
    exp = TorchSketchExporter.from_config(
        cfg, metrics=tally, sink=lambda obj: reports.__setitem__(
            int(obj["Window"]), obj))
    exp._archive = tap  # the archive seam (module docstring)
    cuda = exp.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(exp.device)) if cuda else \
        (lambda: None)
    run = Run(cell, exp.device, cfg.sketch_batch_size, peak=peak or {})
    n_pool = len(evs)
    order = generator.hand_order(cell.mix, seed).tolist()
    sequence: list[int] = []

    def hand(i: int) -> int:
        j = order[i % len(order)]
        exp.export_evicted(evs[j])
        sequence.append(j)
        return j

    warm = int(cell.settings.get("warmup_evictions", n_pool))
    for i in range(warm):
        hand(i)
    exp.flush()
    sync()

    state = {"rows": 0, "error": None}

    def loop(t_end: float) -> None:
        try:
            i = warm
            while True:
                a = time.perf_counter()
                j = hand(i)
                b = time.perf_counter()
                run.latencies.append(b - a)
                state["rows"] += len(evs[j])
                i += 1
                if b >= t_end:
                    return
        except BaseException as exc:  # re-raised on the main thread
            state["error"] = exc

    run.before = _counters(exp, tally)
    run.setup_s = time.time() - process_start
    cpu0, t0 = time.process_time(), time.perf_counter()
    gen = threading.Thread(target=loop, args=(t0 + seconds,),
                           name="portbench-generator")
    gen.start()
    gen.join()
    if state["error"] is not None:
        raise state["error"]
    sync()
    run.seconds = time.perf_counter() - t0
    run.cpu_s = time.process_time() - cpu0
    run.records = state["rows"] - len(exp.pending)
    run.after = _counters(exp, tally)
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(exp.device)

    if trace and cuda:
        exp.flush()
        k = max(1, math.ceil(SLICE_ROWS / len(evs[0])))
        first = len(sequence)

        def slice_fn():
            with torch.profiler.record_function("portbench.generator"):
                for i in range(k):
                    with torch.profiler.record_function(
                            "portbench.export_evicted"):
                        hand(first + i)

        run.slice = profile.trace(slice_fn)
        run.slice_rows = sum(len(evs[i]) for i in sequence[first:]) - \
            len(exp.pending)
        run.slice_cols = [sequence[i] for i in range(first, len(sequence))]
    exp.close()
    del exp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    geo = run.geometry
    feed = cell.config["env"].get("SKETCH_FEED", "resident")
    ref = []
    for i in range(n_pool):
        cols = sketch.columns(pool.events[i], pool.lanes[i])
        ref.append((sketch.eviction_tables(cols, geo, feed, run.device),
                    torch.as_tensor(pool.flow_ids[i], device=run.device),
                    len(pool.events[i])))
    timer = range(run.before["rolls"], run.after["rolls"])
    windows = [{"window": w, "tables": t, "report": reports.get(w),
                "full": w in timer} for w, t in tap.windows]
    detail: list = []
    numbers = judge.judge(geo, ref, sequence, windows, run.device, detail)
    run.pool = pool
    return {"run": run, "numbers": numbers, "windows": detail,
            "attempted": len(sequence),
            "failed": int(numbers["evictions_lost"])}


def slice_folds(run: Run) -> list[dict]:
    """The rows of each fold of the profiled slice, as reference columns
    on the run's device: the slice starts on an empty pending buffer, so
    its folds are the consecutive whole batches of its rows."""
    cols = [sketch.columns(run.pool.events[i], run.pool.lanes[i])
            for i in run.slice_cols]
    cat = {k: torch.as_tensor(np.concatenate([c[k] for c in cols]),
                              device=run.device) for k in cols[0]}
    n = len(cat["bytes"]) // run.batch_size * run.batch_size
    return [{k: v[a:a + run.batch_size] for k, v in cat.items()}
            for a in range(0, n, run.batch_size)]


def kernel_bounds(run: Run) -> tuple[float, float] | None:
    """(bound seconds, device seconds) of the `csrc/` kernels in the
    profiled slice, or None when the trace does not hold one launch set
    per fold of the slice."""
    if run.slice is None or not run.slice.kernels:
        return None
    folds = slice_folds(run)
    launched: dict[str, int] = {}
    dev_s = 0.0
    for name, _, dur in run.slice.kernels:
        k = roofline.csrc_kernel(name)
        if k is not None:
            launched[k] = launched.get(k, 0) + 1
            dev_s += dur
    want = {k: n * len(folds) for k, n in roofline.CSRC_KERNELS.items() if n}
    if launched != want or not folds:
        return None
    topk = int(run.cell.config["env"].get("SKETCH_TOPK", "1024"))
    bound = sum(sum(roofline.fold_bounds(f, run.geometry, topk,
                                         run.peak).values())
                for f in folds)
    return bound, dev_s
