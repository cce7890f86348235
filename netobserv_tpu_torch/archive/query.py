"""Device-merged time-range queries over the archive, and the compactor
that shares their merges.

Counterpart of `netobserv_tpu/archive/query.py` (`ArchiveQueryEngine`,
`:58-349`). The range plane answers ``/query/range?from=&to=`` (and the
``topk | frequency | cardinality | victims`` views) by selecting the
covering segments and merging their table snapshots in one fixed-shape
dispatch of a LADDER of merge sizes (powers of two up to `ladder_max`).
K segments pad up to the next ladder size with zero tables, the exact
merge identity, so shapes never depend on the request; ranges wider than
`ladder_max` chain, each dispatch's merged tables re-entering the next as
its first input. Merge semantics are `federation/statemerge.merge_tables`,
so a range over raw segments is bit-exact against the union roll in the
integer regime, and the rendered report flows through the port's
`exporter/report.report_to_json` and `query/core` payloads. The compactor
is the same machinery pointed at retention. `VIEWS`, `_zero_template`,
`_ladder_fit`, `merge_tables_host`, `_decode_checked`, `compact_once`,
`range_snapshot`, `route_payload`, `_route` and `stats` are the
reference's.

**The ladder on the card.** The reference jits one merge per ladder size
(`:109-134`). Here each entry is one CUDA graph
(`sketch/capture.CapturedFold`, watched by `utils/retrace` as
``archive_merge_x{k}``), and every entry is captured when the engine is
made, so no thread's CUDA work can meet a later capture of the engine's
(ROADMAP C4). The entries share one device buffer of `ladder_max` stacked
snapshots and its pinned host twin (`federation/statemerge.TableStack`,
the aggregator's frame layout: uint32 lanes cross as int32 bits and widen
to int64 on the device); entry k binds its k-prefix. Inside each graph:
zero a merge state made once, run the k in-place merges, write the
pre-roll tables into an output TableStack, roll, and copy the report into
report tensors made once. Outside it: one asynchronous copy of the
k-prefix in, and the copies of the merged tables and the report to the
host. On the CPU the entries merge eagerly, op by op, each watched under
its name.

**Locks.** `lock` (reentrant) serializes the store, the decodes and the
merges, as in the reference. Every CUDA call of the engine also holds
`device_lock`: a lock of the engine's own, or the lock of the exporter or
aggregator that archives through it (`SketchArchive.share_device_lock`),
which keeps every CUDA call of their window plane under one lock (ROADMAP
C4). Segment decodes and report renders run outside `device_lock`.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from netobserv_tpu_torch.archive import segment as aseg
from netobserv_tpu_torch.archive.store import ArchiveStore, SegInfo
from netobserv_tpu_torch.exporter.report import report_numpy, report_to_json
from netobserv_tpu_torch.federation import delta as fdelta
from netobserv_tpu_torch.federation import statemerge
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch.capture import CapturedFold, clone
from netobserv_tpu_torch.utils import retrace
from netobserv_tpu_torch.utils.platform import pick_device

log = logging.getLogger("netobserv_tpu_torch.archive.query")

#: range views and their query-core payload builders ("" = summary)
VIEWS = ("", "summary", "topk", "frequency", "cardinality", "victims")


def _zero_(x) -> None:
    """Zero every tensor of a (nested) state in place."""
    if isinstance(x, torch.Tensor):
        x.zero_()
    elif isinstance(x, tuple):
        for v in x:
            _zero_(v)


class ArchiveQueryEngine:
    """The merge ladder and range rendering over one ArchiveStore, on
    `device` (CUDA unless the caller names the CPU)."""

    def __init__(self, store: ArchiveStore, sketch_cfg, metrics=None,
                 ladder_max: int = 16,
                 report_kwargs: Optional[dict] = None,
                 device: str | torch.device | None = None):
        if ladder_max < 1 or ladder_max & (ladder_max - 1):
            raise ValueError("ladder_max must be a power of two >= 1")
        self.device = pick_device(device)
        self._store = store
        # the ladder merges the canonical WIDE layout: a tiered exporter
        # archives its decoded wide tables
        self._cfg = sketch_cfg._replace(tiered=None) \
            if sketch_cfg.tiered is not None else sketch_cfg
        self._metrics = metrics
        self._report_kwargs = report_kwargs or {}
        self.ladder = tuple(1 << i for i in range(ladder_max.bit_length()))
        #: serializes the store, the decodes and the merges
        self.lock = threading.RLock()
        #: held by every CUDA call of the engine (module docstring)
        self.device_lock = threading.Lock()
        self._zero_tables: Optional[dict] = None
        self._expected_shapes: Optional[dict] = None
        self.dims = {"cm_depth": self._cfg.cm_depth,
                     "cm_width": self._cfg.cm_width,
                     "hll_precision": self._cfg.hll_precision,
                     "topk": self._cfg.topk,
                     "ewma_buckets": self._cfg.ewma_buckets}
        shapes = {n: z.shape for n, z in self._zero_template().items()}
        with self._on_device():
            self._state = sk.init_state(self._cfg, self.device)
            self._in = statemerge.TableStack(shapes, self.ladder[-1],
                                             self.device)
            self._out = statemerge.TableStack(shapes, 1, self.device)
            self._out_views = self._out.host_views()
            # report tensors made once, shaped as a roll's report
            _, report = sk.roll_window(self._state, self._cfg)
            self._report = clone(report)
            if self.device.type == "cuda":
                pool = torch.cuda.graph_pool_handle()
                self._entries = {}
                for k in self.ladder:
                    entry = CapturedFold(f"archive_merge_x{k}",
                                         functools.partial(self._merge_k, k),
                                         pool)
                    entry.prepare(*self._args(k))
                    self._entries[k] = entry
            else:
                self._entries = {
                    k: retrace.watch(functools.partial(self._merge_k, k),
                                     f"archive_merge_x{k}")
                    for k in self.ladder}

    # --- ladder ----------------------------------------------------------
    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _zero_template(self) -> dict:
        """Host zero tables in spec dtypes — the pad identity."""
        if self._zero_tables is None:
            tables = sk.state_tables(sk.init_state(self._cfg, "cpu"))
            self._zero_tables = {
                name: np.zeros(np.asarray(tables[name]).shape, dt)
                for name, dt in fdelta.TABLE_SPEC}
            self._expected_shapes = {n: a.shape for n, a
                                     in self._zero_tables.items()}
        return self._zero_tables

    def _args(self, k: int) -> tuple:
        """Entry k's arguments: the merge state, the k-prefix of the
        stacked buffer, the output buffer and the report tensors."""
        return (self._state, self._in.dev[:k * self._in.words],
                self._out.dev, self._report)

    def _merge_k(self, k: int, state: sk.SketchState, stacked: torch.Tensor,
                 out: torch.Tensor, report: sk.WindowReport) -> None:
        """The ladder-k merge: k stacked snapshots into a fresh state, the
        pre-roll tables into `out`, then the roll's report into
        `report`."""
        _zero_(state)  # init_state is all zeros
        for i in range(k):
            statemerge.merge_tables(state, self._in.device_tables(stacked, i))
        self._out.write_(out, sk.table_tensors(state))
        _, rep = sk.roll_window(state, self._cfg)
        sk.copy_state_(report, rep)

    def _ladder_fit(self, n: int) -> int:
        for k in self.ladder:
            if k >= n:
                return k
        return self.ladder[-1]

    def _dispatch(self, table_dicts: list[dict]) -> tuple:
        """Merge up to ladder_max snapshots in one dispatch (padding with
        the zero identity). Returns (host report, host tables)."""
        n = len(table_dicts)
        k = self._ladder_fit(n)
        words = self._in.words
        for i, tables in enumerate(table_dicts):
            for name, view in self._in.host_views(i).items():
                np.copyto(view, tables[name], casting="unsafe")
        self._in.host[n * words:k * words].zero_()
        with self.device_lock, self._on_device():
            stacked = self._in.dev[:k * words]
            stacked.copy_(self._in.host[:k * words], non_blocking=True)
            self._entries[k](self._state, stacked, self._out.dev,
                             self._report)
            self._out.host.copy_(self._out.dev)  # waits for the merge
            report = report_numpy(self._report)
        return report, {name: np.array(v)
                        for name, v in self._out_views.items()}

    def merge_tables_host(
            self, table_dicts: list[dict]) -> tuple[object, dict, int]:
        """Merge an arbitrary number of table snapshots, chaining
        dispatches past ladder_max. Returns (host report of the final
        merge, HOST copies of the merged tables, dispatch count). Caller
        holds the engine lock."""
        if not table_dicts:
            raise ValueError("nothing to merge")
        n_merges = 0
        cap = self.ladder[-1]
        pending = list(table_dicts)
        while True:
            chunk, pending = pending[:cap], pending[cap:]
            report, host = self._dispatch(chunk)
            n_merges += 1
            if not pending:
                return report, host, n_merges
            # the merged snapshot re-enters as one more input (same
            # TABLE_SPEC shapes by construction)
            pending = [host] + pending

    # --- segment plumbing -------------------------------------------------
    def _decode_checked(self, seg: SegInfo) -> aseg.Segment:
        decoded = aseg.decode_segment(self._store.read(seg))
        self._zero_template()  # ensures _expected_shapes
        for name, arr in decoded.tables.items():
            want = self._expected_shapes[name]
            if tuple(arr.shape) != tuple(want):
                raise aseg.ArchiveSegmentError(
                    f"segment {seg.name}: tensor {name!r} shape "
                    f"{tuple(arr.shape)} != this config's {tuple(want)} "
                    "(the archive was written by a different "
                    "SketchConfig)")
        return decoded

    def compact_once(self) -> bool:
        """Merge one pending retention group into a super-window one level
        up (store.replace lands it before the inputs die). Returns True
        when a compaction ran."""
        with self.lock:
            pending = self._store.pending_compaction()
            if pending is None:
                return False
            level, group = pending
            decoded = [self._decode_checked(s) for s in group]
            _report, merged, _n = self.merge_tables_host(
                [d.tables for d in decoded])
            seg_bytes = aseg.encode_segment(
                merged, agent_id=decoded[-1].agent_id, level=level + 1,
                window_from=group[0].window_from,
                window_to=group[-1].window_to,
                n_windows=sum(d.n_windows for d in decoded),
                ts_ms=max(d.ts_ms for d in decoded), dims=self.dims)
            self._store.replace(group, seg_bytes, level + 1,
                                group[0].window_from,
                                group[-1].window_to)
        if self._metrics is not None:
            self._metrics.archive_compactions_total.inc()
        log.info("archive compaction: L%d windows [%d, %d] -> L%d",
                 level, group[0].window_from, group[-1].window_to,
                 level + 1)
        return True

    # --- range answers ----------------------------------------------------
    def range_snapshot(self, window_from: int,
                       window_to: int) -> Optional[dict]:
        """Merge the covering segments into one snapshot dict shaped like
        the live query plane's (`query/core.py` contract: window / ts_ms /
        seq / report / cm planes) plus the range metadata. None when no
        archived window intersects the range."""
        t0 = time.perf_counter()
        with self.lock:
            segs = self._store.select(window_from, window_to)
            if not segs:
                return None
            decoded = [self._decode_checked(s) for s in segs]
            report, merged, n_merges = self.merge_tables_host(
                [d.tables for d in decoded])
            obj = report_to_json(report, **self._report_kwargs)
        covered = (segs[0].window_from, segs[-1].window_to)
        obj["Type"] = "sketch_range_report"
        obj["Window"] = covered[1]
        obj["WindowFrom"], obj["WindowTo"] = covered
        obj["TimestampMs"] = max(d.ts_ms for d in decoded)
        snap = {
            "window": covered[1],
            "ts_ms": obj["TimestampMs"],
            "seq": 0,  # range answers are derived, not published — no seq
            "report": obj,
            "cm_bytes": merged["cm_bytes"],
            "cm_pkts": merged["cm_pkts"],
            "range": {
                "requested": [int(window_from), int(window_to)],
                "covered": [covered[0], covered[1]],
                "windows_merged": sum(d.n_windows for d in decoded),
                "segments_merged": len(segs),
                "merge_dispatches": n_merges,
                "compacted": any(s.level > 0 for s in segs),
                "merge_seconds": round(time.perf_counter() - t0, 6),
            },
        }
        return snap

    def route_payload(self, params: dict,
                      view: Optional[str] = None) -> tuple[int, dict]:
        """The `/query/range` (and `/federation/range`) body builder.
        Returns (status, JSON-able body); every request is counted in
        ``archive_range_requests_total{result}``."""
        code, body = self._route(params, view)
        if self._metrics is not None:
            result = ("ok" if code == 200 else
                      "bad_request" if code == 400 else
                      "not_found" if code == 404 else "error")
            self._metrics.archive_range_requests_total.labels(result).inc()
        return code, body

    def _route(self, params: dict,
               view: Optional[str]) -> tuple[int, dict]:
        view = (view or params.get("view") or "").strip()
        if view not in VIEWS:
            return 404, {"error": f"unknown range view {view!r}",
                         "views": [v for v in VIEWS if v]}
        try:
            window_from = int(params["from"])
            window_to = int(params["to"])
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "from and to window ids are required "
                                  "(?from=<id>&to=<id>)"}
        if window_to < window_from:
            return 400, {"error": f"empty range [{window_from}, "
                                  f"{window_to}]"}
        try:
            snap = self.range_snapshot(window_from, window_to)
        except Exception as exc:
            log.error("range query [%d, %d] failed: %s", window_from,
                      window_to, exc)
            return 500, {"error": str(exc)}
        if snap is None:
            return 404, {"error": f"no archived windows in "
                                  f"[{window_from}, {window_to}]",
                         "coverage": self._store.coverage()}
        from netobserv_tpu_torch.query import core as qcore
        rng = snap["range"]
        if view in ("", "summary"):
            body = qcore.cardinality_payload(snap)
            bars = qcore.cm_error_bars(snap)
            if bars is not None:
                body.update(bars)
        elif view == "topk":
            body = qcore.topk_payload(snap, params.get("n", 100))
        elif view == "cardinality":
            body = qcore.cardinality_payload(snap)
        elif view == "victims":
            body = qcore.victims_payload(snap)
        else:  # frequency
            if not params.get("src") or not params.get("dst"):
                return 400, {"error": "src and dst are required"}
            body = qcore.frequency_payload(
                snap, params["src"], params["dst"],
                int(params.get("src_port", 0)),
                int(params.get("dst_port", 0)),
                int(params.get("proto", 0)))
        body["range"] = rng
        return 200, body

    def stats(self) -> dict:
        with self.lock:
            out = self._store.stats()
        out["ladder"] = list(self.ladder)
        # every entry is made (on CUDA, captured) with the engine
        out["warmed"] = sorted(self._entries)
        return out
