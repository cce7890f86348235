"""Sketch warehouse: durable, queryable history of closed sketch windows.

Counterpart of `netobserv_tpu/archive/__init__.py` (`:41-211`). Three
pieces:

- `segment.py` — the on-disk snapshot format (TABLE_SPEC tensors through
  the shared per-tensor codec), byte for byte the reference's;
- `store.py` — the append-only directory with hierarchical RRD-style
  retention;
- `query.py` — the merge ladder on the card behind ``/query/range`` and
  ``/federation/range``, and the compactor.

`SketchArchive` is the plane's one facade: the port's exporter (and the
federation aggregator, for cluster-wide history) writes each closed
window through it at publish, off their lock, behind the
``sketch.archive_write`` fault point, and mounts its `route_payload` on
the query surface. No archive setting (`config.ArchiveSettings.
archive_dir` empty) means no archive object exists anywhere: one is-None
check on the publish path.

The reference compiles the merge ladder on a background thread
(`warm=True`); here the engine captures every ladder entry when it is
made, on the caller's thread (`archive/query.py`), so there is no warm
thread and no `warm` argument.

`TenantArchiveSet` and `tenant_archives` are the per-tenant host routing
(one store a tenant under ``<archive_dir>/tenant-<t>``, with the
reference's 400 and 404 contract): a tenant-mode exporter
(SKETCH_TENANTS) writes each tenant's window to its own store.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from netobserv_tpu_torch.archive import segment as aseg
from netobserv_tpu_torch.archive.query import ArchiveQueryEngine
from netobserv_tpu_torch.archive.store import ArchiveStore

log = logging.getLogger("netobserv_tpu_torch.archive")

__all__ = ["ArchiveQueryEngine", "ArchiveStore", "SketchArchive",
           "TenantArchiveSet", "maybe_archive", "tenant_archives"]


class SketchArchive:
    """Writer, compactor and range-query surface over one archive
    directory; its engine runs on `device` (CUDA unless the caller names
    the CPU) and captures its merge ladder when it is made."""

    def __init__(self, store: ArchiveStore, sketch_cfg, metrics=None,
                 agent_id: str = "", ladder_max: int = 16,
                 report_kwargs: Optional[dict] = None,
                 device=None):
        self._store = store
        self._agent_id = agent_id
        self.engine = ArchiveQueryEngine(store, sketch_cfg,
                                         metrics=metrics,
                                         ladder_max=ladder_max,
                                         report_kwargs=report_kwargs,
                                         device=device)

    def share_device_lock(self, lock) -> None:
        """Make every CUDA call of the engine hold `lock` too: the lock
        under which the owner (exporter or aggregator) makes its own CUDA
        calls (ROADMAP C4)."""
        self.engine.device_lock = lock

    def write_window(self, host_tables: dict, window: int,
                     ts_ms: int) -> None:
        """Land one closed window's table snapshot as a raw (level-0)
        segment, then run retention: every due compaction group merges
        through the ladder and the top level ages out. Callers hold HOST
        copies (never live state)."""
        seg_bytes = aseg.encode_segment(
            host_tables, agent_id=self._agent_id, level=0,
            window_from=int(window), window_to=int(window), n_windows=1,
            ts_ms=int(ts_ms), dims=self.engine.dims)
        with self.engine.lock:
            self._store.append(seg_bytes, 0, int(window), int(window))
        # bounded: each pass strictly shrinks some level, so the loop
        # terminates; steady state runs at most one compaction per window
        while self.engine.compact_once():
            pass
        with self.engine.lock:
            self._store.enforce_top_level_retention()

    def route_payload(self, params: dict,
                      view: Optional[str] = None) -> tuple[int, dict]:
        return self.engine.route_payload(params, view)

    def stats(self) -> dict:
        return self.engine.stats()


class TenantArchiveSet:
    """One `SketchArchive` per tenant, each over its own
    ``<archive_dir>/tenant-<t>`` store: segments, retention and range
    answers stay tenant-local. `route_payload` resolves ``?tenant=`` with
    the snapshot routes' 400/404 contract."""

    def __init__(self, archives: list):
        if not archives:
            raise ValueError("TenantArchiveSet needs >= 1 tenant archive")
        self._archives = archives

    @property
    def n_tenants(self) -> int:
        return len(self._archives)

    def share_device_lock(self, lock) -> None:
        for a in self._archives:
            a.share_device_lock(lock)

    def write_tenant_window(self, host_tables: dict, window: int,
                            ts_ms: int, tenant: int) -> None:
        self._archives[int(tenant)].write_window(host_tables, window, ts_ms)

    def route_payload(self, params: dict,
                      view: Optional[str] = None) -> tuple[int, dict]:
        if params.get("tenant") is None:
            return 400, {
                "error": "tenant is required (SKETCH_TENANTS mode)",
                "tenants": len(self._archives)}
        try:
            tid = int(params["tenant"])
        except ValueError:
            return 400, {"error": f"bad tenant {params['tenant']!r}",
                         "tenants": len(self._archives)}
        if not 0 <= tid < len(self._archives):
            return 404, {"error": f"unknown tenant {tid}",
                         "tenants": len(self._archives)}
        return self._archives[tid].route_payload(params, view)

    def stats(self) -> dict:
        per = [a.stats() for a in self._archives]
        return {
            "tenants": len(per),
            "segments": sum(p.get("segments", 0) for p in per),
            "disk_bytes": sum(p.get("disk_bytes", 0) for p in per),
            "per_tenant": {str(t): p for t, p in enumerate(per)},
        }


def _store(settings, directory: str, metrics) -> ArchiveStore:
    return ArchiveStore(directory,
                        raw_windows=settings.archive_raw_windows,
                        compact_group=settings.archive_compact_group,
                        max_levels=settings.archive_max_levels,
                        metrics=metrics)


def tenant_archives(settings, sketch_cfg, n_tenants: int, metrics=None,
                    agent_id: str = "", report_kwargs: Optional[dict] = None,
                    device=None) -> Optional[TenantArchiveSet]:
    """`maybe_archive`'s tenant-mode twin: one store a tenant under
    ``<archive_dir>/tenant-<t>``, same retention settings. None when
    `settings.archive_dir` is empty."""
    if not settings.archive_dir:
        return None
    return TenantArchiveSet([
        SketchArchive(
            _store(settings, os.path.join(settings.archive_dir,
                                          f"tenant-{t}"), metrics),
            sketch_cfg, metrics=metrics, agent_id=agent_id,
            ladder_max=settings.archive_merge_ladder_max,
            report_kwargs=report_kwargs, device=device)
        for t in range(int(n_tenants))])


def maybe_archive(settings, sketch_cfg, metrics=None, agent_id: str = "",
                  report_kwargs: Optional[dict] = None,
                  device=None) -> Optional[SketchArchive]:
    """The ARCHIVE_DIR switch (`config.ArchiveSettings`): None when
    `archive_dir` is empty, so the publish path keeps one is-None check;
    else a store over it and its archive. `report_kwargs` are the
    renderer's thresholds (None: the defaults, as the exporter's)."""
    if not settings.archive_dir:
        return None
    return SketchArchive(_store(settings, settings.archive_dir, metrics),
                         sketch_cfg, metrics=metrics, agent_id=agent_id,
                         ladder_max=settings.archive_merge_ladder_max,
                         report_kwargs=report_kwargs, device=device)
