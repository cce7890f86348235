"""On-disk segment store: append-only window archive with hierarchical
(RRD-style) retention.

A copy of `netobserv_tpu/archive/store.py` (`:1-257`): the same file
names, manifest and retention, so the same schedule of appends and
replaces leaves the same directory under either package.

Layout under ``ARCHIVE_DIR``: one file per segment, named
``seg-L<level>-<window_from>-<window_to>.seg`` (zero-padded ids so a
lexical sort is a window sort), plus an atomically-replaced
``MANIFEST.json`` (utils/atomicio) for operators. The DIRECTORY SCAN is
the source of truth on open — the manifest is a cache: a crash between a
segment rename and the manifest write loses nothing, and a crash between
a compacted segment landing and its inputs' deletion is healed by the
overlap rule below.

Retention is per level: level 0 keeps the last `raw_windows` raw
segments; once a level holds `cap + group` segments its OLDEST `group`
are handed to the compactor (`pending_compaction`), whose device-merged
super-window replaces them one level up (`replace`). The top level
(`max_levels`) deletes its oldest beyond the cap instead — total disk is
bounded by (max_levels + 1) * (cap + group - 1) segments while
arbitrarily old history survives at coarser resolution.

Crash-recovery invariant: every archived window is covered by EXACTLY ONE
segment. `replace` writes the merged segment BEFORE deleting its inputs,
so the only reachable inconsistency is an overlap (merged + leftover
inputs), which the open-time scan heals by keeping the HIGHEST level and
deleting the shadowed files — never the reverse (deleting inputs first
could lose windows).

Host-side only (numpy + os): the store never touches a device; the
compactor's MERGE runs in `archive/query.py`'s ladder of CUDA graphs.
"""

from __future__ import annotations

import logging
import os
import re
from typing import NamedTuple, Optional

from netobserv_tpu_torch.utils.atomicio import (
    write_bytes_atomic, write_json_atomic,
)

log = logging.getLogger("netobserv_tpu_torch.archive.store")

_SEG_RE = re.compile(r"^seg-L(\d+)-(\d{10})-(\d{10})\.seg$")
MANIFEST = "MANIFEST.json"


class SegInfo(NamedTuple):
    """One on-disk segment's index entry (header fields ride the file)."""

    level: int
    window_from: int
    window_to: int
    path: str
    nbytes: int

    @property
    def name(self) -> str:
        return os.path.basename(self.path)


def segment_filename(level: int, window_from: int, window_to: int) -> str:
    return f"seg-L{int(level)}-{int(window_from):010d}-" \
           f"{int(window_to):010d}.seg"


class ArchiveStore:
    """Segment index + retention policy over one archive directory.

    NOT thread-safe by itself: the owning plane (exporter timer thread or
    aggregator publish path) serializes every mutation; readers go through
    the owner's lock (`archive/query.py`)."""

    def __init__(self, directory: str, raw_windows: int = 64,
                 compact_group: int = 8, max_levels: int = 3,
                 metrics=None):
        if compact_group < 2:
            raise ValueError("compact_group must be >= 2")
        if raw_windows < compact_group:
            raise ValueError("raw_windows must be >= compact_group")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.raw_windows = int(raw_windows)
        self.compact_group = int(compact_group)
        self.max_levels = int(max_levels)
        self._metrics = metrics
        #: sorted by (window_from, level) — after the overlap heal, window
        #: ranges are disjoint, so this is also time order
        self._segments: list[SegInfo] = []
        self._scan()
        self._write_manifest()

    # --- open-time recovery ---------------------------------------------
    def _scan(self) -> None:
        found: list[SegInfo] = []
        for name in sorted(os.listdir(self._dir)):
            m = _SEG_RE.match(name)
            if not m:
                continue
            path = os.path.join(self._dir, name)
            try:
                nbytes = os.path.getsize(path)
            except OSError:
                continue
            found.append(SegInfo(int(m.group(1)), int(m.group(2)),
                                 int(m.group(3)), path, nbytes))
        # overlap heal: a crash mid-replace leaves a compacted segment AND
        # some of its (lower-level) inputs — keep the highest level, drop
        # the shadowed files (the merged segment already contains them)
        found.sort(key=lambda s: (-s.level, s.window_from))
        kept: list[SegInfo] = []
        for seg in found:
            shadowed = any(k.window_from <= seg.window_from
                           and seg.window_to <= k.window_to
                           and k.level > seg.level for k in kept)
            if shadowed:
                log.warning("archive scan: deleting %s (shadowed by a "
                            "compacted super-window — crash mid-replace)",
                            seg.name)
                self._unlink(seg)
                continue
            kept.append(seg)
        kept.sort(key=lambda s: (s.window_from, s.level))
        self._segments = kept

    def _unlink(self, seg: SegInfo) -> None:
        try:
            os.remove(seg.path)
        except OSError as exc:
            log.warning("archive: could not remove %s: %s", seg.name, exc)

    def _write_manifest(self) -> None:
        write_json_atomic(os.path.join(self._dir, MANIFEST), {
            "format": 1,
            "raw_windows": self.raw_windows,
            "compact_group": self.compact_group,
            "max_levels": self.max_levels,
            "segments": [{"file": s.name, "level": s.level,
                          "window_from": s.window_from,
                          "window_to": s.window_to, "bytes": s.nbytes}
                         for s in self._segments],
        })

    # --- mutations -------------------------------------------------------
    def append(self, seg_bytes: bytes, level: int, window_from: int,
               window_to: int) -> SegInfo:
        """Land one encoded segment durably (temp + fsync + rename + a
        directory fsync — utils/atomicio, the same discipline as every
        sidecar), THEN retire every indexed segment whose window range
        the new one intersects, then the manifest.

        The retire sweep is what keeps "every window covered by exactly
        one segment" true under BOTH writers: a compaction's merged
        super-window consumes its input group (the merged segment is
        durable before any input dies — the crash order the open-time
        heal assumes), and an agent whose window counter restarted at 0
        (no SKETCH_CHECKPOINT_DIR) overwrites the stale incarnation's
        history window-id by window-id instead of double-indexing it —
        newest write wins; a stale super-window intersecting the new id
        is forfeit (a reset counter makes its old ids ambiguous anyway)."""
        name = segment_filename(level, window_from, window_to)
        path = os.path.join(self._dir, name)
        stale = [s for s in self._segments
                 if s.window_to >= window_from
                 and s.window_from <= window_to]
        write_bytes_atomic(path, seg_bytes)
        for seg in stale:
            self._segments.remove(seg)
            if seg.path != path:  # same-id rewrite already replaced it
                self._unlink(seg)
        info = SegInfo(int(level), int(window_from), int(window_to), path,
                       len(seg_bytes))
        self._segments.append(info)
        self._segments.sort(key=lambda s: (s.window_from, s.level))
        self._write_manifest()
        if self._metrics is not None:
            self._metrics.archive_segments_total.inc()
            self._metrics.archive_bytes_total.inc(len(seg_bytes))
        return info

    def pending_compaction(self) -> Optional[tuple[int, list[SegInfo]]]:
        """(level, oldest-`group` segments) of the lowest level holding
        `cap + group` or more segments — the next compaction's input — or
        None. Levels at `max_levels` never compact (they age out via
        `enforce_top_level_retention`)."""
        for level in range(self.max_levels):
            segs = [s for s in self._segments if s.level == level]
            if len(segs) >= self.raw_windows + self.compact_group:
                return level, segs[:self.compact_group]
        return None

    def replace(self, group: list[SegInfo], merged_bytes: bytes,
                level: int, window_from: int,
                window_to: int) -> SegInfo:
        """Land a compacted super-window; append's intersection sweep
        retires the input group AFTER the merged segment is durable (the
        crash-safe order the open-time overlap heal assumes). `group` is
        advisory — the sweep retires by window range, which covers
        exactly the contiguous inputs."""
        return self.append(merged_bytes, level, window_from, window_to)

    def enforce_top_level_retention(self) -> int:
        """Delete the top level's oldest segments beyond its cap — the one
        place history is truly dropped (the disk bound's backstop).
        Returns how many were dropped."""
        top = [s for s in self._segments if s.level >= self.max_levels]
        dropped = 0
        while len(top) > self.raw_windows:
            seg = top.pop(0)
            log.info("archive retention: dropping %s (top-level cap %d)",
                     seg.name, self.raw_windows)
            self._unlink(seg)
            self._segments.remove(seg)
            dropped += 1
        if dropped:
            self._write_manifest()
        return dropped

    # --- reads -----------------------------------------------------------
    def read(self, seg: SegInfo) -> bytes:
        with open(seg.path, "rb") as fh:
            return fh.read()

    def segments(self) -> list[SegInfo]:
        return list(self._segments)

    def select(self, window_from: int, window_to: int) -> list[SegInfo]:
        """Covering segments: every segment whose window range intersects
        [window_from, window_to], oldest first. A compacted super-window
        partially inside the range is included WHOLE — range answers snap
        to segment boundaries (the payload reports the actual covered
        span)."""
        return [s for s in self._segments
                if s.window_to >= window_from
                and s.window_from <= window_to]

    def coverage(self) -> list[dict]:
        """JSON-able view of what is answerable (the 404 discovery list)."""
        return [{"level": s.level, "window_from": s.window_from,
                 "window_to": s.window_to, "bytes": s.nbytes}
                for s in self._segments]

    def total_bytes(self) -> int:
        return sum(s.nbytes for s in self._segments)

    def stats(self) -> dict:
        per_level: dict[int, int] = {}
        for s in self._segments:
            per_level[s.level] = per_level.get(s.level, 0) + 1
        return {"segments": len(self._segments),
                "segments_per_level": {str(k): v for k, v
                                       in sorted(per_level.items())},
                "disk_bytes": self.total_bytes(),
                "raw_windows": self.raw_windows,
                "compact_group": self.compact_group,
                "max_levels": self.max_levels}
