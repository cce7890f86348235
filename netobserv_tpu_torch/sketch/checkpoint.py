"""Versioned checkpoints of a sketch state, written without orbax.

Counterpart of `netobserv_tpu/sketch/checkpoint.py` (`:1-223`). The
reference saves the state pytree with orbax, which the card's machine
does not have; here the tensors are a file of the port's own, and
everything around them is the reference's:

- `CHECKPOINT_FORMAT_VERSION` 3 and the `FORMAT.json` stamp
  (`format_version`, `table_spec_crc`, `delta_format_version`), checked by
  `check_format` before any tensor is read: the current version restores,
  a table-spec fingerprint from another build is refused, the legacy
  unstamped era (a missing or torn stamp reads as version 1) restores
  through the identity upgrader, and every other version, 2 included, is
  refused;
- the per-step ledger sidecars `META-<step>.json` (pruned to the retained
  steps) and the publish-commit marker `PUBLISHED.json` of the federation
  aggregator;
- `latest_step`, `max_to_keep=3` and `close` (which here frees the host
  buffers: every write ends inside `save`).

Every sidecar goes through `utils/atomicio`, so `FORMAT.json`,
`META-<step>.json` and `PUBLISHED.json` are byte for byte the reference's
for the same inputs, and `check_format` gives the same verdict on either.
The tensors are not interchangeable: the port reads no orbax checkpoint,
and the reference reads none of the port's (ROADMAP C5).

**The tensor file.** One integer-named directory a step, `<step>/`,
holding `state.npz`: the wide `SketchState` as the flat dict of
`sketch/carry` (the JAX package's dotted field paths and dtypes, uint32
lanes as uint32), written by `np.savez` into a temporary directory,
fsynced, and renamed into place when complete; `np.load` reads it with
`allow_pickle=False`, so no pickled object is ever loaded. A step without
its `state.npz` (a crash before the rename) does not exist. A tiered state
checkpoints its wide decode (`sketch/tiered.decode_state`), as the
reference's exporter does.

**A mesh's state** (`parallel/merge.DistState`) checkpoints in the
reference's leading-axis layout (`parallel/merge.dist_tables`): every
leaf `[n_data, ...]`, the Count-Min planes `[n_data, depth, width]` and
the slot table `[n_data, n_sketch, ...]`, under the same dotted paths. The
sidecars are the same files, byte for byte. A restore checks that layout
against the target's and copies each part into its shards in place, every
sketch replica of a data shard included, so captured graphs stay bound; a
one-device checkpoint does not restore into a mesh, nor the reverse.

**A mesh that spans processes** (`parallel/distributed.py`) checkpoints
into a directory every rank shares, as orbax requires of multi-host
saves. `stage` is then a collective: each rank copies its own parts to
the host and rank 0 gathers the others'; only rank 0 writes (the tensor
file, the stamp and the sidecars), so its file equals, byte for byte, the
file a one-process mesh of the same shape writes for the same tables. A
restore is a collective too: every rank reads the file and checks it
against its own layout, the ranks agree on the verdict, and only then
does each copy its own parts in place; a mesh of another shape, on any
rank, raises on every rank before any tensor is written. The file holds
the mesh's layout, not the process count: a mesh of the same shape over
another number of processes restores it.

**Restore** checks every path, shape and dtype of the file against the
target state, as orbax's structural check does, and raises on a mismatch
before it writes a tensor; then it copies each tensor into the target in
place. The exporter's and the aggregator's CUDA graphs are bound to their
state's storage, so a restore that swapped in new tensors would make every
graph capture again.

**Save** is two steps. `stage` copies the state into host buffers made
once (pinned on CUDA) and waits for the copy: the callers take it under
their lock, at the roll. `save` writes a staged copy in the calling
thread, which the callers run off their lock, on the thread that
publishes the window (orbax's save is asynchronous instead, and its next
save waits for the last). There are two buffer sets, so a stage never
waits for a write in progress, however long the disk hangs: a staged copy
holds its set until it is written or released (`release`), and the next
stage takes the other set, or the set of the unwritten copy it
supersedes (a roll's checkpoint not yet written when the next roll
stages its own).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from netobserv_tpu_torch.federation import delta as fdelta
from netobserv_tpu_torch.parallel import distributed
from netobserv_tpu_torch.sketch import carry
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.utils.atomicio import fsync_dir, write_json_atomic

log = logging.getLogger("netobserv_tpu_torch.sketch.checkpoint")

#: checkpoint FORMAT version, stamped next to every save (the reference's:
#: v3 is the persistent-slot heavy-hitter table; v2 has no upgrade path)
CHECKPOINT_FORMAT_VERSION = 3
_LEGACY_VERSION = 1
_STAMP_FILE = "FORMAT.json"
_STATE_FILE = "state.npz"
_TMP_PREFIX = ".tmp-"

#: known upgrade paths: stamped version -> upgrader of the flat field dict
#: (identity where the layout itself is compatible); missing = reject
_UPGRADERS = {_LEGACY_VERSION: lambda fields: fields}

#: the JAX dtype each port dtype of a wide state is checkpointed as
_JAX_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
               torch.bool: np.bool_, torch.int64: np.uint32}


def _spec_fingerprint() -> int:
    return fdelta.table_spec_fingerprint()


def _writer() -> bool:
    """Whether this process writes checkpoint files: rank 0, or the only
    process."""
    return distributed.process_index() == 0


class Staged(NamedTuple):
    """A host copy taken by `stage`: its buffer set and that set's
    generation (a later stage into the set supersedes it)."""

    index: int
    generation: int


class SketchCheckpointer:
    """Versioned checkpoints of a wide sketch state under `directory`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = int(max_to_keep)
        for name in (os.listdir(self._dir) if _writer() else []):
            # a crash mid-write leaves these
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)
        #: two host buffer sets (path -> tensor), made at their first stage,
        #: and what each holds: None (free), ("staged", generation) or
        #: ("writing", generation)
        self._sets: list[Optional[dict]] = [None, None]
        self._sets_state: list[Optional[tuple]] = [None, None]
        self._generation = 0
        #: guards _sets_state and _generation; a set's tensors are touched
        #: only by the one caller that holds its state
        self._state_lock = threading.Lock()

    # --- format stamp ----------------------------------------------------
    def _stamp_path(self) -> str:
        return os.path.join(self._dir, _STAMP_FILE)

    def _write_stamp(self) -> None:
        if not _writer():
            return
        stamp = {"format_version": CHECKPOINT_FORMAT_VERSION,
                 "table_spec_crc": _spec_fingerprint(),
                 "delta_format_version": fdelta.DELTA_FORMAT_VERSION}
        # temp + fsync + rename: a torn stamp must never misread as legacy
        write_json_atomic(self._stamp_path(), stamp)

    def read_stamp(self) -> dict:
        """The directory's format stamp; legacy (pre-stamp) checkpoints
        report version 1."""
        try:
            with open(self._stamp_path()) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return {"format_version": _LEGACY_VERSION}

    def check_format(self) -> Optional[int]:
        """Validate the stamp BEFORE any tensor restore. Returns the
        stamped version when an upgrade path exists (None = current);
        raises RuntimeError when the checkpoint must be rejected."""
        stamp = self.read_stamp()
        version = int(stamp.get("format_version", _LEGACY_VERSION))
        if version == CHECKPOINT_FORMAT_VERSION:
            crc = stamp.get("table_spec_crc")
            if crc is not None and crc != _spec_fingerprint():
                raise RuntimeError(
                    f"checkpoint under {self._dir} stamps format "
                    f"{version} but a different table-snapshot layout "
                    f"(crc {crc} != {_spec_fingerprint()}): the layout "
                    "changed without a format bump — refuse rather than "
                    "restore silently-misaligned tables")
            return None
        if version in _UPGRADERS:
            return version
        raise RuntimeError(
            f"checkpoint under {self._dir} has format version {version}; "
            f"this build reads {CHECKPOINT_FORMAT_VERSION} (known upgrade "
            f"paths: {sorted(_UPGRADERS)}) — refusing to restore")

    # --- steps -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """The complete steps on disk, ascending."""
        steps = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self._dir, name, _STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # --- save ------------------------------------------------------------
    def stage(self, state, replace: Optional[Staged] = None) -> Staged:
        """Copy a wide state (or a mesh's `DistState`) into a host buffer
        set and wait for the copy (callers hold their lock; no disk I/O
        here). The set is the one of `replace`, a staged copy this one
        supersedes, while that is still unwritten; else a free one. A
        staged copy holds its set until it is written (`save`) or released
        (`release`)."""
        layout = self._layout(state, reading=True)
        with self._state_lock:
            if replace is not None and self._sets_state[
                    replace.index] == ("staged", replace.generation):
                i = replace.index
            else:
                free = [j for j in (0, 1) if self._sets_state[j] is None]
                if not free:
                    raise RuntimeError(
                        "both checkpoint buffer sets hold unwritten "
                        "copies; pass the one this stage supersedes")
                i = free[0]
            self._generation += 1
            staged = Staged(i, self._generation)
            self._sets_state[i] = ("staged", staged.generation)
        dev = state.window.device
        bufs = self._sets[i]
        if bufs is None:
            pin = dev.type == "cuda"
            bufs = self._sets[i] = {
                p: torch.zeros(shape, dtype=dtype, pin_memory=pin)
                for p, shape, dtype, _ in layout}
        devs = set()
        for p, _, _, parts in layout:
            for idx, ts in parts:
                bufs[p][idx].copy_(ts[0], non_blocking=True)
                devs.add(ts[0].device)
        for d in devs:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
        if distributed.process_count() > 1:
            self._gather_parts(layout, bufs)
        return staged

    @staticmethod
    def _gather_parts(layout: list, bufs: dict) -> None:
        """Rank 0 takes every other rank's parts into its buffers (a
        collective of every rank's `stage`)."""
        mine = [[(idx, bufs[p][idx].numpy().copy()) for idx, _ in parts]
                for p, _, _, parts in layout]
        every = distributed.gather_object(mine)
        if every is None:
            return
        for (p, *_), *rank_parts in zip(layout, *every):
            for parts in rank_parts:
                for idx, part in parts:
                    bufs[p][idx].copy_(torch.from_numpy(part))

    def release(self, staged: Staged) -> None:
        """Give back a staged copy that will not be written (a no-op once
        it is written or superseded)."""
        with self._state_lock:
            if self._sets_state[staged.index] == ("staged",
                                                  staged.generation):
                self._sets_state[staged.index] = None

    @staticmethod
    def _layout(state, reading: bool = False) -> list[tuple]:
        """(dotted path, shape, dtype, parts) of each leaf to checkpoint, a
        part (index into the leaf, the tensors that hold it): a wide state
        leaf for leaf, a mesh's in the leading-axis layout
        (`parallel/merge.dist_layout`, `reading` for a stage)."""
        from netobserv_tpu_torch.parallel import merge as pmerge
        if isinstance(state, pmerge.DistState):
            return pmerge.dist_layout(state, reading)
        if not isinstance(state, sk.SketchState):
            raise TypeError("a checkpoint holds a wide SketchState or a "
                            "mesh's DistState; stage a tiered state's "
                            "decode (tiered.decode_state)")
        out = []
        for p in carry.field_paths():
            t = carry.get_leaf(state, p)
            out.append((p, tuple(t.shape), t.dtype, [((), [t])]))
        return out

    def save(self, step: int, state) -> None:
        """Write `state` (a wide state, or a `Staged` host copy) as `step`,
        in the calling thread; an error raises."""
        staged = state if isinstance(state, Staged) else self.stage(state)
        if not _writer():
            self.release(staged)  # rank 0 writes the gathered copy
            return
        self._write(int(step), staged)

    def _write(self, step: int, staged: Staged) -> None:
        """Write a staged host copy as `step`: the tensor file under a
        temporary name, renamed when complete, then the stamp, then the
        retention sweep; the copy's set is free again after."""
        i = staged.index
        with self._state_lock:
            if self._sets_state[i] != ("staged", staged.generation):
                raise RuntimeError(f"checkpoint of step {step} was "
                                   "superseded by a later stage")
            self._sets_state[i] = ("writing", staged.generation)
        try:
            fields = {p: t.numpy().astype(np.uint32)
                      if t.dtype == torch.int64 else t.numpy()
                      for p, t in self._sets[i].items()}
            tmp = os.path.join(self._dir, f"{_TMP_PREFIX}{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            path = os.path.join(tmp, _STATE_FILE)
            with open(path, "wb") as fh:
                np.savez(fh, **fields)
                fh.flush()
                os.fsync(fh.fileno())
            final = os.path.join(self._dir, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            fsync_dir(self._dir)
        finally:
            with self._state_lock:
                self._sets_state[i] = None
        self._write_stamp()
        if self._max_to_keep > 0:
            for old in self.all_steps()[:-self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)

    # --- per-step JSON metadata sidecars (federation aggregator ledger) --
    # Contract (the reference's): write the sidecar for step N BEFORE
    # saving step N's tensors; restore reads the sidecar of the step it
    # restored, so (state, ledger) pairs never tear.

    def _meta_path(self, step: int) -> str:
        return os.path.join(self._dir, f"META-{int(step)}.json")

    def save_metadata(self, step: int, meta: dict) -> None:
        """Atomically write step-paired JSON metadata (call BEFORE save());
        old sidecars beyond the retention are pruned."""
        if not _writer():
            return
        write_json_atomic(self._meta_path(step),
                          {"step": int(step), "meta": meta})
        keep = set(self.all_steps()) | {int(step)}
        for name in os.listdir(self._dir):
            if name.startswith("META-") and name.endswith(".json"):
                try:
                    s = int(name[len("META-"):-len(".json")])
                except ValueError:
                    continue
                if s not in keep:
                    try:
                        os.remove(os.path.join(self._dir, name))
                    except OSError:
                        pass

    def read_metadata(self, step: Optional[int] = None) -> Optional[dict]:
        """The metadata paired with `step` (default: latest step). None when
        the sidecar is absent or unreadable — callers treat that as an
        EMPTY ledger, never a failure."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        try:
            with open(self._meta_path(step)) as fh:
                payload = json.load(fh)
        except (OSError, ValueError):
            return None
        if int(payload.get("step", -1)) != int(step):
            return None
        return payload.get("meta")

    # --- publish-commit marker (federation aggregator) -------------------
    def _publish_marker_path(self) -> str:
        return os.path.join(self._dir, "PUBLISHED.json")

    def save_publish_marker(self, window: int, meta: dict) -> None:
        if not _writer():
            return
        write_json_atomic(self._publish_marker_path(),
                          {"window": int(window), "meta": meta})

    def read_publish_marker(self) -> Optional[dict]:
        """{"window": int, "meta": {...}} of the last publish, or None
        (absent/unreadable markers mean no fast-forward, never a failure)."""
        try:
            with open(self._publish_marker_path()) as fh:
                payload = json.load(fh)
            return {"window": int(payload["window"]),
                    "meta": payload.get("meta") or {}}
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # --- restore -----------------------------------------------------------
    def _load(self, step: int) -> dict[str, np.ndarray]:
        """The tensor file of `step`, read with no pickled object."""
        path = os.path.join(self._dir, str(step), _STATE_FILE)
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def restore(self, template, step: Optional[int] = None,
                device: str | torch.device | None = None):
        """Restore `step` (default: the latest) into `template` in place
        and return it: a wide SketchState, a mesh's DistState, or a wide
        SketchConfig, for which a zero state is made on `device` (CUDA
        unless the caller names the CPU). The stamp is checked first (a
        rejected format raises before any tensor is read); every path,
        shape and dtype is checked against the target before any tensor
        is written. Across processes every rank checks, and any rank's
        refusal raises on every rank (`_agreed`)."""
        if distributed.process_count() > 1:
            template, layout, fields = self._agreed(template, step, device)
        else:
            template, layout, fields = self._checked(template, step, device)
        for p, _, _, parts in layout:
            arr = fields[p]
            if arr.dtype == np.uint32:
                arr = arr.astype(np.int64)
            for idx, ts in parts:
                part = torch.from_numpy(np.array(arr[idx]))
                for t in ts:
                    t.copy_(part)
        return template

    def _agreed(self, template, step: Optional[int], device) -> tuple:
        """`_checked` on every rank, then every rank's verdict gathered:
        any rank's refusal raises on every rank, before any tensor is
        written (and before rank 0 may move a refused directory aside)."""
        try:
            out, err = self._checked(template, step, device), None
        except Exception as exc:
            out, err = None, f"{type(exc).__name__}: {exc}"
        errs = [(r, e) for r, e in enumerate(
            distributed.all_gather_object(err)) if e is not None]
        if errs:
            raise ValueError(f"checkpoint under {self._dir} refused on "
                             "rank(s) " + "; ".join(f"{r}: {e}"
                                                    for r, e in errs))
        return out

    def _checked(self, template, step: Optional[int], device) -> tuple:
        """(target, its layout, the tensor file of `step` upgraded), the
        stamp checked first and every path, shape and dtype checked
        against the target's layout."""
        old_version = self.check_format()  # raises on reject
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        if isinstance(template, sk.SketchConfig):
            if template.tiered is not None:
                raise TypeError("checkpoints restore the wide form; encode "
                                "it into the tiered state afterwards")
            template = sk.init_state(template, device)
        layout = self._layout(template)
        fields = self._load(step)
        if old_version is not None:
            log.info("upgrading sketch checkpoint format %d -> %d",
                     old_version, CHECKPOINT_FORMAT_VERSION)
            fields = _UPGRADERS[old_version](fields)
        want = {p for p, *_ in layout}
        if set(fields) != want:
            raise ValueError(
                f"checkpoint step {step} under {self._dir}: fields missing "
                f"{sorted(want - set(fields))}, unexpected "
                f"{sorted(set(fields) - want)}")
        for p, shape, dtype, _ in layout:
            arr = fields[p]
            if (tuple(arr.shape) != tuple(shape)
                    or arr.dtype != _JAX_DTYPES[dtype]):
                raise ValueError(
                    f"checkpoint step {step}: {p} is {arr.dtype}"
                    f"{list(arr.shape)}, the state's "
                    f"{np.dtype(_JAX_DTYPES[dtype])}{list(shape)}")
        return template, layout, fields

    def close(self) -> None:
        """Free the host buffer sets that hold no unwritten copy (every
        write ends inside `save`; a staged copy keeps its set until it is
        written or released)."""
        with self._state_lock:
            for i in (0, 1):
                if self._sets_state[i] is None:
                    self._sets[i] = None
