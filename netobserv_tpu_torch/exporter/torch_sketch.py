"""The sketch exporter of the port, reduced to this slice.

Counterpart of `netobserv_tpu/exporter/tpu_sketch.py` (`TpuSketchExporter`).
Flow records go in through one of two entry points, and `roll` closes the
window into a report dict (`exporter/report.report_to_json`, with the
previous roll's heavy-hitter index threaded so evicted keys are named):

- `fold_events` takes raw flow events with their feature lanes and folds
  them through an owned `sketch/staging.ResidentStagingRing`: the resident
  feed, the reference agent's default (`SKETCH_FEED=resident`);
- `fold_dense` takes the dense feed (20 words per record): each batch is
  padded to the fixed batch size, staged in one pinned host buffer and
  copied to the device without blocking; the next batch waits only for
  that copy.

On CUDA each feed's fold runs as a CUDA graph (`sketch/capture.py`),
captured at the feed's first fold against the state and the feed's
device buffer and replayed every fold after; both graphs share one memory
pool and are watched entries of `utils/retrace` ("fold_dense",
"fold_resident"). A capture that fails raises. `capture=False` folds
eagerly, op by op, as the CPU always does: `chip_smoke.py` holds the
captured run against it.

The resident feed's ring, with its native packer, is made at the first
`fold_events`: an exporter fed only dense batches builds no packer.

With `SketchConfig(tiered=TierSpec())` the state stays resident in tiered
form (`sketch/tiered.py`); folds, rolls and `state_tables` work the same,
and `counter_table_bytes` gives the resident bytes of the tier-covered
tables.

Not in this slice: the lane-sharded and dense staging rings, overload
control, federation, archive, checkpoints and tracing.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from netobserv_tpu_torch.exporter.report import (
    heavy_identity_index, report_numpy, report_to_json,
)
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.sketch.staging import ResidentStagingRing
from netobserv_tpu_torch.utils.platform import pick_device


class TorchSketchExporter:
    """Folds flow records into one device-resident sketch state.

    `window_s` sets a window deadline: the first fold after it passes
    closes the window and returns the report (None otherwise).
    `decay_factor` / `reset_sketches` choose the roll mode as in
    `sketch.state.roll_window`. `folds` and `rolls` count the folds of
    fixed-size batches (dense batches and resident regions alike) and the
    closed windows. `ring` is the resident feed's staging ring (default
    caps for `batch_size`, 2^18 slots), made by the first `fold_events`,
    with the packer `packer` names ("native", the default, or "python":
    `sketch/staging.ResidentStagingRing`). On a CUDA device `capture`
    folds through CUDA graphs, listed in `captures`; the CPU folds
    eagerly."""

    def __init__(self, cfg: sk.SketchConfig = sk.SketchConfig(),
                 batch_size: int = 16384,
                 device: str | torch.device | None = None,
                 window_s: Optional[float] = None,
                 reset_sketches: bool = True,
                 decay_factor: Optional[float] = None,
                 sink: Optional[Callable[[dict], None]] = None,
                 packer: str = "native", capture: bool = True):
        self.device = pick_device(device)
        cuda = self.device.type == "cuda"
        self.cfg = cfg
        self.batch_size = batch_size
        self.window_s = window_s
        self.reset_sketches = reset_sketches
        self.decay_factor = decay_factor
        self.sink = sink
        self.state = sk.init_state(cfg, self.device)
        words = batch_size * sk.DENSE_WORDS
        self._host = torch.zeros(words, dtype=torch.int32, pin_memory=cuda)
        self._host_u32 = self._host.numpy().view(np.uint32)
        self._dev = torch.zeros(words, dtype=torch.int32, device=self.device)
        self._copied = torch.cuda.Event() if cuda else None
        if packer not in ("native", "python"):
            raise ValueError(f"packer must be 'native' or 'python', not "
                             f"{packer!r}")
        self.ring: Optional[ResidentStagingRing] = None
        self._packer = packer
        self._capture = capture and cuda
        self._pool = torch.cuda.graph_pool_handle() if self._capture else None
        self._fold_dense = (CapturedFold("fold_dense", self._ingest_dense,
                                         self._pool)
                            if self._capture else None)
        self._prev_index: Optional[dict] = None
        self._deadline = self._next_deadline()
        self._closed = False
        self.folds = 0
        self.rolls = 0

    @property
    def captures(self) -> list[CapturedFold]:
        """The captured folds made so far: the dense feed's, and the
        resident ring's once the ring is made."""
        return [c for c in (self._fold_dense,
                            self.ring and self.ring.captured)
                if c is not None]

    def _next_deadline(self) -> Optional[float]:
        return (time.monotonic() + self.window_s
                if self.window_s is not None else None)

    def _maybe_roll(self) -> Optional[dict]:
        if self._deadline is not None and time.monotonic() >= self._deadline:
            return self.roll()
        return None

    def fold_events(self, events: np.ndarray, extra=None, dns=None,
                    drops=None, xlat=None, quic=None) -> Optional[dict]:
        """Fold raw flow events (`model/binfmt.FLOW_EVENT_DTYPE` rows, any
        count) and their optional feature lanes (`EXTRA_REC_DTYPE`,
        `DNS_REC_DTYPE`, `DROPS_REC_DTYPE`, `XLAT_REC_DTYPE`,
        `QUIC_REC_DTYPE`, row for row) through the resident feed. Returns
        the window report if this call passed the window deadline, else
        None."""
        if self._closed:
            raise RuntimeError("exporter is closed")
        if self.ring is None:
            self.ring = ResidentStagingRing(
                self.batch_size, device=self.device,
                enable_fanout=self.cfg.enable_fanout,
                enable_asym=self.cfg.enable_asym, packer=self._packer,
                capture=self._capture, graph_pool=self._pool)
        chunks = self.ring.chunks
        self.ring.fold(self.state, events, extra=extra, dns=dns, drops=drops,
                       xlat=xlat, quic=quic)
        self.folds += self.ring.chunks - chunks
        return self._maybe_roll()

    def fold_dense(self, flat: np.ndarray) -> Optional[dict]:
        """Fold a flat uint32 dense feed (rows of 20 words, any row count;
        it folds in batches of `batch_size`). Returns the window report if
        this call passed the window deadline, else None."""
        if self._closed:
            raise RuntimeError("exporter is closed")
        flat = np.asarray(flat).reshape(-1).view(np.uint32)
        if flat.size % sk.DENSE_WORDS:
            raise ValueError(f"dense feed of {flat.size} words is not whole "
                             f"{sk.DENSE_WORDS}-word rows")
        step = self.batch_size * sk.DENSE_WORDS
        for lo in range(0, flat.size, step):
            self._fold_one(flat[lo:lo + step])
        return self._maybe_roll()

    def _fold_one(self, chunk: np.ndarray) -> None:
        if self._copied is not None:
            self._copied.synchronize()  # the last copy out of _host is done
        n = chunk.size
        self._host_u32[:n] = chunk
        self._host_u32[n:] = 0  # zero rows are invalid (word 14 == 0)
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        if self._fold_dense is not None:
            self._fold_dense(self.state, self._dev)
        else:
            self._ingest_dense(self.state, self._dev)
        self.folds += 1

    def _ingest_dense(self, state, dev: torch.Tensor):
        return sk.ingest(state, sk.dense_to_arrays(dev),
                         enable_fanout=self.cfg.enable_fanout,
                         enable_asym=self.cfg.enable_asym)

    def state_tables(self) -> dict[str, np.ndarray]:
        """The current (pre-roll) mergeable tables, on the host."""
        return sk.state_tables(self.state)

    def counter_table_bytes(self) -> dict[str, int]:
        """Resident bytes of each tier-covered table (CM planes, HLL
        banks), read from the state's tensors."""
        return tiered.counter_table_bytes(self.state)

    def roll(self) -> dict:
        """Close the window: render its report, roll the state, pass the
        report to the sink and return it."""
        _, report = sk.roll_window(self.state, self.cfg, self.reset_sketches,
                                   self.decay_factor)
        host = report_numpy(report)
        out = report_to_json(host, prev_heavy_index=self._prev_index)
        self._prev_index = heavy_identity_index(host)
        self.rolls += 1
        self._deadline = self._next_deadline()
        if self.sink is not None:
            self.sink(out)
        return out

    def close(self) -> None:
        """Wait for outstanding device work and drop the buffers, the
        ring's pinned buffers and the captured graphs included."""
        if self._closed:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._closed = True
        if self.ring is not None:
            self.ring.close()
        self._fold_dense = None
        self._host = self._host_u32 = self._dev = None
