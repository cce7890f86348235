"""Host-to-device staging ring for the resident flow feed.

Counterpart of `netobserv_tpu/sketch/staging.py` (`_SlotRing`,
`ResidentStagingRing`), on one device. A small ring of pinned host buffers
lets chunk i+1 be packed while chunk i's copy to the device is in flight.

Slot protocol: each slot has a pinned host buffer (viewed as uint32 for the
packer); the slots share one device buffer. A chunk is copied into it with
`non_blocking=True` on the current stream, and a CUDA event is recorded
after the copy. Before a slot is packed again its event is synchronized, so
the packer never writes a pinned buffer that a copy still reads. The device
buffer needs no guard: each copy into it and the fold that reads it run on
one stream, in order, so a device buffer per slot would overlap nothing,
and one buffer lets one captured fold (`sketch/capture.py`) serve every
slot. On the CPU the copy is synchronous and no event is kept.

Not in this slice: the dense and lane-sharded rings, the pending-event
buffer, the slot-wait budget (`StagingWedged`), tracing, fault injection
and metrics.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from netobserv_tpu_torch.datapath import flowpack
from netobserv_tpu_torch.sketch import state as sk
from netobserv_tpu_torch.sketch.capture import CapturedFold
from netobserv_tpu_torch.utils.platform import pick_device


class _SlotRing:
    """The slot protocol of the module docstring, shared by the rings."""

    #: recent slot-wait samples kept for `slot_wait_p95`
    WAIT_WINDOW = 64

    def _init_slots(self, n_slots: int, words: int,
                    device: torch.device) -> None:
        cuda = device.type == "cuda"
        self.device = device
        self._host = [torch.zeros(words, dtype=torch.int32, pin_memory=cuda)
                      for _ in range(n_slots)]
        self._bufs = [h.numpy().view(np.uint32) for h in self._host]
        self._dev = torch.zeros(words, dtype=torch.int32, device=device)
        self._copied: list[Optional[torch.cuda.Event]] = [None] * n_slots
        self._slot = 0
        self.stalls = 0
        self._waits = np.zeros(self.WAIT_WINDOW, np.float64)
        self._wait_i = 0
        self._wait_n = 0

    def _record_wait(self, seconds: float) -> None:
        self._waits[self._wait_i] = seconds
        self._wait_i = (self._wait_i + 1) % self.WAIT_WINDOW
        self._wait_n = min(self._wait_n + 1, self.WAIT_WINDOW)

    def slot_wait_p95(self) -> float:
        """p95 of the last WAIT_WINDOW slot waits (0.0 before any)."""
        if not self._wait_n:
            return 0.0
        return float(np.percentile(self._waits[:self._wait_n], 95))

    def _wait_slot(self) -> int:
        """The next slot, once the copy out of its host buffer is done."""
        slot = self._slot
        ev = self._copied[slot]
        wait_s = 0.0
        if ev is not None and not ev.query():
            self.stalls += 1
            t0 = time.perf_counter()
            ev.synchronize()
            wait_s = time.perf_counter() - t0
        self._record_wait(wait_s)
        return slot

    def _ship(self, slot: int) -> torch.Tensor:
        """Copy the slot's host buffer to the device buffer (without
        blocking on CUDA) and return the device buffer."""
        dev = self._dev
        dev.copy_(self._host[slot], non_blocking=True)
        if self.device.type == "cuda":
            ev = self._copied[slot] or torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[slot] = ev
        return dev

    def _advance(self, slot: int) -> None:
        self._slot = (slot + 1) % len(self._bufs)

    def drain(self) -> None:
        """Block until every copy out of a host buffer is done."""
        for ev in self._copied:
            if ev is not None:
                ev.synchronize()

    def close(self) -> None:
        """Drain, then drop the pinned and device buffers."""
        self.drain()
        self._host = self._bufs = []
        self._dev = None
        self._copied = []


class ResidentStagingRing(_SlotRing):
    """Staging ring for the resident feed: 15.4 B per record at B = 16,384
    when a fold fits one chunk (251,920 B), against the dense feed's 80.
    The host keeps the key -> slot dictionary, the device the matching key
    table (`sketch.state.init_key_table`), which `fold` threads through
    `sketch.state.ingest_resident`.

    `packer` picks the dictionary and its packer: "native" (the default on
    every device: `flowpack.NativeKeyDict` with `pack_resident_native`) or
    "python" (`flowpack.KeyDict` with `pack_resident`, the layout oracle).
    A native packer that cannot be built or loaded raises; the ring never
    falls back to the Python one. On a CUDA device `capture` folds each
    chunk by replaying one CUDA graph (`sketch/capture.py`, "fold_resident",
    with its memory from `graph_pool` if given); the CPU folds eagerly.

    The packer packs until a lane fills and says how many rows it used; the
    ring ships that self-consistent prefix and continues from the stop row
    in the next slot, so the dictionary and the device table learn
    monotonically under cold-start key floods, with no fallback. A full
    dictionary starts a new epoch (reset) before the next chunk; stale
    device-table rows are harmless, because every live slot is redefined
    through the new-key lane before a hot row references it.

    Counters: `continuations` (chunks beyond one per `fold`), `dict_resets`
    (epochs), `spill_rows` (rows that rode the spill lane), `chunks`
    (regions shipped) and `pack_seconds` (host time in the packer)."""

    def __init__(self, batch_size: int,
                 caps: Optional[flowpack.ResidentCaps] = None,
                 slot_cap: int = 1 << 18, n_slots: int = 4,
                 device: str | torch.device | None = None,
                 enable_fanout: bool = True, enable_asym: bool = True,
                 packer: str = "native", capture: bool = True,
                 graph_pool=None):
        self.batch_size = batch_size
        self.caps = caps or flowpack.default_resident_caps(batch_size)
        self.enable_fanout = enable_fanout
        self.enable_asym = enable_asym
        dev = pick_device(device)
        if packer == "native":
            self.kdict = flowpack.NativeKeyDict(slot_cap)
            self._pack = flowpack.pack_resident_native
        elif packer == "python":
            self.kdict = flowpack.KeyDict(slot_cap)
            self._pack = flowpack.pack_resident
        else:
            raise ValueError(f"packer must be 'native' or 'python', not "
                             f"{packer!r}")
        self.slot_cap = slot_cap
        self.key_table = sk.init_key_table(slot_cap, dev)
        #: the captured fold (`capture` on a CUDA device), else None
        self.captured = (CapturedFold("fold_resident", self._ingest,
                                      graph_pool)
                         if capture and dev.type == "cuda" else None)
        self.continuations = 0
        self.dict_resets = 0
        self.spill_rows = 0
        self.chunks = 0
        self.pack_seconds = 0.0
        self._init_slots(n_slots,
                         flowpack.resident_buf_len(batch_size, self.caps),
                         dev)

    def _ingest(self, state, key_table: torch.Tensor, flat: torch.Tensor):
        return sk.ingest_resident(state, key_table, flat, self.batch_size,
                                  self.caps, enable_fanout=self.enable_fanout,
                                  enable_asym=self.enable_asym)

    def fold(self, state, events: np.ndarray, extra=None, dns=None,
             drops=None, xlat=None, quic=None):
        """Pack `events` (flow event rows, `model/binfmt.FLOW_EVENT_DTYPE`,
        with optional feature lanes row for row) into ring slots in one or
        more chunks, ship and ingest each. Returns `state`, updated in
        place; the device work is not waited for."""
        feats = dict(extra=extra, dns=dns, drops=drops, xlat=xlat, quic=quic)
        n = len(events)
        start = 0
        while start < n:
            if self.kdict.count() >= self.slot_cap:
                self.kdict.reset()
                self.dict_resets += 1
            slot = self._wait_slot()
            t0 = time.perf_counter()
            buf, consumed = self._pack(
                events, batch_size=self.batch_size, kdict=self.kdict,
                caps=self.caps, start=start, out=self._bufs[slot], **feats)
            self.pack_seconds += time.perf_counter() - t0
            if consumed == 0:
                raise RuntimeError("resident pack made no progress")
            self.spill_rows += int(buf[2])
            self.continuations += start > 0
            start += consumed
            flat = self._ship(slot)
            if self.captured is not None:
                self.captured(state, self.key_table, flat)
            else:
                state = self._ingest(state, self.key_table, flat)
            self.chunks += 1
            self._advance(slot)
        return state

    def close(self) -> None:
        """Drain, then drop the buffers and the captured fold."""
        super().close()
        self.captured = None
