"""A profiled slice of a run: torch.profiler's trace, read back.

`trace(fn)` runs `fn` under `torch.profiler` (host and CUDA activities),
waits for the device, writes the Chrome trace to a temporary file, reads
it back and deletes it. The result holds every device interval (kernels,
copies, fills), the union of them (`busy_s`), the slice's wall time
(`window_s`), the device operations that took the most time, and the
longest idle gaps of the device, each named by the harness range
(`record_function`, prefix `portbench.`) and the host operation inside it
that the host thread was in at the middle of the gap.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
ANNOTATION = "portbench."
TOP = 10


@dataclass
class Slice:
    """What a profiled slice saw; times in seconds."""

    kernels: list = field(default_factory=list)   # (name, start, dur)
    device: list = field(default_factory=list)    # (name, start, dur)
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def trace(fn) -> Slice:
    """Run fn() profiled, synchronise, and read the trace (module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return parse(events, wall)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint [start, end) runs covering the given rows (start, end)."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def parse(events: list, wall_s: float) -> Slice:
    """A `Slice` from Chrome trace events (ts and dur in microseconds)."""
    sl = Slice(window_s=wall_s)
    host, notes = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            sl.device.append((name, ts, dur))
            if cat == "kernel":
                sl.kernels.append((name, ts, dur))
        elif cat == "user_annotation" and name.startswith(ANNOTATION):
            notes.append((name[len(ANNOTATION):], ts, ts + dur, e.get("tid")))
        elif cat in HOST_CATS:
            host.append((name, ts, ts + dur, e.get("tid")))
    if not sl.device:
        return sl
    iv = np.array([(s, s + d) for _, s, d in sl.device])
    runs = _union(iv)
    sl.busy_s = float((runs[:, 1] - runs[:, 0]).sum())
    by_name: dict[str, float] = {}
    for name, _, d in sl.device:
        by_name[name] = by_name.get(name, 0.0) + d
    sl.device_ops = sorted(([n, s] for n, s in by_name.items()),
                           key=lambda r: -r[1])[:TOP]
    gaps = np.stack([runs[:-1, 1], runs[1:, 0]], axis=1) if len(runs) > 1 \
        else np.zeros((0, 2))
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:TOP] if len(gaps) else []
    for i in order:
        a, b = gaps[i]
        sl.idle_gaps.append([_host_at((a + b) / 2, notes, host),
                             float(b - a)])
    return sl


def _host_at(t: float, notes: list, host: list) -> str:
    """The innermost harness range, and the innermost host operation on its
    thread, that cover time t."""
    inner = [n for n in notes if n[1] <= t < n[2]]
    if not inner:
        return "outside"
    note = min(inner, key=lambda n: n[2] - n[1])
    ops = [h for h in host if h[3] == note[3] and h[1] <= t < h[2]]
    if not ops:
        return note[0]
    return f"{note[0]}/{min(ops, key=lambda h: h[2] - h[1])[0]}"
