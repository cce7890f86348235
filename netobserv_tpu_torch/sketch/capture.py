"""A fold's device work as one CUDA graph, captured at its first call.

The port dispatches a fold op by op: some 900 PyTorch calls of host work a
fold, against about 1.5 ms of device work. The JAX package folds a batch
as one compiled executable per shape (`exporter/tpu_sketch.py:667-670`,
under `utils/retrace.watch`). Here `CapturedFold` captures a fold at its
first call as a `torch.cuda.CUDAGraph` over fixed tensors (the state, the
feed's device buffer and, for the resident feed, the key table), and each
later call replays it. The exporter (`exporter/torch_sketch.py`) and the
resident ring (`sketch/staging.py`) capture the calls they make eagerly
on the CPU; the host's pack, the copy into the device buffer and its
event stay outside the graph, on the stream the replay runs on, so the
order holds.

The capture happens at a fold's first call, as JAX compiles at a jitted
function's first call. It:

- warms up first, on a side stream, over a clone of every tensor
  argument: the fold updates the state (and the key table) in place, so a
  warm-up on the real tensors would fold its batch twice. The warm-up
  builds and loads the kernels, sets their attributes and makes the
  fold's cached constants (`ops/quantile`'s divisor), none of which a
  capture can do; its launches are real and are counted;
- then captures against the real tensors, which runs nothing, and
  replays the graph once for the call. The graph's temporaries come from
  its memory pool, which an exporter's graphs share
  (`torch.cuda.graph_pool_handle()`): each graph's temporaries die within
  it, and the graphs replay on one stream, never at once, so one pool
  serves them in any order;
- binds the graph to the arguments' storage. Every later update of the
  state is in place (ingest, `roll_window`, `decay_state`), and so is the
  key table's, so one graph serves every window.

Each call holds its arguments' binding (`binding`: every tensor's
address, dtype, shape and strides, every other leaf's value) against the
one captured. A call whose binding differs would replay into stale
storage, so it captures again. That is a retrace: each fold is a watched
entry of the compile watch (`utils/retrace`) under its name, its captures
the entry's compiles, and a capture after the entry's warm-up calls is
counted and logged as an alarm.

`prepare` is the capture alone: the warm-up on clones and the capture,
with no replay, so no fold runs on the arguments. The exporter prepares
every entry of the resident feed's superbatch ladder when it makes the
ring, so no live fold of a ladder entry captures.

A graph cannot span devices: every tensor of a capture's arguments lies
on one device, which is made current for the capture and each replay (a
mesh's shards on several cards have one captured fold a card,
`sketch/staging.py`).

A capture that fails raises; nothing falls back to an eager fold.

Launch counts: `CudaKernel.launches` rises when Python calls `launch`. The
capture calls it and runs nothing, so the capture takes the counts back,
and every replay adds them again: `launches` keeps counting launches run.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from netobserv_tpu_torch.ops.kernels._build import CudaKernel
from netobserv_tpu_torch.utils import retrace, tracing


def clone(x: Any, memo: dict | None = None) -> Any:
    """A copy of every tensor in x (nested tuples, named or not). A tensor
    that x holds twice is copied once and stays shared."""
    memo = {} if memo is None else memo
    if isinstance(x, torch.Tensor):
        key = (x.data_ptr(), x.dtype, tuple(x.shape), x.stride())
        if key not in memo:
            memo[key] = x.clone()
        return memo[key]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(v, memo) for v in x))
    if isinstance(x, tuple):
        return tuple(clone(v, memo) for v in x)
    return x


def _first_tensor(x: Any) -> torch.Tensor | None:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, tuple):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def binding(x: Any) -> tuple:
    """What a graph captured over x is bound to, flat: each tensor's
    address, dtype, shape and strides, each other leaf's value (nested
    tuples, named or not)."""
    out: list = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append((v.data_ptr(), v.dtype, v.shape, v.stride()))
        elif isinstance(v, tuple):
            for u in v:
                walk(u)
        else:
            out.append(v)

    walk(x)
    return tuple(out)


class CapturedFold:
    """`fold(*args)`, captured as a CUDA graph at its first call and
    replayed at every later call with the same binding (module
    docstring); `tenants` marks a tenant-stacked fold in the compile
    watch (`utils/retrace.watch`). `launches` maps each kernel to its
    launches per replay; `captures` counts the captures. With a
    `timeline` (`utils/tracing.Timeline`, which the exporter sets) and
    tracing on, each replay is timed between two CUDA events recorded
    just before and after it, so the host's work ahead of the launch
    (the binding's check) is not the device's."""

    #: the device timeline that times each replay, or None
    timeline = None

    def __init__(self, name: str, fold: Callable[..., Any], pool=None,
                 tenants: int | None = None):
        self.name = name
        self._fold = fold
        self._pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self._binding: tuple | None = None
        self.launches: dict[CudaKernel, int] = {}
        self.captures = 0
        self._device: torch.device | None = None
        self._entry = retrace.watch(self._call, name, tenants=tenants)

    def __call__(self, *args) -> None:
        self._entry(*args)

    def _call(self, *args) -> None:
        self.prepare(*args)
        self._replay()

    def prepare(self, *args) -> None:
        """Capture for `args` unless the graph is bound to them already,
        and replay nothing. The capture is a compile of the watched entry;
        made before the entry's first call, it is warm-up."""
        key = binding(args)
        if key == self._binding:
            return
        t0 = time.perf_counter()
        self._capture(args)
        self._binding = key
        self.captures += 1
        if isinstance(self._entry, retrace.Watched):
            self._entry.note_compile(time.perf_counter() - t0,
                                     retrace.describe(args))

    def _capture(self, args: tuple) -> None:
        first = _first_tensor(args)
        if first is None or first.device.type != "cuda":
            raise ValueError(f"{self.name}: a CUDA graph captures CUDA "
                             "tensors; a fold on the CPU runs eagerly")
        dev = first.device
        self.graph = None  # the old graph's pool memory goes back first
        graph = torch.cuda.CUDAGraph()
        # the arguments' device is current for the capture (a mesh's
        # shards may sit on any device): its streams, its graph
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self._fold(*clone(args))
            stream.wait_stream(side)
            before = [k.launches for k in CudaKernel.instances]
            with torch.cuda.graph(graph, pool=self._pool):
                self._fold(*args)
        self.launches = {}
        for k, n in zip(CudaKernel.instances, before):
            if k.launches != n:
                self.launches[k] = k.launches - n
                k.launches = n
        self.graph = graph
        self._device = dev

    def _replay(self) -> None:
        with torch.cuda.device(self._device), \
                tracing.timed(self.timeline, "ingest_dispatch"):
            self.graph.replay()
        for k, n in self.launches.items():
            k.launches += n

    def stats(self) -> dict:
        """The compile watch's stats of this fold (with the watch off, its
        name and captures)."""
        if isinstance(self._entry, retrace.Watched):
            return self._entry.stats()
        return {"fn": self.name, "compiles": self.captures}
