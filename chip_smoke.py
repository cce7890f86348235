#!/usr/bin/env python3
"""Drive the PyTorch port's sketch plane on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of the port from `netobserv_tpu_torch/csrc/` (nine
C entries: kernels 1-8 and the HLL folds launch) and the empty kernel of
the launch floor (one `nvcc` per source, all started together), holds each
against its plain PyTorch version at the shapes its path gives it, then
drives five
paths through `TorchSketchExporter` at the default geometry, each with the
launch counts set to 0 just before it and read just after:

- the wide main path, `SketchConfig()` through the dense feed
  (`fold_dense`; kernels 1, 2 and 4, and the HLL folds launch, which runs
  kernels 3 and 8's one body on the global HLL and both grids): 2 windows
  x 32 folds of 16,384 records of the seeded bench traffic;
- the tiered path, `SketchConfig(tiered=TierSpec())` (kernels 2, 6 and 7,
  and the folds launch on the two grids): the same 2 windows, then one
  window of DECAY_FOLDS folds rolled in decay mode, so the tier-level
  decay runs on the card;
- the resident path, `SketchConfig()` through the resident feed at one
  lane and the ladder (1,) (`fold_events`; the wide path's kernels): the
  same 2 windows of the same batches as flow events
  (`traffic.event_pool`), default caps for B = 16,384 and 2^18 slots, the
  bytes of the one-lane `ResidentStagingRing`. It also checks the key
  table on the card against the host dictionary and prints the pack time
  apart from the rest, the bytes copied to the card per record, and the
  ring's counters;
- the lanes path, the reference agent's default feed
  (`exporter/tpu_sketch.py:1575-1612`): 8 lanes of 2,048 rows (the auto
  pack threads of an 8-CPU node, set explicitly), the superbatch ladder
  (1, 2, 4) and 2^18 slots a lane, fed the same records as evictions
  (`export_evicted`) of EVICT_ROWS rows three times in four, else of
  40,000-70,000 (`LaneFeeder`, sizes from `numpy.random.default_rng(1)`),
  each window rolled after its 32 x 16,384 records. It checks that every
  ladder entry folded, one capture each (all three captured when the ring
  is made), every lane's key table against its dictionary, and that
  evictions took the pending buffer's direct path; it prints records/s,
  pack and ingest seconds per 16,384 records, the lanes and
  `os.cpu_count()`;
- the dense and compact rings (`dense_ring`, feeds "dense" and "compact"),
  fed flow events of a v4 pool (`traffic.make_pool(v4=True)`: v4-mapped
  keys, 5 % v6 rows a batch, the last batch a burst of 25 % past the
  compact feed's spill lane, so its dense fallback runs at least once),
  with the bytes copied to the card per record.

A last short phase folds C1_FOLDS batches under each of two tiered shapes
that the tier gates once sent to a kernel that could not launch them:
`cm_depth=25`, whose kernel-6 tile passes one block's shared memory (the
gate now sends it to the decode form: the wide path's kernels), and
`ewma_buckets=16384`, past the table width kernel 7's first design could
hold (now the interior form, kernel 7 fused). A third tiered shape,
`cm_depth=6`, has a kernel-6 fold tile of 57,312 B, past the 48 KiB a
launch gets without the function's shared-memory attribute: kernel 6
sets it at every launch, so the captured run sets it inside the capture.
Each is held against the plain run under the whole-window bounds below.

The kernels redesigned for the H100, 1 and 5 (the wide and single-plane
Count-Min folds, one warp-aggregated body of atomics into L2), 2 (the
top-K slot reduce, one thread-block cluster), 4 (the signal fold,
warp-aggregated atomics into L2), 6 (the tier-interior Count-Min fold,
the batch binned by tile), 7 (kernel 4's per-record body beside
packed-HLL tile blocks that test membership on h1 alone), and 3 and 8
with the folds launch (one warp-aggregated max body, up to three folds a
launch), are all held
bit-exact against their plain versions on the seeded contract cases of
`netobserv_tpu_torch/ops/kernels/cases.py` (empty and
one-row batches, one row past a warp's, CTA's or block's share, every row
on one slot, bucket, key or HLL register, ties in different CTAs, dead
rows, the inactive slot, table, tile and triple edges, zero values, rank
33, hashes that wrap past 2^32, several groups of equal cells in one
warp; kernel 2 also at a K of three slot tiles,
kernels 1, 5 and 6 at a width of one tile, kernel 7 at a bank of one small
tile and at a table width of 16,384), which the CPU tests hold against the
JAX package. For every
kernel the kernel phase prints the launch floor: the device time of an
empty kernel (`csrc/launch_floor.cu`) at its grid, cluster and shared
memory, for kernel 2 with its two cluster barriers, and for kernel 6 the
sum over its four launches (its memset of the bin counts left out).
The HLL folds launch runs once per fold on every path (the global HLL
and both grids on the wide and resident paths, the two grids on the
tiered path). Kernels 3 and 8, its folds as C entries of their own, run
on no path: the kernel phase checks each on its folds of the wide path's
folds call. Kernel 5 (the single-plane Count-Min fold, kernel 1's body
with one value row) runs on no path, as in the JAX package, where only
its tests call it: the kernel phase checks it on the wide path's kernel-1
inputs, one plane. The launches of
kernels 3, 5 and 8 print as 0 on every path beside the kernel phase's own
count.

The resident path packs with the native packer (`csrc/flowpack.cc`, host
C++ built with g++ at first use), the exporter's default. A phase before
the paths (`native_pack`) holds it against the Python packer on the first
window's batches as flow events: the same regions word for word, the
same rows consumed and the same dictionary count, chunk by chunk; it
times both.

Every path runs as the exporter runs on CUDA by default: each fold
replays a CUDA graph captured at the feed's first fold, or for a ladder
entry when its ring is made (`sketch/capture.py`), and captured again only
if what it is bound to changed (a retrace). Each path, and each C1 shape,
runs three times over the same batches: captured, eager with the
kernels (`capture=False`: the fold op by op) and eager with the plain
versions. The captured run's
tables are held against both under the whole-window bounds below (kernel
against plain, captured against eager), its launch counts (a replay adds
the launches its capture recorded; the capture's warm-up fold, on clones,
counts as one fold more) against the path's launches per fold, and its
compile watch (`utils/retrace`) must show one capture per graph, a call
per fold and no retrace; the `retrace_watch` phase prints the watch's
snapshot of each captured exporter, taken while it lived, and fails on
any retrace. The first window of a captured run holds its capture's
seconds; the second is steady state. The profile phases trace 8
folds of each path (the lanes path as 8 evictions of 4 batches, each one
k = 4 superbatch), captured and eager, check that the trace counts each
kernel of the path as often as its launch count says, and print wall and
device ms per 16,384 records, the device's busy share and, for the
resident and lanes paths, the pack seconds (the `per_fold` line sums them
up). The launch counts are per ingest dispatch, whatever its rows: a
k-superbatch is one.

Each path checks heavy-hitter recall against the exact oracle and is rerun
with the plain versions on the card to compare the tables; on the kernel
runs no plain version may run at all. Every phase prints one JSON line. Any
failure prints the phase's error and exits non-zero, with no "ok" line.
The last line on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Nothing is cut for time.

Times. One helper (`measure`) times a kernel, its plain version and the
library yardstick over a loop of 50 calls after a warm-up, by two clocks:
`device_*_ms` is the device time from a torch.profiler trace (the sum of
kernel and copy durations, so host launch overhead is left out) and is the
time held against the bound and printed in the `kernels` line;
`kernel_ms`, `plain_ms`, `library_ms` are CUDA-event times of the same loop
and include whatever launch overhead it cannot hide. In-place tables are
restored from the captured state before each call, and the restore's own
time is subtracted from both clocks: a device difference that is not
positive fails the phase, an event difference that is negative prints as
null (the two loops' host overhead, not the kernel, set it). A trace must
be whole, every kernel counted a multiple of the loop's calls, or the
phase fails. Kernels 6 and 7 have no library
yardstick: no single PyTorch call decodes, folds and promotes tiers, or
max-folds a 6-bit packed bank.

Bound. The larger of the bytes the function must move over 3.35 TB/s and
its f32 operations over 67 TFLOP/s (H100 SXM data sheet). Bytes are this
call's: each input read once; of an in-place table only the 32-byte
sectors that this call's non-zero values reach, read once and written once
(for kernel 6 the sectors of the base, mid and top tiers its columns fall
in; for kernel 7 also the sectors of the packed triples its valid records
reach; for kernels 3 and 8 and the folds launch the register cells of
their valid records, each lane once however many folds read it); a fresh
output written once. The kernel phase also prints the atomic count of
kernels 1 and 5 and the most atomics that land on one address as their
design makes them, one per distinct (warp, cell) of each plane's non-zero
values, beside one per (record, row) as a design without warp
aggregation makes them; kernel 6's bin sizes (the entries the hottest
tile's block walks); and the device time of kernels 1, 2, 4, 5, 6 and 7
with the hot key spread out (uniform keys), and of kernels 3 and 8 and
the folds launch with random hash lanes.
Kernel 5's library yardstick is `index_add_` on one plane; kernels 3 and
8's `scatter_reduce_` ("amax") on the flat register file, the folds
launch's one `scatter_reduce_` over its register files end to end.

Tolerances. Kernels 2, 3 and 8 and the folds launch compute maxima and a
minimum row: bit-exact, and so is kernel 7's packed HLL bank, in every
regime. Kernels
1, 4 and 5 (and kernel 7's signal tables) add f32 values with atomics, in
an order that changes from run to run: with integer-valued masses whose
per-cell sums stay below 2^24 (fresh tables, small integer masses on the
main path's indices) they are bit-exact; with the main path's own inputs
(tables warmed by earlier folds, hot cells past 2^24: the production
regime) a cell that took n adds is held to 2 * (n + 1) * 2^-24 relative of
the plain version.

Kernel 6 (the tier-interior CM fold) is bit-exact in the integer regime:
fresh tiers and small integer masses, chained over CHAIN folds so the
cascade reaches the top tier. In the production regime its bound is
derived on the tiers. A cell that took n adds in a fold has its post-fold
wide value (dec + adds) within n * 2^-24 * S of the exact sum on either
side, S the cell's exact value; with the subtraction new - dec, each
side's delta is within (n + 1) * 2^-24 * S, so the two sides' units
du = ceil(delta / unit) differ by at most
A = 2 * (n + 1) * 2^-24 * V / unit + 1 for a touched cell (0 for an
untouched one), with V = max(decoded value of both sides) * (1 + 2^-8)
+ unit >= S. Over a window, from equal tiers, A sums over the window's
folds: A = 2 * (N + F) * 2^-24 * V / unit + F, N the cell's adds and F the
folds that touched it. Base, mid and top are clamped running sums of
those units, so |d base| <= A per cell, |d mid| <= 2 * (sum of A over
the mid group) and |d top| <= 2 * (sum of A over the top group). The
decoded view, units * unit with a mid cell attributed to every saturated
base of its group and a top cell to every saturated mid, is held per cell
to unit * (A + [base saturated on either side] * (A_mid + [mid saturated
on either side] * A_top) + [base saturated on one side only] * mid_total
+ [mid saturated on one side only] * top) + 4 * 2^-24 * V (the decode's
own f32 roundings): a cell one side saturates and the other does not
switches the attribution of a whole overflow cell. `est` is the min over
rows of the post-fold wide value, so it is held to the largest
2 * (n + 1) * 2^-24 * V of the record's cells. Whole windows on the
tiered path hold the decoded CM tables to the window form of the same
bound, with N and F counted through the plain versions.

Whole windows otherwise: each f32 cell of the tables kernels 1, 4 and 7
write is held to 2 * (n + 1) * 2^-24 relative with n counted over the
window by folding unit masses through the plain versions; every other
table (HLL registers, histograms, the scalar totals) is exact, and the
heavy-hitter table (whose slot choices follow the Count-Min estimates)
shares at least 99 % of its identities.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
U = 2.0 ** -24
BATCH = 16384
WINDOWS = 2
FOLDS_PER_WINDOW = 32
DECAY_FOLDS = 8
DECAY_FACTOR = 0.5
WARM_FOLDS = 3
CHAIN = 8
REPS = 50
#: the kernels redesigned for Hopper, with contract cases in the kernel
#: phase
REDESIGNED = ("topk_reduce", "signal_fold", "countmin_fold2",
              "countmin_tier2", "signal_fold_tiered", "hll_fold",
              "hll_fold_grid", "hll_fold_folds", "countmin_fold")
#: folds of each tiered shape of the C1 phase
C1_FOLDS = 4
#: threads of a warp, for the count of warp-aggregated atomics
WARP = 32
#: the empty kernel of the launch floor
FLOOR_SOURCE = "launch_floor.cu"
#: traces of one loop before `measure` fails the phase: a trace can come
#: back with no device events at all (seen about once a run on an H100,
#: torch 2.11), or with some missing (a kernel counted fewer times than the
#: loop ran it, seen as an in-place kernel's time below its restore's)
PROFILE_TRIES = 5
#: traces retried
PROFILE_RETRIED: list = []
#: compile-watch stats of every captured exporter of the run
WATCHED: list = []
#: the runs of a path: CUDA graphs replayed, the fold op by op with the
#: kernels, the fold op by op with the plain versions
MODES = ("captured", "eager", "plain")
#: the paths that fold wide (kernels 1, 2 and 4 and the HLL folds launch
#: on each ingest): the dense entry, the resident feed at one lane, the
#: lanes feed with its ladder, and the dense and compact rings
WIDE_PATHS = ("wide", "resident", "lanes", "dense_ring", "compact_ring")
#: the exporter of the resident path: one lane, no ladder (the bytes of
#: the one-lane `ResidentStagingRing`)
RESIDENT_KW = {"pack_threads": 1, "superbatch": (1,)}
#: the exporter of the lanes path: the reference agent's default on an
#: 8-CPU node (pack threads set, so the lanes do not follow this host)
LANES_KW = {"pack_threads": 8, "superbatch": (1, 2, 4)}
#: eviction sizes of the lanes path: the default flow cache's 5,000 rows
#: (CACHE_MAX_FLOWS) three times in four, else uniform over these bounds
EVICT_ROWS = 5000
EVICT_LARGE = (40_000, 70_000)
#: the v6 share of each batch of the dense-ring pool: the last batch is a
#: burst past the compact feed's spill lane (B / 8 rows)
V6_SHARES = (0.05,) * 7 + (0.25,)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- helpers


def _clone(x):
    """A copy of every tensor in x (nested tuples, named or not). A tensor
    that x holds twice (a lane that several HLL folds read) is copied once
    and stays shared, as in the call it was captured from."""
    from netobserv_tpu_torch.sketch.capture import clone
    return clone(x)


def _tensors(x) -> list:
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _device_rows(prof) -> list[tuple[float, str, int]]:
    """(device us, name, count) of every device-side event of a trace."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host-side ops: their kernels are listed themselves
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, e.key, e.count))
    return sorted(rows, reverse=True)


def measure(fn, setup=None,
            reps: int = REPS) -> tuple[float | None, float]:
    """(event ms, device ms) per call of fn() over `reps` calls after a
    warm-up: CUDA events around the loop, then the same loop under
    torch.profiler for the device's own kernel and copy time, from a whole
    trace (every kernel counted a multiple of `reps` times) or the phase
    fails. With `setup` (which restores in-place inputs), setup alone is
    measured the same way and subtracted from both: the device difference
    must be positive, and a negative event difference is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def loop(body) -> tuple[float, float]:
        for _ in range(5):
            body()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            body()
        end.record()
        torch.cuda.synchronize()
        for _ in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    body()
                torch.cuda.synchronize()
            rows = _device_rows(prof)
            # every call runs the same kernels: a whole trace counts each
            # a multiple of reps times
            if rows and all(c % reps == 0 for _, _, c in rows):
                us = sum(r[0] for r in rows)
                return start.elapsed_time(end) / reps, us / 1e3 / reps
            PROFILE_RETRIED.append(1)
        raise PhaseError(f"no whole profiler trace (device events, every "
                         f"kernel a multiple of {reps} times) in "
                         f"{PROFILE_TRIES} traces")

    if setup is None:
        return loop(fn)
    both, alone = loop(lambda: (setup(), fn())), loop(setup)
    device = both[1] - alone[1]
    check(device > 0, f"the call's device time, {both[1]} ms with the "
          f"restore, is not above the restore's {alone[1]} ms")
    event = both[0] - alone[0]
    return (event if event >= 0 else None), device


def _exact(a, b) -> bool:
    """Bit equality of two tensors of any dtype (integer tiers compare as
    int64, floats by value)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.to(torch.int64), b.to(torch.int64)))


# ----------------------------------------------------------- the kernels


def kernel_specs():
    """Per kernel: its module, launch counter, wrapper and plain version,
    the path whose captured calls the kernel phase checks it on (with
    `derive`, the calls of another kernel of that path, each cut into this
    kernel's calls), its launches per fold on each main path, which
    arguments it updates in place (indices, or a function of the arguments
    giving the tensors; and their `state_tables` names, for the f32 sums),
    how to cut its inputs to n rows, whether its result is exact in any
    order, the Pallas kernel it replaces, and how a trace names its
    `__global__` (`trace`: demangled or mangled; the HLL entries share
    one, and kernel 6's C call counts by its fold kernel)."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
    )
    sig_tables = signal_kernel.SignalPlanes._fields
    flat_paths = {p: 1 for p in WIDE_PATHS}
    every_path = {"tiered": 2, **{p: 2 for p in WIDE_PATHS}}
    one_fold = lambda a, n: (a[0], *(t[:n] for t in a[1:]))  # noqa: E731
    return [
        dict(name="countmin_fold2", mod=countmin_kernel,
             kernel=countmin_kernel.KERNEL, path="wide", per_fold=flat_paths,
             trace=("cm_fold2_kernel<2>", "cm_fold2_kernelILi2E"),
             wrapper="update_two", plain="update_two_plain", inplace=(0, 1),
             tables=("cm_bytes", "cm_pkts"),
             rows=lambda a, n: (a[0], a[1], *(t[:n] for t in a[2:])),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:81"),
        dict(name="topk_reduce", mod=topk_kernel, kernel=topk_kernel.KERNEL,
             path="wide", per_fold=every_path, trace=("topk_reduce_kernel",),
             wrapper="reduce",
             plain="reduce_plain", inplace=(),
             rows=lambda a, n: (*(t[:n] for t in a[:3]), a[3]), exact=True,
             replaces="netobserv_tpu/ops/pallas/topk_kernel.py:82"),
        # kernels 3 and 8 run on every path inside the folds launch below;
        # each is checked on its fold of the wide path's folds call
        dict(name="hll_fold", mod=hll_kernel, kernel=hll_kernel.KERNEL,
             path="wide", per_fold={}, trace=("hll_fold_kernel",),
             derive=("hll_fold_folds",
                     lambda a: [f for f in a[0] if len(f) == 4]),
             wrapper="update", plain="update_plain", inplace=(0,),
             rows=one_fold, exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:70"),
        dict(name="signal_fold", mod=signal_kernel,
             kernel=signal_kernel.KERNEL, path="wide", per_fold=flat_paths,
             trace=("signal_fold_kernel",),
             wrapper="update", plain="update_plain", inplace=(0,),
             tables=sig_tables,
             rows=lambda a, n: (a[0], a[1][:, :n].contiguous(),
                                a[2][:, :n].contiguous()),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/signal_kernel.py:164"),
        # no path of the JAX package runs kernel 5 (kernel 1's body with
        # one value row): it is checked on the wide path's kernel-1 inputs
        # (table, h1, h2, bytes values)
        dict(name="countmin_fold", mod=countmin_kernel,
             kernel=countmin_kernel.KERNEL_ONE, path="wide", per_fold={},
             trace=("cm_fold2_kernel<1>", "cm_fold2_kernelILi1E"),
             derive=("countmin_fold2", lambda a: [(a[0], a[2], a[3], a[4])]),
             wrapper="update", plain="update_plain", inplace=(0,),
             tables=("cm_bytes",),
             rows=lambda a, n: (a[0], *(t[:n] for t in a[1:])),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:266"),
        dict(name="countmin_tier2", mod=countmin_kernel,
             kernel=countmin_kernel.KERNEL_TIER2, path="tiered",
             per_fold={"tiered": 1}, trace=("cm_tier2_kernel",),
             wrapper="update_two_tiered", plain="update_two_tiered_plain",
             inplace=(0, 1), tables=("cm_bytes", "cm_pkts"),
             rows=lambda a, n: (a[0], a[1], *(t[:n] for t in a[2:6]), a[6]),
             exact=False, chain=CHAIN,
             library_note="no single PyTorch call decodes, folds and "
                          "promotes the tiers",
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:199"),
        dict(name="signal_fold_tiered", mod=signal_kernel,
             kernel=signal_kernel.KERNEL_TIERED, path="tiered",
             per_fold={"tiered": 1}, trace=("signal_fold_tiered_kernel",),
             wrapper="update_tiered", plain="update_tiered_plain",
             inplace=(0, 1), tables=sig_tables,
             rows=lambda a, n: (a[0], a[1], a[2][:, :n].contiguous(),
                                a[3][:, :n].contiguous(),
                                *(t[:n] for t in a[4:])),
             exact=False,
             library_note="no single PyTorch call max-folds a 6-bit "
                          "packed bank",
             replaces="netobserv_tpu/ops/pallas/signal_kernel.py:214"),
        dict(name="hll_fold_grid", mod=hll_kernel,
             kernel=hll_kernel.KERNEL_GRID, path="wide", per_fold={},
             trace=("hll_fold_kernel",),
             derive=("hll_fold_folds",
                     lambda a: [f for f in a[0] if len(f) == 5]),
             wrapper="update_per_dst", plain="update_per_dst_plain",
             inplace=(0,), rows=one_fold, exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:81"),
        # the global-src HLL (not on the tiered path: kernel 7 folds its
        # packed bank) and both grids of a fold in one launch
        dict(name="hll_fold_folds", mod=hll_kernel,
             kernel=hll_kernel.KERNEL_FOLDS, path="wide",
             per_fold={"tiered": 1, **{p: 1 for p in WIDE_PATHS}},
             trace=("hll_fold_kernel",),
             wrapper="update_folds", plain="update_folds_plain",
             inplace=lambda a: [f[0] for f in a[0]],
             rows=lambda a, n: (tuple(one_fold(f, n) for f in a[0]),),
             exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:40"),
    ]


def _unit_cells(spec, args):
    """The tables an f32-sum kernel adds into, zeroed, and the call's
    arguments with every non-zero value replaced by 1.0 (its plain version
    then counts each cell's adds)."""
    import torch
    a = _clone(args)
    name = spec["name"]
    if name == "countmin_fold2":
        for t in a[:2]:
            t.zero_()
        return a[:2], (*a[:4], (a[4] != 0).float(), (a[5] != 0).float())
    if name == "countmin_fold":
        a[0].zero_()
        return a[:1], (*a[:3], (a[3] != 0).float())
    if name == "countmin_tier2":
        pa, pb, h1, h2, va, vb, _ = a
        d, w = pa.base.shape
        wide = [torch.zeros((d, w), device=va.device) for _ in range(2)]
        return wide, (*wide, h1, h2, (va != 0).float(), (vb != 0).float())
    for t in a[0]:  # signal_fold, signal_fold_tiered: the eight tables
        t.zero_()
    idx, vals = (a[2], a[3]) if name == "signal_fold_tiered" else a[1:3]
    return a[0], (a[0], idx, (vals != 0).to(torch.float32))


def adds_per_cell(spec, args) -> list:
    """How many non-zero values each cell of the kernel's f32 tables (for
    kernel 6: of its wide view) takes in this call: the n of the bounds."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, signal_kernel,
    )
    tables, unit_args = _unit_cells(spec, args)
    if spec["name"] == "countmin_fold":
        countmin_kernel.update_plain(*unit_args)
    elif spec["name"] in ("countmin_fold2", "countmin_tier2"):
        countmin_kernel.update_two_plain(*unit_args)
    else:
        signal_kernel.update_plain(*unit_args)
    return _tensors(tuple(tables))


@contextlib.contextmanager
def plain_versions(specs, adds: dict | None = None,
                   touched: dict | None = None):
    """Route every wrapper to its plain version (on any device) for the
    duration: the main path then runs the kernels' PyTorch twins. With
    `adds`, every call of an f32-sum kernel also adds its per-cell count of
    non-zero values into adds[table name], and into touched[table name]
    one for every cell the call reached (the N and F of the bounds)."""
    saved = [(s["mod"], getattr(s["mod"], s["wrapper"])) for s in specs]
    for s in specs:
        plain = getattr(s["mod"], s["plain"])
        if adds is not None and "tables" in s:
            def plain(*args, _s=s, _fn=plain):
                for name, n in zip(_s["tables"], adds_per_cell(_s, args)):
                    adds[name] = adds[name] + n if name in adds else n
                    hit = (n > 0).float()
                    touched[name] = (touched[name] + hit if name in touched
                                     else hit)
                return _fn(*args)
        setattr(s["mod"], s["wrapper"], plain)
    try:
        yield
    finally:
        for (mod, fn), s in zip(saved, specs):
            setattr(mod, s["wrapper"], fn)


@contextlib.contextmanager
def recording(specs, calls: dict):
    """Record a clone of every wrapper call's arguments (before the call:
    in-place kernels mutate their tables)."""
    saved = [(s["mod"], getattr(s["mod"], s["wrapper"])) for s in specs]
    for s, (_, fn) in zip(specs, saved):
        def rec(*args, _fn=fn, _name=s["name"]):
            calls.setdefault(_name, []).append(_clone(args))
            return _fn(*args)
        setattr(s["mod"], s["wrapper"], rec)
    try:
        yield
    finally:
        for (mod, fn), s in zip(saved, specs):
            setattr(mod, s["wrapper"], fn)


def _inplace(spec, args) -> list:
    """The tensors a call of the kernel updates in place."""
    sel = spec["inplace"]
    if callable(sel):
        return sel(args)
    return _tensors(tuple(args[i] for i in sel))


def run_once(spec, fn_name: str, args):
    """Call the kernel (or plain version) on args in place; return the
    output tensors: the in-place tables, then whatever it returned."""
    out = getattr(spec["mod"], fn_name)(*args)
    return _inplace(spec, args) + _tensors(out)


def _expand(x, g: int):
    return x.repeat_interleave(g, dim=-1)


def tier_view_check(tk, tp, n_adds, n_folds, spec, unit: int) -> dict:
    """Hold one plane's tiers and decoded view, kernel side `tk` against
    plain side `tp` (base, mid, top), to the bound of the module docstring,
    given the per-cell adds `n_adds` and touching folds `n_folds` since the
    two sides were equal. Returns the worst reading beside its bound."""
    import torch
    from netobserv_tpu_torch.sketch import tiered
    mg, tg = spec.mid_group, spec.top_group
    tk, tp = tiered.TieredPlane(*tk), tiered.TieredPlane(*tp)
    bk, mk, ok = (x.to(torch.int64) for x in tk)
    bp, mp, op = (x.to(torch.int64) for x in tp)
    dk = tiered.decode_plane(tk, spec, unit).double()
    dp = tiered.decode_plane(tp, spec, unit).double()
    d, w = dk.shape
    v = torch.maximum(dk, dp) * (1 + 2.0 ** -8) + unit
    n_adds, n_folds = n_adds.double(), n_folds.double()
    a = 2 * (n_adds + n_folds) * U * v / unit + n_folds
    a_mid = 2 * a.reshape(d, w // mg, mg).sum(-1)
    a_top = 2 * a.reshape(d, w // tg, tg).sum(-1)
    for name, x, y, lim in (("base", bk, bp, a), ("mid", mk, mp, a_mid),
                            ("top", ok, op, a_top)):
        check(bool(((x - y).abs() <= lim).all()),
              f"tier {name}: kernel and plain differ past their bound")
    satb_k, satb_p = bk == tiered.BASE_MAX, bp == tiered.BASE_MAX
    satm_k, satm_p = mk == tiered.MID_MAX, mp == tiered.MID_MAX
    per_mid = tg // mg

    def mid_total(m, t):
        return (m + (m == tiered.MID_MAX) * _expand(t, per_mid)).double()

    sb = (satb_k | satb_p).double()
    fb = (satb_k ^ satb_p).double()
    sm = _expand((satm_k | satm_p).double(), mg)
    fm = _expand((satm_k ^ satm_p).double(), mg)
    lim = unit * (a + sb * (_expand(a_mid, mg) + sm * _expand(a_top, tg))
                  + fb * _expand(torch.maximum(mid_total(mk, ok),
                                               mid_total(mp, op)), mg)
                  + sb * fm * _expand(torch.maximum(ok, op).double(), tg)
                  ) + 4 * U * v
    diff = (dk - dp).abs()
    check(bool((diff <= lim).all()),
          "decoded view: kernel and plain differ past the tier bound")
    i = int(diff.argmax())
    return {"max_abs_diff": float(diff.reshape(-1)[i]),
            "bound_there": float(lim.reshape(-1)[i]),
            "value_there": float(dp.reshape(-1)[i]),
            "max_diff_over_bound": float((diff / lim).max()),
            "base_saturation_flips": int(fb.sum()),
            "mid_saturation_flips": int((satm_k ^ satm_p).sum())}


def compare_tier2(spec, args, kern, plain) -> dict:
    """Kernel 6 in the production regime: each plane's tiers and decoded
    view, and est, under the bound of the module docstring."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    pa, pb, h1, h2, va, vb, tspec = args
    n_a, n_b = adds_per_cell(spec, args)
    out = {}
    for p, (name, n, unit) in enumerate((("cm_bytes", n_a,
                                          tspec.bytes_unit),
                                         ("cm_pkts", n_b, 1))):
        out[name] = tier_view_check(kern[3 * p:3 * p + 3],
                                    plain[3 * p:3 * p + 3], n,
                                    (n > 0).float(), tspec, unit)
    from netobserv_tpu_torch.sketch import tiered
    dmax = torch.maximum(
        tiered.decode_plane(tiered.TieredPlane(*kern[:3]), tspec,
                            tspec.bytes_unit),
        tiered.decode_plane(tiered.TieredPlane(*plain[:3]), tspec,
                            tspec.bytes_unit)).double()
    delta = 2 * (n_a.double() + 1) * U * (dmax * (1 + 2.0 ** -8)
                                          + tspec.bytes_unit)
    d, w = dmax.shape
    idx = hashing.row_indices(h1, h2, d, w)
    est_lim = torch.gather(delta, 1, idx).amax(dim=0)
    est_k, est_p = kern[6].double(), plain[6].double()
    diff = (est_k - est_p).abs()
    check(bool((diff <= est_lim).all()), "est: kernel and plain differ "
          "past 2*(n+1)*2^-24*V")
    i = int(diff.argmax())
    out["est"] = {"max_abs_diff": float(diff[i]),
                  "bound_there": float(est_lim[i]),
                  "max_rel_diff": float((diff / est_p.abs().clamp(
                      min=1e-30)).max())}
    return out


def compare(spec, args, regime: str) -> dict:
    import torch
    kern = run_once(spec, spec["wrapper"], _clone(args))
    plain = run_once(spec, spec["plain"], _clone(args))
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for k, p in zip(kern, plain):
        check(k.shape == p.shape and k.dtype == p.dtype,
              f"{spec['name']}: output shape/dtype differ")
        if not k.numel():
            continue  # kernel 6's est of an empty batch
        if k.dtype.is_floating_point:
            d = (k.double() - p.double()).abs()
            max_abs = max(max_abs, float(d.max()))
            mag = torch.maximum(k.double().abs(), p.double().abs())
            max_rel = max(max_rel, float((d / mag.clamp(min=1e-30)).max()))
        else:
            max_abs = max(max_abs, float((k.to(torch.int64)
                                          - p.to(torch.int64)).abs().max()))
    res = {"max_abs_err": max_abs, "max_rel_err": max_rel}
    if spec["name"] == "signal_fold_tiered":
        check(_exact(kern[8], plain[8]),
              f"signal_fold_tiered ({regime}): packed HLL bank differs")
    if spec["exact"] or regime == "integer":
        if regime == "integer" and not spec["exact"]:
            top = max(float(p.double().abs().max()) for p in plain
                      if p.numel())
            if spec["name"] == "countmin_tier2":
                from netobserv_tpu_torch.sketch import tiered
                tspec = args[6]
                top = max(float(tiered.decode_plane(
                    tiered.TieredPlane(*plain[3 * p:3 * p + 3]), tspec,
                    u).max()) for p, u in ((0, tspec.bytes_unit), (1, 1)))
            check(top < 2 ** 24, f"{spec['name']}: integer regime input "
                  f"reaches {top} >= 2^24")
        check(all(_exact(k, p) for k, p in zip(kern, plain)),
              f"{spec['name']} ({regime}): not bit-exact, max abs err "
              f"{max_abs}")
        res["bound"] = "bit-exact"
    elif spec["name"] == "countmin_tier2":
        res.update(bound="tier bound (module docstring)",
                   worst=compare_tier2(spec, args, kern, plain))
    else:
        adds = adds_per_cell(spec, args)
        for k, p, n in zip(kern, plain, adds):
            lim = 2 * (n.double() + 1) * U * torch.maximum(
                k.double().abs(), p.double().abs())
            check(bool(((k.double() - p.double()).abs() <= lim).all()),
                  f"{spec['name']} ({regime}): outside the 2*(n+1)*2^-24 "
                  "bound")
        res["bound"] = "2*(n_adds+1)*2^-24 relative per cell"
    return res


def integer_inputs(spec, args):
    """The call's indices on fresh (zero) tables with each non-zero value v
    replaced by the integer v mod 251 + 1: every per-cell sum then stays
    below 16384 * 251 < 2^24, where add order cannot change a bit, while
    the same cells take the same number of atomics as on the main path."""
    import torch
    a = _clone(args)
    for t in _inplace(spec, a):
        t.zero_()

    def small(v):
        return torch.where(v != 0, torch.remainder(v, 251.0).floor() + 1,
                           0.0)

    name = spec["name"]
    if name == "countmin_fold2":
        return (*a[:4], small(a[4]), small(a[5]))
    if name == "countmin_fold":
        return (*a[:3], small(a[3]))
    if name == "countmin_tier2":
        return (*a[:4], small(a[4]), small(a[5]), a[6])
    if name == "signal_fold":
        return (a[0], a[1], small(a[2]))
    if name == "signal_fold_tiered":
        return (a[0], a[1], a[2], small(a[3]), *a[4:])
    return a


def integer_chain(spec, args) -> list[dict]:
    """Kernel 6 in the integer regime over CHAIN folds of the same call
    from fresh tiers, the kernel and the plain version each on its own
    tiers, bit-exact after every fold; the last fold must have reached the
    top tier."""
    from netobserv_tpu_torch.sketch import tiered
    a = integer_inputs(spec, args)
    ak, ap = _clone(a), _clone(a)
    out = []
    for fold in range(spec["chain"]):
        kern = run_once(spec, spec["wrapper"], ak)
        plain = run_once(spec, spec["plain"], ap)
        top = max(float(tiered.decode_plane(
            tiered.TieredPlane(*plain[3 * p:3 * p + 3]), a[6], u).max())
            for p, u in ((0, a[6].bytes_unit), (1, 1)))
        check(top < 2 ** 24, f"integer chain reaches {top} >= 2^24")
        check(all(_exact(k, p) for k, p in zip(kern, plain)),
              f"{spec['name']} (integer chain fold {fold}): not bit-exact")
        out.append({"fold": fold, "max_decoded": top})
    tops = sum(int((p.top.to("cpu").numpy() > 0).sum()) for p in ak[:2])
    check(tops > 0, "integer chain never reached the top tier")
    out[-1]["top_cells_active"] = tops
    return out


def timing(spec, args):
    """`measure` of the kernel and of its plain version on the main path's
    inputs; in-place tables are restored from the captured state before
    every launch."""
    work = _clone(args)
    src, dst = _inplace(spec, args), _inplace(spec, work)

    def restore():
        for d, s in zip(dst, src):
            d.copy_(s)

    setup = restore if spec["inplace"] else None
    out = []
    for fn_name in (spec["wrapper"], spec["plain"]):
        fn = getattr(spec["mod"], fn_name)
        out.append(measure(lambda: fn(*work), setup))
    return out[0], out[1]


def library_call(spec, args):
    """One PyTorch call computing the same function (a yardstick only; the
    port never calls it), with its index/value prep done outside it; None
    where there is none."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.ops.kernels import hll_kernel
    name = spec["name"]
    if "library_note" in spec:
        return None
    if name == "countmin_fold2":
        ca, cb, h1, h2, va, vb = args
        d, w = ca.shape
        idx = hashing.row_indices(h1, h2, d, w)
        cell = (idx + torch.arange(d, device=idx.device)[:, None] * w
                ).reshape(-1)
        cell = torch.cat([cell, cell + d * w])
        vals = torch.cat([va.expand(d, -1).reshape(-1),
                          vb.expand(d, -1).reshape(-1)])
        table = torch.stack([ca, cb]).reshape(-1)
        return lambda: table.index_put_((cell,), vals, accumulate=True)
    if name == "topk_reduce":
        # the two maxima in one scatter (the winner row needs a second)
        mslot, target, est, k = args
        cell = torch.cat([mslot, target + k + 1])
        vals = torch.cat([est, est])
        table = torch.full((2 * (k + 1),), -1.0, device=est.device)
        return lambda: table.scatter_reduce_(0, cell, vals, "amax")
    if name == "countmin_fold":
        counts, h1, h2, vals = args
        d, w = counts.shape
        idx = hashing.row_indices(h1, h2, d, w)
        cell = (idx + torch.arange(d, device=idx.device)[:, None] * w
                ).reshape(-1)
        flat_vals = vals.expand(d, -1).reshape(-1)
        table = counts.clone().reshape(-1)
        return lambda: table.index_add_(0, cell, flat_vals)
    if name.startswith("hll_fold"):
        # the folds' register files end to end, one scatter over them all
        cells, ranks, tables = [], [], []
        for f in _hll_folds(name, args):
            cells.append(_hll_cells(f) + sum(t.numel() for t in tables))
            ranks.append(torch.where(f[-1], hll_kernel.rank(f[-2]), 0))
            tables.append(f[0].reshape(-1))
        cell, rank = torch.cat(cells), torch.cat(ranks)
        table = torch.cat(tables)
        return lambda: table.scatter_reduce_(0, cell, rank, "amax")
    planes, idx, vals = args
    from netobserv_tpu_torch.ops.kernels.signal_kernel import FAMILY
    sizes = [p.shape[0] for p in planes]
    offs = [sum(sizes[:j]) for j in range(len(sizes))]
    cell = torch.cat([idx[FAMILY[j]] + offs[j] for j in range(len(sizes))])
    table = torch.cat([p.clone() for p in planes])
    flat = vals.reshape(-1)
    return lambda: table.index_add_(0, cell, flat)


def _hll_folds(name: str, args) -> tuple:
    """The folds of a call of kernel 3, kernel 8 or the folds launch."""
    return args[0] if name == "hll_fold_folds" else (args,)


def _hll_cells(fold):
    """Flat cell of every row of an HLL fold: h1 & (m-1) for kernel 3's
    (regs, h1, h2, valid), (dst_h & (D-1)) * m + (src_h1 & (m-1)) for
    kernel 8's (regs, dst_h, src_h1, src_h2, valid)."""
    if len(fold) == 4:
        return fold[1] & (fold[0].shape[0] - 1)
    dbuckets, m = fold[0].shape
    return (fold[1] & (dbuckets - 1)) * m + (fold[2] & (m - 1))


def _sector_bytes(elems, elem_size: int = 4) -> int:
    """Bytes of the distinct 32-byte sectors that the given element indices
    of one array reach, read once and written once."""
    import torch
    return 2 * 32 * int(torch.unique(elems // (32 // elem_size)).numel())


def _signal_bytes_ops(planes, idx, vals) -> tuple[int, int]:
    from netobserv_tpu_torch.ops.kernels.signal_kernel import FAMILY
    nbytes = sum(t.numel() * t.element_size() for t in (idx, vals)) + sum(
        _sector_bytes(idx[FAMILY[j]][vals[j] != 0])
        for j in range(len(planes)))
    return nbytes, int((vals != 0).sum())


def _cm_atomics(cells, values, size: int) -> dict:
    """The atomics of kernels 1 and 5 as their design makes them, for the
    cells r * W + col [d, n] of a call and each plane's values [n]: thread
    t = r * n + b sits in warp t // 32, and the leader of each distinct
    (warp, cell) with a non-zero value makes one atomic a plane. Beside
    them, one per (record, row) of a non-zero value, as a design without
    warp aggregation makes them."""
    import torch
    d, n = cells.shape
    warp = (torch.arange(d, device=cells.device)[:, None] * n
            + torch.arange(n, device=cells.device)) // WARP
    hits = [cells[:, v != 0].reshape(-1) for v in values]
    groups = [torch.unique(warp[:, v != 0] * size + cells[:, v != 0]) % size
              for v in values]

    def most(cs):
        return max((int(torch.bincount(c).max()) for c in cs if c.numel()),
                   default=0)

    return {"atomics": sum(g.numel() for g in groups),
            "max_atomics_one_address": most(groups),
            "atomics_one_per_row": sum(c.numel() for c in hits),
            "max_atomics_one_address_one_per_row": most(hits)}


def bound_of(spec, args) -> dict:
    """Least time the card could take for this call: the larger of the
    bytes it must move over HBM bandwidth and its f32 operations over the
    f32 peak (see the module docstring), with the counts behind them."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.ops.kernels import countmin_kernel

    def read(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    name = spec["name"]
    extra = {}
    if name in ("countmin_fold2", "countmin_fold"):
        # kernel 1 (ca, cb, h1, h2, va, vb) or kernel 5 (counts, h1, h2, vals)
        planes = 2 if name == "countmin_fold2" else 1
        h1, h2 = args[planes:planes + 2]
        values = args[planes + 2:]
        d, w = args[0].shape
        cells = (hashing.row_indices(h1, h2, d, w)
                 + torch.arange(d, device=h1.device)[:, None] * w)
        hits = [cells[:, v != 0].reshape(-1) for v in values]
        nbytes = read(args[planes:]) + sum(_sector_bytes(c) for c in hits)
        ops = sum(c.numel() for c in hits)  # one f32 add per (record, row)
        extra = _cm_atomics(cells, values, d * w)
    elif name == "countmin_tier2":
        pa, pb, h1, h2, va, vb, tspec = args
        d, w = pa.base.shape
        cols = hashing.row_indices(h1, h2, d, w)
        rows = torch.arange(d, device=h1.device)[:, None].expand_as(cols)
        nbytes = read((h1, h2, va, vb)) + 4 * h1.numel()  # inputs, est
        ops = 0
        for plane, v in ((pa, va), (pb, vb)):
            c, r = cols[:, v != 0].reshape(-1), rows[:, v != 0].reshape(-1)
            ops += c.numel()
            for arr, g in ((plane.base, 1), (plane.mid, tspec.mid_group),
                           (plane.top, tspec.top_group)):
                nbytes += _sector_bytes(r * (w // g) + c // g,
                                        arr.element_size())
        tiles = torch.bincount((cols // countmin_kernel.TILE_W).reshape(-1))
        extra = {"adds": ops, "max_adds_one_cell": max(
            int(torch.bincount((cols + rows * w)[:, v != 0].reshape(-1)
                               ).max()) for v in (va, vb)),
            "bin_entries": cols.numel(),
            "max_bin_entries": int(tiles.max()),
            "median_bin_entries": float(tiles.float().median())}
    elif name == "topk_reduce":
        mslot, target, est, k = args
        nbytes = read((mslot, target, est)) + 3 * k * 4  # fresh outputs
        ops = 3 * est.numel()  # two maxima and a minimum per row
    elif name.startswith("hll_fold"):
        # each lane once, though several folds read it; each register file's
        # sectors that its valid rows reach
        folds = _hll_folds(name, args)
        lanes = {t.data_ptr(): t for f in folds for t in f[1:]}
        nbytes = read(lanes.values()) + sum(
            _sector_bytes(_hll_cells(f)[f[-1]]) for f in folds)
        ops = sum(int(f[-1].sum()) for f in folds)
        # the kernel's warps as it makes them (row b of a fold in warp
        # b // 32): one atomic per distinct (warp, cell) of valid rows
        groups = [torch.unique(
            (torch.arange(f[-1].numel(), device=f[-1].device) // WARP
             * f[0].numel() + _hll_cells(f))[f[-1]]) % f[0].numel()
            for f in folds]
        extra = {"atomics": sum(g.numel() for g in groups),
                 "max_atomics_one_address": max(
                     (int(torch.bincount(g).max()) for g in groups
                      if g.numel()), default=0),
                 "atomics_one_per_row": ops}
    elif name == "signal_fold_tiered":
        planes, packed, idx, vals, h1, h2, valid = args
        nbytes, ops = _signal_bytes_ops(planes, idx, vals)
        m_hll = packed.shape[0] // 3 * 4
        first = 3 * ((h1 & (m_hll - 1))[valid] // 4)  # first byte of triple
        nbytes += read((h1, h2, valid)) + _sector_bytes(
            torch.cat([first, first + 2]), 1)
        ops += int(valid.sum())
    else:
        nbytes, ops = _signal_bytes_ops(*args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by,
            "bound_bytes": nbytes, "bound_ops": ops, **extra}


def uniform_variant(spec, args):
    """The same call with the hot key spread out: random hashes (kernels 1,
    3, 5, 6 and 8, and the HLL folds launch), random slots (kernel 2) or
    random indices in every table (kernel 4; kernel 7 also random HLL
    registers), to price same-address atomics."""
    import torch
    if spec["name"].startswith("hll_fold"):
        # every hash lane random (a lane several folds read stays shared)
        folds = _hll_folds(spec["name"], args)
        g = torch.Generator(device=folds[0][-1].device).manual_seed(1)
        rand: dict = {}

        def spread(f):
            for t in f[1:-1]:
                if t.data_ptr() not in rand:
                    rand[t.data_ptr()] = torch.randint(
                        0, 2**32, t.shape, generator=g, device=t.device,
                        dtype=torch.int64)
            return (f[0], *(rand[t.data_ptr()] for t in f[1:-1]), f[-1])

        folds = tuple(spread(f) for f in folds)
        return (folds,) if spec["name"] == "hll_fold_folds" else folds[0]
    if spec["name"] in ("signal_fold", "signal_fold_tiered"):
        tiered = spec["name"] == "signal_fold_tiered"
        planes, idx = args[0], args[2 if tiered else 1]
        g = torch.Generator(device=idx.device).manual_seed(1)
        sizes = [planes.ddos_rate.shape[0]] * 3 + [
            planes.dscp_bytes.shape[0], planes.drop_causes.shape[0]]
        uni = torch.stack([torch.randint(0, size, idx.shape[1:], generator=g,
                                         device=idx.device)
                           for size in sizes])
        if not tiered:
            return (planes, uni, args[2])
        h1 = torch.randint(0, 2**32, idx.shape[1:], generator=g,
                           device=idx.device, dtype=torch.int64)
        return (planes, args[1], uni, args[3], h1, *args[5:])
    if spec["name"] in ("countmin_fold2", "countmin_tier2", "countmin_fold"):
        lanes = 1 if spec["name"] == "countmin_fold" else 2  # tables first
        h1 = args[lanes]
        g = torch.Generator(device=h1.device).manual_seed(1)
        r = lambda: torch.randint(0, 2**32, h1.shape, generator=g,  # noqa
                                  device=h1.device, dtype=torch.int64)
        return (*args[:lanes], r(), r() | 1, *args[lanes + 2:])
    mslot, target, est, k = args
    g = torch.Generator(device=mslot.device).manual_seed(1)
    r = lambda: torch.randint(0, k + 1, mslot.shape, generator=g,  # noqa
                              device=mslot.device, dtype=torch.int64)
    return (r(), r(), est, k)


def contract_cases(spec, args) -> list[dict]:
    """The redesigned kernels against their plain versions, bit-exact, on
    the seeded contract cases of `ops/kernels/cases.py` (the CPU tests hold
    the plain versions against the JAX package on the same cases): kernel 2
    at K = 128, the path's K and a K of three slot tiles, kernel 4 at the
    path's m onto tables of small integers, kernel 7 the same with the
    path's bank and one of 64 registers (one tile of 16 triples), the
    last case at m = 16,384, kernels 1, 5 and 6 at a width of one tile and
    the path's width (kernels 1 and 5 onto tables of small integers, kernel
    5 with `va` as its one value row, kernel 6 onto `cases.tier_planes`
    under the path's TierSpec), kernels 3 and 8 and the folds launch at the
    path's geometry of each fold and at a small one (64 registers, a 32 x
    16 grid), from the cases' pre-fold registers."""
    import numpy as np
    import torch
    from netobserv_tpu_torch.ops.kernels import (
        cases, countmin_kernel, signal_kernel, topk_kernel,
    )
    from netobserv_tpu_torch.sketch import tiered
    if spec["name"].startswith("hll_fold"):
        return hll_contract_cases(spec, args)
    dev = args[2].device  # the path's device: est of kernel 2, h1 or vals
    out = []
    if spec["name"].startswith("countmin"):
        tier = spec["name"] == "countmin_tier2"
        planes = 1 if spec["name"] == "countmin_fold" else 2
        d, w = args[0].base.shape if tier else args[0].shape
        rng = np.random.default_rng(3)
        for width in (countmin_kernel.TILE_W, w):
            for name, c in cases.countmin_cases(width):
                batch = [torch.from_numpy(c[f]).to(dev)
                         for f in ("h1", "h2", "va", "vb")[:2 + planes]]
                if tier:
                    tspec = args[6]
                    a = (*(tiered.TieredPlane(*(torch.from_numpy(x).to(dev)
                                                for x in p))
                           for p in cases.tier_planes(
                               d, width, tspec.mid_group, tspec.top_group)),
                         *batch, tspec)
                else:
                    a = (*(torch.from_numpy(rng.integers(0, 50, (
                        d, width)).astype(np.float32)).to(dev)
                        for _ in range(planes)), *batch)
                r = compare(spec, a, "integer")
                out.append({"case": name, "w": width, "rows": len(c["va"]),
                            "max_abs_err": r["max_abs_err"]})
        return out
    if spec["name"] == "topk_reduce":
        # the path's K, a small one, and one of three tiles
        for k in (128, args[3], 2 * topk_kernel.TILE + 5):
            for name, c in cases.topk_cases(k):
                a = (*(torch.from_numpy(c[f]).to(dev)
                       for f in ("mslot", "target", "est")), k)
                r = compare(spec, a, "integer")
                out.append({"case": name, "k": k, "rows": len(c["est"]),
                            "max_abs_err": r["max_abs_err"]})
        return out
    m = args[0].ddos_rate.shape[0]
    rng = np.random.default_rng(3)
    if spec["name"] == "signal_fold_tiered":
        for m_hll in (args[1].shape[0] // 3 * 4, 64):
            for name, c in cases.tiered_signal_cases(m, m_hll):
                planes = signal_kernel.SignalPlanes(*(
                    torch.from_numpy(rng.integers(0, 50, size).astype(
                        np.float32)).to(dev)
                    for size in (c["m"],) * 6 + tuple(
                        p.shape[0] for p in args[0][6:])))
                packed = tiered.pack_hll(torch.from_numpy(c["regs"]).to(dev))
                a = (planes, packed, *(torch.from_numpy(c[f]).to(dev) for f
                                       in ("idx", "vals", "h1", "h2",
                                           "valid")))
                r = compare(spec, a, "integer")
                out.append({"case": name, "m": c["m"], "m_hll": m_hll,
                            "rows": c["vals"].shape[1],
                            "max_abs_err": r["max_abs_err"]})
        return out
    for name, c in cases.signal_cases(m):
        planes = signal_kernel.SignalPlanes(*(
            torch.from_numpy(rng.integers(0, 50, p.shape[0]).astype(
                np.float32)).to(dev) for p in args[0]))
        a = (planes, torch.from_numpy(c["idx"]).to(dev),
             torch.from_numpy(c["vals"]).to(dev))
        r = compare(spec, a, "integer")
        out.append({"case": name, "m": m, "rows": c["vals"].shape[1],
                    "max_abs_err": r["max_abs_err"]})
    return out


def hll_contract_cases(spec, args) -> list[dict]:
    """contract_cases of kernels 3 and 8 and the folds launch: each fold
    of the call takes the case of one name from `cases.hll_fold_cases` at
    its geometry (seeded by its place), so a folds call runs its folds on
    one batch size in one launch."""
    import torch
    from netobserv_tpu_torch.ops.kernels import cases
    folds = _hll_folds(spec["name"], args)
    dev = folds[0][0].device
    path = [(1, f[0].shape[0]) if len(f) == 4 else tuple(f[0].shape)
            for f in folds]
    small = [(1, 64) if d == 1 else (32, 16) for d, _ in path]
    out = []
    for geometry in (path, small):
        per_fold = [cases.hll_fold_cases(d, m, seed)
                    for seed, (d, m) in enumerate(geometry)]
        for named in zip(*per_fold):
            name = named[0][0]
            fs = []
            for (_, c), f in zip(named, folds):
                t = {k: torch.from_numpy(v).to(dev) for k, v in c.items()}
                fs.append((t["regs"].reshape(-1), t["h1"], t["h2"],
                           t["valid"]) if len(f) == 4 else
                          (t["regs"], t["dst"], t["h1"], t["h2"],
                           t["valid"]))
            a = (tuple(fs),) if spec["name"] == "hll_fold_folds" else fs[0]
            r = compare(spec, a, "integer")
            out.append({"case": name, "geometry": geometry,
                        "rows": len(named[0][1]["valid"]),
                        "max_abs_err": r["max_abs_err"]})
    return out


def launch_shapes(spec, args) -> tuple[list, int]:
    """The grids a call of the kernel launches at these arguments (the
    wrappers' `launch_shape*`), and its cluster barriers (kernel 2: two
    per slot tile)."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
    )
    name = spec["name"]
    if name == "topk_reduce":
        return [topk_kernel.launch_shape(args[3])], 2
    if name == "signal_fold_tiered":
        return [signal_kernel.launch_shape_tiered(args[3].shape[1],
                                                  args[1].shape[0])], 0
    if name == "signal_fold":
        return [signal_kernel.launch_shape(args[2].shape[1])], 0
    if name == "countmin_fold2":
        return [countmin_kernel.launch_shape(args[2].shape[0],
                                             args[0].shape[0])], 0
    if name == "countmin_fold":
        return [countmin_kernel.launch_shape(args[1].shape[0],
                                             args[0].shape[0])], 0
    if name == "countmin_tier2":
        d, w = args[0].base.shape
        return countmin_kernel.launch_shapes_tier2(
            args[2].shape[0], d, w, args[6].mid_group, args[6].top_group), 0
    folds = _hll_folds(name, args)  # kernels 3 and 8, the folds launch
    return [hll_kernel.launch_shape(folds[0][1].shape[0], len(folds))], 0


def launch_floor(spec, args) -> dict:
    """Device and event time of an empty kernel launched at each of the
    kernel's own grids, clusters, blocks and shared memory
    (csrc/launch_floor.cu), summed over its launches, alone and, for
    kernel 2, with the two cluster barriers of its one slot tile: the least
    a call of that shape takes, beside the byte bound."""
    import torch
    from netobserv_tpu_torch.ops.kernels._build import CudaKernel
    shapes, barriers = launch_shapes(spec, args)
    floor = CudaKernel(FLOOR_SOURCE, "launch_floor", n_ptrs=0, n_ints=5)
    dev = torch.device("cuda")
    out = {"shapes": [s._asdict() for s in shapes]}
    for syncs in sorted({0, barriers}):
        times = [measure(lambda s=s: floor.launch([], [*s, syncs], dev))
                 for s in shapes]
        out[f"syncs_{syncs}"] = {"device_ms": sum(dv for _, dv in times),
                                 "event_ms": sum(ev for ev, _ in times)}
    return out


# --------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return {"phase": "device", "kind": name, "nvidia_smi": line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def phase_build(specs) -> dict:
    """Every kernel library (one nvcc each, all at once), then the native
    packer's (g++)."""
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build(sorted({s["kernel"].source for s in specs}
                               | {FLOOR_SOURCE}))
    t1 = time.perf_counter()
    flowpack.native_lib()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "per_source_seconds": secs,
            "packer_seconds": time.perf_counter() - t1}


def tiered_cfg():
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch.tiered import TierSpec
    return sk.SketchConfig(tiered=TierSpec())


def capture_main_path_inputs(specs, dense, cfg) -> dict:
    """Warm a state under `cfg` with WARM_FOLDS folds (plain versions),
    then record every wrapper call of one more fold: the exact inputs the
    path hands each kernel, production-regime tables included."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    # eager: a replayed graph calls no wrapper
    exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                              capture=False)
    calls: dict = {}
    with plain_versions(specs):
        for i in range(WARM_FOLDS):
            exp.fold_dense(dense[i % len(dense)])
        with recording(specs, calls):
            exp.fold_dense(dense[WARM_FOLDS % len(dense)])
    exp.close()
    return calls


def phase_kernels(specs, calls) -> list[dict]:
    import torch
    results = []
    for s in specs:
        if "derive" in s:
            src, cut = s["derive"]
            recs = [c for a in calls[s["path"]].get(src, []) for c in cut(a)]
        else:
            recs = calls[s["path"]].get(s["name"], [])
        check(len(recs) >= 1, f"{s['name']}: the main path never called it")
        case = {"phase": "kernel", "name": s["name"], "path": s["path"],
                "calls_per_fold": len(recs), "cases": []}
        s["kernel"].launches = 0
        errs = []
        for ci, args in enumerate(recs):
            for n in (BATCH, BATCH - 1):
                a = s["rows"](args, n)
                for regime, aa in (("production", a),
                                   ("integer", integer_inputs(s, a))):
                    r = compare(s, aa, regime)
                    r.update(call=ci, rows=n, regime=regime)
                    case["cases"].append(r)
                    errs.append(r["max_abs_err"])
        args = recs[0]
        if "chain" in s:
            case["integer_chain"] = integer_chain(s, args)
        (k_ms, dev_k_ms), (p_ms, dev_p_ms) = timing(s, args)
        lib = library_call(s, args)
        lib_ms, dev_lib_ms = measure(lib) if lib else (None, None)
        case.update(kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    device_kernel_ms=dev_k_ms, device_plain_ms=dev_p_ms,
                    device_library_ms=dev_lib_ms, **bound_of(s, args),
                    max_abs_err=max(errs),
                    max_rel_err=max(c["max_rel_err"] for c in case["cases"]))
        if "library_note" in s:
            case["library_note"] = s["library_note"]
        if s["name"] in REDESIGNED:
            uni = uniform_variant(s, args)
            case["device_kernel_ms_uniform_keys"] = timing(s, uni)[0][1]
            case["contract_cases"] = contract_cases(s, args)
        case["launch_floor"] = launch_floor(s, args)
        torch.cuda.synchronize()
        case["kernel_phase_launches"] = s["kernel"].launches
        check(case["kernel_phase_launches"] > 0,
              f"{s['name']}: the kernel phase never launched it")
        emit(case)
        results.append(case)
    return results


def hot_key_rows(pool) -> list[int]:
    import numpy as np
    return [int(np.bincount(ranks).max()) for _, ranks in pool]


def dense_feeder(dense):
    """Fold pool batch bi through the dense feed."""
    return lambda exp, bi: exp.fold_dense(dense[bi])


def event_feeder(events):
    """Fold pool batch bi through the exporter's feed of events."""
    return lambda exp, bi: exp.fold_events(events[bi][0], **events[bi][1])


def _concat(parts):
    """One (events, feature lanes) of the parts' rows, in order."""
    import numpy as np
    return (np.concatenate([e for e, _ in parts]),
            {k: np.concatenate([f[k] for _, f in parts])
             for k in parts[0][1]})


class LaneFeeder:
    """The lanes path's traffic: a window is the pool batches it names
    (FOLDS_PER_WINDOW of them, as on every path), delivered as evictions
    (`export_evicted`) of seeded sizes: EVICT_ROWS three times in four,
    else uniform over EVICT_LARGE, the last one cut at the window's end.
    The call for a window's i-th batch delivers every eviction that ends
    within its first i + 1 batches; the last call flushes the pending
    tail, so the window's tables hold all its records. Every exporter gets
    the same evictions (the sizes come from `numpy.random.default_rng(1)`,
    drawn anew for each exporter)."""

    def __init__(self, events):
        import numpy as np
        n = len(events)
        # both windows fold batches 0..n-1 in turn: one stream serves them
        self.stream = _concat([events[i % n]
                               for i in range(FOLDS_PER_WINDOW)])
        self.n_batches = n
        self._exp = None
        self._np = np

    def _cuts(self) -> list[int]:
        """The ends of one window's evictions in the stream."""
        total, ends = FOLDS_PER_WINDOW * BATCH, []
        end = 0
        while end < total:
            if self._rng.random() < 0.75:
                size = EVICT_ROWS
            else:
                size = int(self._rng.integers(*EVICT_LARGE))
            end = min(end + size, total)
            ends.append(end)
        return ends

    def __call__(self, exp, bi: int) -> None:
        from netobserv_tpu_torch.datapath.fetcher import EvictedFlows
        if exp is not self._exp:
            self._exp, self._calls = exp, 0
            self._rng = self._np.random.default_rng(1)
            self.sizes = []
        i = self._calls % FOLDS_PER_WINDOW
        if i == 0:
            self._ends, self._start = self._cuts(), 0
            self.sizes += [b - a for a, b in zip([0, *self._ends],
                                                 self._ends)]
        self._calls += 1
        ev, lanes = self.stream
        upto = (i + 1) * BATCH
        while self._ends and self._ends[0] <= upto:
            lo, hi = self._start, self._ends.pop(0)
            exp.export_evicted(EvictedFlows(
                ev[lo:hi], **{k: v[lo:hi] for k, v in lanes.items()}))
            self._start = hi
        if i == FOLDS_PER_WINDOW - 1:
            exp.flush()


class SuperbatchFeeder:
    """Folds of k pool batches at once (one eviction of k * BATCH rows,
    which the lanes feed dispatches as one k-superbatch): call j folds
    batches jk .. jk + k - 1 (mod the pool)."""

    def __init__(self, events, k: int):
        n = len(events)
        self.k = k
        self.parts = [_concat([events[(j * k + i) % n] for i in range(k)])
                      for j in range(n)]

    def __call__(self, exp, bi: int) -> None:
        ev, lanes = self.parts[bi % len(self.parts)]
        exp.fold_events(ev, **lanes)


@contextlib.contextmanager
def counting_plains(specs, counts: dict):
    """Count every call of a plain version (by the wrappers or anyone) in
    counts[kernel name] for the duration."""
    saved = [(s["mod"], s["plain"], getattr(s["mod"], s["plain"]))
             for s in specs]
    for s, (mod, attr, fn) in zip(specs, saved):
        def counted(*args, _fn=fn, _name=s["name"]):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args)
        setattr(mod, attr, counted)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _pack_seconds(exp) -> float:
    """The host seconds the exporter's ring spent packing so far (0 before
    its first fold of events makes the ring)."""
    return exp.ring.pack_seconds if exp.ring is not None else 0.0


def _watch_stats(exp) -> list:
    """The compile watch's snapshot, taken while the exporter lives: the
    entries of its captured folds, which must stand in it. Kept in
    WATCHED for the `retrace_watch` line."""
    from netobserv_tpu_torch.utils import retrace
    snap = retrace.snapshot()
    mine = [c.stats() for c in exp.captures]
    check(all(m in snap for m in mine),
          f"captured folds {mine} missing from the watch's snapshot")
    WATCHED.extend(mine)
    return mine


def _window(exp, feed, n_batches: int, first: int, n_folds: int,
            adds: dict, touched: dict) -> dict:
    """Fold n_folds pool batches from `first` (mod n_batches) through
    `feed`, then read the pre-roll tables (and tier arrays), roll, and time
    each step; for the resident feed also the ring's pack time."""
    import torch
    from netobserv_tpu_torch.sketch import tiered
    adds.clear()
    touched.clear()
    torch.cuda.synchronize()
    pack0 = _pack_seconds(exp)
    t0 = time.perf_counter()
    batches = []
    for i in range(n_folds):
        bi = (first + i) % n_batches
        batches.append(bi)
        feed(exp, bi)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    t1 = time.perf_counter()
    tables = exp.state_tables()
    t2 = time.perf_counter()
    tiers = (_clone(exp.state.tables)
             if isinstance(exp.state, tiered.TieredState) else None)
    report = exp.roll()
    return dict(feed=batches, seconds=secs, tables=tables, tiers=tiers,
                report=report, tables_seconds=t2 - t1,
                roll_seconds=time.perf_counter() - t2,
                pack_seconds=_pack_seconds(exp) - pack0,
                adds={k: v.cpu().numpy() for k, v in adds.items()},
                touched={k: v.cpu().numpy() for k, v in touched.items()})


def run_windows(feed, n_batches: int, mode: str, specs, cfg,
                decay_window: bool = False, ring: bool = False,
                exp_kw: dict | None = None):
    """Fold WINDOWS x FOLDS_PER_WINDOW pool batches through `feed` into an
    exporter under `cfg` (reset roll mode), and with `decay_window` one
    more window of DECAY_FOLDS rolled in decay mode. `mode` (one of MODES)
    picks the fold: the captured graphs, or op by op with the kernels or
    with the plain versions. Per window the pre-roll tables (and tier
    arrays), the report, the times and, on the plain run, the per-cell add
    counts of the window's f32 sums. The launch counts are set to 0 just
    before the reset windows and read just after them; on the kernel runs
    every call of a plain version is counted too (there must be none). The
    captured run also keeps its graphs' compile-watch stats. The exporter
    takes `exp_kw` (its feed, pack threads, ladder). With `ring`, the
    ring (its counters), the key tables against the host dictionaries
    (resident rings), the pending buffer's direct rows and the records are
    read before the exporter closes."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.sketch import tiered
    check(mode in MODES, f"unknown mode {mode}")
    adds: dict = {}
    touched: dict = {}
    plain_calls: dict = {}
    ctx = (plain_versions(specs, adds, touched) if mode == "plain"
           else counting_plains(specs, plain_calls))
    out = {}
    with ctx:
        exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                  capture=mode == "captured",
                                  **(exp_kw or {}))
        for s in specs:
            s["kernel"].launches = 0
        out["windows"] = [
            _window(exp, feed, n_batches, w * FOLDS_PER_WINDOW,
                    FOLDS_PER_WINDOW, adds, touched) for w in range(WINDOWS)]
        out["launches"] = {s["name"]: s["kernel"].launches for s in specs}
        out["folds"], out["rolls"] = exp.folds, exp.rolls
        out["resident_bytes"] = exp.counter_table_bytes()
        if ring:
            from netobserv_tpu_torch.sketch import staging
            out["ring"] = exp.ring
            out["records"] = exp.records
            out["direct_rows"] = exp.pending.direct_rows
            if isinstance(exp.ring, staging.ShardedResidentStagingRing):
                out["key_table_check"] = key_table_check(exp.ring)
        if decay_window:
            exp.reset_sketches, exp.decay_factor = False, DECAY_FACTOR
            for s in specs:
                s["kernel"].launches = 0
            pre = _clone(exp.state.tables)
            win = _window(exp, feed, n_batches, WINDOWS * FOLDS_PER_WINDOW,
                          DECAY_FOLDS, adds, touched)
            win["launches"] = {s["name"]: s["kernel"].launches
                               for s in specs}
            decayed = [tiered.decay_plane(getattr(win["tiers"], p),
                                          DECAY_FACTOR)
                       for p in ("cm_bytes", "cm_pkts")]
            got = (exp.state.tables.cm_bytes, exp.state.tables.cm_pkts)
            win["decay_exact"] = all(_exact(x, y) for pw, pg in zip(
                decayed, got) for x, y in zip(pw, pg))
            win["hll_reset"] = not any(bool(t.any()) for t in (
                exp.state.tables.hll_src, exp.state.tables.hll_per_dst,
                exp.state.tables.hll_per_src))
            win["tiers_moved"] = not all(_exact(x, y) for x, y in zip(
                _tensors(pre), _tensors(exp.state.tables)))
            out["decay"] = win
        out["watch"] = _watch_stats(exp)
        check(mode == "captured" or not out["watch"],
              f"{mode} run captured {out['watch']}")
        exp.close()
    if mode != "plain":
        check(not plain_calls, f"plain versions ran on the card: "
              f"{plain_calls}")
    return out


def key_table_check(ring) -> dict:
    """Every live slot of each region's key table on the card holds the
    words of its key in that region's host dictionary: for a native
    dictionary, the words of each slot below its count look up to that
    slot."""
    import numpy as np
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.sketch import carry
    tables = carry.key_table_to_numpy(ring.key_tables)
    live = []
    for r, (table, kd) in enumerate(zip(tables, ring.kdicts)):
        if isinstance(kd, flowpack.NativeKeyDict):
            n = kd.count()
            ok = np.array_equal(kd.slots_of(table[:n]), np.arange(n))
        else:
            slots = np.fromiter(kd.slots.values(), np.int64)
            words = np.frombuffer(b"".join(kd.slots), np.uint32).reshape(
                -1, 10)
            n = len(slots)
            ok = np.array_equal(table[slots], words)
        check(ok, f"region {r}: the key table on the card differs from the "
              "host dictionary")
        live.append(n)
    check(live[0] > 0, "the host dictionary is empty")
    return {"regions": len(live), "live_slots": live, "equal": True,
            "packer": ("native" if isinstance(ring.kdicts[0],
                                              flowpack.NativeKeyDict)
                       else "python")}


def compare_tables(a: dict, b: dict, adds: dict, tier_check=None) -> dict:
    """Kernel-path vs plain-path tables of one window: a cell that took n
    f32 adds (`adds`) is held to 2 * (n + 1) * 2^-24 relative, except the
    tiered CM tables, which `tier_check(name)` holds to the tier bound;
    every other table is exact, apart from the heavy-hitter table
    (identity overlap) and its eviction count, which follows it."""
    import numpy as np
    worst = 0.0
    tier = {}
    for k in a:
        x, y = a[k], b[k]
        if k.startswith("heavy"):
            continue
        if k == "scalars":
            x, y = x[:-1], y[:-1]  # heavy_evictions, the last, as above
        if tier_check is not None and k in ("cm_bytes", "cm_pkts"):
            tier[k] = tier_check(k)
        elif k in adds:
            x64, y64 = x.astype(np.float64), y.astype(np.float64)
            mag = np.maximum(np.abs(x64), np.abs(y64))
            lim = 2 * (adds[k].astype(np.float64) + 1) * U * mag
            check(bool((np.abs(x64 - y64) <= lim).all()),
                  f"table {k}: outside 2*(n+1)*2^-24 per cell")
            worst = max(worst, float(
                (np.abs(x64 - y64) / np.maximum(mag, 1e-30)).max()))
        else:
            check(np.array_equal(x, y), f"table {k}: differs")
    check(set(adds) <= set(a), f"add counts for unknown tables {set(adds)}")
    ids = lambda t: {(int(h1), int(h2)) for h1, h2, v in zip(  # noqa: E731
        t["heavy_h1"], t["heavy_h2"], t["heavy_valid"]) if v}
    ia, ib = ids(a), ids(b)
    overlap = len(ia & ib) / max(len(ia | ib), 1)
    check(overlap >= 0.99, f"heavy identities overlap {overlap} < 0.99")
    out = {"max_rel_diff": worst, "bound": "2*(n+1)*2^-24 per cell",
           "max_adds_per_cell": max(float(v.max()) for v in adds.values()),
           "heavy_identity_overlap": overlap}
    if tier:
        out["tier_bound"] = tier
    return out


def _check_windows(wins, universe, pool) -> list[float]:
    """Recall@100 >= 0.99 and a sane report in every window."""
    from netobserv_tpu_torch.scenarios import traffic
    recalls = [traffic.check_recall(w["tables"]["heavy_words"],
                                    w["tables"]["heavy_valid"], w["feed"],
                                    universe, pool) for w in wins]
    check(min(recalls) >= 0.99, f"recall@100 {recalls} < 0.99")
    for w in wins:
        rep = w["report"]
        rows = len(w["feed"]) * BATCH
        check(rep["Records"] == float(rows),
              f"report records {rep['Records']}")
        check(len(rep["HeavyHitters"]) == 64, "report heavy hitters")
        for v in (rep["Bytes"], rep["DistinctSrcEstimate"],
                  *rep["RttQuantilesUs"].values()):
            check(v == v and abs(v) < float("inf"), "non-finite report value")
    return recalls




def _runs(feed, n_batches: int, specs, cfg, **kw) -> dict:
    """A path's three runs over the same batches (MODES)."""
    return {m: run_windows(feed, n_batches, m, specs, cfg, **kw)
            for m in MODES}


def _window_summary(runs: dict, cmp: list, cmp_eager: list) -> dict:
    run, eager, plain = (runs[m] for m in MODES)
    rows = FOLDS_PER_WINDOW * BATCH

    def secs(r):
        return [w["seconds"] for w in r["windows"]]

    return {"launches": run["launches"], "folds": run["folds"],
            "rolls": run["rolls"], "records_per_window": rows,
            "window_seconds": secs(run),
            "records_per_s": [rows / s for s in secs(run)],
            "state_tables_seconds": [w["tables_seconds"]
                                     for w in run["windows"]],
            "roll_seconds": [w["roll_seconds"] for w in run["windows"]],
            "eager_window_seconds": secs(eager),
            "eager_records_per_s": [rows / s for s in secs(eager)],
            "plain_window_seconds": secs(plain),
            "plain_records_per_s": [rows / s for s in secs(plain)],
            "vs_plain": cmp, "vs_eager": cmp_eager,
            "captured_folds": [{k: v for k, v in w.items()
                                if k != "last_signature"}
                               for w in run["watch"]],
            "distinct_src_estimate": [w["report"]["DistinctSrcEstimate"]
                                      for w in run["windows"]]}


def _want_launches(specs, path: str, folds: int) -> dict:
    """Launches over `folds` folds (ingest calls) of `path`: each kernel's
    launches per fold on that path (zero off it). The HLL folds launch
    makes one a fold whatever its folds: three on the wide and resident
    paths, two on the tiered path and with the fan-out signal off."""
    return {s["name"]: s["per_fold"].get(path, 0) * folds for s in specs}


def _captures(watch: list) -> int:
    """The captures of a run's graphs. Each capture's warm-up runs the
    fold once, eagerly, on clones, and its launches count."""
    return sum(w["compiles"] for w in watch)


def _check_launches(runs: dict, specs, path: str, folds: int,
                    what: str) -> None:
    """The kernel runs launched what the path launches per fold: the eager
    run for each fold, the captured run for each fold and each capture's
    warm-up fold (the captures made within the counted folds)."""
    for m in ("captured", "eager"):
        warm = _captures(runs[m]["watch"]) if m == "captured" else 0
        want = _want_launches(specs, path, folds + warm)
        check(runs[m]["launches"] == want,
              f"{what} {m} launch counts {runs[m]['launches']}, want {want}")


def _warm_captured(name: str) -> bool:
    """A ladder entry of the resident feed, captured when its ring is made
    (`warm_superbatch_ladder`) whether or not a fold calls it."""
    return name.startswith("fold_resident_lanes_x")


def _check_watch(run: dict, replays: dict) -> None:
    """The captured run's graphs: a graph for each feed it folded, one
    capture each, a call per fold of the feed (`replays`, by graph name)
    and no retrace; a graph whose feed was not folded never captured,
    but for a ladder entry, captured at warm-up."""
    names = {w["fn"] for w in run["watch"]}
    check(set(replays) <= names, f"graphs {sorted(names)}, want "
          f"{sorted(replays)}")
    for w in run["watch"]:
        want = replays.get(w["fn"], 0)
        captures = 1 if _warm_captured(w["fn"]) else min(want, 1)
        check(w["compiles"] == captures and w["retraces"] == 0,
              f"{w['fn']}: {w['compiles']} captures, {w['retraces']} "
              "retraces")
        check(w["calls"] == want,
              f"{w['fn']}: {w['calls']} calls, want {want}")


def phase_main_path(specs, universe, pool, dense) -> dict:
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    runs = _runs(dense_feeder(dense), len(dense), specs, cfg)
    run, eager, plain = (runs[m] for m in MODES)
    folds = WINDOWS * FOLDS_PER_WINDOW
    _check_launches(runs, specs, "wide", folds, "wide")
    for r in (run, eager):
        check(r["folds"] == folds and r["rolls"] == WINDOWS,
              f"exporter counted {r['folds']} folds, {r['rolls']} rolls")
    _check_watch(run, {"fold_dense": folds})
    recalls = _check_windows(run["windows"], universe, pool)
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"])
           for w, p in zip(run["windows"], plain["windows"])]
    cmp_eager = [compare_tables(w["tables"], e["tables"], p["adds"])
                 for w, e, p in zip(run["windows"], eager["windows"],
                                    plain["windows"])]
    return {"phase": "main_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            "resident_bytes": run["resident_bytes"],
            "hot_key_rows_per_fold": hot_key_rows(pool)}


def _tier_checker(w: dict, p: dict, tspec, counted: dict | None = None):
    """tier_check for compare_tables: hold one window's decoded CM table
    of the run `w` against the run `p` to the tier bound, with the adds
    counted by the plain run `counted` (default `p`)."""
    import torch
    counted = p if counted is None else counted

    def fn(name: str) -> dict:
        unit = tspec.bytes_unit if name == "cm_bytes" else 1
        n = torch.from_numpy(counted["adds"][name]).cuda()
        f = torch.from_numpy(counted["touched"][name]).cuda()
        return tier_view_check(getattr(w["tiers"], name),
                               getattr(p["tiers"], name), n, f, tspec, unit)

    return fn


def phase_tiered_path(specs, universe, pool, dense) -> dict:
    cfg = tiered_cfg()
    runs = _runs(dense_feeder(dense), len(dense), specs, cfg,
                 decay_window=True)
    run, eager, plain = (runs[m] for m in MODES)
    folds = WINDOWS * FOLDS_PER_WINDOW
    _check_launches(runs, specs, "tiered", folds, "tiered")
    for r in (run, eager):
        check(r["folds"] == folds and r["rolls"] == WINDOWS,
              f"exporter counted {r['folds']} folds, {r['rolls']} rolls")
        dec = r["decay"]
        want_decay = _want_launches(specs, "tiered", DECAY_FOLDS)
        check(dec["launches"] == want_decay,
              f"decay window launches {dec['launches']}, want {want_decay}")
        check(dec["decay_exact"], "decay roll: the tiers are not "
              "decay_plane of the pre-roll tiers")
        check(dec["hll_reset"] and dec["tiers_moved"],
              "decay roll: HLL banks not reset or tiers unchanged")
    _check_watch(run, {"fold_dense": folds + DECAY_FOLDS})
    dec = run["decay"]
    wins = run["windows"] + [dec]
    recalls = _check_windows(wins, universe, pool)
    ewins = eager["windows"] + [eager["decay"]]
    pwins = plain["windows"] + [plain["decay"]]
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"],
                          _tier_checker(w, p, cfg.tiered))
           for w, p in zip(wins, pwins)]
    cmp_eager = [compare_tables(w["tables"], e["tables"], p["adds"],
                                _tier_checker(w, e, cfg.tiered, p))
                 for w, e, p in zip(wins, ewins, pwins)]
    from netobserv_tpu_torch.sketch import tiered
    occ = {p: tiered.plane_occupancy(getattr(run["windows"][-1]["tiers"], p))
           for p in ("cm_bytes", "cm_pkts")}
    return {"phase": "tiered_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            "decay_window": {"folds": DECAY_FOLDS, "factor": DECAY_FACTOR,
                             "launches": dec["launches"],
                             "seconds": dec["seconds"],
                             "eager_seconds": eager["decay"]["seconds"],
                             "roll_seconds": dec["roll_seconds"],
                             "decay_plane_exact": dec["decay_exact"]},
            "resident_bytes": run["resident_bytes"],
            "tier_occupancy_end_of_window_2": occ}


def phase_native_pack(events) -> dict:
    """The native packer against the Python one on the host of the card's
    machine: the pool's batches as flow events (the resident path's first
    batches), packed chunk by chunk from one start row with each packer and
    its own dictionary (default caps, 2^18 slots): the same regions word
    for word, the same rows consumed and dictionary count, and in the end
    the same slot for every key; with each packer's seconds per batch."""
    import numpy as np
    from netobserv_tpu_torch.datapath import flowpack
    caps = flowpack.default_resident_caps(BATCH)
    kd_n = flowpack.NativeKeyDict(1 << 18)
    kd_p = flowpack.KeyDict(1 << 18)
    secs = {"native": 0.0, "python": 0.0}
    chunks = 0
    for ev, feats in events:
        start = 0
        while start < len(ev):
            t0 = time.perf_counter()
            bn, cn = flowpack.pack_resident_native(ev, BATCH, kd_n, caps,
                                                   start=start, **feats)
            t1 = time.perf_counter()
            bp, cp = flowpack.pack_resident(ev, BATCH, kd_p, caps,
                                            start=start, **feats)
            secs["native"] += t1 - t0
            secs["python"] += time.perf_counter() - t1
            check(cn == cp and cn > 0,
                  f"chunk {chunks}: consumed {cn} native, {cp} Python")
            check(np.array_equal(bn, bp), f"chunk {chunks}: regions differ")
            check(kd_n.count() == kd_p.count(),
                  f"chunk {chunks}: {kd_n.count()} keys native, "
                  f"{kd_p.count()} Python")
            chunks += 1
            start += cn
    words = np.frombuffer(b"".join(kd_p.slots), np.uint32).reshape(-1, 10)
    check(np.array_equal(kd_n.slots_of(words),
                         np.fromiter(kd_p.slots.values(), np.int64)),
          "the dictionaries give other slots")
    n = len(events)
    out = {"phase": "native_pack", "batches": n, "chunks": chunks,
           "keys": kd_n.count(), "regions_equal": True,
           "native_seconds_per_batch": secs["native"] / n,
           "python_seconds_per_batch": secs["python"] / n,
           "python_over_native": secs["python"] / secs["native"]}
    kd_n.close()
    return out


def _ring_summary(run: dict, eager: dict, plain: dict, cfg_note: dict
                  ) -> dict:
    """The checks every feed of events shares, and its per-16,384-record
    numbers: the three runs folded the same dispatches and records, and
    the pack time apart from the rest of a window's time."""
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    check(run["records"] == records and run["rolls"] == WINDOWS,
          f"exporter counted {run['records']} records, {run['rolls']} "
          "rolls")
    for other in (eager, plain):
        check(other["folds"] == run["folds"]
              and other["records"] == run["records"],
              "the eager or plain run folded other dispatches")
    ring = run["ring"]
    check(run["folds"] == ring.chunks, f"exporter counted {run['folds']} "
          f"folds, the ring {ring.chunks} dispatches")
    per_batch = FOLDS_PER_WINDOW  # batches of BATCH records in a window

    def per(r, key):
        return [w[key] / per_batch for w in r["windows"]]

    def rest(r):
        return [(w["seconds"] - w["pack_seconds"]) / per_batch
                for w in r["windows"]]

    return {**cfg_note, "dispatches": ring.chunks,
            "records": run["records"], "stalls": ring.stalls,
            "slot_wait_p95_s": ring.slot_wait_p95(),
            "direct_rows": run["direct_rows"],
            "pack_seconds_per_16384": per(run, "pack_seconds"),
            "ingest_seconds_per_16384": rest(run),
            "eager_pack_seconds_per_16384": per(eager, "pack_seconds"),
            "eager_ingest_seconds_per_16384": rest(eager)}


def _compare_runs(runs: dict) -> tuple[list, list]:
    run, eager, plain = (runs[m] for m in MODES)
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"])
           for w, p in zip(run["windows"], plain["windows"])]
    cmp_eager = [compare_tables(w["tables"], e["tables"], p["adds"])
                 for w, e, p in zip(run["windows"], eager["windows"],
                                    plain["windows"])]
    return cmp, cmp_eager


def phase_resident_path(specs, universe, pool, events) -> dict:
    """The resident feed at full width: `fold_events` over the event form
    of the same pool batches, at one lane and the ladder (1,) (one region
    of B = 16,384, default caps, 2^18 slots, what the one-lane ring
    ships), the native packer."""
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    runs = _runs(event_feeder(events), len(events), specs, cfg, ring=True,
                 exp_kw=RESIDENT_KW)
    run, eager, plain = (runs[m] for m in MODES)
    ring = run["ring"]
    check(ring.lanes == 1 and ring.ladder == (1,),
          f"{ring.lanes} lanes, ladder {ring.ladder}")
    check(run["folds"] == WINDOWS * FOLDS_PER_WINDOW + ring.continuations,
          f"{run['folds']} dispatches, {ring.continuations} continuations")
    check(isinstance(ring.kdicts[0], flowpack.NativeKeyDict),
          "the exporter's ring does not pack natively")
    _check_launches(runs, specs, "resident", run["folds"], "resident")
    _check_watch(run, {"fold_resident_lanes_x1": run["folds"]})
    recalls = _check_windows(run["windows"], traffic.event_universe(universe),
                             pool)
    cmp, cmp_eager = _compare_runs(runs)
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    h2d = ring.chunks * flowpack.resident_buf_len(BATCH, ring.caps) * 4
    return {"phase": "resident_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            **_ring_summary(run, eager, plain, {
                "caps": repr(ring.caps), "slot_cap": ring.slot_cap,
                "packer": "native", "lanes": ring.lanes,
                "ladder": list(ring.ladder)}),
            "continuations": ring.continuations,
            "dict_resets": ring.dict_resets, "spill_rows": ring.spill_rows,
            "key_table": run["key_table_check"],
            "h2d_bytes_per_record": h2d / records,
            "dense_h2d_bytes_per_record": sk.DENSE_WORDS * 4}


def phase_lanes_path(specs, universe, pool, events) -> dict:
    """The reference agent's default feed at full width: the default
    exporter (8 lanes of 2,048 rows, ladder (1, 2, 4), 2^18 slots a lane,
    the native packer) fed the pool's records as evictions of seeded sizes
    (`LaneFeeder`), each window rolled after its 32 x 16,384 records."""
    import os
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    feeder = LaneFeeder(events)
    runs = _runs(feeder, len(events), specs, cfg, ring=True,
                 exp_kw=LANES_KW)
    run, eager, plain = (runs[m] for m in MODES)
    ring = run["ring"]
    check(ring.lanes == 8 and ring.ladder == (1, 2, 4),
          f"{ring.lanes} lanes, ladder {ring.ladder}")
    check(all(ring.superbatch_folds.get(k, 0) > 0 for k in (1, 2, 4)),
          f"superbatch folds {ring.superbatch_folds}")
    for other in (eager, plain):
        check(other["ring"].superbatch_folds == ring.superbatch_folds,
              "the eager or plain run took other ladder entries")
    check(run["direct_rows"] > 0, "no eviction took the direct path")
    check(all(isinstance(kd, flowpack.NativeKeyDict) for kd in ring.kdicts),
          "the exporter's ring does not pack natively")
    _check_launches(runs, specs, "lanes", run["folds"], "lanes")
    _check_watch(run, {f"fold_resident_lanes_x{k}": n
                       for k, n in ring.superbatch_folds.items()})
    check(_captures(run["watch"]) == 3, f"captures {run['watch']}")
    recalls = _check_windows(run["windows"], traffic.event_universe(universe),
                             pool)
    cmp, cmp_eager = _compare_runs(runs)
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    h2d = sum(n * k * ring.n_regions * ring._region_words * 4
              for k, n in ring.superbatch_folds.items())
    sizes = feeder.sizes
    return {"phase": "lanes_path", "recall_at_100": recalls,
            **_window_summary(runs, cmp, cmp_eager),
            **_ring_summary(run, eager, plain, {
                "lanes": ring.lanes, "ladder": list(ring.ladder),
                "pack_threads": ring.pack_threads,
                "cpu_count": os.cpu_count(), "caps": repr(ring.caps),
                "slot_cap": ring.slot_cap, "packer": "native"}),
            "evictions": len(sizes), "eviction_rows_min": min(sizes),
            "eviction_rows_max": max(sizes),
            "superbatch_folds": {str(k): v for k, v in
                                 sorted(ring.superbatch_folds.items())},
            "continuations": ring.continuations,
            "dict_resets": ring.dict_resets, "spill_rows": ring.spill_rows,
            "key_table": run["key_table_check"],
            "h2d_bytes_per_record": h2d / records}


def phase_dense_ring(specs) -> dict:
    """The dense and compact rings at full width, fed flow events of a v4
    pool (v4-mapped keys, V6_SHARES of v6 rows a batch; the last batch a
    burst past the compact feed's spill lane, so its dense fallback runs):
    each feed captured, eager and plain, 2 windows x 32 batches."""
    import numpy as np
    from netobserv_tpu_torch.datapath import flowpack
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import staging
    from netobserv_tpu_torch.sketch import state as sk
    cfg = sk.SketchConfig()
    universe, pool = traffic.make_pool(np.random.default_rng(2), v4=True,
                                       v6_share=V6_SHARES)
    events = traffic.event_pool(pool, np.random.default_rng(3))
    out = {"phase": "dense_ring", "v6_share_per_batch": list(V6_SHARES),
           "feeds": {}}
    records = WINDOWS * FOLDS_PER_WINDOW * BATCH
    for feed, path in (("dense", "dense_ring"), ("compact", "compact_ring")):
        runs = _runs(event_feeder(events), len(events), specs, cfg,
                     ring=True, exp_kw={"feed": feed, **LANES_KW})
        run, eager, plain = (runs[m] for m in MODES)
        ring = run["ring"]
        check(isinstance(ring, staging.DenseStagingRing)
              and (ring.spill_cap is not None) == (feed == "compact"),
              f"{feed}: ring {ring}")
        check(run["folds"] == WINDOWS * FOLDS_PER_WINDOW,
              f"{feed}: {run['folds']} dispatches")
        _check_launches(runs, specs, path, run["folds"], feed)
        if feed == "compact":
            check(ring.dense_fallbacks >= 1, "no dense fallback")
            for other in (eager, plain):
                check(other["ring"].dense_fallbacks == ring.dense_fallbacks,
                      "the eager or plain run fell back otherwise")
            fb = ring.dense_fallbacks
            _check_watch(run, {"fold_compact": run["folds"] - fb,
                               "fold_compact_dense": fb})
            h2d = ((run["folds"] - fb)
                   * flowpack.compact_buf_len(BATCH, ring.spill_cap) * 4
                   + fb * BATCH * sk.DENSE_WORDS * 4)
        else:
            _check_watch(run, {"fold_dense_ring": run["folds"]})
            h2d = run["folds"] * BATCH * sk.DENSE_WORDS * 4
        recalls = _check_windows(run["windows"],
                                 traffic.event_universe(universe), pool)
        cmp, cmp_eager = _compare_runs(runs)
        res = {"recall_at_100": recalls,
               **_window_summary(runs, cmp, cmp_eager),
               **_ring_summary(run, eager, plain, {
                   "pack_threads": ring.pack_threads,
                   "spill_cap": ring.spill_cap}),
               "dense_fallbacks": ring.dense_fallbacks,
               "h2d_bytes_per_record": h2d / records}
        out["feeds"][feed] = res
        out[path] = res["launches"]
    return out


def _c1_run(specs, dense, cfg, mode: str) -> dict:
    """C1_FOLDS pool batches through the dense feed under `cfg`, folded as
    `mode` says (MODES): the kernel runs count every call of a plain
    version (there must be none), the plain run the adds of the window
    bounds; the launch counts are set to 0 just before and read just
    after."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    adds: dict = {}
    touched: dict = {}
    plain_calls: dict = {}
    ctx = (plain_versions(specs, adds, touched) if mode == "plain"
           else counting_plains(specs, plain_calls))
    with ctx:
        exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                                  capture=mode == "captured")
        for s in specs:
            s["kernel"].launches = 0
        win = _window(exp, dense_feeder(dense), len(dense), 0, C1_FOLDS,
                      adds, touched)
        win["launches"] = {s["name"]: s["kernel"].launches for s in specs}
        win["watch"] = _watch_stats(exp)
        exp.close()
    check(not plain_calls, f"plain versions ran on the card: {plain_calls}")
    return win


def phase_c1(specs, dense) -> dict:
    """Fault C1's two shapes on the card: a depth whose kernel-6 tile
    passes one block's shared memory, which the gate sends to the decode
    form (the wide path's kernels), and a table width past what kernel 7's
    first design held, which folds on the interior form through kernel 7;
    and a depth whose kernel-6 tile needs the shared-memory attribute set
    at launch, inside the capture too (interior form).
    Each runs captured, eager and plain: the captured run's tables are held
    against both under the whole-window bounds (the tiered CM tables under
    the tier bound), the packed HLL banks bit-exact."""
    from netobserv_tpu_torch.sketch import state as sk
    from netobserv_tpu_torch.sketch.tiered import TierSpec
    out = {"phase": "c1_shapes", "folds": C1_FOLDS, "shapes": []}
    for cfg, form, path in (
            (sk.SketchConfig(cm_depth=25, tiered=TierSpec()), "decode",
             "wide"),
            (sk.SketchConfig(ewma_buckets=16384, tiered=TierSpec()),
             "interior", "tiered"),
            (sk.SketchConfig(cm_depth=6, tiered=TierSpec()), "interior",
             "tiered")):
        got = sk.tiered_fold_form(cfg)
        check(got == form, f"{cfg}: fold form {got}, want {form}")
        runs = {m: _c1_run(specs, dense, cfg, m) for m in MODES}
        run, eager, plain = (runs[m] for m in MODES)
        _check_launches(runs, specs, path, C1_FOLDS, f"{form} form")
        _check_watch(run, {"fold_dense": C1_FOLDS})
        for other in (eager, plain):
            check(all(_exact(x, y) for x, y in zip(
                _tensors(run["tiers"][2:]), _tensors(other["tiers"][2:]))),
                f"{form} form: the packed HLL banks differ")
        cmp = compare_tables(run["tables"], plain["tables"], plain["adds"],
                             _tier_checker(run, plain, cfg.tiered))
        cmp_eager = compare_tables(run["tables"], eager["tables"],
                                   plain["adds"],
                                   _tier_checker(run, eager, cfg.tiered,
                                                 plain))
        out["shapes"].append({
            "cm_depth": cfg.cm_depth, "ewma_buckets": cfg.ewma_buckets,
            "form": got, "launches": run["launches"], "vs_plain": cmp,
            "vs_eager": cmp_eager, "seconds": run["seconds"],
            "eager_seconds": eager["seconds"],
            "plain_seconds": plain["seconds"]})
    return out


def _traced(specs, rows) -> dict:
    """Per kernel `__global__` (the first of its `trace` names), the kernel
    events a trace counts under it."""
    return {s["trace"][0]: sum(c for _, k, c in rows
                               if any(t in k for t in s["trace"]))
            for s in specs}


def _traced_want(specs, launches: dict) -> dict:
    """The kernel events `launches` make: one per launch, the HLL entries
    (one `__global__`) summed."""
    want: dict = {}
    for s in specs:
        key = s["trace"][0]
        want[key] = want.get(key, 0) + launches[s["name"]]
    return want


def phase_profile(specs, feed, n_batches: int, cfg, name: str, path: str,
                  capture: bool, warm: int = 2, exp_kw: dict | None = None,
                  batches_per_call: int = 1) -> dict:
    """Device time by kernel over FOLDS_PER_WINDOW // 4 calls of a path's
    feed (torch.profiler) after `warm` warm-up calls, captured or eager,
    and the device's busy share of the wall time; each call folds
    `batches_per_call` batches of BATCH records, and the times are per
    batch ("per_fold", per 16,384 records). The trace must count each
    kernel of the path as often as the launch counts say (a replay adds
    its capture's launches), and the launch counts must be the path's per
    ingest dispatch, or the loop runs again, up to PROFILE_TRIES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    exp = TorchSketchExporter(cfg, batch_size=BATCH, device="cuda",
                              capture=capture, **(exp_kw or {}))
    for i in range(warm):
        feed(exp, i % n_batches)
    torch.cuda.synchronize()
    n = FOLDS_PER_WINDOW // 4
    for _ in range(PROFILE_TRIES):
        for s in specs:
            s["kernel"].launches = 0
        folds0, pack0 = exp.folds, _pack_seconds(exp)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                feed(exp, i % n_batches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        chunks = exp.folds - folds0
        launches = {s["name"]: s["kernel"].launches for s in specs}
        rows = _device_rows(prof)
        if rows and _traced(specs, rows) == _traced_want(specs, launches):
            break
        PROFILE_RETRIED.append(1)
    else:
        raise PhaseError(f"{name}: no trace in {PROFILE_TRIES} counted the "
                         f"launches {launches}: {_traced(specs, rows)}")
    want = _want_launches(specs, path, chunks)
    check(launches == want, f"{name}: launches {launches}, want {want}")
    pack = _pack_seconds(exp) - pack0
    _watch_stats(exp)
    exp.close()
    busy_us = sum(r[0] for r in rows)
    check(busy_us > 0, "the profiler saw no device time")
    nb = n * batches_per_call  # batches of BATCH records folded
    return {"phase": name, "path": path, "captured": capture, "calls": n,
            "batches_per_call": batches_per_call, "folds": nb,
            "ingest_calls": chunks, "launches": launches,
            "wall_ms_per_fold": wall * 1e3 / nb,
            "device_ms_per_fold": busy_us / 1e3 / nb,
            "device_busy_share": busy_us / 1e6 / wall if wall else None,
            "pack_seconds_per_fold": pack / nb,
            "top_device_ops": [{"name": k[:80], "us_per_fold": us / nb,
                                "calls_per_fold": c / nb}
                               for us, k, c in rows[:15]]}


def phase_watch() -> dict:
    """The compile watch over the run: every captured fold of every
    captured exporter captured once, at its first call (a ladder entry
    when its ring was made), and never again (a graph whose feed was not
    folded, never, but for a ladder entry); no retrace in the process.
    `snapshot` is the watch's snapshot of each captured exporter, taken
    while it lived (`_watch_stats`)."""
    from netobserv_tpu_torch.utils import retrace
    total = retrace.total_retraces()
    check(total == 0, f"{total} retraces")
    check(WATCHED and all(
        w["compiles"] == (1 if _warm_captured(w["fn"])
                          else min(w["calls"], 1))
        and w["retraces"] == 0 for w in WATCHED),
        f"captured folds {WATCHED}")
    used = [w for w in WATCHED if w["calls"]]
    return {"phase": "retrace_watch", "total_retraces": total,
            "captured_folds": len(used),
            "captures": sum(w["compiles"] for w in WATCHED),
            "replays": sum(w["calls"] for w in WATCHED),
            "capture_seconds": [w["compile_seconds"] for w in used],
            "snapshot": [{k: v for k, v in w.items()
                          if k != "last_signature"} for w in WATCHED],
            "signatures": {w["fn"]: w.get("last_signature", "")
                           for w in used}}


#: profile phases: (path, name, feed kind, warm-up calls: None = the
#: pool, exporter arguments, batches a call)
PROFILES = (("wide", "profile", "dense", 2, None, 1),
            ("tiered", "profile_tiered", "dense", 2, None, 1),
            ("resident", "profile_resident", "events", None, RESIDENT_KW, 1),
            ("lanes", "profile_lanes", "superbatch", 2, LANES_KW, 4))


def phase_profiles(specs, dense, events, paths: dict) -> dict:
    """The profile phases, each path captured then eager; emits each and
    returns the `per_fold` line: per path and batch of 16,384 records, the
    profiled wall and device ms, busy share and pack seconds, and from
    the path phase's unprofiled windows (`paths`, by path) the wall ms
    (of the last reset window, steady state: a captured run's first
    window holds its capture) and the device ms over it. The lanes path
    is profiled at k = 4 (each call one eviction of 4 batches, one
    superbatch dispatch); its window is the lanes phase's eviction mix."""
    from netobserv_tpu_torch.sketch import state as sk
    cfgs = {"wide": sk.SketchConfig(), "tiered": tiered_cfg(),
            "resident": sk.SketchConfig(), "lanes": sk.SketchConfig()}
    out = {"phase": "per_fold"}
    for path, name, kind, warm, kw, per_call in PROFILES:
        if kind == "dense":
            pool, feeder = dense, dense_feeder(dense)
        elif kind == "events":
            pool, feeder = events, event_feeder(events)
        else:
            feeder = SuperbatchFeeder(events, per_call)
            pool = feeder.parts
        out[path] = {}
        for capture in (True, False):
            r = phase_profile(specs, feeder, len(pool), cfgs[path],
                              name + ("" if capture else "_eager"), path,
                              capture, len(pool) if warm is None else warm,
                              kw, per_call)
            emit(r)
            secs = paths[path]["window_seconds" if capture
                               else "eager_window_seconds"]
            window_ms = secs[-1] * 1e3 / FOLDS_PER_WINDOW
            out[path]["captured" if capture else "eager"] = {
                **{k: r[k] for k in ("wall_ms_per_fold", "device_ms_per_fold",
                                     "device_busy_share",
                                     "pack_seconds_per_fold")},
                "window_wall_ms_per_fold": window_ms,
                "device_over_window_wall": r["device_ms_per_fold"]
                / window_ms}
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import numpy as np
        from netobserv_tpu_torch.scenarios import traffic
        from netobserv_tpu_torch.sketch import state as sk
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    t_start = time.perf_counter()
    try:
        dev = phase_device()
        emit(dev)
        specs = kernel_specs()
        phase = "build"
        emit(phase_build(specs))
        phase = "traffic"
        t0 = time.perf_counter()
        universe, pool = traffic.make_pool(np.random.default_rng(0))
        dense = traffic.dense_pool(pool)
        events = traffic.event_pool(pool, np.random.default_rng(0))
        emit({"phase": "traffic", "seconds": time.perf_counter() - t0,
              "batches": len(pool), "rows_per_batch": BATCH})
        phase = "native_pack"
        emit(phase_native_pack(events))
        phase = "kernels"
        calls = {"wide": capture_main_path_inputs(specs, dense,
                                                  sk.SketchConfig()),
                 "tiered": capture_main_path_inputs(specs, dense,
                                                    tiered_cfg())}
        results = phase_kernels(specs, calls)
        phase = "main_path"
        main_res = phase_main_path(specs, universe, pool, dense)
        emit(main_res)
        phase = "tiered_path"
        tier_res = phase_tiered_path(specs, universe, pool, dense)
        wide_b = sum(main_res["resident_bytes"].values())
        tier_b = sum(tier_res["resident_bytes"].values())
        tier_res["resident_bytes_wide_over_tiered"] = wide_b / tier_b
        emit(tier_res)
        phase = "resident_path"
        res_res = phase_resident_path(specs, universe, pool, events)
        emit(res_res)
        phase = "lanes_path"
        lanes_res = phase_lanes_path(specs, universe, pool, events)
        emit(lanes_res)
        phase = "dense_ring"
        ring_res = phase_dense_ring(specs)
        emit(ring_res)
        phase = "c1_shapes"
        emit(phase_c1(specs, dense))
        phase = "profile"
        emit(phase_profiles(specs, dense, events, {
            "wide": main_res, "tiered": tier_res, "resident": res_res,
            "lanes": lanes_res}))
        phase = "retrace_watch"
        emit(phase_watch())
        torch.cuda.synchronize()
    except Exception as e:  # every phase failure ends the run, loudly
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    launches = {"wide": main_res["launches"], "tiered": tier_res["launches"],
                "resident": res_res["launches"],
                "lanes": lanes_res["launches"],
                "dense_ring": ring_res["dense_ring"],
                "compact_ring": ring_res["compact_ring"]}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "traces_retried": len(PROFILE_RETRIED)})
    emit({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"netobserv_tpu_torch/csrc/{s['kernel'].source}",
         "replaces": s["replaces"],
         # the count on the kernel's first path (0 for kernel 5, which no
         # path runs); every path's count beside it
         "launches": next((launches[p][r["name"]] for p in s["per_fold"]),
                          0),
         "launches_by_path": {p: launches[p][r["name"]] for p in launches},
         "max_abs_err": r["max_abs_err"], "ms": r["device_kernel_ms"],
         "plain_ms": r["device_plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["device_library_ms"]}
        for r, s in zip(results, specs)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
