#!/usr/bin/env python3
"""Drive the PyTorch port's sketch plane on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the four CUDA kernels of the main path from `netobserv_tpu_torch/
csrc/`, holds each against its plain PyTorch version at the main path's
shapes, then drives the main path through `TorchSketchExporter` at the
default `SketchConfig()` (2 windows x 32 folds of 16,384 records of the
seeded bench traffic), counts the kernel launches of that run, checks
heavy-hitter recall against the exact oracle, and reruns the same windows
with the plain versions on the card to compare the tables.

Every phase prints one JSON line. Any failure prints the phase's error and
exits non-zero, with no "ok" line. The last line on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Times. One helper (`measure`) times a kernel, its plain version and the
library yardstick over a loop of 50 calls after a warm-up, by two clocks:
`device_*_ms` is the device time from a torch.profiler trace (the sum of
kernel and copy durations, so host launch overhead is left out) and is the
time held against the bound and printed in the `kernels` line;
`kernel_ms`, `plain_ms`, `library_ms` are CUDA-event times of the same loop
and include whatever launch overhead it cannot hide. In-place tables are
restored from the captured state before each call, and the restore's own
time is subtracted from both clocks.

Bound. The larger of the bytes the function must move over 3.35 TB/s and
its f32 operations over 67 TFLOP/s (H100 SXM data sheet). Bytes are this
call's: each input read once; of an in-place table only the 32-byte
sectors that this call's non-zero values reach, read once and written once;
a fresh output written once. The kernel phase also prints the call's
atomic count and the most atomics that land on one address.

Tolerances. Kernels 2 and 3 compute maxima and a minimum row: bit-exact.
Kernels 1 and 4 add f32 values with atomics, in an order that changes from
run to run: with integer-valued masses whose per-cell sums stay below 2^24
(fresh tables, small integer masses on the main path's indices) they are
bit-exact; with the main path's own inputs (tables warmed by earlier folds,
hot cells past 2^24: the production regime) a cell that took n adds is held
to 2 * (n + 1) * 2^-24 relative of the plain version. Whole windows, kernel
path against plain path: each cell of the tables kernels 1 and 4 write is
held to the same per-cell bound, with n counted over the window by folding
unit masses through the plain versions; every other table (HLL registers,
histograms, the scalar totals) is exact, and the heavy-hitter table (whose
slot choices follow the Count-Min estimates) shares at least 99 % of its
identities.
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
WARM_FOLDS = 3
REPS = 50


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- helpers


def _clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x


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


def measure(fn, setup=None, reps: int = REPS) -> tuple[float, float]:
    """(event ms, device ms) per call of fn() over `reps` calls after a
    warm-up: CUDA events around the loop, then the same loop under
    torch.profiler for the device's own kernel and copy time. With `setup`
    (which restores in-place inputs), setup alone is measured the same way
    and subtracted from both."""
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                body()
            torch.cuda.synchronize()
        us = sum(r[0] for r in _device_rows(prof))
        check(us > 0, "the profiler saw no device time")
        return start.elapsed_time(end) / reps, us / 1e3 / reps

    if setup is None:
        return loop(fn)
    both, alone = loop(lambda: (setup(), fn())), loop(setup)
    return max(both[0] - alone[0], 0.0), max(both[1] - alone[1], 0.0)


# ----------------------------------------------------------- the kernels


def kernel_specs():
    """Per kernel: its module, wrapper and plain version, which arguments
    it updates in place (and their `state_tables` names, for the f32 sums),
    how to cut its inputs to n rows, whether its result is exact in any
    order, and the Pallas kernel it replaces."""
    from netobserv_tpu_torch.ops.kernels import (
        countmin_kernel, hll_kernel, signal_kernel, topk_kernel,
    )
    return [
        dict(name="countmin_fold2", mod=countmin_kernel,
             wrapper="update_two", plain="update_two_plain", inplace=(0, 1),
             tables=("cm_bytes", "cm_pkts"),
             rows=lambda a, n: (a[0], a[1], *(t[:n] for t in a[2:])),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/countmin_kernel.py:81"),
        dict(name="topk_reduce", mod=topk_kernel, wrapper="reduce",
             plain="reduce_plain", inplace=(),
             rows=lambda a, n: (*(t[:n] for t in a[:3]), a[3]), exact=True,
             replaces="netobserv_tpu/ops/pallas/topk_kernel.py:82"),
        dict(name="hll_fold", mod=hll_kernel, wrapper="update",
             plain="update_plain", inplace=(0,),
             rows=lambda a, n: (a[0], *(t[:n] for t in a[1:])), exact=True,
             replaces="netobserv_tpu/ops/pallas/hll_kernel.py:70"),
        dict(name="signal_fold", mod=signal_kernel, wrapper="update",
             plain="update_plain", inplace=(0,),
             tables=signal_kernel.SignalPlanes._fields,
             rows=lambda a, n: (a[0], a[1][:, :n].contiguous(),
                                a[2][:, :n].contiguous()),
             exact=False,
             replaces="netobserv_tpu/ops/pallas/signal_kernel.py:164"),
    ]


@contextlib.contextmanager
def plain_versions(specs, adds: dict | None = None):
    """Route every wrapper to its plain version (on any device) for the
    duration: the main path then runs the kernels' PyTorch twins. With
    `adds`, every call of an f32-sum kernel also adds its per-cell count of
    non-zero values into adds[table name] (the n of the add-order bound)."""
    saved = [(s["mod"], getattr(s["mod"], s["wrapper"])) for s in specs]
    for s in specs:
        plain = getattr(s["mod"], s["plain"])
        if adds is not None and "tables" in s:
            def plain(*args, _s=s, _fn=plain):
                for name, n in zip(_s["tables"], adds_per_cell(_s, args)):
                    adds[name] = adds[name] + n if name in adds else n
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


def run_once(spec, fn_name: str, args):
    """Call the kernel (or plain version) on a clone of args; return the
    output tensors (the in-place tables, or the returned tuple)."""
    a = _clone(args)
    out = getattr(spec["mod"], fn_name)(*a)
    if spec["inplace"]:
        return _tensors(tuple(a[i] for i in spec["inplace"]))
    return _tensors(out)


def adds_per_cell(spec, args):
    """How many non-zero values each output cell takes in this call (the
    n of the add-order bound), via the plain version on unit values."""
    import torch
    a = _clone(args)
    if spec["name"] == "countmin_fold2":
        for t in a[:2]:
            t.zero_()
        a = (a[0], a[1], a[2], a[3], (a[4] != 0).float(),
             (a[5] != 0).float())
    else:  # signal_fold
        for t in a[0]:
            t.zero_()
        a = (a[0], a[1], (a[2] != 0).to(torch.float32))
    getattr(spec["mod"], spec["plain"])(*a)
    return _tensors(tuple(a[i] for i in spec["inplace"]))


def compare(spec, args, regime: str) -> dict:
    import torch
    kern = run_once(spec, spec["wrapper"], args)
    plain = run_once(spec, spec["plain"], args)
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for k, p in zip(kern, plain):
        check(k.shape == p.shape and k.dtype == p.dtype,
              f"{spec['name']}: output shape/dtype differ")
        if k.dtype.is_floating_point:
            d = (k.double() - p.double()).abs()
            max_abs = max(max_abs, float(d.max()))
            mag = torch.maximum(k.double().abs(), p.double().abs())
            max_rel = max(max_rel, float((d / mag.clamp(min=1e-30)).max()))
        else:
            max_abs = max(max_abs, float((k.long() - p.long()).abs().max()))
    if spec["exact"] or regime == "integer":
        if regime == "integer" and not spec["exact"]:
            top = max(float(p.abs().max()) for p in plain)
            check(top < 2 ** 24, f"{spec['name']}: integer regime input "
                  f"reaches {top} >= 2^24")
        check(all(torch.equal(k, p) for k, p in zip(kern, plain)),
              f"{spec['name']} ({regime}): not bit-exact, max abs err "
              f"{max_abs}")
        bound = "bit-exact"
    else:
        adds = adds_per_cell(spec, args)
        for k, p, n in zip(kern, plain, adds):
            lim = 2 * (n.double() + 1) * U * torch.maximum(
                k.double().abs(), p.double().abs())
            check(bool(((k.double() - p.double()).abs() <= lim).all()),
                  f"{spec['name']} ({regime}): outside the 2*(n+1)*2^-24 bound")
        bound = "2*(n_adds+1)*2^-24 relative per cell"
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "bound": bound}


def integer_inputs(spec, args):
    """The call's indices on fresh (zero) tables with each non-zero value v
    replaced by the integer v mod 251 + 1: every per-cell sum then stays
    below 16384 * 251 < 2^24, where add order cannot change a bit, while
    the same cells take the same number of atomics as on the main path."""
    import torch
    a = _clone(args)
    for i in spec["inplace"]:
        for t in _tensors(a[i]):
            t.zero_()

    def small(v):
        return torch.where(v != 0, torch.remainder(v, 251.0).floor() + 1,
                           0.0)

    if spec["name"] == "countmin_fold2":
        return (*a[:4], small(a[4]), small(a[5]))
    if spec["name"] == "signal_fold":
        return (a[0], a[1], small(a[2]))
    return a


def timing(spec, args):
    """`measure` of the kernel and of its plain version on the main path's
    inputs; in-place tables are restored from the captured state before
    every launch."""
    work = _clone(args)
    src = _tensors(tuple(args[i] for i in spec["inplace"]))
    dst = _tensors(tuple(work[i] for i in spec["inplace"]))

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
    port never calls it), with its index/value prep done outside it."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    from netobserv_tpu_torch.ops.kernels import hll_kernel
    name = spec["name"]
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
    if name == "hll_fold":
        regs, h1, h2, valid = args
        m = regs.shape[0]
        cell = h1 & (m - 1)
        rank = torch.where(valid, hll_kernel.rank(h2), 0)
        table = regs.clone()
        return lambda: table.scatter_reduce_(0, cell, rank, "amax")
    planes, idx, vals = args
    from netobserv_tpu_torch.ops.kernels.signal_kernel import FAMILY
    sizes = [p.shape[0] for p in planes]
    offs = [sum(sizes[:j]) for j in range(len(sizes))]
    cell = torch.cat([idx[FAMILY[j]] + offs[j] for j in range(len(sizes))])
    table = torch.cat([p.clone() for p in planes])
    flat = vals.reshape(-1)
    return lambda: table.index_add_(0, cell, flat)


def _sector_bytes(cells) -> int:
    """Bytes of the distinct 32-byte sectors that f32/i32 cells reach, read
    once and written once."""
    import torch
    return 2 * 32 * int(torch.unique(cells // 8).numel())


def bound_of(spec, args) -> dict:
    """Least time the card could take for this call: the larger of the
    bytes it must move over HBM bandwidth and its f32 operations over the
    f32 peak (see the module docstring), with the counts behind them."""
    import torch
    from netobserv_tpu_torch.ops import hashing
    def read(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    name = spec["name"]
    extra = {}
    if name == "countmin_fold2":
        ca, cb, h1, h2, va, vb = args
        d, w = ca.shape
        cells = (hashing.row_indices(h1, h2, d, w)
                 + torch.arange(d, device=h1.device)[:, None] * w)
        hits = [cells[:, v != 0].reshape(-1) for v in (va, vb)]
        nbytes = read(args[2:]) + sum(_sector_bytes(c) for c in hits)
        ops = sum(c.numel() for c in hits)  # one f32 add per atomic
        extra = {"atomics": ops, "max_atomics_one_address": max(
            int(torch.bincount(c).max()) for c in hits if c.numel())}
    elif name == "topk_reduce":
        mslot, target, est, k = args
        nbytes = read((mslot, target, est)) + 3 * k * 4  # fresh outputs
        ops = 3 * est.numel()  # two maxima and a minimum per row
    elif name == "hll_fold":
        regs, h1, h2, valid = args
        nbytes = read((h1, h2, valid)) + _sector_bytes(
            (h1 & (regs.shape[0] - 1))[valid])
        ops = int(valid.sum())
    else:
        planes, idx, vals = args
        from netobserv_tpu_torch.ops.kernels.signal_kernel import FAMILY
        nbytes = read((idx, vals)) + sum(
            _sector_bytes(idx[FAMILY[j]][vals[j] != 0])
            for j in range(len(planes)))
        ops = int((vals != 0).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by,
            "bound_bytes": nbytes, "bound_ops": ops, **extra}


def uniform_variant(spec, args):
    """The same call with the hot key spread out: random hashes (kernel 1)
    or random slots (kernel 2), to price same-address atomics."""
    import torch
    g = torch.Generator(device=args[2].device if spec["name"] ==
                        "countmin_fold2" else args[0].device).manual_seed(1)
    if spec["name"] == "countmin_fold2":
        ca, cb, h1, h2, va, vb = args
        r = lambda: torch.randint(0, 2**32, h1.shape, generator=g,  # noqa
                                  device=h1.device, dtype=torch.int64)
        return (ca, cb, r(), r() | 1, va, vb)
    mslot, target, est, k = args
    r = lambda: torch.randint(0, k + 1, mslot.shape, generator=g,  # noqa
                              device=mslot.device, dtype=torch.int64)
    return (r(), r(), est, k)


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
    from netobserv_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build([s["mod"].SOURCE for s in specs])
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "per_source_seconds": secs}


def capture_main_path_inputs(specs, universe, pool, dense):
    """Warm a default-config state with WARM_FOLDS folds (plain versions),
    then record every wrapper call of one more fold: the exact inputs the
    main path hands each kernel, production-regime tables included."""
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    exp = TorchSketchExporter(batch_size=BATCH, device="cuda")
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
        recs = calls.get(s["name"], [])
        check(len(recs) >= 1, f"{s['name']}: the main path never called it")
        case = {"phase": "kernel", "name": s["name"],
                "calls_per_fold": len(recs), "cases": []}
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
        (k_ms, dev_k_ms), (p_ms, dev_p_ms) = timing(s, args)
        lib_ms, dev_lib_ms = measure(library_call(s, args))
        case.update(kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    device_kernel_ms=dev_k_ms, device_plain_ms=dev_p_ms,
                    device_library_ms=dev_lib_ms, **bound_of(s, args),
                    max_abs_err=max(errs),
                    max_rel_err=max(c["max_rel_err"] for c in case["cases"]))
        if s["name"] in ("countmin_fold2", "topk_reduce"):
            uni = uniform_variant(s, args)
            case["device_kernel_ms_uniform_keys"] = timing(s, uni)[0][1]
        torch.cuda.synchronize()
        emit(case)
        results.append(case)
    return results


def hot_key_rows(pool) -> list[int]:
    import numpy as np
    return [int(np.bincount(ranks).max()) for _, ranks in pool]


def run_windows(dense, n_windows: int, plain: bool, specs):
    """Fold n_windows x FOLDS_PER_WINDOW batches through the exporter (in
    its default reset roll mode); per window, the pre-roll tables, the
    report and the fold time, and on the plain run the per-cell add counts
    of the window's f32 sums."""
    import torch
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    adds: dict = {}
    ctx = plain_versions(specs, adds) if plain else contextlib.nullcontext()
    out = []
    with ctx:
        exp = TorchSketchExporter(batch_size=BATCH, device="cuda")
        for w in range(n_windows):
            adds.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feed = []
            for i in range(FOLDS_PER_WINDOW):
                bi = (w * FOLDS_PER_WINDOW + i) % len(dense)
                feed.append(bi)
                exp.fold_dense(dense[bi])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            t1 = time.perf_counter()
            tables = exp.state_tables()
            t2 = time.perf_counter()
            report = exp.roll()
            out.append(dict(feed=feed, seconds=secs, tables=tables,
                            report=report, tables_seconds=t2 - t1,
                            roll_seconds=time.perf_counter() - t2,
                            adds={k: v.cpu().numpy()
                                  for k, v in adds.items()}))
        folds, rolls = exp.folds, exp.rolls
        exp.close()
    return out, folds, rolls


def compare_tables(a: dict, b: dict, adds: dict) -> dict:
    """Kernel-path vs plain-path tables of one window: a cell that took n
    f32 adds (`adds`) is held to 2 * (n + 1) * 2^-24 relative; every other
    table is exact, apart from the heavy-hitter table (identity overlap)
    and its eviction count, which follows it."""
    import numpy as np
    worst = 0.0
    for k in a:
        x, y = a[k], b[k]
        if k.startswith("heavy"):
            continue
        if k == "scalars":
            x, y = x[:-1], y[:-1]  # heavy_evictions, the last, as above
        if k in adds:
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
    return {"max_rel_diff": worst, "bound": "2*(n+1)*2^-24 per cell",
            "max_adds_per_cell": max(float(v.max()) for v in adds.values()),
            "heavy_identity_overlap": overlap}


def phase_main_path(specs, universe, pool, dense) -> dict:
    from netobserv_tpu_torch.scenarios import traffic
    for s in specs:
        s["mod"].KERNEL.launches = 0
    wins, folds, rolls = run_windows(dense, WINDOWS, False, specs)
    launches = {s["name"]: s["mod"].KERNEL.launches for s in specs}
    n_folds = WINDOWS * FOLDS_PER_WINDOW
    want = {"countmin_fold2": n_folds, "topk_reduce": 2 * n_folds,
            "hll_fold": n_folds, "signal_fold": n_folds}
    check(launches == want, f"launch counts {launches}, want {want}")
    check(folds == n_folds and rolls == WINDOWS,
          f"exporter counted {folds} folds, {rolls} rolls")
    recalls = [traffic.check_recall(w["tables"]["heavy_words"],
                                    w["tables"]["heavy_valid"], w["feed"],
                                    universe, pool) for w in wins]
    check(min(recalls) >= 0.99, f"recall@100 {recalls} < 0.99")
    rows = FOLDS_PER_WINDOW * BATCH
    for w in wins:
        rep = w["report"]
        check(rep["Records"] == float(rows), f"report records {rep['Records']}")
        check(len(rep["HeavyHitters"]) == 64, "report heavy hitters")
        for v in (rep["Bytes"], rep["DistinctSrcEstimate"],
                  *rep["RttQuantilesUs"].values()):
            check(v == v and abs(v) < float("inf"), "non-finite report value")
    plain, _, _ = run_windows(dense, WINDOWS, True, specs)
    cmp = [compare_tables(w["tables"], p["tables"], p["adds"])
           for w, p in zip(wins, plain)]
    secs = [w["seconds"] for w in wins]
    return {"phase": "main_path", "launches": launches, "folds": folds,
            "rolls": rolls, "recall_at_100": recalls,
            "records_per_window": rows, "window_seconds": secs,
            "records_per_s": [rows / s for s in secs],
            "state_tables_seconds": [w["tables_seconds"] for w in wins],
            "roll_seconds": [w["roll_seconds"] for w in wins],
            "plain_window_seconds": [p["seconds"] for p in plain],
            "plain_records_per_s": [rows / p["seconds"] for p in plain],
            "vs_plain": cmp, "hot_key_rows_per_fold": hot_key_rows(pool),
            "distinct_src_estimate": [w["report"]["DistinctSrcEstimate"]
                                      for w in wins]}


def phase_profile(dense) -> dict:
    """Device time by kernel over FOLDS_PER_WINDOW // 4 folds of the main
    path (torch.profiler), and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    exp = TorchSketchExporter(batch_size=BATCH, device="cuda")
    for d in dense[:2]:
        exp.fold_dense(d)
    torch.cuda.synchronize()
    n = FOLDS_PER_WINDOW // 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            exp.fold_dense(dense[i % len(dense)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    exp.close()
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    check(busy_us > 0, "the profiler saw no device time")
    return {"phase": "profile", "folds": n, "wall_ms_per_fold":
            wall * 1e3 / n, "device_ms_per_fold": busy_us / 1e3 / n,
            "device_busy_share": busy_us / 1e6 / wall if wall else None,
            "top_device_ops": [{"name": k[:80], "us_per_fold": us / n,
                                "calls_per_fold": c / n}
                               for us, k, c in rows[:15]]}


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
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
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
        emit({"phase": "traffic", "seconds": time.perf_counter() - t0,
              "batches": len(pool), "rows_per_batch": BATCH})
        phase = "kernels"
        calls = capture_main_path_inputs(specs, universe, pool, dense)
        results = phase_kernels(specs, calls)
        phase = "main_path"
        main_res = phase_main_path(specs, universe, pool, dense)
        emit(main_res)
        phase = "profile"
        emit(phase_profile(dense))
        torch.cuda.synchronize()
    except Exception as e:  # every phase failure ends the run, loudly
        import traceback
        traceback.print_exc()
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        return 1
    emit({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"netobserv_tpu_torch/csrc/{s['mod'].SOURCE}",
         "replaces": s["replaces"],
         "launches": main_res["launches"][r["name"]],
         "max_abs_err": r["max_abs_err"], "ms": r["device_kernel_ms"],
         "plain_ms": r["device_plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["device_library_ms"]}
        for r, s in zip(results, specs)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
