#!/usr/bin/env python3
"""Time design variants of the single-plane Count-Min fold (kernel 5,
`csrc/countmin_fold2.cu` `cm_fold`) against the committed design on one
CUDA card, and count the SASS instructions of each.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/countmin_fold_variants.py [--parent DIR] [--rounds N]

The committed design runs kernel 1's body (`cm_fold2_kernel`) with one
value row: threads row-major, t = r * B + b, the lanes of a warp that hit
one cell summing their values (`warp_agg.cuh`) and the group's leader
making the one atomicAdd. The variants, each a source of its own with a
`cm_fold` entry of the same signature:

- `record_loop`: one thread per record that loads h1, h2 and its value
  once and loops over the d rows, one match and aggregation a row (a
  quarter of the threads, d atomics each);
- `row_major_no_aggregation`: the committed thread layout with one
  atomicAdd per (row, record) of a non-zero value, which isolates the
  layout's share of the gain;
- `parent` (with `--parent DIR`): the Count-Min sources of the checkout at
  DIR, `countmin_fold.cu` (a record-major kernel with one atomicAdd per
  (record, row)) where it has one, and its `countmin_fold2.cu`, whose
  kernel 1 is timed beside the committed one.

Sources are built with the flags of `ops/kernels/_build.py` into
`csrc/build/variants_cm/`. Inputs are the wide path's kernel-1 call at
the default geometry (B = 16,384, d = 4, W = 65,536, the bench traffic,
seed 0, after WARM_FOLDS folds; `chip_smoke.capture_main_path_inputs`):
kernel 5 takes its table, h1, h2 and bytes values, as in `chip_smoke.py`;
both also with random hash lanes (uniform keys). Every variant is first
held against the plain version (`countmin_kernel.update_plain`): on those
inputs within 2 * (n + 1) * 2^-24 of each cell (`chip_smoke.compare`), in
the integer regime (`chip_smoke.integer_inputs`) and on the contract cases
of `ops/kernels/cases.py` bit-exact. Then each is timed by
`chip_smoke.measure` (device ms from torch.profiler, the table's restore
subtracted) in ROUNDS rounds whose order alternates. One JSON line per
variant (its SASS counts and every reading), then a summary line of
medians, with the card's name and power limit. Before it, a last probe
times the committed kernels 1 and 5 on the same inputs with their tables
at PLACES addresses of one buffer, and prints each placement's median:
how far the tables' addresses alone move a reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the C entry every variant exports, with the committed signature
ENTRY = """
extern "C" int cm_fold(float* cm, const int64_t* h1, const int64_t* h2,
                       const float* vals, int n, int depth, int width,
                       cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (int)(((long long)n * GRID_ROWS + 255) / 256);
    cm_fold_kernel<<<blocks, 256, 0, stream>>>(cm, h1, h2, vals, n, depth,
                                               width);
  }
  return (int)cudaGetLastError();
}
"""
HEAD = """#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_agg.cuh"

"""
RECORD_LOOP = HEAD + """#define GRID_ROWS 1

__global__ void cm_fold_kernel(float* __restrict__ cm,
                               const int64_t* __restrict__ h1,
                               const int64_t* __restrict__ h2,
                               const float* __restrict__ vals,
                               int n, int depth, int width) {
  // one thread per record; every lane runs all d rows' matches
  const unsigned b = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  uint32_t x = 0, y = 0;
  if (b < (unsigned)n) {
    v = vals[b];
    x = (uint32_t)h1[b];
    y = (uint32_t)h2[b];
  }
  for (int r = 0; r < depth; ++r) {
    const int key = v != 0.0f
        ? r * width + (int)((x + (uint32_t)r * y) & (uint32_t)(width - 1))
        : -1;
    const unsigned peers = warp_peers(key);
    float s[1] = {v};
    group_sum<1>(peers, s);
    if (key >= 0 && group_leader(peers) && s[0] != 0.0f)
      atomicAdd(cm + key, s[0]);
  }
}
""" + ENTRY
ROW_MAJOR_NO_AGGREGATION = HEAD + """#define GRID_ROWS depth

__global__ void cm_fold_kernel(float* __restrict__ cm,
                               const int64_t* __restrict__ h1,
                               const int64_t* __restrict__ h2,
                               const float* __restrict__ vals,
                               int n, int depth, int width) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)n * (unsigned)depth) return;
  const int r = (int)(t / (unsigned)n);
  const int b = (int)t - r * n;
  const float v = vals[b];
  if (v == 0.0f) return;
  const uint32_t col = ((uint32_t)h1[b] + (uint32_t)r * (uint32_t)h2[b])
                       & (uint32_t)(width - 1);
  atomicAdd(cm + r * width + (int)col, v);
}
""" + ENTRY
#: SASS opcodes counted in the fold kernels
OPCODES = ("LDG", "RED", "ATOM", "ATOMG", "REDG", "MATCH", "SHFL", "VOTE",
           "BRA")
#: table placements of the address probe
PLACES = 8
#: bytes between the table placements of the address probe: 289 x 256,
#: aligned as an allocation is and not a power of two, so the placements
#: spread over the L2's address hashing
PLACE_STEP = 73984
#: kernel 5's and kernel 1's kernels as the wrapper module names them
ATTRS = {"cm_fold": "KERNEL_ONE", "cm_fold2": "KERNEL"}


def variant_sources(parent: Path | None) -> dict[str, str]:
    """The committed source, the two variants and the parent's sources,
    by name."""
    from netobserv_tpu_torch.ops.kernels import _build, countmin_kernel
    out = {"committed": (_build.CSRC / countmin_kernel.SOURCE).read_text(),
           "record_loop": RECORD_LOOP,
           "row_major_no_aggregation": ROW_MAJOR_NO_AGGREGATION}
    if parent:
        csrc = parent / "netobserv_tpu_torch" / "csrc"
        texts = [(csrc / f).read_text() for f in ("countmin_fold.cu",
                                                  "countmin_fold2.cu")
                 if (csrc / f).exists()]
        if not texts:
            raise SystemExit(f"{csrc}: no Count-Min fold source")
        out["parent"] = "\n".join(texts)
    return out


def build_all(sources: dict[str, str], out_dir: Path) -> dict[str, Path]:
    """Build every source at once (one nvcc each, all against the committed
    headers); raise on a failure."""
    from netobserv_tpu_torch.ops.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out_dir / f"{name}.so"), str(src)],
            stdout=log, stderr=subprocess.STDOUT), log)
    for name, (p, log) in procs.items():
        rc = p.wait()
        log.close()
        if rc:
            raise SystemExit(f"{name}: nvcc rc={rc}\n"
                             + (out_dir / f"{name}.log").read_text()[-3000:])
    return {name: out_dir / f"{name}.so" for name in sources}


def sass_counts(lib: Path, log: Path) -> dict:
    """Opcode counts of each fold kernel's SASS (cuobjdump -sass), by its
    mangled name, and the registers and spills of the build (-Xptxas -v)."""
    from netobserv_tpu_torch.ops.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out: dict = {}
    for f in text.split("Function : ")[1:]:
        name = f.split("\n", 1)[0].strip()
        if "cm_fold" not in name:
            continue
        counts: dict = {}
        for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", f):
            if m.group(1) in OPCODES:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        out[name] = counts
    logtext = log.read_text()
    return {"kernels": out,
            "registers": [int(r) for r in
                          re.findall(r"Used (\d+) registers", logtext)],
            "spill_store_bytes": [int(s) for s in re.findall(
                r"(\d+) bytes spill stores", logtext)]}


def bind(name: str, lib: Path) -> dict:
    """The variant's C entries as CudaKernels, by the wrapper module's
    attribute (KERNEL_ONE for kernel 5, KERNEL for kernel 1)."""
    from netobserv_tpu_torch.ops.kernels import _build, countmin_kernel
    key = f"variant_cm:{name}"
    _build._LIBS[key] = ctypes.CDLL(str(lib))
    out = {}
    for symbol, attr in ATTRS.items():
        if hasattr(_build._LIBS[key], symbol):
            k = getattr(countmin_kernel, attr)
            out[attr] = _build.CudaKernel(
                key, symbol, k.argtypes.count(ctypes.c_void_p) - 1,
                k.argtypes.count(ctypes.c_int))
    return out


def timed(spec, fn, args, work) -> float:
    """Device ms of fn(*work) by `chip_smoke.measure`, the work's tables
    restored from args' before every call (and that restore subtracted)."""
    import chip_smoke as cs
    src, dst = cs._inplace(spec, args), cs._inplace(spec, work)

    def restore():
        for d, s in zip(dst, src):
            d.copy_(s)
    return cs.measure(lambda: fn(*work), restore)[1]


def address_probe(spec: dict, inputs: dict, places: int,
                  rounds: int) -> dict:
    """The committed kernels 1 and 5 on the same inputs with their tables
    at `places` addresses PLACE_STEP bytes apart in one buffer, in rounds
    of alternating order: how much of a reading the tables' addresses set
    (on the batch, the hot key's d cells sit at other L2 addresses in each
    place; on uniform keys no cell is hot)."""
    import torch
    import chip_smoke as cs
    from netobserv_tpu_torch.ops.kernels import countmin_kernel
    step = PLACE_STEP // 4
    out: dict = {"place_step_bytes": PLACE_STEP, "device_ms": {}}
    for attr, by in inputs.items():
        s = spec[attr]
        fn = getattr(countmin_kernel, s["wrapper"])
        for k, args in by.items():
            tables = cs._inplace(s, args)
            bufs = [torch.empty(t.numel() + places * step, device=t.device)
                    for t in tables]
            ms = [[] for _ in range(places)]
            for r in range(rounds):
                for j in (range(places) if r % 2 == 0
                          else reversed(range(places))):
                    views = [b[j * step:j * step + t.numel()].view_as(t)
                             for b, t in zip(bufs, tables)]
                    work = (*views, *cs._clone(args[len(views):]))
                    ms[j].append(timed(s, fn, args, work))
            med = [statistics.median(x) for x in ms]
            out["device_ms"][f"{s['name']}:{k}"] = {
                "median_by_place": med, "min": min(med), "max": max(med),
                "max_over_min": max(med) / min(med)}
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("countmin_fold_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from netobserv_tpu_torch.ops.kernels import _build, countmin_kernel
    from netobserv_tpu_torch.scenarios import traffic
    from netobserv_tpu_torch.sketch import state as sk

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    opt = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)

    out_dir = _build.BUILD_DIR / "variants_cm"
    libs = build_all(variant_sources(opt.parent), out_dir)

    specs = {s["name"]: s for s in cs.kernel_specs()}
    spec = {"KERNEL_ONE": specs["countmin_fold"],
            "KERNEL": specs["countmin_fold2"]}
    _, pool = traffic.make_pool(np.random.default_rng(0))
    calls = cs.capture_main_path_inputs(list(specs.values()),
                                        traffic.dense_pool(pool),
                                        sk.SketchConfig())
    (two,) = calls["countmin_fold2"][:1]
    (one,) = spec["KERNEL_ONE"]["derive"][1](two)
    inputs = {"KERNEL_ONE": {"wide": one}, "KERNEL": {"wide": two}}
    for attr, by in inputs.items():
        by["wide_uniform"] = cs.uniform_variant(spec[attr], by["wide"])

    saved = {a: getattr(countmin_kernel, a) for a in ATTRS.values()}

    def use(kernels: dict) -> None:
        for a, k in {**saved, **kernels}.items():
            setattr(countmin_kernel, a, k)

    variants = {}
    for name, lib in libs.items():
        kernels = bind(name, lib)
        use(kernels)
        checks = {}
        for attr in kernels:
            s = spec[attr]
            for k, args in inputs[attr].items():
                checks[f"{s['name']}:{k}"] = cs.compare(
                    s, args, "production")["max_rel_err"]
                checks[f"{s['name']}:{k}:integer"] = cs.compare(
                    s, cs.integer_inputs(s, args), "integer")["max_abs_err"]
            checks[f"{s['name']}:contract_cases"] = max(
                c["max_abs_err"] for c in cs.contract_cases(
                    s, inputs[attr]["wide"]))
        use({})
        variants[name] = {"kernels": kernels, "checks": checks,
                          "ms": {f"{spec[a]['name']}:{k}": []
                                 for a in kernels for k in inputs[a]},
                          "sass": sass_counts(lib, out_dir / f"{name}.log")}

    order = list(variants)
    for r in range(opt.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            v = variants[name]
            use(v["kernels"])
            for attr in v["kernels"]:
                s = spec[attr]
                fn = getattr(countmin_kernel, s["wrapper"])
                for k, args in inputs[attr].items():
                    work = cs._clone(args)
                    v["ms"][f"{s['name']}:{k}"].append(
                        timed(s, fn, args, work))
            use({})
    summary = {}
    for name, v in variants.items():
        print(json.dumps({"variant": name, "checks": v["checks"],
                          "sass": v["sass"], "device_ms": v["ms"]}))
        summary[name] = {k: statistics.median(x) for k, x in v["ms"].items()}
    print(json.dumps(address_probe(spec, inputs, PLACES, opt.rounds)))
    print(json.dumps({"card": smi, "rounds": opt.rounds,
                      "median_device_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
