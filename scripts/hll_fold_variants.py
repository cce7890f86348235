#!/usr/bin/env python3
"""Time design variants of the HLL folds launch (`csrc/hll_fold.cu`, kernels
3 and 8 of one batch in one launch) against the committed design on one
CUDA card, and count the SASS instructions of each.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/hll_fold_variants.py [--parent DIR] [--rounds N]

Each variant is the committed source with one choice of its design turned
the other way: the group maximum by the pointer jumping of `warp_agg.cuh`
(`group_max`) or by `__reduce_max_sync`; the leader reading its register
first and skipping the atomic when the register already holds the maximum,
or not; blocks of 256 threads or 128; and no warp aggregation at all (one
atomic per valid row, with or without the read first). With `--parent DIR`, the `hll_fold.cu` of the
checkout at DIR is timed too: kernels 3 and 8 as it builds them, one launch
per fold. Sources are built with the flags of `ops/kernels/_build.py` into
`csrc/build/variants/`.

Inputs are the wide path's folds call at the default geometry (B = 16,384,
the global HLL and the per-dst and per-src grids of one fold of the bench
traffic, seed 0, after WARM_FOLDS folds; `chip_smoke.capture_main_path_
inputs`), its two grids alone (the tiered path's folds call), both with
random hash lanes (uniform keys), and the wide call onto registers that a
window's roll has just reset to 0 (cold registers). Every variant is first held bit-exact
against `update_folds_plain` on those inputs (and, for those with a folds
entry, on the contract cases of `ops/kernels/cases.py`); then each is timed
by `chip_smoke.measure` (device ms from torch.profiler, the registers'
restore subtracted) in ROUNDS rounds whose order alternates. One JSON line
per variant (its SASS counts and every reading), then a summary line of
medians, with the card's name and power limit.
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

#: one design choice each, as the two forms (named) of its lines
REDUX = "  const int top = __reduce_max_sync(peers, rank);\n"
GROUP = "  const int top = group_max(peers, rank);\n"
ATOMIC = ("  if (group_leader(peers) && top > 0) "
          "atomicMax(f.regs + cell, top);\n")
READ_FIRST = ("  if (group_leader(peers) && top > 0\n"
              "      && *((volatile int*)(f.regs + cell)) < top)\n"
              "    atomicMax(f.regs + cell, top);\n")
THREADS_256 = "#define HLL_THREADS 256\n"
THREADS_128 = "#define HLL_THREADS 128\n"
TOGGLES = ((("reduce_max_sync", REDUX), ("group_max", GROUP)),
           (("no_read_first", ATOMIC), ("read_first", READ_FIRST)),
           (("threads_256", THREADS_256), ("threads_128", THREADS_128)))
#: SASS opcodes counted in the fold kernel
OPCODES = ("LDG", "RED", "ATOM", "ATOMG", "REDG", "REDUX", "MATCH", "SHFL",
           "VOTE", "BRA")


def variant_sources(text: str) -> dict[str, str]:
    """The committed source and each toggle of it, by name."""
    out = {"committed": text}
    for pair in TOGGLES:
        for (_, have), (name, other) in (pair, pair[::-1]):
            if text.count(have) == 1:
                out[name] = text.replace(have, other)
                break
        else:
            raise SystemExit(f"hll_fold.cu: no line to toggle for {pair}")
    agg = re.search(r"  const unsigned peers = warp_peers\(\(int\)cell\);\n"
                    r".*?atomicMax\(f\.regs \+ cell, top\);\n", text, re.S)
    if agg is None:
        raise SystemExit("hll_fold.cu: no warp aggregation to remove")
    out["no_aggregation"] = text.replace(
        agg.group(0), "  if (rank > 0) atomicMax(f.regs + cell, rank);\n")
    out["no_aggregation_read_first"] = text.replace(
        agg.group(0), "  if (rank > 0 && *((volatile int*)(f.regs + cell)) "
        "< rank)\n    atomicMax(f.regs + cell, rank);\n")
    return out


def build_all(sources: dict[str, str], out_dir: Path) -> dict[str, Path]:
    """Build every source at once (one nvcc each); raise on a failure."""
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
    """Opcode counts of the fold kernel's SASS (cuobjdump -sass) and its
    registers and spills (the -Xptxas -v lines of the build log)."""
    from netobserv_tpu_torch.ops.kernels import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = [f for f in text.split("Function : ")[1:]
             if "hll_fold" in f.split("\n", 1)[0]]
    counts: dict = {}
    strong = 0
    for f in funcs:
        for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)", f):
            if m.group(1) in OPCODES:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
            if m.group(1) == "LDG" and "STRONG" in m.group(2):
                strong += 1
    regs = re.findall(r"Used (\d+) registers", log.read_text())
    spills = re.findall(r"(\d+) bytes spill stores", log.read_text())
    return {"kernels": len(funcs), "opcodes": counts,
            "ldg_strong": strong, "registers": [int(r) for r in regs],
            "spill_store_bytes": [int(s) for s in spills]}


def bind(name: str, lib: Path):
    """The variant's three C entries as CudaKernels (None where absent)."""
    from netobserv_tpu_torch.ops.kernels import _build, hll_kernel
    key = f"variant:{name}"
    _build._LIBS[key] = ctypes.CDLL(str(lib))
    out = {}
    for attr in ("KERNEL", "KERNEL_GRID", "KERNEL_FOLDS"):
        k = getattr(hll_kernel, attr)
        if hasattr(_build._LIBS[key], k.symbol):
            out[attr] = _build.CudaKernel(key, k.symbol,
                                          k.argtypes.count(ctypes.c_void_p)
                                          - 1,
                                          k.argtypes.count(ctypes.c_int))
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hll_fold_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from netobserv_tpu_torch.ops.kernels import _build, hll_kernel
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

    sources = variant_sources((_build.CSRC / hll_kernel.SOURCE).read_text())
    if opt.parent:
        sources["parent"] = (opt.parent / "netobserv_tpu_torch" / "csrc"
                             / hll_kernel.SOURCE).read_text()
    out_dir = _build.BUILD_DIR / "variants"
    libs = build_all(sources, out_dir)

    specs = cs.kernel_specs()
    spec = next(s for s in specs if s["name"] == "hll_fold_folds")
    _, pool = traffic.make_pool(np.random.default_rng(0))
    calls = cs.capture_main_path_inputs(specs, traffic.dense_pool(pool),
                                        sk.SketchConfig())
    (wide,) = calls["hll_fold_folds"][0]
    inputs = {"wide": (wide,), "tiered": (wide[1:],)}
    for k in list(inputs):
        inputs[f"{k}_uniform"] = cs.uniform_variant(spec, inputs[k])
    # the first fold of a window: the roll reset every register to 0
    cold = cs._clone(inputs["wide"])
    for f in cold[0]:
        f[0].zero_()
    inputs["wide_cold"] = cold

    saved = {a: getattr(hll_kernel, a) for a in
             ("KERNEL", "KERNEL_GRID", "KERNEL_FOLDS")}

    def call(kernels):
        """The fold of a variant: one folds launch, or one launch a fold."""
        if "KERNEL_FOLDS" in kernels:
            return hll_kernel.update_folds

        def per_fold(folds):
            for f in folds:
                (hll_kernel.update if len(f) == 4
                 else hll_kernel.update_per_dst)(*f)
        return per_fold

    variants = {}
    for name, lib in libs.items():
        kernels = bind(name, lib)
        for a, k in kernels.items():
            setattr(hll_kernel, a, k)
        fn = call(kernels)
        checks = {}
        for k, args in inputs.items():
            got, want = cs._clone(args), cs._clone(args)
            fn(*got)
            hll_kernel.update_folds_plain(*want)
            torch.cuda.synchronize()
            checks[k] = all(torch.equal(g[0], w[0])
                            for g, w in zip(got[0], want[0]))
        if "KERNEL_FOLDS" in kernels:
            checks["contract_cases"] = max(
                c["max_abs_err"] for c in cs.contract_cases(spec, (wide,)))
        for a, k in saved.items():
            setattr(hll_kernel, a, k)
        ok = (all(checks[k] is True for k in inputs)
              and checks.get("contract_cases", 0.0) == 0.0)
        variants[name] = {"kernels": kernels, "fn": fn, "checks": checks,
                          "ok": ok, "ms": {k: [] for k in inputs},
                          "sass": sass_counts(lib, out_dir / f"{name}.log")}
        if not ok:
            print(json.dumps({"variant": name, "checks": checks}))
            return 1

    order = list(variants)
    for r in range(opt.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            v = variants[name]
            for a, k in v["kernels"].items():
                setattr(hll_kernel, a, k)
            for k, args in inputs.items():
                work = cs._clone(args)
                src = [f[0] for f in args[0]]
                dst = [f[0] for f in work[0]]

                def restore():
                    for d, s in zip(dst, src):
                        d.copy_(s)
                v["ms"][k].append(cs.measure(lambda: v["fn"](*work),
                                             restore)[1])
            for a, k in saved.items():
                setattr(hll_kernel, a, k)
    summary = {}
    for name, v in variants.items():
        print(json.dumps({"variant": name, "checks": v["checks"],
                          "sass": v["sass"], "device_ms": v["ms"]}))
        summary[name] = {k: statistics.median(x) for k, x in v["ms"].items()}
    print(json.dumps({"card": smi, "rounds": opt.rounds,
                      "median_device_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
