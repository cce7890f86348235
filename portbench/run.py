"""Run one cell of the benchmark and print its result line.

    python -m portbench.run --workload resident.fullmap --seed 7 --seconds 45 \
        --trace 0

Run from the root of a checkout that holds `BENCHMARK.json`. The run needs
as many CUDA cards as the cell asks for: without them it exits with 2 and
prints no result. It prints, as the last line of standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (with `--trace 0` the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` a `breakdown`, and last `checks`: each number
the comparison with the reference gave, beside its limit. The same
numbers end standard error. A run whose process has loaded JAX or the JAX
package exits with 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

#: top-level modules the run must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "netobserv_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, roofline

    root = Path.cwd()
    cell = harness.load_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    peaks = roofline.peaks(Path(harness.__file__).resolve().parent)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           started, peak=peaks.get(kind, peaks["default"]))
    run = out["run"]
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in out["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace and run.slice is not None:
        device["busy_s"] = run.slice.busy_s
        device["window_s"] = run.slice.window_s
        result["breakdown"] = {"device_ops": run.slice.device_ops,
                               "idle_gaps": run.slice.idle_gaps}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for w in out["windows"]:
        print(f"window {json.dumps(w)}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
