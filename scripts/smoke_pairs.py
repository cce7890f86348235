#!/usr/bin/env python3
"""Run `chip_smoke.py` from two checkouts in turns on one card and compare.

    python3 scripts/smoke_pairs.py --a PARENT_DIR --b CHANGE_DIR \\
        [--pairs 10] [--out .ab/pairs]

Runs `python3 chip_smoke.py` from the root of checkout A, then B, B, A,
A, B, ... (A B B A per two pairs), `--pairs` runs of each, one at a time
on the card of this machine. Each run's output goes to OUT/run<i>-<a|b>.log.
From every run that ended with the "ok" line it reads the end-to-end
numbers the smoke prints (records/s of each path, over its windows and in
its last, the resident path's pack seconds per fold, and the profile
phases' wall and device ms per fold and device busy share) and prints, per number, each side's median, its range
and in how many pairs B was lower than A. The last line is one JSON object
with the same. A checkout whose smoke lacks a number prints null for it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: (line phase, key, how a list value reduces: the mean over windows, or
#: the last window) of every number compared
NUMBERS = (
    ("main_path", "records_per_s", "mean"),
    ("main_path", "records_per_s", "last"),
    ("tiered_path", "records_per_s", "mean"),
    ("tiered_path", "records_per_s", "last"),
    ("resident_path", "records_per_s", "mean"),
    ("resident_path", "records_per_s", "last"),
    ("resident_path", "pack_seconds_per_fold", "mean"),
    ("resident_path", "ingest_seconds_per_fold", "mean"),
    ("profile", "wall_ms_per_fold", None),
    ("profile", "device_ms_per_fold", None),
    ("profile", "device_busy_share", None),
    ("profile_tiered", "wall_ms_per_fold", None),
    ("profile_tiered", "device_ms_per_fold", None),
    ("profile_tiered", "device_busy_share", None),
    ("profile_resident", "wall_ms_per_fold", None),
    ("profile_resident", "device_ms_per_fold", None),
    ("profile_resident", "device_busy_share", None),
    ("done", "seconds", None),
)


def read_run(log: Path) -> dict | None:
    """The compared numbers of one run's output, or None unless it ended
    with the ok line."""
    lines = [ln for ln in log.read_text().splitlines() if ln.startswith("{")]
    if not lines or not json.loads(lines[-1]).get("ok"):
        return None
    by_phase = {}
    for ln in lines:
        obj = json.loads(ln)
        if "phase" in obj:
            by_phase[obj["phase"]] = obj
    out = {}
    for phase, key, reduce in NUMBERS:
        v = by_phase.get(phase, {}).get(key)
        if isinstance(v, list) and reduce == "mean":
            v = sum(v) / len(v)
        elif isinstance(v, list) and reduce == "last":
            v = v[-1]
        name = f"{phase}.{key}" + (".last" if reduce == "last" else "")
        out[name] = v
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=".ab/pairs",
                    help="directory for the runs' logs")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    roots = {"a": Path(args.a).resolve(), "b": Path(args.b).resolve()}
    order = [("a", "b", "b", "a")[i % 4] for i in range(2 * args.pairs)]
    runs = {"a": [], "b": []}
    failed = []
    for i, side in enumerate(order):
        log = out / f"run{i:02d}-{side}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"],
                                cwd=roots[side], stdout=f,
                                stderr=subprocess.STDOUT).returncode
        got = read_run(log) if rc == 0 else None
        print(f"run {i} {side}: rc={rc} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if got is None:
            failed.append(log.name)
        runs[side].append(got)
    summary = {}
    for phase, key, reduce in NUMBERS:
        name = f"{phase}.{key}" + (".last" if reduce == "last" else "")
        vals = {s: [r[name] if r else None for r in runs[s]] for s in runs}
        row = {}
        for s, vs in vals.items():
            have = [v for v in vs if v is not None]
            row[s] = ({"median": statistics.median(have), "min": min(have),
                       "max": max(have), "n": len(have)} if have else None)
        pairs = [(a, b) for a, b in zip(vals["a"], vals["b"])
                 if a is not None and b is not None]
        row["b_lower_in_pairs"] = (sum(b < a for a, b in pairs)
                                   if pairs else None)
        row["pairs"] = len(pairs)
        summary[name] = row
        med = {s: (row[s]["median"] if row[s] else None) for s in runs}
        print(f"{name:42s} A {med['a']!s:>22} B {med['b']!s:>22} "
              f"B lower in {row['b_lower_in_pairs']}/{len(pairs)}")
    print(json.dumps({"pairs": args.pairs, "failed": failed,
                      "numbers": summary}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
