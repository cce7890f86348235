#!/usr/bin/env python3
"""How the resident feed's host pack scales with lanes and threads.

Run from the root of a checkout (host code only: it builds the native
packer with g++, and needs no card):

    python3 scripts/lane_pack_scaling.py [--repeats N]

It folds the seeded bench pool (`scenarios/traffic`, 8 batches of 16,384
records as flow events) through `sketch/staging.ShardedResidentStagingRing`
with the device fold left out (its ingest returns the state untouched), so
the ring's `pack_seconds` and wall time are the host's alone: once to learn
the keys, then `--repeats` times, per 16,384 records, for each
(lanes, pack threads, ladder entry) of CONFIGS (with the native packer
the ring packs each segment in one native call). Then the ring's region
loop alone at k = 4 and 8 lanes (32 regions of 1,024 rows, the
benchmark's geometry), two ways, at 1, 2, 4 and 8 threads: region by
region through the pack pool (`flowpack._pack_submit`, one Python closure
and one `pack_resident_native` call a region: the ring's path before the
one-call pack), and one `pack_resident_segment` call a segment; and that
call's hand-off, 8 one-row regions at 8 workers against 1. Then the
native pack without the ring: the same 8 regions of 2,048 rows, 50 times
each (`pack_resident_native`, each with its own dictionary), one after
another and in 8 threads; and a control that holds no lock of the interpreter's
and touches no table (SHA-256 of a 16 MiB buffer, which hashlib computes
with the lock released), serial and in 8 threads: where the control does
not scale either, the host gives the process less than its CPU count. The
host line reads the CPU count, the affinity and the cgroup CPU quota. One
JSON line per measurement; on a machine with a card, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from netobserv_tpu_torch.datapath import flowpack  # noqa: E402
from netobserv_tpu_torch.scenarios import traffic  # noqa: E402
from netobserv_tpu_torch.sketch import staging  # noqa: E402

BATCH = 16384
#: (lanes, pack threads, ladder entry k)
CONFIGS = ((1, 1, 1), (2, 1, 1), (2, 2, 1), (4, 4, 1), (8, 1, 1),
           (8, 8, 1), (8, 1, 4), (8, 2, 4), (8, 4, 4), (8, 8, 4))


class PackOnlyRing(staging.ShardedResidentStagingRing):
    """The ring with its device fold left out."""

    def _ingest(self, k, state, key_tables, flat):
        return state


def _stream():
    _, pool = traffic.make_pool(np.random.default_rng(0))
    parts = traffic.event_pool(pool, np.random.default_rng(0))
    return (np.concatenate([e for e, _ in parts]),
            {k: np.concatenate([f[k] for _, f in parts])
             for k in parts[0][1]})


def ring_scaling(events, feats, repeats: int) -> None:
    for lanes, threads, k in CONFIGS:
        ring = PackOnlyRing(BATCH, device="cpu", lanes=lanes,
                            pack_threads=threads, ladder=(1, k))
        ring.fold(None, events, **feats)  # learn the keys
        ring.pack_seconds, chunks = 0.0, ring.chunks
        t0 = time.perf_counter()
        for _ in range(repeats):
            ring.fold(None, events, **feats)
        wall = time.perf_counter() - t0
        n16 = repeats * len(events) / BATCH
        print(json.dumps({
            "measure": "ring", "lanes": lanes, "pack_threads": threads,
            "k": k, "dispatches": ring.chunks - chunks,
            "pack_ms_per_16384": ring.pack_seconds * 1e3 / n16,
            "wall_ms_per_16384": wall * 1e3 / n16}), flush=True)
        ring.close()


def segment_scaling(events, feats, repeats: int) -> None:
    rows, k, lanes = 1024, 4, 8
    nr = k * lanes
    caps = flowpack.default_resident_caps(rows)
    rw = flowpack.resident_buf_len(rows, caps)
    buf = np.zeros(nr * rw, np.uint32)
    chunk = nr * rows
    chunks = [(events[lo:lo + chunk],
               {n: v[lo:lo + chunk] for n, v in feats.items()})
              for lo in range(0, len(events) - chunk + 1, chunk)]
    stats = np.zeros((nr, 4), np.int64)

    def by_pool(dicts, threads, ev, f):
        bounds = [len(ev) * i // nr for i in range(nr + 1)]
        starts = [0] * nr

        def region(i):
            lo, hi = bounds[i], bounds[i + 1]
            if starts[i] >= hi - lo:
                flowpack.zero_resident_region(buf[i * rw:(i + 1) * rw],
                                              rows, caps)
                return
            _, c = flowpack.pack_resident_native(
                ev[lo:hi], rows, dicts[i], caps, start=starts[i],
                out=buf[i * rw:(i + 1) * rw],
                **{n: v[lo:hi] for n, v in f.items()})
            starts[i] += c

        while any(starts[i] < bounds[i + 1] - bounds[i] for i in range(nr)):
            if threads > 1:
                for fut in flowpack._pack_submit(
                        threads, [lambda i=i: region(i) for i in range(nr)]):
                    fut.result()
            else:
                for i in range(nr):
                    region(i)

    def by_call(dicts, threads, ev, f, workers):
        n = len(ev)
        bounds = np.array([n * i // nr for i in range(nr + 1)], np.uint64)
        handles = np.array([d._live_handle() for d in dicts], np.uint64)
        lanes_ = tuple(flowpack._fit_rows(f[name], n, dt)
                       for name, dt in staging.PendingEventBuffer.LANES)
        starts = np.zeros(nr, np.uint64)
        while flowpack.pack_resident_segment(
                ev, lanes_, bounds, handles, starts, buf, rows, caps,
                1 << 18, stats, workers, threads):
            pass

    for path in ("pool", "call"):
        for threads in (1, 2, 4, 8):
            dicts = [flowpack.NativeKeyDict(1 << 18) for _ in range(nr)]
            workers = flowpack.PackWorkers() if path == "call" else None

            def one_pass():
                for ev, f in chunks:
                    if path == "pool":
                        by_pool(dicts, threads, ev, f)
                    else:
                        by_call(dicts, threads, ev, f, workers)

            one_pass()  # learn the keys
            cpu0, t0 = time.process_time(), time.perf_counter()
            for _ in range(repeats):
                one_pass()
            wall, cpu = (time.perf_counter() - t0,
                         time.process_time() - cpu0)
            n16 = repeats * len(chunks) * chunk / BATCH
            print(json.dumps({
                "measure": f"segment_{path}", "k": k, "lanes": lanes,
                "regions": nr, "rows": rows, "threads": threads,
                "wall_ms_per_16384": wall * 1e3 / n16,
                "cpu_ms_per_16384": cpu * 1e3 / n16}), flush=True)
            for d in dicts:
                d.close()
            if workers is not None:
                workers.close()
    # the hand-off: 8 one-row regions a call, at 8 workers against 1
    dicts = [flowpack.NativeKeyDict(1 << 10) for _ in range(8)]
    handles = np.array([d._live_handle() for d in dicts], np.uint64)
    bounds = np.arange(9, dtype=np.uint64)
    ev = np.ascontiguousarray(events[:8])
    workers, calls, per = flowpack.PackWorkers(), 2000, {}
    for threads in (1, 8, 1, 8):
        t0 = time.perf_counter()
        for _ in range(calls):
            flowpack.pack_resident_segment(
                ev, (None,) * 5, bounds, handles, np.zeros(8, np.uint64),
                buf, rows, caps, 1 << 10, stats[:8], workers, threads)
        per[threads] = (time.perf_counter() - t0) / calls
    print(json.dumps({"measure": "segment_handoff", "calls": calls,
                      "call_us_1": per[1] * 1e6, "call_us_8": per[8] * 1e6,
                      "handoff_ms": (per[8] - per[1]) * 1e3}), flush=True)
    workers.close()
    for d in dicts:
        d.close()


def call_scaling(events, feats) -> None:
    rows = BATCH // 8
    caps = flowpack.default_resident_caps(rows)
    dicts = [flowpack.NativeKeyDict(1 << 18) for _ in range(8)]
    outs = [np.zeros(flowpack.resident_buf_len(rows, caps), np.uint32)
            for _ in range(8)]
    regions = [(events[i * rows:(i + 1) * rows],
                {k: v[i * rows:(i + 1) * rows] for k, v in feats.items()})
               for i in range(8)]

    def job(i, n=50):
        ev, f = regions[i]
        for _ in range(n):
            flowpack.pack_resident_native(ev, rows, dicts[i], caps,
                                          out=outs[i], **f)

    for i in range(8):
        job(i, 1)
    t0 = time.perf_counter()
    for i in range(8):
        job(i)
    serial = time.perf_counter() - t0
    parallel = _threaded(job)
    print(json.dumps({"measure": "regions", "regions": 8, "rows": rows,
                      "calls_each": 50, "serial_s": serial,
                      "threads_s": parallel,
                      "speedup": serial / parallel}), flush=True)


def _threaded(fn, n: int = 8) -> float:
    """Seconds for n threads each running fn(i) to their end."""
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a thread did not finish")
    return time.perf_counter() - t0


def control_scaling() -> None:
    buf = np.random.default_rng(0).integers(0, 256, 1 << 24,
                                            dtype=np.uint8).tobytes()

    def job(i, n=4):
        for _ in range(n):
            hashlib.sha256(buf).digest()

    t0 = time.perf_counter()
    for i in range(8):
        job(i)
    serial = time.perf_counter() - t0
    parallel = _threaded(job)
    print(json.dumps({"measure": "control_sha256", "threads": 8,
                      "mib_each": 4 * 16, "serial_s": serial,
                      "threads_s": parallel,
                      "speedup": serial / parallel}), flush=True)


def _cpu_quota() -> str | None:
    """The cgroup's CPU quota line (v2 cpu.max, or v1 quota and period)."""
    for path in ("/sys/fs/cgroup/cpu.max",):
        if os.path.exists(path):
            return Path(path).read_text().strip()
    v1 = Path("/sys/fs/cgroup/cpu/cpu.cfs_quota_us")
    if v1.exists():
        period = Path("/sys/fs/cgroup/cpu/cpu.cfs_period_us").read_text()
        return f"{v1.read_text().strip()} {period.strip()}"
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        if smi.returncode == 0:
            print(smi.stdout.strip().splitlines()[0], flush=True)
    except (OSError, subprocess.TimeoutExpired):
        pass
    print(json.dumps({"measure": "host", "cpu_count": os.cpu_count(),
                      "affinity": len(os.sched_getaffinity(0)),
                      "cgroup_cpu_quota": _cpu_quota()}), flush=True)
    control_scaling()
    events, feats = _stream()
    segment_scaling(events, feats, args.repeats)
    call_scaling(events, feats)
    ring_scaling(events, feats, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
