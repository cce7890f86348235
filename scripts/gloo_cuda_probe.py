#!/usr/bin/env python3
"""Time the port's collectives (`netobserv_tpu_torch/parallel/
distributed.py`) on CUDA tensors of two gloo ranks that share one card.

    python3 scripts/gloo_cuda_probe.py

Run from the root of a checkout on a machine with a CUDA card. It prints
the card's name and power limit, then starts two ranks of itself
(`--rank R PORT`) on `cuda:0` over 127.0.0.1, each killed after 120 s.
Each rank checks and times, on CUDA tensors: a sum all-reduce of 2^20
float32 (4 MiB), a maximum all-reduce of 1,000 int32, an all-gather of
1,000 int64 and of 10 bool, and an object all-gather; for each the first
call's seconds and the median of five more in ms, as one JSON line
("PROBE {...}"). It exits 0 when both ranks checked every result.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPS = 5


def _timed(fn) -> dict:
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    reps = []
    for _ in range(REPS):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t1)
    return {"first_s": first, "median_ms": sorted(reps)[REPS // 2] * 1e3}


def rank_main(rank: int, port: str) -> int:
    import torch
    from netobserv_tpu_torch.parallel import distributed as pd
    os.environ.update(SKETCH_COORDINATOR=f"127.0.0.1:{port}",
                      SKETCH_NUM_PROCESSES="2", SKETCH_PROCESS_ID=str(rank))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def check(cond: bool, what: str) -> None:
        if not cond:
            raise RuntimeError(f"rank {rank}: {what}")

    check(pd.maybe_initialize_distributed(backend="gloo", devices=[dev]),
          "no process group")
    out: dict = {"rank": rank, "backend": pd.backend()}

    def sum_f32():
        t = torch.full((1 << 20,), float(rank + 1), device=dev)
        pd.all_reduce_sum_(t)
        check(t.device == dev and bool((t == 3.0).all()), "sum")

    def max_i32():
        t = torch.full((1000,), rank + 3, dtype=torch.int32, device=dev)
        pd.all_reduce_max_(t)
        check(bool((t == 4).all()), "max")

    def gather_i64():
        got = pd.all_gather(torch.full((1000,), rank, dtype=torch.int64,
                                       device=dev))
        check([int(g[0]) for g in got] == [0, 1]
              and got[1].device == dev, "all-gather int64")

    def gather_bool():
        got = pd.all_gather(torch.full((10,), bool(rank), device=dev))
        check([bool(g[0]) for g in got] == [False, True], "all-gather bool")

    def gather_obj():
        check(pd.all_gather_object({"r": rank}) == [{"r": 0}, {"r": 1}],
              "object all-gather")

    for name, fn in (("all_reduce_sum_f32_4MiB", sum_f32),
                     ("all_reduce_max_i32", max_i32),
                     ("all_gather_i64", gather_i64),
                     ("all_gather_bool", gather_bool),
                     ("all_gather_object", gather_obj)):
        out[name] = _timed(fn)
    print("PROBE " + json.dumps(out), flush=True)
    pd.destroy()
    return 0


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), port]) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    print(json.dumps({"rcs": rcs}), flush=True)
    return 0 if rcs == [0, 0] else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
