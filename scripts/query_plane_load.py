#!/usr/bin/env python3
"""What the query plane costs the lanes feed, by poll rate, on one card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 scripts/query_plane_load.py

It builds the kernels and the seeded bench traffic as `chip_smoke.py`
does, runs that script's `window_thread` phase (the lanes feed with its
window thread on, query plane off), then its `query_plane` phase once per
entry of VARIANTS: the pollers' pause after each turn of the nine routes
(0 is the smoke's tight loop) and the interpreter's switch interval
(`sys.setswitchinterval`; 5 ms is Python's default) and the window (the
refresh a quarter of it), then `window_thread` again. A check of a phase
that fails is printed with its run, not raised: this script measures, and
`chip_smoke.py` is the gate. One JSON line per run:
records/s, `export_evicted` median and longest, the requests answered a
second, the refreshes' lock hold and whole time, the roll's CM-plane copy
and the routes' p50 and p99; the card's name and power limit first.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

#: (label, poller pause in seconds, switch interval in seconds, window in
#: seconds)
VARIANTS = (("tight", 0.0, 0.005, 1.0), ("tight_window_0.5s", 0.0, 0.005, 0.5),
            ("tight_switch_0.5ms", 0.0, 0.0005, 1.0),
            ("pace_0.1s", 0.1, 0.005, 1.0), ("pace_1s", 1.0, 0.005, 1.0))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("query_plane_load: needs a CUDA card", file=sys.stderr)
        return 2
    from netobserv_tpu_torch.scenarios import traffic
    cs.emit(cs.phase_device())
    specs = cs.kernel_specs()
    cs.emit(cs.phase_build(specs))
    universe, pool = traffic.make_pool(np.random.default_rng(0))
    events = traffic.event_pool(pool, np.random.default_rng(0))
    default_si = sys.getswitchinterval()
    failed: list = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    before = cs.phase_window_thread(specs, universe, pool, events)
    cs.emit({"run": "window_thread", "records_per_s":
             before["records_per_s"],
             "export_evicted_median_s": before["export_evicted_median_s"],
             "export_evicted_max_s": before["export_evicted_max_s"],
             "failed_checks": failed[:]})
    window = cs.QP_WINDOW_S
    for label, pace, si, win in VARIANTS:
        failed.clear()
        cs.QP_PACE_S = pace
        cs.QP_WINDOW_S, cs.QP_REFRESH_S = win, win / 4
        sys.setswitchinterval(si)
        t0 = time.perf_counter()
        try:
            r = cs.phase_query_plane(specs, universe, pool, events,
                                     before["records_per_s"])
        finally:
            sys.setswitchinterval(default_si)
            cs.QP_WINDOW_S, cs.QP_REFRESH_S = window, window / 4
        asked = sum(v["n"] for v in r["route_ms"].values())
        cs.emit({"run": label, "poll_pace_s": pace, "switch_interval_s": si,
                 "window_s": win, "failed_checks": failed[:],
                 "seconds": time.perf_counter() - t0,
                 "records_per_s": r["records_per_s"],
                 "window_thread_records_per_s": before["records_per_s"],
                 "export_evicted_median_s": r["export_evicted_median_s"],
                 "export_evicted_max_s": r["export_evicted_max_s"],
                 "requests_per_s": asked / r["feed_seconds"],
                 "refreshes": r["refreshes"], "windows": r["windows"],
                 "mid_window_snapshots": r["mid_window_snapshots"],
                 "refresh_lock_ms_median": r["refresh_lock_ms_median"],
                 "refresh_lock_ms_max": r["refresh_lock_ms_max"],
                 "refresh_drain_ms_median": r["refresh_drain_ms_median"],
                 "refresh_total_ms_median": r["refresh_total_ms_median"],
                 "roll_cm_copy_ms_median": r["roll_cm_copy_ms_median"],
                 "route_ms": r["route_ms"]})
    failed.clear()
    after = cs.phase_window_thread(specs, universe, pool, events)
    cs.emit({"run": "window_thread_again",
             "records_per_s": after["records_per_s"],
             "export_evicted_median_s": after["export_evicted_median_s"],
             "export_evicted_max_s": after["export_evicted_max_s"],
             "failed_checks": failed[:]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
