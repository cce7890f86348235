"""Read the control's numbers at a cell's own size.

    python -m portbench.control --workload resident.fullmap --seeds 1,2,3 \
        --window-evictions 220

For each seed: the cell's pool, `--windows` windows of
`--window-evictions` evictions each (a run's window holds as many as the
cell folds in the configuration's 5 s), the control's tables
(`reference/control.py`) judged against the reference, one JSON line a
seed. On the card when there is one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from portbench import harness
from portbench.reference import control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--window-evictions", type=int, required=True)
    ap.add_argument("--windows", type=int, default=2)
    args = ap.parse_args(argv)
    cell = harness.load_cell(Path.cwd(), args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds.split(","):
        num = control.readings(cell.mix, cell.config, int(seed),
                               args.window_evictions, args.windows, dev,
                               harness._dtypes())
        print(json.dumps({"workload": args.workload, "seed": int(seed),
                          "device": str(dev), "control": num}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
