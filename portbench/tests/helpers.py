"""Small cells for the CPU tests: the benchmark's own files, at a size a
test run holds."""

from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
#: the exporter on the CPU, with small batches and 1 s windows
CPU_ENV = {"SKETCH_DEVICES": "cpu", "SKETCH_BATCH_SIZE": "1024",
           "SKETCH_WINDOW": "1s"}


def small_mix(mix: dict, flows: int = 3000, pool: int = 4) -> dict:
    """A mix's laws at a test's size: `pool` evictions of `flows` flows."""
    out = dict(mix, flows_per_eviction=flows, pool=pool)
    out["universe"] = flows * pool if mix["draw"] == "sequential" \
        else 20 * flows
    return out


def small_cell(name: str, **kw) -> harness.Cell:
    """A cell at a test's size: its mix cut by `small_mix`, its warm-up
    one pass of the small pool."""
    cell = harness.load_cell(ROOT, name)
    cell.mix = small_mix(cell.mix, **kw)
    cell.settings = dict(cell.settings, warmup_evictions=cell.mix["pool"])
    return cell
