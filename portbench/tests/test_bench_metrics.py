"""The metric arithmetic: a tail over every eviction, the per-16,384
normalisations, the byte counts behind `kernel_roofline`, and a profiled
slice's busy time and gaps."""

import types

import numpy as np
import pytest
import torch

from portbench import harness, profile, roofline
from portbench.reference import sketch
from portbench.tests.helpers import ROOT


def _run(**kw):
    cell = harness.load_cell(ROOT, "resident.fullmap")
    run = harness.Run(cell, torch.device("cpu"), 8192)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_the_tail_is_over_every_eviction():
    lat = [0.001] * 94 + [0.050] * 6  # the six slowest calls close windows
    got = harness.reader("evict_p95_ms")(_run(latencies=lat))
    assert got == pytest.approx(np.percentile(np.array(lat), 95) * 1e3)
    assert got > 1.0  # a median of chunks would have read 1 ms


def test_rates_and_normalisations():
    tally = ({}, {("sketch_slot_wait_seconds",): 0.5})
    run = _run(records=16384 * 100, seconds=2.0, cpu_s=1.6384,
               before={"pack_seconds": 1.0, "dict_resets": 0,
                       "superbatch_folds": {1: 5},
                       "tally": ({}, {})},
               after={"pack_seconds": 1.2, "dict_resets": 3,
                      "superbatch_folds": {1: 6, 4: 3},
                      "tally": tally})
    assert harness.reader("records_per_s")(run) == 16384 * 50
    assert harness.reader("cpu_us_per_record")(run) == pytest.approx(1.0)
    assert harness.reader("pack_ms_per_16k")(run) == pytest.approx(2.0)
    assert harness.reader("slot_wait_ms_per_16k")(run) == pytest.approx(5.0)
    assert harness.reader("superbatch_k_mean")(run) == pytest.approx(13 / 4)
    assert harness.reader("dict_resets_per_mrec")(run) == pytest.approx(
        3 / 1.6384)


def test_a_cells_twin_reads_with_its_base_readers_file():
    run = _run(records=16384 * 100, seconds=2.0, latencies=[0.002] * 20)
    for name in ("records_per_s", "evict_p95_ms"):
        assert harness.reader(name + ".resident")(run) == \
            harness.reader(name)(run)


def test_roll_ms_is_the_mean_of_the_window_rolls():
    tally = ({("observe_stage", "roll_dispatch"): 4},
             {("observe_stage", "roll_dispatch"): 0.02,
              ("observe_stage", "roll_drain"): 0.02})
    run = _run(before={"tally": ({}, {})}, after={"tally": tally})
    assert harness.reader("roll_ms")(run) == pytest.approx(10.0)


def test_readers_find_nothing_without_their_source():
    run = _run(before={"tally": ({}, {})}, after={"tally": ({}, {})})
    for name in ("kernel_roofline", "device_ms_per_16k", "launches_per_16k",
                 "torch_ops_ms_per_16k", "roll_ms", "records_per_s",
                 "device_mib"):
        assert harness.reader(name)(run) is None, name


def test_sector_bytes_count_distinct_sectors_read_and_written():
    # int32 elements 0..7 share a sector; 8 starts the next
    assert roofline.sector_bytes(torch.tensor([0, 1, 7])) == 64
    assert roofline.sector_bytes(torch.tensor([0, 8, 8, 16])) == 192
    assert roofline.sector_bytes(torch.tensor([0, 31]), 1) == 64


def test_fold_bounds_count_the_inputs_and_the_sectors():
    geo = sketch.Geometry.from_dict(harness.load_json(
        ROOT / "portbench/configs/node-dense.json")["geometry"])
    n = 64
    g = torch.Generator().manual_seed(5)
    cols = {"words": torch.randint(0, 2**32, (n, 10), generator=g),
            "bytes": torch.full((n,), 100.0, dtype=torch.float64),
            "packets": torch.ones(n, dtype=torch.float64),
            "tcp_flags": torch.zeros(n, dtype=torch.int64),
            "dscp": torch.zeros(n, dtype=torch.int64),
            "drop_bytes": torch.zeros(n, dtype=torch.float64),
            "drop_packets": torch.zeros(n, dtype=torch.float64),
            "drop_cause": torch.zeros(n, dtype=torch.int64)}
    peak = {"hbm_bytes_per_s": 1.0, "f32_ops_per_s": 1e30}
    b = roofline.fold_bounds(cols, geo, 1024, peak)
    # the slot table's reduction: three lanes a row and three K-long
    # outputs, twice
    assert b["topk_reduce_kernel"] == 2 * (n * 20 + 3 * 1024 * 4)
    # Count-Min: four lanes a row, and each plane's distinct sectors
    from portbench.reference import hashing
    h = hashing.multi_hashes(cols["words"])
    cells = hashing.cm_cells(h["h1"], h["h2"], 4, 65536).reshape(-1)
    sectors = len(torch.unique(cells // 8))
    assert b["cm_fold2_kernel"] == n * 24 + 2 * (2 * 32 * sectors)


def test_a_slice_reads_busy_time_and_names_its_gaps():
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.generator",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation",
         "name": "portbench.export_evicted", "ts": 10, "dur": 75, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 40, "dur": 20, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "a_kernel", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "b_kernel", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "a_kernel", "ts": 80, "dur": 10},
    ]
    sl = profile.parse(events, 100 / us)
    assert sl.busy_s == pytest.approx(60 / us)
    assert len(sl.kernels) == 3 and len(sl.device) == 4
    assert sl.device_ops[0] == ["a_kernel", pytest.approx(40 / us)]
    assert sl.idle_gaps[0] == ["export_evicted",
                               pytest.approx(20 / us)]
    assert sl.idle_gaps[1] == ["export_evicted/cudaStreamSynchronize",
                               pytest.approx(10 / us)]
    run = _run(slice=sl, slice_rows=16384)
    assert harness.reader("device_ms_per_16k")(run) == pytest.approx(
        60 / us * 1e3)
    assert harness.reader("launches_per_16k")(run) == 3


def test_csrc_kernel_names_from_a_trace():
    assert roofline.csrc_kernel(
        "cm_fold2_kernel(float*, float*, long const*)") == "cm_fold2_kernel"
    assert roofline.csrc_kernel(
        "void signal_fold_kernel<8>(SignalTables)") == "signal_fold_kernel"
    assert roofline.csrc_kernel(
        "void at::native::elementwise_kernel<128, 2>(int)") is None
