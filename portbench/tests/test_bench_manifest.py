"""BENCHMARK.json against the benchmark's contract, and every
configuration, mix, limit and metric found by name in a file of its own."""

import json
import re

import pytest

from portbench import generator, harness
from portbench.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_its_metrics_move(w):
    cell = harness.load_cell(ROOT, w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in BENCH["per_layer"]:
        if w["name"] in m.get("workloads", []):
            assert m["moves"] in e2e, (m["name"], w["name"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_by_name(w):
    here = ROOT / "portbench"
    assert (here / "traffic" / f"{w['traffic']}.json").is_file()
    assert (here / "cells" / f"{w['name']}.json").is_file()
    cell = harness.load_cell(ROOT, w["name"])
    assert set(cell.limits) == set(
        __import__("portbench.reference.judge",
                   fromlist=["NUMBERS"]).NUMBERS)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"])), m["name"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configurations_state_their_source_and_cuts(c):
    from netobserv_tpu_torch.config import load_config
    assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    assert 1 <= len(c["source"]) <= 200
    conf = harness.load_json(ROOT / c["file"])
    assert conf["source"] == c["source"]
    assert conf["reduced"] == c["reduced"]
    assert set(c["reduced"]) <= set(conf["env"])
    assert conf["assumed"]
    cfg = load_config(conf["env"])
    cfg.validate()
    assert cfg.export == "tpu-sketch"


@pytest.mark.parametrize("name", ["fullmap", "churn", "smallmap"])
def test_mixes_are_data(name):
    mix = generator.load_mix(ROOT / "portbench", name)
    assert mix["draw"] in ("zipf", "sequential")
    assert mix["flows_per_eviction"] <= mix["universe"]


def test_files_under_paths_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
