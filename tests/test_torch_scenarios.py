"""The port's scenario zoo (netobserv_tpu_torch/scenarios/zoo.py) and its
runner (scenarios/runner.py) against the JAX package's, on the CPU.

- Every scenario's pcap is byte for byte the reference zoo's and its
  ground truth equal; `SIGNALS`, `THRESHOLDS` and the runner's sketch
  geometry are the reference's.
- The port's `evaluate` gives the reference's grade, key for key, on the
  observation cases of the reference's tests/test_scenarios.py:94-264.
- One full `run_scenario("overlay_syn_scan", device="cpu")` through the
  port's agent, exporter, alert engine and metrics server, with the
  reference smoke's assertions (tests/test_scenarios.py:266-280) and no
  retrace; the other eight are `slow`, as the reference tiers them
  (tests/test_scenarios.py:283): each runs a full agent, about 4-20 s on
  the CPU. A CUDA request without CUDA raises before anything is built.
"""

from __future__ import annotations

import pytest
import torch

from netobserv_tpu.scenarios import runner as jrunner
from netobserv_tpu.scenarios import zoo as jzoo
from netobserv_tpu_torch.scenarios import runner as trunner
from netobserv_tpu_torch.scenarios import zoo as tzoo
from netobserv_tpu_torch.scenarios.zoo import SCENARIOS, SIGNALS


@pytest.mark.parametrize("name", sorted(jzoo.SCENARIOS))
def test_scenario_pcap_and_truth_are_the_references(name, tmp_path):
    truth = tzoo.SCENARIOS[name](str(tmp_path / "port.pcap"))
    want = jzoo.SCENARIOS[name](str(tmp_path / "ref.pcap"))
    assert (tmp_path / "port.pcap").read_bytes() == \
        (tmp_path / "ref.pcap").read_bytes()
    assert truth == want
    assert truth["name"] == name


def test_signals_thresholds_and_geometry_are_the_references():
    assert list(SCENARIOS) == list(jzoo.SCENARIOS)
    assert SIGNALS == jzoo.SIGNALS
    assert trunner.THRESHOLDS == jrunner.THRESHOLDS
    got, want = trunner._sketch_cfg()._asdict(), jrunner._sketch_cfg()._asdict()
    want.pop("use_pallas")
    assert got == want
    assert (got["cm_depth"], got["cm_width"], got["hll_precision"],
            got["topk"]) == (4, 16384, 12, 256)


# --- the grading logic alone: the reference tests' observation cases ----

def _obs(records=500.0, topk=(), victims=None, distinct=10.0):
    return {
        "status": {"window": 0, "seq": 1},
        "topk": {"topk": list(topk)},
        "victims": victims or {s: [] for s in SIGNALS},
        "cardinality": {"records": records, "bytes": 1.0,
                        "distinct_src_estimate": distinct},
    }


def _alert_view(active=(), recent=(), transition_seq=0):
    return {"active": list(active), "recent": list(recent),
            "transition_seq": transition_seq, "evals": 1}


def _quiet():
    return {s: [] for s in SIGNALS}


def _with(obs, **extra):
    return {**obs, **extra}


def _cases() -> dict:
    """name -> (truth, observations, freq_obs, keyword arguments)."""
    cases = {}
    cases["no_data_window"] = (
        {"name": "x", "min_records": 100}, [_obs(records=5.0)], None, {})
    # alarm directions
    truth = {"name": "x", "min_records": 1,
             "expect_alarms": ["syn_flood"], "quiet_alarms": ["port_scan"]}
    firing = dict(_quiet(), syn_flood=[{"bucket": 1,
                                        "probable_victims": []}])
    raised = {"active": [{"rule": "syn_flood", "victims": []}],
              "recent": [], "transition_seq": 1}
    cases["alarm_fires"] = (truth, [_with(_obs(victims=firing),
                                          alerts=raised)], None,
                            {"time_to_detect_s": 1.0})
    cases["no_alert_view"] = (truth, [_obs(victims=firing)], None, {})
    cases["expected_missing"] = (truth, [_obs(victims=_quiet())], None, {})
    noisy = dict(_quiet(), port_scan=[{"bucket": 2}])
    cases["quiet_fires_outside_data"] = (
        truth, [_obs(victims=firing), _obs(records=0.0, victims=noisy)],
        None, {})
    # alert directions and time to detect
    truth = {"name": "x", "min_records": 1,
             "expect_alarms": ["syn_flood"], "quiet_alarms": ["port_scan"],
             "victim": "2.2.2.2", "victim_signal": "syn_flood"}
    firing_v = dict(_quiet(), syn_flood=[{"bucket": 1,
                                          "probable_victims": ["2.2.2.2"]}])
    raised = _alert_view(active=[{"rule": "syn_flood",
                                  "victims": ["2.2.2.2"], "bucket": 1}],
                         transition_seq=1)
    obs = _with(_obs(victims=firing_v), alerts=raised)
    cases["alert_raised_sub_window"] = (
        truth, [obs], None, {"time_to_detect_s": 1.2, "window_s": 600.0})
    cases["alert_never_raised"] = (
        truth, [_with(_obs(victims=firing_v), alerts=_alert_view())], None,
        {"time_to_detect_s": None, "window_s": 600.0})
    noisy_view = _alert_view(
        active=[{"rule": "syn_flood", "victims": ["2.2.2.2"], "bucket": 1}],
        recent=[{"rule": "port_scan", "action": "raise"}], transition_seq=2)
    cases["quiet_alert_raised_in_ring"] = (
        truth, [_with(_obs(victims=firing_v), alerts=noisy_view)], None,
        {"time_to_detect_s": 0.5, "window_s": 600.0})
    cases["detection_past_the_window"] = (
        truth, [obs], None, {"time_to_detect_s": 700.0, "window_s": 600.0})
    # flow_ascent key and budget
    key = {"SrcAddr": "10.0.5.50", "DstAddr": "10.0.6.1",
           "SrcPort": 51000, "DstPort": 443, "Proto": 6}
    key_str = "10.0.5.50:51000->10.0.6.1:443/6"
    truth = {"name": "fa", "min_records": 1,
             "expect_alarms": ["flow_ascent"],
             "quiet_alarms": ["new_heavy_key"],
             "ascent_key": key, "ttd_budget_s": 20.0}
    ascent = _with(_obs(victims=_quiet()), alerts=_alert_view(
        active=[{"rule": "flow_ascent", "bucket": key_str,
                 "victims": ["10.0.5.50", "10.0.6.1"]}], transition_seq=1))
    kw = {"time_to_detect_s": 14.0, "window_s": 10.0}
    cases["ascent_named"] = (truth, [ascent], None, kw)
    cases["ascent_wrong_key"] = (truth, [_with(
        _obs(victims=_quiet()), alerts=_alert_view(
            active=[{"rule": "flow_ascent",
                     "bucket": "1.1.1.1:1->2.2.2.2:2/6", "victims": []}],
            transition_seq=1))], None, kw)
    cases["ascent_past_budget"] = (truth, [ascent], None,
                                   {"time_to_detect_s": 21.0,
                                    "window_s": 10.0})
    cases["new_heavy_key_raised"] = (truth, [_with(
        _obs(victims=_quiet()), alerts=_alert_view(
            active=[{"rule": "flow_ascent", "bucket": key_str,
                     "victims": []},
                    {"rule": "new_heavy_key", "bucket": key_str,
                     "victims": []}], transition_seq=2))], None, kw)
    # top-K recall and victim naming
    heavy = [{"SrcAddr": "1.1.1.1", "DstAddr": "2.2.2.2", "SrcPort": 1,
              "DstPort": 443, "Proto": 6}]
    truth = {"name": "x", "min_records": 1, "heavy": heavy, "topk_n": 4,
             "min_recall": 0.9, "victim": "2.2.2.2",
             "victim_signal": "syn_flood"}
    victims = dict(_quiet(), syn_flood=[{"bucket": 7,
                                         "probable_victims": ["2.2.2.2"]}])
    cases["topk_hit"] = (truth, [_obs(topk=[dict(heavy[0], EstBytes=9.0)],
                                      victims=victims)], None, {})
    cases["topk_miss"] = (truth, [_obs(topk=[], victims=victims)], None, {})
    # cardinality and frequency bounds
    truth = {"name": "x", "min_records": 1, "distinct_src": 100,
             "distinct_tol": 0.1,
             "frequency_probe": {"SrcAddr": "1.1.1.1", "DstAddr": "2.2.2.2",
                                 "SrcPort": 1, "DstPort": 2, "Proto": 6,
                                 "true_bytes": 1000}}
    good = {"est_bytes": 1001.0, "overestimate_bound_bytes": 50.0}
    cases["cardinality_and_frequency_ok"] = (
        truth, [_obs(distinct=95.0)], [good], {})
    cases["cardinality_out_of_tolerance"] = (
        truth, [_obs(distinct=150.0)], [good], {})
    cases["frequency_underestimates"] = (
        truth, [_obs(distinct=100.0)],
        [{"est_bytes": 900.0, "overestimate_bound_bytes": 50.0}], {})
    cases["frequency_past_its_bound"] = (
        truth, [_obs(distinct=100.0)],
        [{"est_bytes": 1100.0, "overestimate_bound_bytes": 50.0}], {})
    cases["frequency_never_answered"] = (truth, [_obs(distinct=100.0)], [],
                                         {})
    # retraces, plumbing, DNS latency and QUIC records
    cases["retraces"] = ({"name": "x", "min_records": 1}, [_obs()], None,
                         {"retraces": 2})
    plumb = {"resident_spill_rows": 3, "dense_fallbacks": 1,
             "direct_fold_rows": 0}
    cases["dense_fallbacks_pinned"] = (
        {"name": "v6", "min_records": 1, "max_dense_fallbacks": 0,
         "min_resident_spill_rows": 5}, [_obs()], None,
        {"plumbing": plumb})
    dns_status = {"window": 0, "seq": 1, "quic_records": 3.0,
                  "dns_latency_quantiles_us": {"0.5": "40000.0"}}
    cases["dns_and_quic_short"] = (
        {"name": "d", "min_records": 1, "dns_p50_min_us": 50_000,
         "quic_min_records": 12}, [_with(_obs(), status=dns_status)], None,
        {})
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_grades_as_the_reference(case):
    truth, observations, freq, kw = CASES[case]
    got = trunner.evaluate(truth, observations, freq, **kw)
    want = jrunner.evaluate(truth, observations, freq, **kw)
    assert got == want
    assert got["passed"] == (case in ("alarm_fires",
                                      "alert_raised_sub_window",
                                      "ascent_named", "topk_hit",
                                      "cardinality_and_frequency_ok"))


# --- end to end through the port's agent and /query/* ------------------

def _run(name, tmp_path):
    result = trunner.run_scenario(name, str(tmp_path), device="cpu")
    assert result["passed"], result["failures"]
    assert result["retraces"] == 0
    assert result["folds"] >= 1 and result["records"] >= 1
    return result


def test_scenario_smoke_overlay_syn_scan(tmp_path):
    """The reference's tier-1 smoke on the port: the flood AND the scan
    raise live through /query/alerts with the victim named, no cross-talk
    alarm fires, and detection lands within the window."""
    result = _run("overlay_syn_scan", tmp_path)
    assert sorted(result["alarms_fired"]) == ["port_scan", "syn_flood"]
    assert sorted(result["alerts_raised"]) == ["port_scan", "syn_flood"]
    assert result["victim_named"] and result["alert_victim_named"]
    assert result["time_to_detect_s"] is not None
    assert result["alert_transitions"] >= 2


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(n for n in SCENARIOS
                                        if n != "overlay_syn_scan"))
def test_scenario_zoo_slow(name, tmp_path):
    _run(name, tmp_path)


def test_a_cuda_request_without_cuda_raises(tmp_path, monkeypatch):
    """No fallback: `run_scenario` on CUDA where torch sees no card raises
    before it writes the pcap or builds an agent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            trunner.run_scenario("syn_flood", str(tmp_path), device=device)
    assert not list(tmp_path.iterdir())
