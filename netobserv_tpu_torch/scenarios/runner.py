"""Scenario runner: replay one zoo pcap through a full in-process agent of
the port and grade detection quality through the live `/query/*` HTTP
routes.

A copy of `netobserv_tpu/scenarios/runner.py` (lines 1-436). The pipeline
under test is the port's own: PcapReplayFetcher -> MapTracer ->
CapacityLimiter -> QueueExporter -> TorchSketchExporter (the resident
feed, one lane, batch 512) -> window roll -> query snapshot ->
metrics-server HTTP, with the supervisor running, the mid-window refresh
on and the default alert rules mounted over the same snapshots, so every
scenario also shows that the query plane answers during sustained ingest
and that the agent raises its own alarms without being polled for them.
The runner records a per-scenario time to detect (replay start -> first
RAISE seen through `/query/alerts`); with the refresh on, attack
scenarios must detect within one window period.

`run_scenario` runs the sketch plane on `device`: CUDA unless the caller
passes `device="cpu"`, and a CUDA request on a box without CUDA raises
(`utils/platform.pick_device`). It builds the exporter as the reference
builds its `TpuSketchExporter` directly (one pack thread, no superbatch
ladder, no closed-window history). `THRESHOLDS`, `_sketch_cfg` and
`evaluate` are the reference's. Used by `tests/test_torch_scenarios.py`
(one scenario on the CPU in tier 1, the others in the slow tier) and by
`chip_smoke.py` (all nine on the card).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request

from netobserv_tpu_torch.scenarios.zoo import SCENARIOS, SIGNALS

log = logging.getLogger("netobserv_tpu_torch.scenarios")

#: one shared detection config for the WHOLE zoo — floods must fire and
#: benign mixes stay quiet under the SAME thresholds, or the assertions
#: prove nothing
THRESHOLDS = dict(
    synflood_min=64,
    synflood_ratio=8.0,
    scan_fanout_threshold=256,
    asym_min_bytes=2048,
    asym_ratio=0.95,
    # heavy-hitter churn gates (persistent-slot plane): the flow_ascent /
    # new_heavy_key alert rules fire on lists rendered under exactly these
    churn_ascent=8.0,
    churn_min_bytes=256 * 1024,
)


def _sketch_cfg():
    from netobserv_tpu_torch.sketch.state import SketchConfig
    # compile-friendly but honest geometry (width >= 16*topk, the
    # documented precision floor)
    return SketchConfig(cm_depth=4, cm_width=16384, hll_precision=12,
                        topk=256)


def run_scenario(name: str, workdir: str, window_s: float = 600.0,
                 evict_s: float = 0.25, query_refresh_s: float = 0.5,
                 deadline_s: float = 240.0, device=None) -> dict:
    """Build the scenario pcap, run the agent over it, poll /query/* while
    the window is LIVE, and return the graded quality dict.

    The window deliberately outlives the replay (a one-shot pcap's data
    window would otherwise be queryable only until the next roll swapped in
    an empty one): the mid-window refresh serves the ACCUMULATING live
    window — the "query plane answers during sustained ingest" claim — and
    the agent's shutdown flush closes the window, publishing the final
    ROLL snapshot, which is graded too. Besides `evaluate`'s keys the dict
    carries the exporter's `folds` and `records` (the folds that ran and
    the records they took) and the `captures` of its CUDA graphs (none on
    the CPU; each capture's warm-up runs the fold's kernels once)."""
    from netobserv_tpu_torch.agent.agent import FlowsAgent
    from netobserv_tpu_torch.alerts.engine import AlertEngine
    from netobserv_tpu_torch.alerts.rules import default_rules
    from netobserv_tpu_torch.alerts.sinks import LogSink, MetricsSink
    from netobserv_tpu_torch.config import AgentConfig
    from netobserv_tpu_torch.datapath.replay import PcapReplayFetcher
    from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
    from netobserv_tpu_torch.metrics.registry import Metrics
    from netobserv_tpu_torch.metrics.server import start_metrics_server
    from netobserv_tpu_torch.utils import retrace
    from netobserv_tpu_torch.utils.platform import pick_device

    device = pick_device(device)
    build = SCENARIOS[name]
    pcap = os.path.join(workdir, f"{name}.pcap")
    truth = build(pcap)
    # multi-window scenarios (flow_ascent: the churn diff needs a ROLL
    # between its phases) override the runner shape through their truth —
    # thresholds stay the ONE shared set above
    overrides = truth.get("runner") or {}
    window_s = overrides.get("window_s", window_s)
    deadline_s = overrides.get("deadline_s", deadline_s)

    cfg = AgentConfig(export="tpu-sketch", cache_active_timeout=evict_s)
    metrics = Metrics()
    # one replay window: every scenario keeps its packets inside the
    # virtual 5s span, so the whole pcap lands in ONE eviction and
    # therefore ONE sketch window — deterministic per-window assertions
    fetcher = PcapReplayFetcher(pcap, window_s=5.0)
    if not query_refresh_s:
        raise ValueError("the scenario runner grades the LIVE window "
                         "through mid-window refreshes; query_refresh_s "
                         "must be > 0")
    # the alerting plane runs with its DEFAULT rules: they fire on the
    # report's suspect lists, which the exporter renders under the zoo's
    # ONE shared threshold set below — grading and alerting read the same
    # truth by construction (alerts/rules.py one-truth note)
    engine = AlertEngine(default_rules(), metrics=metrics,
                         sinks=[LogSink(), MetricsSink(metrics)])
    exporter = TorchSketchExporter(
        _sketch_cfg(), batch_size=512, device=device, window_s=window_s,
        metrics=metrics, sink=lambda obj: None, pack_threads=1,
        superbatch=(1,), query_refresh_s=query_refresh_s, query_history=0,
        alerts=engine, ddos_z_threshold=6.0, drop_z_threshold=6.0,
        **THRESHOLDS)
    agent = FlowsAgent(cfg, fetcher, exporter, metrics=metrics)
    srv = start_metrics_server(metrics.registry, port=0,
                               health_source=agent.health_snapshot,
                               query_routes=agent.query_routes)
    port = srv.server_address[1]
    retraces_before = retrace.total_retraces()

    def get(path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    stop = threading.Event()
    t = threading.Thread(target=agent.run, args=(stop,), daemon=True)
    t.start()

    observations: list[dict] = []
    freq_obs: list[dict] = []
    min_records = truth.get("min_records", 1)
    probe = truth.get("frequency_probe")

    def observe() -> dict:
        """One full /query/* round against the current snapshot; probes
        frequency once the data window surfaced."""
        obs: dict = {}
        code, status = get("/query/status")
        if code == 200:
            obs["status"] = status
        for route in ("topk?n=64", "victims", "cardinality", "alerts",
                      "churn"):
            c, body = get(f"/query/{route}")
            if c == 200:
                obs[route.split("?")[0]] = body
        records = obs.get("cardinality", {}).get("records", 0)
        if probe is not None and records >= min_records:
            c, f = get("/query/frequency?src={SrcAddr}&dst={DstAddr}"
                       "&src_port={SrcPort}&dst_port={DstPort}"
                       "&proto={Proto}".format(**probe))
            if c == 200:
                freq_obs.append(f)
        observations.append(obs)
        return obs

    seen_seq, live_data_obs = 0, 0
    expect = set(truth.get("expect_alarms", ()))
    t_run0 = time.monotonic()  # replay start: time-to-detect is measured
    #                            from here to the first observed RAISE
    time_to_detect: float | None = None
    deadline = time.monotonic() + deadline_s
    try:
        # phase 1: poll the LIVE window through the mid-window refreshes
        # until the whole pcap is folded AND a couple more refresh
        # snapshots answered over it (sustained-ingest answering)
        while time.monotonic() < deadline and live_data_obs < 3:
            code, status = get("/query/status")
            if code == 200 and status.get("seq", 0) > seen_seq:
                seen_seq = status["seq"]
                obs = observe()
                if time_to_detect is None:
                    view = obs.get("alerts", {})
                    # an expected rule counts as detected whether it is
                    # still ACTIVE or already visible as a raise in the
                    # transitions ring (a raise that cleared between two
                    # polls must not read as "never detected")
                    if any(a.get("rule") in expect
                           for a in view.get("active", ())) or any(
                            t.get("rule") in expect
                            and t.get("action") == "raise"
                            for t in view.get("recent", ())):
                        time_to_detect = time.monotonic() - t_run0
                if (obs.get("cardinality", {}).get("records", 0)
                        >= min_records and fetcher.exhausted()):
                    live_data_obs += 1
            time.sleep(0.1)
    finally:
        # close() drops the pending buffer and the graphs; read them here
        pending = exporter.pending
        captures = sum(c.captures for c in exporter.captures)
        stop.set()
        t.join(timeout=60)
    # phase 2: the agent's shutdown flush closed the window and published
    # the final ROLL snapshot (mid_window=False) — grade that one too
    try:
        if t.is_alive():
            log.error("agent did not stop within 60s")
        else:
            final = observe()
            if final.get("status", {}).get("mid_window", True):
                log.warning("final snapshot is still a mid-window refresh "
                            "(shutdown flush did not publish a roll?)")
    finally:
        srv.shutdown()
    retraces = retrace.total_retraces() - retraces_before
    # feed-plumbing evidence for scenarios that pin it (ipv6_heavy: the
    # resident feed must never dense-fallback on v6; spill volume is
    # reported for the artifact but not pinned — cold-start geometry)
    ring = exporter.ring
    plumbing = {
        "resident_spill_rows": int(getattr(ring, "spill_rows", 0)),
        # read the REGISTRY counter, not a ring attribute: the resident
        # ring has no dense-fallback path at all (getattr would grade a
        # vacuous 0), while the metric covers whichever feed is wired
        "dense_fallbacks": int(
            metrics.sketch_dense_fallback_total._value.get()),
        "direct_fold_rows": int(getattr(pending, "direct_rows", 0)),
    }
    out = evaluate(truth, observations, freq_obs, retraces=retraces,
                   plumbing=plumbing, time_to_detect_s=time_to_detect,
                   window_s=window_s)
    out.update(folds=exporter.folds, records=exporter.records,
               captures=captures)
    return out


def evaluate(truth: dict, observations: list[dict],
             freq_obs: list[dict] | None = None,
             retraces: int = 0, plumbing: dict | None = None,
             time_to_detect_s: float | None = None,
             window_s: float | None = None) -> dict:
    """Grade collected /query/* observations against the ground truth.
    Returns {"name", "passed", "failures": [...], ...quality metrics}.
    `plumbing` carries feed-path counters (spill rows, dense fallbacks)
    for scenarios whose truth pins them; `time_to_detect_s` the replay-
    start -> first-observed-RAISE latency (None = no raise observed), and
    `window_s` the window period the sub-window detection bar grades
    against."""
    failures: list[str] = []
    out: dict = {"name": truth.get("name", "?"), "retraces": retraces,
                 "windows_observed": len(
                     {o["status"].get("window") for o in observations
                      if "status" in o})}
    if plumbing:
        out.update(plumbing)
        want_spill = truth.get("min_resident_spill_rows")
        if want_spill is not None and \
                plumbing["resident_spill_rows"] < want_spill:
            failures.append(
                f"resident spill rows {plumbing['resident_spill_rows']} < "
                f"{want_spill} (v6 rows did not ride the spill lane?)")
        max_fb = truth.get("max_dense_fallbacks")
        if max_fb is not None and plumbing["dense_fallbacks"] > max_fb:
            failures.append(
                f"{plumbing['dense_fallbacks']} dense fallbacks > "
                f"{max_fb} (the resident feed degraded wholesale)")
    data = [o for o in observations
            if o.get("cardinality", {}).get("records", 0)
            >= truth.get("min_records", 1)]
    if not data:
        failures.append("the data window never surfaced through /query/*")
        out.update(passed=False, failures=failures)
        return out

    # --- heavy-hitter recall (through /query/topk) ---
    if truth.get("heavy"):
        want = {(h["SrcAddr"], h["DstAddr"], h["SrcPort"], h["DstPort"],
                 h["Proto"]) for h in truth["heavy"]}
        best = 0.0
        for o in data:
            top = o.get("topk", {}).get("topk", [])[:truth["topk_n"]]
            got = {(e["SrcAddr"], e["DstAddr"], e["SrcPort"], e["DstPort"],
                    e["Proto"]) for e in top}
            best = max(best, len(want & got) / len(want))
        out["topk_recall"] = best
        if best < truth.get("min_recall", 0.9):
            failures.append(
                f"top-{truth['topk_n']} recall {best:.2f} < "
                f"{truth.get('min_recall', 0.9)}")

    # --- alarms: expected must fire in a data window, quiet must stay
    # silent in EVERY observed window (including mid-window refreshes) ---
    fired = {sig: any(o.get("victims", {}).get(sig) for o in data)
             for sig in SIGNALS}
    out["alarms_fired"] = sorted(s for s, f in fired.items() if f)
    for sig in truth.get("expect_alarms", ()):
        # per-flow churn rules (flow_ascent/new_heavy_key) have no
        # /query/victims bucket list — their only surface is the alert
        # plane, graded below
        if sig in SIGNALS and not fired[sig]:
            failures.append(f"expected {sig} alarm never fired")
    for sig in truth.get("quiet_alarms", ()):
        if any(o.get("victims", {}).get(sig) for o in observations):
            failures.append(f"{sig} alarm fired on a benign signal")

    # --- continuous detection plane (through /query/alerts): expected
    # alarms must RAISE live (not just sit in suspect lists a poller
    # would have to read), quiet ones must never raise in ANY observed
    # view, and with the refresh enabled detection must land inside one
    # window period (sub-window detection is the plane's point) ---
    alert_views = [o["alerts"] for o in observations if "alerts" in o]
    if not alert_views and (truth.get("expect_alarms")
                            or truth.get("quiet_alarms")):
        # a dead /query/alerts surface must FAIL the scenario, not
        # silently skip every alert assertion — for attack scenarios AND
        # benign ones (whose whole point is proving nothing raises)
        failures.append("no /query/alerts view ever observed")
    if alert_views:
        raised = {a["rule"] for v in alert_views for a in v.get("active", ())}
        raised |= {t["rule"] for v in alert_views
                   for t in v.get("recent", ()) if t["action"] == "raise"}
        out["alerts_raised"] = sorted(raised)
        out["alert_transitions"] = max(
            v.get("transition_seq", 0) for v in alert_views)
        for sig in truth.get("expect_alarms", ()):
            if sig not in raised:
                failures.append(
                    f"expected {sig} alert never RAISED on /query/alerts")
        for sig in truth.get("quiet_alarms", ()):
            if sig in raised:
                failures.append(
                    f"{sig} alert raised on a benign signal")
        want_key = truth.get("ascent_key")
        if want_key:
            # the acceptance bar "detects with the RIGHT KEY named": a
            # raised flow_ascent whose fingerprint bucket is exactly the
            # ramping flow's 5-tuple Key string
            key = (f"{want_key['SrcAddr']}:{want_key['SrcPort']}->"
                   f"{want_key['DstAddr']}:{want_key['DstPort']}/"
                   f"{want_key['Proto']}")
            named = any(
                a.get("bucket") == key
                for v in alert_views for a in v.get("active", ())
                if a["rule"] == "flow_ascent") or any(
                t.get("bucket") == key
                for v in alert_views for t in v.get("recent", ())
                if t["rule"] == "flow_ascent" and t["action"] == "raise")
            out["ascent_key_named"] = named
            if not named:
                failures.append(
                    f"flow_ascent never raised with key {key}")
        if truth.get("victim") and truth.get("victim_signal"):
            sig = truth["victim_signal"]
            # same active-OR-ring rule as detection: a raise that cleared
            # between two polls still carries its victims in the ring
            named = any(
                truth["victim"] in a.get("victims", ())
                for v in alert_views for a in v.get("active", ())
                if a["rule"] == sig) or any(
                truth["victim"] in t.get("victims", ())
                for v in alert_views for t in v.get("recent", ())
                if t["rule"] == sig and t["action"] == "raise")
            out["alert_victim_named"] = named
            if not named:
                failures.append(
                    f"victim {truth['victim']} not named by the "
                    f"{sig} alert")
        out["time_to_detect_s"] = (
            None if time_to_detect_s is None
            else round(time_to_detect_s, 3))
        if truth.get("expect_alarms"):
            # multi-window scenarios whose attack STARTS after a roll
            # (flow_ascent) budget detection relative to the attack
            # window: truth's ttd_budget_s, else one window period
            budget = truth.get("ttd_budget_s", window_s)
            if time_to_detect_s is None:
                failures.append(
                    "no live RAISE observed during the replay "
                    "(time-to-detect unmeasurable)")
            elif budget is not None and time_to_detect_s >= budget:
                failures.append(
                    f"time-to-detect {time_to_detect_s:.1f}s is not "
                    f"sub-window (budget {budget:.0f}s)")

    # --- victim naming ---
    if truth.get("victim"):
        sig = truth["victim_signal"]
        named = any(
            truth["victim"] in b.get("probable_victims", ())
            for o in data for b in o.get("victims", {}).get(sig, ()))
        out["victim_named"] = named
        if not named:
            failures.append(
                f"victim {truth['victim']} not named in {sig} buckets")

    # --- cardinality within HLL bounds ---
    if truth.get("distinct_src"):
        est = max(o["cardinality"]["distinct_src_estimate"] for o in data)
        rel = abs(est - truth["distinct_src"]) / truth["distinct_src"]
        out["distinct_src_est"] = est
        out["distinct_src_err"] = round(rel, 4)
        if rel > truth.get("distinct_tol", 0.2):
            failures.append(
                f"distinct-src estimate {est:.0f} off ground truth "
                f"{truth['distinct_src']} by {rel:.1%}")

    # --- DNS latency spike (through /query/status quantiles) ---
    if truth.get("dns_p50_min_us"):
        p50 = max(float(o["status"]["dns_latency_quantiles_us"]["0.5"])
                  for o in data if "dns_latency_quantiles_us" in o["status"])
        out["dns_p50_us"] = p50
        if p50 < truth["dns_p50_min_us"]:
            failures.append(
                f"dns latency p50 {p50:.0f}us below the injected spike "
                f"({truth['dns_p50_min_us']}us)")

    # --- QUIC marker plumbing ---
    if truth.get("quic_min_records"):
        quic = max(float(o["status"].get("quic_records", 0)) for o in data)
        out["quic_records"] = quic
        if quic < truth["quic_min_records"]:
            failures.append(
                f"QuicRecords {quic:.0f} < {truth['quic_min_records']}")

    # --- CM frequency error-bar contract (through /query/frequency) ---
    if truth.get("frequency_probe") is not None:
        if not freq_obs:
            failures.append("frequency probe never answered on the "
                            "data window")
        else:
            true_b = truth["frequency_probe"]["true_bytes"]
            best = min(freq_obs, key=lambda f: f["est_bytes"])
            out["frequency_est_bytes"] = best["est_bytes"]
            out["frequency_true_bytes"] = true_b
            # CM never underestimates; the overestimate stays within the
            # advertised (e/w)*N bound (float32 rounding slack)
            if best["est_bytes"] < true_b * 0.999:
                failures.append(
                    f"CM estimate {best['est_bytes']:.0f} underestimates "
                    f"true {true_b}")
            bound = best["overestimate_bound_bytes"]
            if best["est_bytes"] > true_b + bound + true_b * 0.001:
                failures.append(
                    f"CM estimate {best['est_bytes']:.0f} exceeds true "
                    f"{true_b} + stated bound {bound:.0f}")

    if retraces:
        failures.append(f"{retraces} post-warmup retraces during the run")
    out.update(passed=not failures, failures=failures)
    return out
