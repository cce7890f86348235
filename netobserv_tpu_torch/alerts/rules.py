"""Declarative alert rules over published query snapshots.

A copy of `netobserv_tpu/alerts/rules.py` (`SIGNAL_FIELDS`, `AlertRule`,
`signal_rule`, `cardinality_rule`, `topk_share_rule`, `flow_ascent_rule`,
`new_heavy_key_rule`, `default_rules`, `parse_rules`, `:1-295`). A rule
names a report field, a threshold, a hysteresis schedule (``raise_evals``
consecutive firing evaluations raise, ``clear_evals`` quiet closed-window
ones clear) and a severity, and reads only the host snapshot dict the
exporter publishes.

``SIGNAL_FIELDS`` is the port's one signal-name -> report-key map: the
report renderer (`exporter/report.py`), `/query/victims`
(`query/core.victims_payload`) and the default rules read it here. The
per-signal default rules carry no thresholds of their own: they fire on
the suspect lists the renderer already gated, and their victims are the
buckets' ``probable_victims``, named by `query/core.victim_bucket_names`.
"""

from __future__ import annotations

from dataclasses import dataclass

#: signal name -> rendered-report suspect-list key — the ONE map
#: (scenarios/zoo.SIGNALS and query/core.victims_payload derive from it)
SIGNAL_FIELDS = {
    "ddos": "DdosSuspectBuckets",
    "syn_flood": "SynFloodSuspectBuckets",
    "port_scan": "PortScanSuspectBuckets",
    "drop_storm": "DropAnomalyBuckets",
    "asym_conv": "AsymmetricConversationBuckets",
}

#: default severity per signal (a drop storm or flood is actionable now;
#: a scan or conversation asymmetry is investigate-next)
_SEVERITIES = {
    "ddos": "critical",
    "syn_flood": "critical",
    "drop_storm": "critical",
    "port_scan": "warning",
    "asym_conv": "warning",
}

#: per-bucket value field surfaced as the alert's ``value`` (best-effort;
#: buckets lacking the key report 0.0)
_VALUE_KEYS = {
    "ddos": "z",
    "syn_flood": "syn",
    "port_scan": "distinct_dst_port_pairs",
    "drop_storm": "z",
    "asym_conv": "bytes",
}


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule. ``kind``:

    - ``buckets`` — fire one instance per suspect bucket in
      ``report[field]`` (fingerprint = (rule, bucket id); victims ride the
      bucket's ``probable_victims``). ``threshold`` is the minimum bucket
      count for the rule to fire at all (default 1 — the render thresholds
      already gated each bucket).
    - ``scalar``  — fire one instance (fingerprint bucket None) when
      ``float(report[field]) >= threshold``.
    - ``topk_share`` — fire when the top heavy hitter's ``EstBytes`` share
      of the window's ``Bytes`` reaches ``threshold`` (a single flow
      dominating the window).
    - ``flow_keys`` — fire one instance per PER-KEY churn entry in
      ``report[field]`` (``FlowAscents`` / ``NewHeavyKeys``, rendered by
      the persistent-slot heavy-hitter plane — no host sort exists
      anywhere on this path: the slot table ships ready, the renderer
      diffs K rows). Fingerprint = (rule, the entry's ``Key`` 5-tuple
      string); victims = the flow's endpoints. For ``flow_ascent`` a
      non-zero ``threshold`` RE-FILTERS the rendered entries by their
      window-over-window ``Ratio`` (a per-rule factor on top of the
      renderer's ``SKETCH_CHURN_ASCENT`` gate — it can only tighten).
    """

    name: str
    field: str
    kind: str = "buckets"
    severity: str = "warning"
    threshold: float = 1.0
    value_key: str = ""
    raise_evals: int = 2
    clear_evals: int = 2

    def firing(self, report: dict) -> list[dict]:
        """Firing instances for this evaluation: a list of
        ``{"bucket": id-or-None, "value": float, "victims": [...]}``."""
        if self.kind == "scalar":
            value = float(report.get(self.field) or 0.0)
            if value >= self.threshold:
                return [{"bucket": None, "value": value, "victims": []}]
            return []
        if self.kind == "topk_share":
            heavy = report.get("HeavyHitters") or []
            total = float(report.get("Bytes") or 0.0)
            if not heavy or total <= 0.0:
                return []
            top = heavy[0]
            share = float(top.get("EstBytes", 0.0)) / total
            if share >= self.threshold:
                return [{"bucket": None, "value": round(share, 4),
                         "victims": [top.get("DstAddr", "")]}]
            return []
        if self.kind == "flow_keys":
            out = []
            for e in (report.get(self.field) or []):
                if self.threshold and \
                        float(e.get("Ratio", 0.0)) < self.threshold:
                    continue
                out.append({
                    "bucket": e.get("Key", ""),
                    "value": float(e.get(self.value_key, 0.0) or 0.0)
                    if self.value_key else 0.0,
                    # the flow's endpoints — rendered by report_to_json
                    # from the slot's exact key words, never re-hashed
                    "victims": [e.get("SrcAddr", ""),
                                e.get("DstAddr", "")],
                })
            return out
        buckets = report.get(self.field) or []
        if len(buckets) < self.threshold:
            return []
        return [{"bucket": int(b.get("bucket", 0)),
                 "value": float(b.get(self.value_key, 0.0) or 0.0)
                 if self.value_key else 0.0,
                 "victims": list(b.get("probable_victims", ()))}
                for b in buckets]


def signal_rule(signal: str, raise_evals: int = 2,
                clear_evals: int = 2) -> AlertRule:
    """The default rule for one anomaly signal: fire per suspect bucket of
    the rendered report list (threshold truth lives in the renderer)."""
    return AlertRule(
        name=signal, field=SIGNAL_FIELDS[signal], kind="buckets",
        severity=_SEVERITIES[signal], value_key=_VALUE_KEYS[signal],
        raise_evals=raise_evals, clear_evals=clear_evals)


def cardinality_rule(threshold: float, raise_evals: int = 2,
                     clear_evals: int = 2) -> AlertRule:
    """HLL cardinality surge: distinct-source estimate at/above
    ``threshold`` (an amplification fleet or sweep appearing)."""
    return AlertRule(
        name="cardinality_surge", field="DistinctSrcEstimate",
        kind="scalar", severity="warning", threshold=threshold,
        raise_evals=raise_evals, clear_evals=clear_evals)


def topk_share_rule(share: float, raise_evals: int = 2,
                    clear_evals: int = 2) -> AlertRule:
    """Top-K dominance: one heavy hitter carrying >= ``share`` of the
    window's bytes."""
    return AlertRule(
        name="topk_share", field="HeavyHitters", kind="topk_share",
        severity="warning", threshold=share,
        raise_evals=raise_evals, clear_evals=clear_evals)


def flow_ascent_rule(factor: float = 0.0, raise_evals: int = 1,
                     clear_evals: int = 2) -> AlertRule:
    """Per-flow ascent: a tracked key whose window count grew past the
    renderer's SKETCH_CHURN_ASCENT factor of its previous window (a mouse
    ramping into an elephant). `factor` > 0 additionally re-filters by the
    entry's rendered Ratio — a per-rule tightening knob
    (``flow_ascent:<factor>``); 0 fires on the rendered list as-is (the
    one-threshold-truth default).

    raise_evals defaults to 1, NOT the bucket rules' 2: a churn entry
    already encodes a two-window crossing (count vs the closed previous
    window), and in reset mode it exists in exactly ONE roll snapshot —
    on a roll-only deployment (SKETCH_QUERY_REFRESH unset, the default) a
    2-eval hysteresis could never accumulate two consecutive firing
    evaluations and the rule would be structurally dead."""
    return AlertRule(
        name="flow_ascent", field="FlowAscents", kind="flow_keys",
        severity="warning", threshold=factor, value_key="Ratio",
        raise_evals=raise_evals, clear_evals=clear_evals)


def new_heavy_key_rule(raise_evals: int = 1,
                       clear_evals: int = 2) -> AlertRule:
    """A key entering the heavy table for the first time this window with
    real mass (>= SKETCH_CHURN_MIN_BYTES) — a brand-new elephant.
    raise_evals defaults to 1 for the same one-roll-snapshot reason as
    `flow_ascent_rule` (first_seen matches exactly one window)."""
    return AlertRule(
        name="new_heavy_key", field="NewHeavyKeys", kind="flow_keys",
        severity="warning", value_key="EstBytes", threshold=0.0,
        raise_evals=raise_evals, clear_evals=clear_evals)


def default_rules(raise_evals: int = 2, clear_evals: int = 2) -> list:
    """One rule per anomaly signal, plus the two per-flow churn rules
    (the ALERT_RULES=default set). The churn rules are structurally quiet
    until the table has cross-window history (first window: prev_counts
    are zero and NewHeavyKeys render only for window > 0), so enabling
    them by default adds no cold-start noise."""
    # the churn rules keep their own raise_evals=1 (one-roll-snapshot
    # lifetime — see flow_ascent_rule); only the clear schedule follows
    # the global setting
    return [signal_rule(s, raise_evals, clear_evals)
            for s in SIGNAL_FIELDS] + [
        flow_ascent_rule(0.0, clear_evals=clear_evals),
        new_heavy_key_rule(clear_evals=clear_evals),
    ]


def parse_rules(spec: str, raise_evals: int = 2,
                clear_evals: int = 2) -> list:
    """Parse an ALERT_RULES spec into a rule list.

    Grammar: comma-separated tokens; ``default`` expands to the five
    signal rules plus the two per-flow churn rules; a bare signal name
    enables that one; parameterized rules spell
    ``cardinality_surge:<count>`` / ``topk_share:<fraction>`` /
    ``flow_ascent[:<factor>]``; ``new_heavy_key`` takes no parameter.
    Duplicate names keep the LAST occurrence (an override idiom)."""
    def _num(arg: str, tok: str) -> float:
        try:
            return float(arg)
        except ValueError:
            raise ValueError(
                f"ALERT_RULES: {tok!r} has a non-numeric parameter "
                f"(want e.g. cardinality_surge:50000 or topk_share:0.5)"
            ) from None

    out: dict[str, AlertRule] = {}
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        name, _, arg = tok.partition(":")
        if name == "default" or name in SIGNAL_FIELDS:
            if arg:
                # fail-fast symmetry with the parameterized rules: a
                # stray ":<arg>" here is a user expecting a per-rule
                # threshold that does not exist — silently dropping it
                # would run the stock rule against their intent
                raise ValueError(
                    f"ALERT_RULES: {name!r} takes no parameter "
                    f"(got {tok!r}; signal thresholds live in the "
                    "SKETCH_* render settings)")
            if name == "default":
                for r in default_rules(raise_evals, clear_evals):
                    out[r.name] = r
            else:
                out[name] = signal_rule(name, raise_evals, clear_evals)
        elif name == "cardinality_surge":
            if not arg:
                raise ValueError(
                    "ALERT_RULES: cardinality_surge needs a threshold "
                    "(e.g. cardinality_surge:50000)")
            out[name] = cardinality_rule(_num(arg, tok), raise_evals,
                                         clear_evals)
        elif name == "topk_share":
            if not arg:
                raise ValueError("ALERT_RULES: topk_share needs a share "
                                 "(e.g. topk_share:0.5)")
            out[name] = topk_share_rule(_num(arg, tok), raise_evals,
                                        clear_evals)
        elif name == "flow_ascent":
            # optional factor: bare = the renderer's SKETCH_CHURN_ASCENT
            # gate is the one truth; a factor only tightens on top of it
            factor = _num(arg, tok) if arg else 0.0
            if arg and factor <= 1.0:
                raise ValueError(
                    f"ALERT_RULES: {tok!r} — the flow_ascent factor is a "
                    "window-over-window growth ratio and must be > 1")
            out[name] = flow_ascent_rule(factor, clear_evals=clear_evals)
        elif name == "new_heavy_key":
            if arg:
                raise ValueError(
                    f"ALERT_RULES: new_heavy_key takes no parameter "
                    f"(got {tok!r}; the mass floor lives in "
                    "SKETCH_CHURN_MIN_BYTES)")
            out[name] = new_heavy_key_rule(clear_evals=clear_evals)
        else:
            raise ValueError(
                f"ALERT_RULES: unknown rule {name!r} (one of "
                f"{', '.join(SIGNAL_FIELDS)}, cardinality_surge:<n>, "
                f"topk_share:<f>, flow_ascent[:<factor>], new_heavy_key, "
                "default)")
    if not out:
        raise ValueError("ALERT_RULES is set but names no rules")
    return list(out.values())
