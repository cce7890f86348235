"""Report thresholds and feed settings of the sketch plane.

Counterpart of the `DEFAULT_*` thresholds in `netobserv_tpu/config.py`,
kept as a copy: the window report renderer (`exporter/report.py`) reads
them as its defaults. `resolved_pack_threads` and `parse_superbatch_ladder`
are copies of `AgentConfig.resolved_pack_threads` and
`parsed_superbatch_ladder` (`:592-620`) as functions of their setting.
`QuerySettings` holds the query and alerting planes' settings of
`AgentConfig` (`:443-451`, `:495-518`) with their defaults and checks
(`:693-733`): the port has no `AgentConfig`, and `alerts/engine.maybe_engine`
takes these.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

#: port-scan fan-out: distinct (dst addr, dst port) pairs per source bucket
DEFAULT_SCAN_FANOUT = 512
#: DDoS z-score threshold
DEFAULT_DDOS_Z = 6.0
#: SYN flood: minimum half-open attempts per victim bucket per window, and
#: the offered:accepted (SYN : SYN-ACK) ratio both required to report
DEFAULT_SYNFLOOD_MIN = 128
DEFAULT_SYNFLOOD_RATIO = 8.0
#: drop-anomaly z-score threshold
DEFAULT_DROP_Z = 6.0
#: conversation asymmetry: minimum window bytes of a pair bucket and the
#: one-way share at which it is reported
DEFAULT_ASYM_MIN_BYTES = 1 << 20
DEFAULT_ASYM_RATIO = 0.95
#: heavy-hitter churn: ascent factor and minimum current mass
DEFAULT_CHURN_ASCENT = 8.0
DEFAULT_CHURN_MIN_BYTES = 1 << 20


def resolved_pack_threads(pack_threads: int) -> int:
    """SKETCH_PACK_THREADS with 0 = auto (the CPU count, at most 8)."""
    if pack_threads > 0:
        return pack_threads
    return min(os.cpu_count() or 1, 8)


def parse_superbatch_ladder(spec) -> tuple[int, ...]:
    """A superbatch ladder ("1,2,4" as SKETCH_SUPERBATCH gives it, or an
    iterable of ints) as a sorted tuple without repeats. It must include 1,
    be positive and stay at most 64 (each entry costs k-batch buffers and
    key-table rows, so a larger one is taken for a typo)."""
    try:
        toks = spec.split(",") if isinstance(spec, str) else list(spec)
        ladder = tuple(sorted({int(tok) for tok in toks if tok != ""}))
    except (TypeError, ValueError) as exc:
        raise ValueError(f"superbatch ladder {spec!r}: want comma-separated "
                         "ints, e.g. 1,2,4") from exc
    if not ladder or ladder[0] != 1 or any(k < 1 for k in ladder):
        raise ValueError(f"superbatch ladder {spec!r}: the ladder must "
                         "include 1 and be positive")
    if ladder[-1] > 64:
        raise ValueError(f"superbatch ladder {spec!r}: entries above 64 are "
                         "almost certainly a typo (each costs k*batch-sized "
                         "buffers and key-table rows)")
    return ladder


@dataclass
class QuerySettings:
    """The query plane's and the alerting plane's settings, under the
    reference's names: `sketch_query_refresh` (SKETCH_QUERY_REFRESH, the
    mid-window refresh period in seconds, 0 = off), `sketch_query_history`
    (SKETCH_QUERY_HISTORY, the closed-window snapshots kept for
    ``?window=``), `alert_rules` (ALERT_RULES, "" = no engine),
    `alert_raise_evals`, `alert_clear_evals`, `alert_sinks`,
    `alert_webhook_url`, `alert_webhook_interval` (seconds) and
    `alert_ring`. A value the reference refuses raises here."""

    sketch_query_refresh: float = 0.0
    sketch_query_history: int = 8
    alert_rules: str = ""
    alert_raise_evals: int = 2
    alert_clear_evals: int = 2
    alert_sinks: str = "log,metrics"
    alert_webhook_url: str = ""
    alert_webhook_interval: float = 1.0
    alert_ring: int = 256

    def __post_init__(self):
        if self.sketch_query_refresh < 0:
            raise ValueError(
                "SKETCH_QUERY_REFRESH must be >= 0 (0 disables the "
                "mid-window refresh)")
        if self.sketch_query_history < 0:
            raise ValueError("SKETCH_QUERY_HISTORY must be >= 0 "
                             "(0 disables the back-scroll ring)")
        if self.alert_raise_evals < 1 or self.alert_clear_evals < 1:
            raise ValueError("ALERT_RAISE_EVALS and ALERT_CLEAR_EVALS "
                             "must be >= 1")
        if self.alert_ring < 1:
            raise ValueError("ALERT_RING must be >= 1")
        if self.alert_webhook_interval < 0:
            raise ValueError("ALERT_WEBHOOK_INTERVAL must be >= 0")
        if self.alert_rules:
            # a malformed rule spec or sink set fails here, not at the
            # exporter's construction
            from netobserv_tpu_torch.alerts.rules import parse_rules
            from netobserv_tpu_torch.alerts.sinks import build_sinks
            parse_rules(self.alert_rules)
            build_sinks(self)
