"""Report thresholds and feed settings of the sketch plane.

Counterpart of the `DEFAULT_*` thresholds in `netobserv_tpu/config.py`,
kept as a copy: the window report renderer (`exporter/report.py`) reads
them as its defaults. `resolved_pack_threads` and `parse_superbatch_ladder`
are copies of `AgentConfig.resolved_pack_threads` and
`parsed_superbatch_ladder` (`:592-620`) as functions of their setting.
`QuerySettings` holds the query and alerting planes' settings of
`AgentConfig` (`:443-451`, `:495-518`) with their defaults and checks
(`:693-733`): the port has no `AgentConfig`, and `alerts/engine.maybe_engine`
takes these. `FederationSettings` holds the federation aggregator's and the
delta sender's settings (`:545-590`) with the reference's defaults, and
`parse_duration` is a copy of the reference's (`:18-43`), which reads the
duration settings. `ArchiveSettings` holds the archive's settings
(`:520-544`) with their checks (`:735-750`), which `archive.maybe_archive`
takes, and `CheckpointSettings` the exporter's and the aggregator's
checkpoint settings (`:325-326`, `:581-590`). `OverloadSettings` holds the
overload controller's and the overlapped fold thread's settings
(`:455-482`) with their checks (`:697-712`), and `SupervisorSettings` the
stage supervisor's (`:247-270`); both read durations as the reference
does (`_DURATION_FIELDS`, `:776-784`) and booleans through `_parse_bool`
(`:45-46`).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Mapping, Optional

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


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
    "h": 3600.0,
}


def parse_duration(text: str) -> float:
    """Parse a Go-style duration string ("5s", "300ms", "1m30s") into
    seconds; a plain number is seconds, an empty string 0."""
    text = text.strip()
    if not text:
        return 0.0
    try:
        return float(text)
    except ValueError:
        pass
    total = 0.0
    pos = 0
    for m in _DURATION_RE.finditer(text):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {text!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(text):
        raise ValueError(f"invalid duration: {text!r}")
    return total


@dataclass
class FederationSettings:
    """The federation plane's settings, under the reference's names and
    defaults: `federation_window` (FEDERATION_WINDOW, the aggregator's
    window in seconds), `federation_stale_after` (FEDERATION_STALE_AFTER,
    seconds without a delta before an agent reads as stale),
    `federation_agent_ttl` (FEDERATION_AGENT_TTL, seconds before a silent
    agent is evicted, 0 = never) and `federation_agent_id`
    (FEDERATION_AGENT_ID, the agent identity its frames carry; "" = the
    host name). `from_env` reads them as the reference does: the three
    durations through `parse_duration`, which raises on a malformed one."""

    federation_window: float = 60.0
    federation_stale_after: float = 120.0
    federation_agent_ttl: float = 600.0
    federation_agent_id: str = ""

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "FederationSettings":
        env = os.environ if environ is None else environ
        out = cls()
        for name in ("federation_window", "federation_stale_after",
                     "federation_agent_ttl"):
            raw = env.get(name.upper())
            if raw:  # set but empty reads as unset, as the reference's
                setattr(out, name, parse_duration(raw))
        out.federation_agent_id = env.get("FEDERATION_AGENT_ID",
                                          out.federation_agent_id)
        return out


def _env_int(env: Mapping[str, str], name: str, default: int) -> int:
    """An integer setting; set but empty reads as unset, as the
    reference's."""
    raw = env.get(name)
    return int(raw) if raw else default


@dataclass
class ArchiveSettings:
    """The archive's settings, under the reference's names and defaults:
    `archive_dir` (ARCHIVE_DIR, "" = no archive), `archive_raw_windows`
    (ARCHIVE_RAW_WINDOWS, raw segments a level keeps before its oldest
    group compacts), `archive_compact_group` (ARCHIVE_COMPACT_GROUP, the
    coarsening factor), `archive_max_levels` (ARCHIVE_MAX_LEVELS) and
    `archive_merge_ladder_max` (ARCHIVE_MERGE_LADDER_MAX, the largest
    merge of one dispatch, a power of two in [1, 64]: every power of two
    up to it is a CUDA graph). A value the reference refuses raises
    here."""

    archive_dir: str = ""
    archive_raw_windows: int = 64
    archive_compact_group: int = 8
    archive_max_levels: int = 3
    archive_merge_ladder_max: int = 16

    def __post_init__(self):
        if self.archive_compact_group < 2:
            raise ValueError("ARCHIVE_COMPACT_GROUP must be >= 2 (it is "
                             "the RRD coarsening factor)")
        if self.archive_raw_windows < self.archive_compact_group:
            raise ValueError(
                f"ARCHIVE_RAW_WINDOWS ({self.archive_raw_windows}) must "
                f"be >= ARCHIVE_COMPACT_GROUP "
                f"({self.archive_compact_group})")
        if self.archive_max_levels < 1:
            raise ValueError("ARCHIVE_MAX_LEVELS must be >= 1")
        v = self.archive_merge_ladder_max
        if v < 1 or v & (v - 1) or v > 64:
            raise ValueError(
                f"ARCHIVE_MERGE_LADDER_MAX must be a power of two in "
                f"[1, 64] (got {v}) — every power of two up to it costs "
                "a pre-built merge executable")

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "ArchiveSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(archive_dir=env.get("ARCHIVE_DIR", ""), **{
            name: _env_int(env, name.upper(), d[name].default)
            for name in ("archive_raw_windows", "archive_compact_group",
                         "archive_max_levels", "archive_merge_ladder_max")})


@dataclass
class CheckpointSettings:
    """The checkpoint settings, under the reference's names and defaults:
    `sketch_checkpoint_dir` (SKETCH_CHECKPOINT_DIR, "" = none) and
    `sketch_checkpoint_every` (SKETCH_CHECKPOINT_EVERY, every Nth window
    roll, 0 = never) of the exporter; `federation_checkpoint_dir`
    (FEDERATION_CHECKPOINT_DIR) and `federation_checkpoint_every`
    (FEDERATION_CHECKPOINT_EVERY, default every roll) of the
    aggregator."""

    sketch_checkpoint_dir: str = ""
    sketch_checkpoint_every: int = 0
    federation_checkpoint_dir: str = ""
    federation_checkpoint_every: int = 1

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "CheckpointSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(
            sketch_checkpoint_dir=env.get("SKETCH_CHECKPOINT_DIR", ""),
            federation_checkpoint_dir=env.get("FEDERATION_CHECKPOINT_DIR",
                                              ""),
            **{name: _env_int(env, name.upper(), d[name].default)
               for name in ("sketch_checkpoint_every",
                            "federation_checkpoint_every")})


def _parse_bool(text: str) -> bool:
    """A boolean setting as the reference reads one."""
    return text.strip().lower() in ("1", "true", "yes", "on")


def _env_typed(env: Mapping[str, str], fields: dict, durations=()) -> dict:
    """The settings of `fields` (name -> default) that `env` sets under
    their upper-case names, each read as its default's type (a name in
    `durations` through `parse_duration`); set but empty reads as unset,
    as the reference's."""
    out = {}
    for name, default in fields.items():
        raw = env.get(name.upper())
        if not raw:
            continue
        if name in durations:
            out[name] = parse_duration(raw)
        elif isinstance(default, bool):
            out[name] = _parse_bool(raw)
        else:
            out[name] = type(default)(raw)
    return out


@dataclass
class OverloadSettings:
    """The overload controller's and the overlapped fold thread's settings,
    under the reference's names and defaults: `sketch_shed_watermark`
    (SKETCH_SHED_WATERMARK, the pressure score in batches above which the
    exporter sheds; 0 = no controller), `sketch_shed_max`
    (SKETCH_SHED_MAX, the largest 1-in-N factor), `sketch_shed_slot_budget`
    (SKETCH_SHED_SLOT_BUDGET, a duration: the longest one fold waits for a
    staging slot while a controller exists) and `sketch_overlap`
    (SKETCH_OVERLAP, the handoff depth of the fold thread; 0 = no thread).
    A value the reference refuses raises here. The exporter takes them as
    `shed_watermark`, `shed_max`, `shed_slot_budget_s` and
    `overlap_depth`."""

    sketch_shed_watermark: float = 0.0
    sketch_shed_max: int = 64
    sketch_shed_slot_budget: float = 30.0
    sketch_overlap: int = 0

    def __post_init__(self):
        if self.sketch_shed_watermark < 0:
            raise ValueError("SKETCH_SHED_WATERMARK must be >= 0 (0 disables)")
        if self.sketch_overlap < 0:
            raise ValueError("SKETCH_OVERLAP must be >= 0 (0 keeps the "
                             "synchronous export seam)")
        if self.sketch_shed_max < 2:
            raise ValueError("SKETCH_SHED_MAX must be >= 2 (it bounds the "
                             "1-in-N shed factor)")

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "OverloadSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(**_env_typed(env, {n: f.default for n, f in d.items()},
                                durations=("sketch_shed_slot_budget",)))


@dataclass
class SupervisorSettings:
    """The stage supervisor's settings, under the reference's names and
    defaults: `supervisor_enable` (SUPERVISOR_ENABLE), and the durations
    `supervisor_check_period` (SUPERVISOR_CHECK_PERIOD),
    `supervisor_backoff_initial`, `supervisor_backoff_max`,
    `supervisor_healthy_reset` and `supervisor_heartbeat_timeout`, and
    `supervisor_max_restarts` (the consecutive failures before a stage is
    DEGRADED). `agent/supervisor.Supervisor` takes the check period;
    `register_supervised` the rest."""

    supervisor_enable: bool = True
    supervisor_check_period: float = 0.25
    supervisor_max_restarts: int = 5
    supervisor_backoff_initial: float = 0.2
    supervisor_backoff_max: float = 30.0
    supervisor_healthy_reset: float = 30.0
    supervisor_heartbeat_timeout: float = 300.0

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "SupervisorSettings":
        env = os.environ if environ is None else environ
        d = cls.__dataclass_fields__
        return cls(**_env_typed(
            env, {n: f.default for n, f in d.items()},
            durations=("supervisor_check_period",
                       "supervisor_backoff_initial", "supervisor_backoff_max",
                       "supervisor_healthy_reset",
                       "supervisor_heartbeat_timeout")))
