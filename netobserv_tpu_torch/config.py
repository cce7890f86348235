"""Report thresholds and feed settings of the sketch plane.

Counterpart of the `DEFAULT_*` thresholds in `netobserv_tpu/config.py`,
kept as a copy: the window report renderer (`exporter/report.py`) reads
them as its defaults. `resolved_pack_threads` and `parse_superbatch_ladder`
are copies of `AgentConfig.resolved_pack_threads` and
`parsed_superbatch_ladder` (`:592-620`) as functions of their setting.
"""

from __future__ import annotations

import os

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
