"""Sketch-delta frame codec (versioned, proto3-framed, endian-independent).

A copy of `netobserv_tpu/federation/delta.py` on top of the port's own
proto3 writer and parser (`federation/pbwire.py`) in place of the
generated protobuf module: the card's machine has no protobuf package.
The frames are the reference's, byte for byte
(`tests/golden/sketch_delta_v{1,2,3}.hex`).

One frame per (agent, closed window) carries every mergeable sketch table,
the structures whose merge operators are exact by construction:

- Count-Min planes           merge = elementwise add (linearity)
- HLL register banks         merge = elementwise max
- top-K candidate table      merge = concat + re-score vs the merged CM
- latency log-histograms     merge = elementwise add
- signal-plane window rates  merge = elementwise add (rates are additive)
- window totals              merge = add

EWMA baselines (mean/var) stay agent-local: the aggregator keeps its own
cluster-level baselines over the merged per-window rates, so a fleet-wide
surge scores against fleet history, not against any one host's.

Encoding and decoding never touch a device. Tensor payloads are always
little-endian (explicit ``<`` numpy dtypes) regardless of host order.
`TABLE_SPEC` is the canonical table-snapshot layout
(`sketch/state.state_tables` produces exactly these names).
"""

from __future__ import annotations

import uuid
import zlib
from typing import Mapping, NamedTuple, Optional

import numpy as np

from netobserv_tpu_torch.federation import pbwire
from netobserv_tpu_torch.utils import tensorcodec
from netobserv_tpu_torch.utils.tracing import TraceContext

#: bump on ANY change to TABLE_SPEC, tensor encoding, or frame semantics.
#: v2 adds the idempotent-delivery header (window_seq / frame_uuid /
#: agent_epoch) so the aggregator can ack-and-discard redelivered frames
#: after an ambiguous DEADLINE_EXCEEDED instead of double-counting.
#: v3 adds the persistent-slot churn tensors (heavy_prev_counts /
#: heavy_first_seen / heavy_epoch) and the heavy_evictions scalar — the
#: per-key heavy-hitter plane rides the delta wire.
DELTA_FORMAT_VERSION = 3

#: versions decode_frame still accepts. v1 frames (pre-idempotency agents)
#: carry no delivery header; the aggregator merges them unconditionally and
#: counts them `legacy` — a mixed-version fleet keeps aggregating during a
#: rollout, it just loses dedup protection for the old agents. v1/v2 frames
#: carry no churn tensors; `upgrade_tables` zero-fills them (merging as "no
#: history": the key set and counts still aggregate exactly).
SUPPORTED_VERSIONS = (1, 2, 3)

#: ack reason strings of the aggregator (and of the reference's
#: FederationDeltaSink, their consumer). Both verdicts set `duplicate=1` on the
#: wire — retrying either is pointless — but only a true duplicate was
#: MERGED; a stale discard is per-window data loss, and the reason string
#: is how the agent side tells the two apart in its sent-counter.
ACK_REASON_DUPLICATE = "window already applied"
ACK_REASON_STALE = "stale window discarded"

# the per-tensor codec (utils/tensorcodec.py); these aliases keep the wire
# constants importable from here
CODEC_RAW = tensorcodec.CODEC_RAW
CODEC_ZLIB = tensorcodec.CODEC_ZLIB

_DTYPE_TO_CODE = tensorcodec.DTYPE_TO_CODE
_CODE_TO_DTYPE = tensorcodec.CODE_TO_DTYPE

#: canonical (name, little-endian dtype) of every tensor in a frame, in
#: frame order. `sketch.state.state_tables` produces exactly these names;
#: `scalars` packs the window totals in SCALAR_FIELDS order.
TABLE_SPEC: tuple[tuple[str, str], ...] = (
    ("cm_bytes", "<f4"),
    ("cm_pkts", "<f4"),
    ("heavy_words", "<u4"),
    ("heavy_h1", "<u4"),
    ("heavy_h2", "<u4"),
    ("heavy_counts", "<f4"),
    ("heavy_valid", "<u4"),
    # persistent-slot churn metadata (v3): prev_counts merge by sum,
    # first_seen by min, epoch by max (ops/topk.merge_slot_tables)
    ("heavy_prev_counts", "<f4"),
    ("heavy_first_seen", "<i4"),
    ("heavy_epoch", "<i4"),
    ("hll_src", "<i4"),
    ("hll_per_dst", "<i4"),
    ("hll_per_src", "<i4"),
    ("hist_rtt", "<f4"),
    ("hist_dns", "<f4"),
    ("ddos_rate", "<f4"),
    ("syn_rate", "<f4"),
    ("synack", "<f4"),
    ("drops_rate", "<f4"),
    ("drop_causes", "<f4"),
    ("dscp_bytes", "<f4"),
    ("conv_fwd", "<f4"),
    ("conv_rev", "<f4"),
    ("scalars", "<f4"),
)

#: the v1/v2-era table layout — kept for DECODE COMPAT (legacy frames) and
#: for `encode_frame(version=...)` producing mixed-fleet test vectors; the
#: v2 golden stays pinned against it (tests/test_federation_golden.py)
TABLE_SPEC_V2: tuple[tuple[str, str], ...] = tuple(
    (n, d) for n, d in TABLE_SPEC
    if n not in ("heavy_prev_counts", "heavy_first_seen", "heavy_epoch"))

#: layout of the `scalars` tensor (window totals; all additive)
SCALAR_FIELDS = ("total_records", "total_bytes", "total_drop_bytes",
                 "total_drop_packets", "quic_records", "nat_records",
                 "heavy_evictions")
#: v1/v2 frames carry only the first six
SCALAR_FIELDS_V2 = SCALAR_FIELDS[:6]


def spec_for_version(version: int) -> tuple[tuple[str, str], ...]:
    """The table layout a given frame format version carries."""
    return TABLE_SPEC if version >= 3 else TABLE_SPEC_V2

#: frame-header geometry fields (validated by the aggregator BEFORE its
#: fixed-shape jitted merge ever sees the tensors)
DIM_FIELDS = ("cm_depth", "cm_width", "hll_precision", "topk",
              "ewma_buckets")


class DeltaFrameError(ValueError):
    """Malformed/incomplete frame (decode-time validation failure)."""


class DeltaVersionError(DeltaFrameError):
    """Frame format version does not match DELTA_FORMAT_VERSION."""


class DeltaFrame(NamedTuple):
    """Decoded frame: header metadata + the table dict (TABLE_SPEC names ->
    little-endian numpy arrays, read-only views over the frame buffer).
    `window_seq`/`frame_uuid`/`agent_epoch` are the v2 idempotent-delivery
    header; on v1 frames they read as proto3 defaults (0 / "" / 0) and the
    version field is how consumers tell the difference."""

    version: int
    agent_id: str
    window: int
    ts_ms: int
    dims: dict
    tables: dict
    window_seq: int = 0
    frame_uuid: str = ""
    agent_epoch: int = 0
    # fleet-observability extras (optional on the wire; None when absent —
    # a frame without them is byte-identical to the pre-fleet encoding):
    # trace_ctx is a utils.tracing.TraceContext-shaped tuple
    # (trace_id, origin, sampled); telemetry is the per-agent health dict
    trace_ctx: Optional[tuple] = None
    telemetry: Optional[dict] = None
    #: SKETCH_TENANTS plane identity: (tenant_id, n_tenants) when the
    #: frame carries one tenant plane of a multi-tenant agent; None on
    #: single-tenant frames (absent on the wire — explicit presence)
    tenant: Optional[tuple] = None


def table_spec_fingerprint() -> int:
    """Stable fingerprint of the canonical snapshot layout (the reference
    stamps it into its sketch checkpoints too)."""
    text = ";".join(f"{n}:{d}" for n, d in TABLE_SPEC) + \
        "|" + ",".join(SCALAR_FIELDS)
    return zlib.crc32(text.encode())


def encode_frame(tables: Mapping[str, np.ndarray], *, agent_id: str,
                 window: int, ts_ms: int, dims: Mapping[str, int],
                 codec: int = CODEC_ZLIB, window_seq: Optional[int] = None,
                 frame_uuid: str = "", agent_epoch: int = 0,
                 version: Optional[int] = None,
                 trace_ctx=None,
                 telemetry: Optional[Mapping] = None,
                 tenant: Optional[tuple] = None) -> bytes:
    """Serialize a table snapshot into one SketchDelta frame.

    `tables` must carry every name of the frame version's spec (host numpy
    arrays; dtype is coerced to the spec's little-endian type).
    `codec=CODEC_ZLIB` deflates each tensor but keeps raw whenever deflate
    does not shrink it (the per-tensor codec field records which shipped).

    Idempotency header: `window_seq` defaults to `window` (one frame per
    closed window, the counter IS the sequence); an empty `frame_uuid`
    draws a fresh uuid4 — callers retrying the SAME frame must resend the
    same bytes, not re-encode. `agent_epoch` is the sender's boot identity
    (0 only looks legacy-ish to operators; the version field is what marks
    a frame v1).

    `version` (default: current) may name an OLDER supported version to
    produce mixed-fleet/legacy frames: a v2 frame drops the churn tensors
    and trims `scalars` to the six v2 totals; a v1 frame additionally
    carries no delivery header. Production agents always encode current.

    Fleet observability (current-version frames only): `trace_ctx` (a
    utils.tracing.TraceContext, or any (trace_id, origin, sampled)-shaped
    object) and `telemetry` (the per-agent health dict — shed_factor /
    conditions / host_records_per_s / map_occupancy / windows_published)
    are OPTIONAL message fields: None (the default) writes zero bytes, so
    a frame without them is byte-identical to the pre-fleet wire — not a
    format bump. The context encodes ONCE per frame, here — a retry
    resends the same bytes, never a re-derived context.

    `tenant` (SKETCH_TENANTS agents only): the `(tenant_id, n_tenants)`
    plane identity, same optional-message presence rules — None writes
    zero bytes. The aggregator ledgers each tenant plane as its own
    source (`source_key`), so N tenant frames per window do not read as
    N-1 stale deliveries.
    """
    version = DELTA_FORMAT_VERSION if version is None else int(version)
    if version not in SUPPORTED_VERSIONS:
        raise DeltaFrameError(f"cannot encode unsupported frame version "
                              f"{version} (supported {SUPPORTED_VERSIONS})")
    spec = spec_for_version(version)
    missing = [n for n, _ in spec if n not in tables]
    if missing:
        raise DeltaFrameError(f"table snapshot missing tensors: {missing}")
    if not frame_uuid:
        frame_uuid = uuid.uuid4().hex
    if version >= 2:
        frame = pbwire.SketchDelta(
            version=version, agent_id=agent_id,
            window=int(window), ts_ms=int(ts_ms),
            window_seq=int(window if window_seq is None else window_seq),
            frame_uuid=frame_uuid, agent_epoch=int(agent_epoch))
    else:  # v1: pre-idempotency — no delivery header on the wire
        frame = pbwire.SketchDelta(
            version=version, agent_id=agent_id,
            window=int(window), ts_ms=int(ts_ms))
    for f in DIM_FIELDS:
        setattr(frame, f, int(dims[f]))
    if version >= 3 and trace_ctx is not None:
        frame.trace_ctx = pbwire.TraceContext(
            trace_id=str(trace_ctx.trace_id),
            origin=str(getattr(trace_ctx, "origin", "") or ""),
            sampled=int(bool(getattr(trace_ctx, "sampled", True))))
    if version >= 3 and telemetry is not None:
        frame.telemetry = pbwire.AgentTelemetry(
            shed_factor=float(telemetry.get("shed_factor", 1.0)),
            conditions=[str(c) for c in telemetry.get("conditions", ())],
            host_records_per_s=float(
                telemetry.get("host_records_per_s", 0.0)),
            map_occupancy=float(telemetry.get("map_occupancy", 0.0)),
            windows_published=int(telemetry.get("windows_published", 0)))
    if version >= 3 and tenant is not None:
        frame.tenant = pbwire.TenantInfo(id=int(tenant[0]),
                                         n_tenants=int(tenant[1]))
    n_scalars = len(SCALAR_FIELDS if version >= 3 else SCALAR_FIELDS_V2)
    for name, dt in spec:
        arr = np.asarray(tables[name])
        if name == "scalars":
            arr = arr[:n_scalars]
        arr = np.ascontiguousarray(arr, dtype=dt)
        raw = arr.tobytes()
        try:
            t_codec, t_data = tensorcodec.encode_payload(raw, codec)
        except tensorcodec.TensorCodecError as exc:
            raise DeltaFrameError(str(exc)) from exc
        frame.tensors.append(pbwire.Tensor(
            name=name, dtype=_DTYPE_TO_CODE[dt],
            shape=[int(s) for s in arr.shape], codec=t_codec, data=t_data))
    return frame.SerializeToString(deterministic=True)


#: hard per-tensor size ceiling (decoded bytes) — the codec's bound
#: (utils/tensorcodec.py): caps what a hostile/corrupt frame can
#: make the aggregator allocate BEFORE any shape validation, both via a
#: declared-huge shape and via a zlib bomb
MAX_TENSOR_BYTES = tensorcodec.MAX_TENSOR_BYTES

#: spec dtype per tensor name — decode rejects a frame whose tensor dtype
#: disagrees (a same-shape foreign dtype would otherwise reach the
#: aggregator's fixed-signature jitted merge and force a retrace)
_SPEC_DTYPES = dict(TABLE_SPEC)
_SPEC_DTYPES_V2 = dict(TABLE_SPEC_V2)


def decode_frame(data: bytes) -> DeltaFrame:
    """Parse + validate one frame. Raises DeltaVersionError on a format
    version outside SUPPORTED_VERSIONS and DeltaFrameError on anything
    structurally wrong (unknown tensor name, dtype drift from TABLE_SPEC,
    size over MAX_TENSOR_BYTES, payload/shape mismatch); the tensor arrays
    are zero-copy read-only views over the frame bytes (copy before
    mutating; never hand them to `torch.from_numpy`). v1 frames decode with an empty delivery header (proto3
    defaults) — consumers branch on `frame.version`."""
    try:
        frame = pbwire.SketchDelta.FromString(data)
    except Exception as exc:
        # protobuf's message, whatever the fault (the ack's reason carries
        # it, byte for byte the reference's); the parser's own detail
        # rides the exception's cause
        raise DeltaFrameError(
            "unparseable delta frame: Error parsing message with type "
            "'pbsketch.SketchDelta'") from exc
    if frame.version not in SUPPORTED_VERSIONS:
        raise DeltaVersionError(
            f"delta frame version {frame.version} not in supported "
            f"{SUPPORTED_VERSIONS} (agent {frame.agent_id!r})")
    spec = spec_for_version(frame.version)
    spec_dtypes = _SPEC_DTYPES if frame.version >= 3 else _SPEC_DTYPES_V2
    tables: dict[str, np.ndarray] = {}
    for t in frame.tensors:
        spec_dt = spec_dtypes.get(t.name)
        if spec_dt is None:
            raise DeltaFrameError(
                f"unknown tensor {t.name!r} (not in the v{frame.version} "
                "table spec)")
        dt = _CODE_TO_DTYPE.get(t.dtype)
        if dt is None:
            raise DeltaFrameError(f"tensor {t.name!r}: unknown dtype code "
                                  f"{t.dtype}")
        if dt != spec_dt:
            raise DeltaFrameError(
                f"tensor {t.name!r}: dtype {dt} != spec {spec_dt}")
        shape = tuple(int(s) for s in t.shape)
        try:
            # size-cap + bounded inflate live in the codec
            expected = tensorcodec.declared_nbytes(t.name, shape, dt)
            raw = tensorcodec.decode_payload(t.name, t.codec, t.data,
                                             expected)
        except tensorcodec.TensorCodecError as exc:
            raise DeltaFrameError(str(exc)) from exc
        tables[t.name] = np.frombuffer(raw, dtype=dt).reshape(shape)
    missing = [n for n, _ in spec if n not in tables]
    if missing:
        raise DeltaFrameError(f"delta frame missing tensors: {missing}")
    dims = {f: int(getattr(frame, f)) for f in DIM_FIELDS}
    # optional fleet-observability fields: message presence (HasField) is
    # the absent/present signal — a zero-valued present block is still a
    # block, an absent one decodes as None
    trace_ctx = None
    if frame.HasField("trace_ctx"):
        trace_ctx = TraceContext(frame.trace_ctx.trace_id,
                                 frame.trace_ctx.origin,
                                 bool(frame.trace_ctx.sampled))
    telemetry = None
    if frame.HasField("telemetry"):
        telemetry = {
            "shed_factor": float(frame.telemetry.shed_factor),
            "conditions": list(frame.telemetry.conditions),
            "host_records_per_s": float(frame.telemetry.host_records_per_s),
            "map_occupancy": float(frame.telemetry.map_occupancy),
            "windows_published": int(frame.telemetry.windows_published),
        }
    tenant = None
    if frame.HasField("tenant"):
        tenant = (int(frame.tenant.id), int(frame.tenant.n_tenants))
    return DeltaFrame(version=int(frame.version), agent_id=frame.agent_id,
                      window=int(frame.window), ts_ms=int(frame.ts_ms),
                      dims=dims, tables=tables,
                      window_seq=int(frame.window_seq),
                      frame_uuid=frame.frame_uuid,
                      agent_epoch=int(frame.agent_epoch),
                      trace_ctx=trace_ctx, telemetry=telemetry,
                      tenant=tenant)


def source_key(frame: "DeltaFrame") -> str:
    """The aggregator-side delivery-source identity of a frame.

    A multi-tenant agent publishes N frames per closed window — same
    agent_id, same agent_epoch, same window_seq, different tenant planes.
    Keying the ledger by bare agent_id would read tenants 1..N-1 as
    duplicate/stale deliveries of tenant 0's frame and DISCARD them, so
    each tenant plane ledgers as its own source. Single-tenant frames
    (tenant absent) keep the bare agent_id — existing ledgers, checkpoint
    sidecars and fleet views are unchanged."""
    if frame.tenant is None:
        return frame.agent_id
    return f"{frame.agent_id}#t{frame.tenant[0]}"


def upgrade_tables(frame: DeltaFrame) -> dict:
    """Normalize a decoded frame's tables to the CURRENT (v3) layout.

    v1/v2 frames carry no churn tensors and six-wide scalars: the missing
    tensors zero-fill (shaped after the frame's own heavy_counts — merging
    as "no churn history"; the key set and counts still aggregate exactly)
    and `scalars` pads with zeros to the current width, so the aggregator's
    fixed-signature jitted merge sees ONE table layout for every supported
    frame version. Current frames return their table dict unchanged."""
    if frame.version >= 3:
        return frame.tables
    tables = dict(frame.tables)
    k = np.asarray(frame.tables["heavy_counts"]).shape
    tables["heavy_prev_counts"] = np.zeros(k, "<f4")
    tables["heavy_first_seen"] = np.zeros(k, "<i4")
    tables["heavy_epoch"] = np.zeros(k, "<i4")
    scal = np.asarray(frame.tables["scalars"], "<f4")
    tables["scalars"] = np.concatenate(
        [scal, np.zeros(len(SCALAR_FIELDS) - scal.shape[0], "<f4")])
    return tables


def localize_churn(tables: Mapping[str, np.ndarray],
                   window: int) -> dict:
    """Re-base a delta frame's churn tensors into the AGGREGATOR's window
    domain before merging.

    The churn baselines are tier-local by construction: an agent's
    `heavy_prev_counts` is ITS previous agent-window's mass, and the
    aggregator's own `slot_roll` already snapshots the previous CLUSTER
    window's merged counts as the aggregate's baseline — summing the
    agents' prevs on top would double-count every persistent key (and
    worse with several agent windows per federation window). Likewise
    `heavy_first_seen`/`heavy_epoch` are numbered in each agent's window/
    insertion domain, meaningless at the cluster tier. So delta frames
    merge with: prev_counts zeroed (the aggregate's own roll history IS
    the cluster baseline), first_seen set to the aggregator's CURRENT
    window (the segmented MIN keeps the aggregate's earlier stamp for
    known keys and stamps genuinely-new keys with the window they first
    reached the cluster table), epoch zeroed (the aggregate's own
    generations count)."""
    out = dict(tables)
    k = np.asarray(tables["heavy_counts"]).shape
    out["heavy_prev_counts"] = np.zeros(k, "<f4")
    out["heavy_first_seen"] = np.full(k, int(window), "<i4")
    out["heavy_epoch"] = np.zeros(k, "<i4")
    return out


def expected_shapes(template_tables: Mapping[str, np.ndarray]) -> dict:
    """Shape dict of a snapshot (the aggregator's fixed-shape contract)."""
    return {n: tuple(np.asarray(template_tables[n]).shape)
            for n, _ in TABLE_SPEC}


def validate_shapes(frame: DeltaFrame,
                    expected: Mapping[str, tuple]) -> None:
    """Reject a frame whose tensor shapes differ from the aggregator's own
    snapshot template — a foreign shape must never reach the jitted merge
    (it would retrace; the fixed-shape invariant is load-bearing)."""
    for name, shape in expected.items():
        if name not in frame.tables:
            raise DeltaFrameError(
                f"tensor {name!r} absent (upgrade_tables the frame before "
                "shape validation — legacy frames lack the churn tensors)")
        got = tuple(frame.tables[name].shape)
        if got != tuple(shape):
            raise DeltaFrameError(
                f"tensor {name!r}: shape {got} != aggregator's {shape} "
                f"(agent {frame.agent_id!r} runs a different SketchConfig)")
