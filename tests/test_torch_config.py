"""The port's agent settings (netobserv_tpu_torch/config.py: `AgentConfig`,
`load_config`, `validate`; sketch/state.py `SketchConfig.
from_agent_config`; exporter/torch_sketch.py `TorchSketchExporter.
from_config`; exporter.build_exporter) against the JAX package's, on the
CPU.

- `load_config` of both packages gives equal configurations
  (`dataclasses.asdict`) over a set of environments: the default, every
  SKETCH_* and KAFKA_* field set, durations, booleans and lists in every
  spelling, set-but-empty values; a malformed value raises `ValueError`
  in both, and so does `validate` on an invalid configuration.
- `from_config` with SKETCH_DEVICES=cpu builds an exporter whose
  geometry, batch, window, feed, ladder, lanes, thresholds, overload,
  query, alert, archive, checkpoint and decay settings and sink type are
  the JAX `TpuSketchExporter.from_config`'s on the same environment.
- Every setting the port has not ported raises `ValueError` naming its
  ROADMAP item; FEDERATION_TARGET and the record exporters build.
"""

import dataclasses

import pytest

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu import config as jcfg
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.exporter import build_exporter
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.sketch import state as ts
from netobserv_tpu_torch.sketch.tenancy import TenantStack

#: a value of each type, unlike every default
_VALUES = {"int": "7", "float": "0.25", "bool": "true", "str": "x",
           "list[str]": "a, b,,c"}

def _fields_with_prefix(*prefixes):
    return [f for f in dataclasses.fields(jcfg.AgentConfig)
            if f.metadata["env"].startswith(prefixes)]


def _every_sketch_and_kafka_field() -> dict:
    env = {f.metadata["env"]: ("false" if f.default is True
                               else _VALUES[f.type])
           for f in _fields_with_prefix("SKETCH_", "KAFKA_")}
    env["SKETCH_WINDOW"] = "1m30s"
    env["SKETCH_SHED_SLOT_BUDGET"] = "250ms"
    env["SKETCH_QUERY_REFRESH"] = "1.5"
    return env


ENVS = {
    "default": {},
    "sketch_and_kafka": _every_sketch_and_kafka_field(),
    "durations": {"CACHE_ACTIVE_TIMEOUT": "300ms", "SKETCH_WINDOW": "2h",
                  "LISTEN_POLL_PERIOD": "1m30s",
                  "STALE_ENTRIES_EVICT_TIMEOUT": "10us",
                  "SUPERVISOR_CHECK_PERIOD": "5µs",
                  "SUPERVISOR_BACKOFF_MAX": "2.5",
                  "SUPERVISOR_HEARTBEAT_TIMEOUT": "100ns",
                  "FEDERATION_WINDOW": "1h1m1s", "ALERT_WEBHOOK_INTERVAL": ""},
    "bools_on": {"KAFKA_ASYNC": "0", "KAFKA_ENABLE_TLS": "1",
                 "SKETCH_TIERED": " True ", "METRICS_ENABLE": "yes",
                 "ENABLE_RTT": "on", "FORCE_GARBAGE_COLLECTION": "off",
                 "SUPERVISOR_ENABLE": "no", "ENABLE_PCA": "TRUE"},
    "bools_odd": {"KAFKA_ASYNC": "maybe", "SKETCH_TIERED": "",
                  "METRICS_ENABLE": "2", "ENABLE_DNS_TRACKING": "False"},
    "lists_and_empty": {"KAFKA_BROKERS": "b1:9092 , b2:9093,",
                        "EXCLUDE_INTERFACES": "", "INTERFACES": "eth0,eth1",
                        "KAFKA_TOPIC": "", "SKETCH_BATCH_SIZE": "",
                        "FLOWS_TARGET_HOST": "h", "FLOWS_TARGET_PORT": "9",
                        "ENABLE_PCA": "true", "PCA_SERVER_PORT": "7"},
    "agent_run": {"EXPORT": "tpu-sketch", "DATAPATH": "pcap:/x.pcap",
                  "CACHE_ACTIVE_TIMEOUT": "100ms", "SKETCH_BATCH_SIZE": "512",
                  "SKETCH_WINDOW": "3s", "SKETCH_SYNFLOOD_MIN": "128",
                  "METRICS_LEVEL": "trace!", "LOG_LEVEL": "debug"},
}

#: environments whose values cannot be read, or which `validate` refuses,
#: in both packages
INVALID_LOAD = {"SKETCH_WINDOW": "5x", "SKETCH_BATCH_SIZE": "abc",
                "SKETCH_DDOS_Z": "high", "CACHE_ACTIVE_TIMEOUT": "1s5"}
INVALID = [
    {"EXPORT": "nope"}, {"EXPORT": "grpc"}, {"EXPORT": "kafka"},
    {"SKETCH_CM_WIDTH": "1000"}, {"SKETCH_HLL_PRECISION": "3"},
    {"SKETCH_WINDOW_MODE": "slide"},
    {"SKETCH_WINDOW_MODE": "decay", "SKETCH_DECAY_FACTOR": "1"},
    {"SKETCH_REPORT_SINK": "file"}, {"SKETCH_SUPERBATCH": "2,4"},
    {"SKETCH_SUPERBATCH": "1,x"}, {"SKETCH_SUPERBATCH": "1,128"},
    {"SKETCH_QUERY_REFRESH": "-1"}, {"SKETCH_SHED_WATERMARK": "-1"},
    {"SKETCH_SHED_MAX": "1"}, {"SKETCH_OVERLAP": "-1"},
    {"MAP_PRESSURE_WATERMARK": "1.0"}, {"ALERT_RAISE_EVALS": "0"},
    {"ALERT_RULES": "nope"}, {"ALERT_RULES": "default",
                              "ALERT_SINKS": "webhook"},
    {"SKETCH_CHURN_ASCENT": "1"}, {"ALERT_RING": "0"},
    {"ARCHIVE_COMPACT_GROUP": "1"}, {"ARCHIVE_MERGE_LADDER_MAX": "3"},
    {"FEDERATION_MODE": "hub"}, {"FEDERATION_TARGET": "nohost"},
    {"SKETCH_TIERED": "true", "SKETCH_TIER_TOP_GROUP": "16"},
    {"SKETCH_TENANTS": "-1"}, {"EVICT_DRAIN_LANES": "-1"},
]


@pytest.mark.parametrize("name", sorted(ENVS))
def test_load_config_equals_the_reference(name):
    env = ENVS[name]
    ours, ref = tcfg.load_config(env), jcfg.load_config(env)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [(f.name, dict(f.metadata)) for f in
            dataclasses.fields(tcfg.AgentConfig)] == [
        (f.name, dict(f.metadata)) for f in
        dataclasses.fields(jcfg.AgentConfig)]
    assert ours.resolved_pack_threads() == ref.resolved_pack_threads()
    if name in ("default", "agent_run"):
        assert ours.parsed_superbatch_ladder() == \
            ref.parsed_superbatch_ladder()


def test_the_sketch_and_kafka_environment_sets_every_field():
    env = ENVS["sketch_and_kafka"]
    cfg = tcfg.load_config(env)
    default = tcfg.AgentConfig()
    fields = _fields_with_prefix("SKETCH_", "KAFKA_")
    assert len(fields) > 40
    for f in fields:
        assert getattr(cfg, f.name) != getattr(default, f.name), f.name


@pytest.mark.parametrize("name", sorted(INVALID_LOAD))
def test_malformed_values_raise_in_both(name):
    env = {name: INVALID_LOAD[name]}
    with pytest.raises(ValueError):
        jcfg.load_config(env)
    with pytest.raises(ValueError):
        tcfg.load_config(env)


@pytest.mark.parametrize("env", INVALID, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()))
def test_invalid_configurations_fail_validate_in_both(env):
    env = {"EXPORT": "tpu-sketch", **env}
    with pytest.raises(ValueError):
        jcfg.load_config(env).validate()
    with pytest.raises(ValueError):
        tcfg.load_config(env).validate()


def test_the_agent_run_configuration_validates_in_both():
    env = ENVS["agent_run"]
    jcfg.load_config(env).validate()
    tcfg.load_config(env).validate()


#: settings the port once refused, ported since: with the kernel
#: datapath's bpf(2) layer the first three, with the SSL, UDN and
#: network-events branches the last three; both packages' `validate` take
#: them, and no setting of the flow agent is refused any more
_PORTED_SINCE = (
    ("flow_filter_rules", "FLOW_FILTER_RULES"),
    ("ebpf_program_manager_mode", "EBPF_PROGRAM_MANAGER_MODE"),
    ("evict_native_pipeline", "EVICT_NATIVE_PIPELINE"),
    ("enable_openssl_tracking", "ENABLE_OPENSSL_TRACKING"),
    ("enable_udn_mapping", "ENABLE_UDN_MAPPING"),
    ("enable_network_events_monitoring", "ENABLE_NETWORK_EVENTS_MONITORING"),
)


@pytest.mark.parametrize("name,env_name", list(_PORTED_SINCE))
def test_validate_refuses_unported_features(name, env_name):
    """Each setting the port once refused: the reference takes it (its
    `validate` passes), and so does the port's `validate`, with no
    refusal table left (`_UNPORTED` went with the last of them)."""
    env = {"EXPORT": "tpu-sketch",
           env_name: "[{}]" if name == "flow_filter_rules" else "true"}
    jcfg.load_config(env).validate()
    cfg = tcfg.load_config(env)
    assert getattr(cfg, name)
    assert not hasattr(tcfg, "_UNPORTED")
    cfg.validate()
    if name == "flow_filter_rules":
        assert cfg.parsed_filter_rules() == [tcfg.FlowFilterRule()]


def test_validate_accepts_the_ringbuf_fallback_and_the_agent_builds_it():
    """ENABLE_FLOWS_RINGBUF_FALLBACK, once refused, is ported: both
    packages' `validate` take it, and the port's agent builds the tracer
    and the accounter, registered with its supervisor."""
    from netobserv_tpu_torch.agent import FlowsAgent
    from netobserv_tpu_torch.datapath.fetcher import FakeFetcher
    from netobserv_tpu_torch.flow import Accounter, RingBufTracer

    class Collect:
        name = "collect"

        def export_batch(self, records):
            pass

    env = {"EXPORT": "tpu-sketch", "ENABLE_FLOWS_RINGBUF_FALLBACK": "true"}
    jcfg.load_config(env).validate()
    cfg = tcfg.load_config(env)
    cfg.validate()
    assert cfg.enable_flows_ringbuf_fallback
    agent = FlowsAgent(cfg, FakeFetcher(), Collect())
    assert isinstance(agent.rb_tracer, RingBufTracer)
    assert isinstance(agent.accounter, Accounter)
    assert {"accounter", "ringbuf-tracer"} <= set(
        agent.supervisor.snapshot())


@pytest.mark.parametrize("env", [
    {}, {"SKETCH_TIERED": "yes", "SKETCH_TIER_MID_GROUP": "16",
         "SKETCH_TIER_TOP_GROUP": "512", "SKETCH_TIER_BYTES_UNIT": "64",
         "SKETCH_CM_DEPTH": "3", "SKETCH_CM_WIDTH": "4096",
         "SKETCH_HLL_PRECISION": "12", "SKETCH_TOPK": "128",
         "SKETCH_EWMA_ALPHA": "0.5", "SKETCH_USE_PALLAS": "false"}],
    ids=["default", "tiered"])
def test_sketch_config_from_agent_config_matches_the_reference(env):
    cfg = tcfg.load_config(env)
    ours = ts.SketchConfig.from_agent_config(cfg)
    ref = js.SketchConfig.from_agent_config(jcfg.load_config(env))
    want = ref._asdict()
    want.pop("use_pallas")
    got = ours._asdict()
    if ref.tiered is not None:
        assert tuple(got.pop("tiered")) == tuple(want.pop("tiered"))
    assert got == want


#: environments of the from_config comparison: a small default, every
#: plane on (overload, overlap, query refresh, alerts, archive,
#: checkpoints, decay), and the dense feed with its thresholds
FROM_CONFIG = {
    "small": {},
    "planes": {"SKETCH_SHED_WATERMARK": "4", "SKETCH_SHED_MAX": "16",
               "SKETCH_SHED_SLOT_BUDGET": "2s", "SKETCH_OVERLAP": "2",
               "SKETCH_QUERY_REFRESH": "30s", "SKETCH_QUERY_HISTORY": "3",
               "ALERT_RULES": "default", "ARCHIVE_DIR": "{tmp}/arc",
               "ARCHIVE_RAW_WINDOWS": "8", "ARCHIVE_COMPACT_GROUP": "2",
               "ARCHIVE_MERGE_LADDER_MAX": "2",
               "SKETCH_CHECKPOINT_DIR": "{tmp}/ck",
               "SKETCH_CHECKPOINT_EVERY": "3", "SKETCH_WINDOW_MODE": "decay",
               "SKETCH_DECAY_FACTOR": "0.25", "SKETCH_SUPERBATCH": "1,2,4",
               "SKETCH_PACK_THREADS": "2"},
    "dense": {"SKETCH_FEED": "dense", "SKETCH_SCAN_FANOUT": "9",
              "SKETCH_DDOS_Z": "3.5", "SKETCH_SYNFLOOD_MIN": "5",
              "SKETCH_SYNFLOOD_RATIO": "2", "SKETCH_DROP_Z": "4",
              "SKETCH_ASYM_MIN_BYTES": "100", "SKETCH_ASYM_RATIO": "0.5",
              "SKETCH_CHURN_ASCENT": "3", "SKETCH_CHURN_MIN_BYTES": "7",
              "SKETCH_WINDOW": "90s", "SKETCH_SUPERBATCH": "1"},
}
_SMALL_ENV = {"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
              "SKETCH_BATCH_SIZE": "256", "SKETCH_CM_WIDTH": "1024",
              "SKETCH_TOPK": "64", "SKETCH_HLL_PRECISION": "10",
              "SKETCH_RESIDENT_SLOTS": "4096", "SKETCH_WINDOW": "1h"}


def _discard(report):
    pass


def one_device_reference(cfg, **kw):
    """The reference exporter on one device: the tests' CPU backend has 8
    devices, and `from_config` would shard over all of them; it is shown
    one while it is built (as tests/test_torch_window.py does)."""
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        return TpuSketchExporter.from_config(cfg, **kw)
    finally:
        jax.devices = devices


@pytest.mark.parametrize("name", sorted(FROM_CONFIG))
def test_from_config_matches_the_reference(name, tmp_path):
    env = {**_SMALL_ENV, **{k: v.format(tmp=tmp_path / "ref")
                            for k, v in FROM_CONFIG[name].items()}}
    ref = one_device_reference(jcfg.load_config(env))
    env = {**env, **{k: v.format(tmp=tmp_path / "port")
                     for k, v in FROM_CONFIG[name].items()}}
    ours = TorchSketchExporter.from_config(tcfg.load_config(env))
    try:
        with ours._lock:
            ours._ensure_ring()
        assert ours.device.type == "cpu"
        assert ours.batch_size == ref._batch_size == 256
        assert ours.window_s == ref._window_s
        want = ref._cfg._asdict()
        want.pop("use_pallas")
        assert ours.cfg._asdict() == want
        assert type(ours.ring).__name__ == type(ref._ring).__name__
        assert getattr(ours.ring, "ladder", None) == getattr(
            ref._ring, "ladder", None)
        assert getattr(ours.ring, "lanes", None) == getattr(
            ref._ring, "lanes", None)
        assert getattr(ours.ring, "slot_cap", None) == getattr(
            ref._ring, "slot_cap", None)
        assert ours._thresholds == dict(
            scan_fanout_threshold=ref._scan_fanout,
            ddos_z_threshold=ref._ddos_z, synflood_min=ref._synflood_min,
            synflood_ratio=ref._synflood_ratio,
            drop_z_threshold=ref._drop_z,
            asym_min_bytes=ref._asym_min_bytes,
            asym_ratio=ref._asym_ratio, churn_ascent=ref._churn_ascent,
            churn_min_bytes=ref._churn_min_bytes)
        assert (ours._overload is None) == (ref._overload is None)
        if ref._overload is not None:
            for attr in ("batch_size", "high", "low", "shed_max"):
                assert getattr(ours._overload, attr) == getattr(
                    ref._overload, attr), attr
            assert ours.ring.slot_wait_budget_s == \
                ref._ring.slot_wait_budget_s == 2.0
        assert (ours._handoff is None) == (ref._handoff is None)
        if ref._handoff is not None:
            assert ours._handoff.maxsize == ref._handoff.maxsize == 2
        assert ours._query_refresh_s == ref._query_refresh_s
        assert ours.query._history_cap == ref.query._history_cap
        assert (ours._alerts is None) == (ref._alerts is None)
        assert (ours._archive is None) == (ref._archive is None)
        assert (ours._ckpt is None) == (ref._ckpt is None)
        assert ours._ckpt_every == ref._ckpt_every
        assert (ours.decay_factor is not None) == \
            ref._tier_sticky_promotions
        if ours.decay_factor is not None:
            assert ours.decay_factor == 0.25
        assert type(ours.sink).__name__ == type(ref._sink).__name__
        assert ours._delta_sink is None and ref._delta_sink is None
        assert ours.name == ref.name and ours.supports_columnar
    finally:
        ours.close()
        ref.close()


#: EXPORT=direct-flp's case: a conntrack extract and a prom encode
_FLP_CONFIG = """
pipeline: [{name: c}, {name: p, follows: c}]
parameters:
  - name: c
    extract: {type: conntrack, conntrack: {outputRecordTypes: [flowLog]}}
  - name: p
    encode: {type: prom, prom: {metrics: [{name: x_total, type: counter}]}}
"""


@pytest.mark.parametrize("env,item", [
    ({"SKETCH_MESH_SHAPE": "2x1"}, None), ({"SKETCH_TENANTS": "2"}, None),
    ({"FEDERATION_TARGET": "127.0.0.1:9"}, None),
    ({"SKETCH_DEVICES": "tpu"}, "SKETCH_DEVICES"),
    ({"EXPORT": "grpc", "TARGET_HOST": "127.0.0.1", "TARGET_PORT": "9",
      "GRPC_MESSAGE_MAX_FLOWS": "7", "GRPC_RECONNECT_TIMER": "30s",
      "GRPC_RECONNECT_TIMER_RANDOMIZATION": "5s"}, None),
    ({"EXPORT": "stdout"}, None),
    ({"EXPORT": "direct-flp", "FLP_CONFIG": _FLP_CONFIG}, None)],
    ids=["mesh", "tenants", "federation", "devices", "grpc", "stdout",
         "direct-flp"])
def test_build_exporter_refuses_what_the_port_lacks(env, item):
    """Each setting the port lacks raises naming its ROADMAP item (only
    SKETCH_DEVICES now); the cases with item None, ported since, build:
    the tenant planes (a `TenantStack` ring and one query publisher a
    tenant), the mesh exporter (a 2x1 mesh of the CPU, its state a
    `DistState`), FEDERATION_TARGET's delta sink and the grpc, stdout and
    direct-flp record exporters, each of the reference's type with the
    reference's settings (the reference's gRPC objects connect lazily, so
    nothing dials port 9; direct-flp's stages the reference's, its prom
    metrics on its own registry, as no agent metrics are given)."""
    cfg = tcfg.load_config({**_SMALL_ENV, **env})
    if item is not None:
        with pytest.raises(ValueError, match=item):
            build_exporter(cfg)
        return
    if "EXPORT" in env:
        from netobserv_tpu.exporter import build_exporter as ref_build
        ref = ref_build(jcfg.load_config({**_SMALL_ENV, **env}))
        exp = build_exporter(cfg)
        try:
            assert type(exp).__name__ == type(ref).__name__
            assert exp.name == ref.name and not exp.supports_columnar
            if env["EXPORT"] == "grpc":
                assert exp._max_flows == ref._max_flows == 7
                assert exp._reconnect_every == ref._reconnect_every == 30
                assert exp._reconnect_rand == ref._reconnect_rand == 5
                assert exp._client._target == ref._client._target
            elif env["EXPORT"] == "direct-flp":
                assert [type(st).__name__ for st in exp._stages] == \
                    [type(st).__name__ for st in ref._stages]
                assert len(exp._stages) == 2
                assert exp._prom_names == ref._prom_names == {"x_total"}
                assert exp._stream is ref._stream
            else:
                assert exp._stream is ref._stream
        finally:
            exp.close()
            getattr(ref, "close", lambda: None)()
        return
    exp = build_exporter(cfg)
    try:
        if "FEDERATION_TARGET" in env:
            from netobserv_tpu.exporter.federation import (
                FederationDeltaSink as RefSink,
            )
            from netobserv_tpu_torch.exporter.federation import (
                FederationDeltaSink,
            )
            ref = RefSink("127.0.0.1", 9)
            try:
                sink = exp._delta_sink
                assert isinstance(sink, FederationDeltaSink)
                assert sink._client._target == ref._client._target
                for attr in ("_retries", "_backoff_initial",
                             "_backoff_max", "_timeout"):
                    assert getattr(sink, attr) == getattr(ref, attr)
            finally:
                ref.close()
            return
        if "SKETCH_MESH_SHAPE" in env:
            from netobserv_tpu_torch.parallel.merge import DistState
            assert exp.mesh.shape == {"data": 2, "sketch": 1}
            assert isinstance(exp.state, DistState)
            return
        assert isinstance(exp.ring, TenantStack)
        assert exp.ring.n_tenants == 2 and len(exp._tenant_query) == 2
    finally:
        exp.close()


def test_from_config_takes_the_card_unless_asked_for_the_cpu():
    import torch
    cfg = tcfg.load_config({**_SMALL_ENV, "SKETCH_DEVICES": ""})
    if torch.cuda.is_available():
        exp = TorchSketchExporter.from_config(cfg, sink=_discard)
        try:
            assert exp.device.type == "cuda"
        finally:
            exp.close()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        TorchSketchExporter.from_config(cfg, sink=_discard)


def test_from_config_takes_the_environments_batch_size():
    """SKETCH_BATCH_SIZE defaults to 8192 in the environment (the
    constructor's default is 16384): `from_config` takes the setting."""
    cfg = tcfg.load_config({"EXPORT": "tpu-sketch", "SKETCH_DEVICES": "cpu",
                            "SKETCH_CM_WIDTH": "1024", "SKETCH_TOPK": "64",
                            "SKETCH_WINDOW": "1h"})
    exp = TorchSketchExporter.from_config(cfg, sink=_discard)
    try:
        assert exp.batch_size == 8192 == jcfg.AgentConfig().sketch_batch_size
        assert exp.sink is _discard
    finally:
        exp.close()
