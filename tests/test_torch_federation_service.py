"""The port's aggregator process (netobserv_tpu_torch/federation/
service.py `FederationAggregatorService`) against the JAX package's
(netobserv_tpu/federation/service.py), on the CPU: the twin of
tests/test_federation.py::TestAggregatorService.

Both services are built from one environment (SKETCH_DEVICES=cpu, small
CM and top-K, ports 0, a one-hour window, so windows close only by
`flush()` and `shutdown()`), started, and fed the same delta frames,
made by the reference's `federation.delta.encode_frame` from a JAX fold
(the delta wire is byte-identical), each over its own package's
`FederationDeltaSink` and gRPC collector. Then:

- `/federation/status` over HTTP and `health_snapshot()` agree (the
  agents' ages and the heartbeat ages left out);
- the published cluster reports agree field by field (floats to 1e-5
  relative, quantiles to one histogram bucket, `TimestampMs` left out);
- `shutdown()` publishes the last window, whose frame arrived after the
  flush, and leaves both services Stopped;
- the port's service refuses to start without CUDA unless
  SKETCH_DEVICES=cpu, as the agent does.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from netobserv_tpu import config as jconfig
from netobserv_tpu.exporter.federation import FederationDeltaSink as JSink
from netobserv_tpu.federation import delta as rdelta
from netobserv_tpu.federation.service import (
    FederationAggregatorService as JService,
)
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch import config as tconfig
from netobserv_tpu_torch.exporter.federation import FederationDeltaSink
from netobserv_tpu_torch.federation.service import (
    FederationAggregatorService,
)
from netobserv_tpu_torch.ops import quantile as tq
from netobserv_tpu_torch.sketch import state as ts
from tests.test_federation import make_arrays
from tests.test_torch_federation import _timeless_agents
from tests.test_torch_query_plane import _assert_report

ENV = {"SKETCH_CM_DEPTH": "3", "SKETCH_CM_WIDTH": "1024",
       "SKETCH_HLL_PRECISION": "8", "SKETCH_TOPK": "64",
       "FEDERATION_LISTEN_PORT": "0", "FEDERATION_QUERY_PORT": "0",
       "FEDERATION_WINDOW": "1h", "SKETCH_DEVICES": "cpu"}

#: (agent, window, seed) of each frame; the last arrives after the flush
FRAMES = (("svc-agent", 0, 0), ("svc-agent-2", 0, 1), ("svc-agent", 1, 2))


def _frames() -> list[bytes]:
    """The reference's fold and encoder at the services' geometry."""
    cfg = js.SketchConfig.from_agent_config(jconfig.load_config(ENV))
    roll = js.make_roll_fn(cfg, with_tables=True)
    universe = np.random.default_rng(1).integers(0, 2**32, (16, 10),
                                                 dtype=np.uint32)
    dims = {"cm_depth": cfg.cm_depth, "cm_width": cfg.cm_width,
            "hll_precision": cfg.hll_precision, "topk": cfg.topk,
            "ewma_buckets": cfg.ewma_buckets}
    out = []
    for agent, window, seed in FRAMES:
        s = js.ingest(js.init_state(cfg), make_arrays(
            np.random.default_rng(seed), universe))
        _, _, tables = roll(s)
        out.append(rdelta.encode_frame(
            {k: np.asarray(v) for k, v in tables.items()},
            agent_id=agent, window=window, ts_ms=0, dims=dims))
    return out


def _status(port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/federation/status", timeout=10) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def run():
    """Both services through one schedule; what each showed."""
    frames = _frames()
    seen = {}
    for name, service, sink_cls, cfg in (
            ("port", FederationAggregatorService, FederationDeltaSink,
             tconfig.load_config(ENV)),
            ("ref", JService, JSink, jconfig.load_config(ENV))):
        reports: list[dict] = []
        svc = service(cfg, sink=reports.append)
        svc.start()
        try:
            sink = sink_cls("127.0.0.1", svc.grpc_port)
            pushed = [sink(f) for f in frames[:2]]
            svc.aggregator.flush()
            started = (svc.health_snapshot(), _status(svc.query_port))
            pushed.append(sink(frames[2]))
            sink.close()
        finally:
            svc.shutdown()
        seen[name] = dict(reports=reports, pushed=pushed, started=started,
                          stopped=svc.health_snapshot())
    return seen


def test_frames_are_accepted_and_both_windows_publish(run):
    for side in ("port", "ref"):
        assert run[side]["pushed"] == [True] * 3, side
        assert len(run[side]["reports"]) == 2, side


def test_status_route_equals_the_reference(run):
    got, want = run["port"]["started"][1], run["ref"]["started"][1]
    assert got.keys() == want.keys()
    for k in want:
        if k == "agents":
            assert _timeless_agents(got[k]) == _timeless_agents(want[k])
            assert set(got[k]) == {"svc-agent", "svc-agent-2"}
        else:
            assert got[k] == want[k], k


def _stageless(h: dict) -> dict:
    return {**h, "stages": {n: {k: v for k, v in s.items()
                                if k != "heartbeat_age_s"}
                            for n, s in h["stages"].items()}}


def test_health_snapshot_equals_the_reference(run):
    for when in ("started", "stopped"):
        got = run["port"][when] if when == "stopped" else \
            run["port"][when][0]
        want = run["ref"][when] if when == "stopped" else \
            run["ref"][when][0]
        assert _stageless(got) == _stageless(want), when
        assert got["status"] == ("Started" if when == "started"
                                 else "Stopped")
    assert set(run["port"]["started"][0]["stages"]) == {"federation-window"}


@pytest.mark.parametrize("window", [0, 1])
def test_published_reports_equal_the_reference(run, window):
    """Window 0 closed by `flush()`, window 1 by `shutdown()`."""
    got = run["port"]["reports"][window]
    want = run["ref"]["reports"][window]
    gamma = tq.gamma_for(ts.SketchConfig.from_agent_config(
        tconfig.load_config(ENV)).hist_buckets)
    _assert_report(got, want, gamma)
    assert got["Records"] == want["Records"] > 0
    assert got["Agents"] == (["svc-agent", "svc-agent-2"] if window == 0
                             else ["svc-agent"])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the refusal needs a box without CUDA")
def test_refuses_to_start_without_cuda_unless_asked():
    cfg = tconfig.load_config({**ENV, "SKETCH_DEVICES": ""})
    with pytest.raises(RuntimeError, match="cuda"):
        FederationAggregatorService(cfg, sink=lambda r: None)
