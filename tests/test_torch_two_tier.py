"""The two-tier deployment on the port, on the CPU: per-node agents
(EXPORT=grpc, a `FakeFetcher`) export over the port's gRPC transport to a
collector-tier worker (DATAPATH=grpc, `GrpcIngestFetcher`, EXPORT=
tpu-sketch on `device="cpu"`). The twins of tests/test_two_tier.py:24
(one agent into a worker) and :74 (two agents fanning in), which the
reference marks slow; these run in a few seconds each at the reference
test's small `SketchConfig` and B = 256.

The worker's evictions are recorded in the order they reach its sketch
exporter (gRPC arrival fixes that order), then replayed into the JAX
package's `TpuSketchExporter` of the same geometry, feed, lanes and
ladder (shown one of the CPU devices). The worker's pre-roll
`state_tables` equal the reference's bit for bit: every mass is an
integer and every cell's sum stays below 2^24, so no tolerance is
needed, the top-K table and heavy hitters included (they depend on the
batch order, which the replay keeps). The histograms are held to the
edge-move bound of tests/test_torch_staging.py (ROADMAP C5); these
events carry no RTT or DNS sample, so that bound is 0 here. The
published reports then carry every record, and the elephant flow heads
the heavy hitters, as the reference test requires.
"""

from __future__ import annotations

import threading
import time

import numpy as np

import tests.conftest  # noqa: F401
import jax
from netobserv_tpu.datapath import fetcher as jfetch
from netobserv_tpu.exporter.tpu_sketch import TpuSketchExporter
from netobserv_tpu.metrics import registry as jreg
from netobserv_tpu.sketch import state as js
from netobserv_tpu_torch import config as tcfg
from netobserv_tpu_torch.agent.agent import FlowsAgent
from netobserv_tpu_torch.datapath.fetcher import FakeFetcher
from netobserv_tpu_torch.datapath.grpc_ingest import GrpcIngestFetcher
from netobserv_tpu_torch.exporter import build_exporter
from netobserv_tpu_torch.exporter.torch_sketch import TorchSketchExporter
from netobserv_tpu_torch.model import binfmt
from netobserv_tpu_torch.sketch import state as ts
from tests.test_pipeline import make_events
from tests.test_torch_entry import (
    _assert_tables_from, _port_tables, _ref_tables,
)
from tests.test_torch_staging import _Samples

#: the reference test's geometry (tests/test_two_tier.py:31-34)
GEOM = dict(cm_depth=2, cm_width=1 << 10, hll_precision=6, perdst_buckets=32,
            perdst_precision=4, topk=16, hist_buckets=64, ewma_buckets=32)
FEED = dict(batch_size=256, pack_threads=2, superbatch=(1, 2),
            resident_slots=1 << 12)


class _Recorder:
    """Wraps the worker's `export_evicted`: each eviction's rows kept in
    the order they reached it, once its call has returned."""

    def __init__(self, exp):
        self.evictions: list = []
        self._export = exp.export_evicted
        exp.export_evicted = self

    def __call__(self, evicted):
        rows = (evicted.events.copy(),
                None if evicted.extra is None else evicted.extra.copy(),
                None if evicted.dns is None else evicted.dns.copy())
        self._export(evicted)
        self.evictions.append(rows)  # counted once it has folded


def _worker(reports: list):
    fetcher = GrpcIngestFetcher(0)
    cfg = tcfg.load_config({"EXPORT": "tpu-sketch",
                            "CACHE_ACTIVE_TIMEOUT": "150ms"})
    exp = TorchSketchExporter(ts.SketchConfig(**GEOM), window_s=3600.0,
                              device="cpu", sink=reports.append, **FEED)
    return FlowsAgent(cfg, fetcher, exp), _Recorder(exp)


def _agent(port: int) -> tuple[FlowsAgent, FakeFetcher]:
    cfg = tcfg.load_config({"EXPORT": "grpc", "TARGET_HOST": "127.0.0.1",
                            "TARGET_PORT": str(port),
                            "CACHE_ACTIVE_TIMEOUT": "100ms"})
    fake = FakeFetcher()
    return FlowsAgent(cfg, fake, build_exporter(cfg)), fake


def _rows_folded(recorder) -> int:
    return sum(len(e) for e, _, _ in recorder.evictions)


def _reference_tables(evictions):
    """The JAX exporter of the worker's settings, fed the same evictions
    in the same order; its pre-roll tables."""
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        jexp = TpuSketchExporter(
            window_s=3600.0, sketch_cfg=js.SketchConfig(**GEOM,
                                                        use_pallas=False),
            sink=lambda obj: None,
            metrics=jreg.Metrics(jreg.MetricsSettings()), feed="resident",
            **FEED)
    finally:
        jax.devices = devices
    try:
        for events, extra, dns in evictions:
            jexp.export_evicted(jfetch.EvictedFlows(events, extra=extra,
                                                    dns=dns))
        return _ref_tables(jexp)
    finally:
        jexp.close()


def _two_tier(feeds: list[list[np.ndarray]]) -> tuple:
    """Agents (one a feed) into one worker; the worker's pre-roll tables,
    its recorded evictions and its reports after a flush."""
    reports: list[dict] = []
    worker, recorder = _worker(reports)
    stop_w = threading.Event()
    tw = threading.Thread(target=worker.run, args=(stop_w,), daemon=True)
    tw.start()
    agents = []
    try:
        for feed in feeds:
            agent, fake = _agent(worker.fetcher.port)
            stop = threading.Event()
            t = threading.Thread(target=agent.run, args=(stop,),
                                 daemon=True)
            t.start()
            agents.append((stop, t))
            for events in feed:
                fake.inject_events(events)
        want = sum(len(e) for feed in feeds for e in feed)
        deadline = time.monotonic() + 20
        while _rows_folded(recorder) < want and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _rows_folded(recorder) == want
        tables = _port_tables(worker.exporter)
        worker.exporter.flush()
    finally:
        for stop, t in agents:
            stop.set()
            t.join(timeout=5)
        stop_w.set()
        tw.join(timeout=10)
    return tables, recorder.evictions, reports


def _check(tables, evictions, reports, n_records: int) -> None:
    samples = _Samples()
    for events, extra, dns in evictions:
        n = len(events)
        samples.add({"extra": extra if extra is not None
                     else np.zeros(n, binfmt.EXTRA_REC_DTYPE),
                     "dns": dns if dns is not None
                     else np.zeros(n, binfmt.DNS_REC_DTYPE)})
    _assert_tables_from(tables, _reference_tables(evictions), "two-tier",
                        samples)
    assert sum(r["Records"] for r in reports) == n_records


def test_agent_to_worker():
    """tests/test_two_tier.py:24: one agent sees an elephant and 20 mice."""
    feed = [make_events(1, sport0=7777, nbytes=900_000),
            make_events(20, nbytes=50)]
    tables, evictions, reports = _two_tier([feed])
    _check(tables, evictions, reports, 21)
    tops = [hh for r in reports for hh in r["HeavyHitters"]
            if hh["SrcPort"] == 7777]
    assert tops and tops[0]["EstBytes"] >= 900_000
    assert reports[0]["HeavyHitters"][0]["SrcPort"] == 7777


def test_two_agents_fan_in_to_one_worker():
    """tests/test_two_tier.py:74: node 0 sees 10 flows, node 1 sees 15
    (disjoint ports); the worker's sketch merges both streams."""
    feeds = [[make_events(10, sport0=10_000)],
             [make_events(15, sport0=20_000)]]
    tables, evictions, reports = _two_tier(feeds)
    _check(tables, evictions, reports, 25)
    ports = {hh["SrcPort"] for r in reports for hh in r["HeavyHitters"]}
    assert ports and ports <= set(range(10_000, 10_010)) | set(
        range(20_000, 20_015))
    fed = np.concatenate([e["key"]["src_port"] for e, _, _ in evictions])
    assert sorted(fed.tolist()) == list(range(10_000, 10_010)) + list(
        range(20_000, 20_015))
