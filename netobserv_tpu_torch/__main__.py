"""`python -m netobserv_tpu_torch`: the port's agent process.

After `netobserv_tpu/__main__.py` (lines 19-95): zero flags, every setting
from the environment (`config.load_config`). It sets up logging, starts
the debug server on PPROF_ADDR (`server/debug.py`), builds the agent
(`agent.FlowsAgent.from_config`) and, under METRICS_ENABLE, the metrics
server with the agent's health (`/healthz`, `/readyz`) and the sketch
exporter's `/query/*` routes, then runs the agent until SIGTERM or SIGINT,
which stop it: the map tracer's final eviction, the limiter's and the
terminal's drain, and the exporter's last window. It exits 0 then. With
no DATAPATH the agent takes the reference's ladder
(`agent.build_fetcher`): the clang-built object through libbpf, else the
hand-assembled kernel datapath, else synthetic replay with a warning, so
a host without bpf(2) still starts.

ENABLE_PCA runs the packets agent instead (`agent/packets_agent.py`,
`netobserv_tpu/__main__.py:43-62`): TARGET_HOST and TARGET_PORT (or
PCA_SERVER_PORT) name the packet collector, `DATAPATH=pcap:<file>`
replays a pcap file's frames (`datapath/replay.PcapPacketFetcher`) and
anything else takes `datapath/loader.load_packet_fetcher`. It keeps no
metrics, so no metrics server starts for it, as in the reference.

FEDERATION_MODE=aggregator runs the aggregator tier instead
(`federation/service.FederationAggregatorService`,
`netobserv_tpu/__main__.py:36-42`): the Federation gRPC collector on
FEDERATION_LISTEN_PORT, the device merge and cluster window, and the
query surface on FEDERATION_QUERY_PORT; no datapath and no flow
pipeline. Its metrics server serves its health and no `/query/*`
routes, since it has none. DATAPATH=grpc:<port> makes a flow agent the
collector-tier worker (`agent.build_fetcher`).

A `ValueError` or `RuntimeError` while the agent is built exits 2 with
the message on the log: among them ENABLE_PCA without its target and
DATAPATH=kernel on a host that is not root; DATAPATH=kernel where bpf(2)
fails raises its `OSError`, as the reference's does. The sketch exporter
and the aggregator fold on the card; SKETCH_DEVICES=cpu runs them on the
CPU, and without CUDA they refuse to start unless asked so. The record
exporters (EXPORT=grpc, the
DaemonSet's and the default, stdout, ipfix+udp, ipfix+tcp, kafka and
direct-flp, the embedded flowlogs-pipeline) and the packets agent need
no card.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading

from netobserv_tpu_torch.config import load_config

log = logging.getLogger("netobserv_tpu_torch")


def _packets_agent(cfg):
    """The ENABLE_PCA agent (`netobserv_tpu/__main__.py:43-62`)."""
    import os

    if not cfg.target_host or not cfg.target_port:
        raise ValueError(
            "ENABLE_PCA: TARGET_HOST and TARGET_PORT (or "
            "PCA_SERVER_PORT) are required")
    from netobserv_tpu_torch.agent.packets_agent import PacketsAgent
    mode = os.environ.get("DATAPATH", "auto")
    if mode.startswith("pcap:"):
        from netobserv_tpu_torch.datapath.replay import PcapPacketFetcher
        fetcher = PcapPacketFetcher(mode[5:])
    else:
        # self-managed kernel capture: the clang object or the
        # hand-assembled PCA program, verifier-loaded
        from netobserv_tpu_torch.datapath.loader import load_packet_fetcher
        fetcher = load_packet_fetcher(cfg)
    return PacketsAgent(cfg, fetcher)


def main() -> int:
    cfg = load_config()
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        stream=sys.stderr)
    log.info("starting the netobserv_tpu_torch agent (export=%s)",
             cfg.export)

    dbg = None
    if cfg.pprof_addr:
        from netobserv_tpu_torch.server.debug import start_debug_server
        dbg = start_debug_server(cfg.pprof_addr)

    try:
        if cfg.federation_mode == "aggregator":
            from netobserv_tpu_torch.federation.service import (
                FederationAggregatorService,
            )
            agent = FederationAggregatorService(cfg)
        elif cfg.enable_pca:
            agent = _packets_agent(cfg)
        else:
            from netobserv_tpu_torch.agent import FlowsAgent
            agent = FlowsAgent.from_config(cfg)
    except (ValueError, RuntimeError) as exc:
        log.error("invalid configuration: %s", exc)
        if dbg is not None:
            dbg.shutdown()
        return 2

    srv = None
    metrics = getattr(agent, "metrics", None)
    if cfg.metrics_enable and metrics is not None:
        from netobserv_tpu_torch.metrics.server import start_metrics_server
        srv = start_metrics_server(
            metrics.registry, cfg.metrics_server_address,
            cfg.metrics_server_port, cfg.metrics_tls_cert_path,
            cfg.metrics_tls_key_path,
            health_source=getattr(agent, "health_snapshot", None),
            query_routes=getattr(agent, "query_routes", None))

    stop = threading.Event()

    def _terminate(signum, _frame):
        log.info("received %s, stopping agent", signal.Signals(signum).name)
        stop.set()

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    agent.run(stop)
    if srv is not None:
        srv.shutdown()
    if dbg is not None:
        dbg.shutdown()
    log.info("agent stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
