"""PacketsAgent: the PCA (packet capture) pipeline.

A copy of `netobserv_tpu/agent/packets_agent.py` (lines 1-122), whose
reference is `pkg/agent/packets_agent.go` — mutually exclusive with the
flow agent; packet ringbuf -> PerfTracer -> PerfBuffer -> gRPC pcap stream.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional, Protocol

from netobserv_tpu_torch.config import AgentConfig
from netobserv_tpu_torch.exporter.grpc_packets import GRPCPacketExporter
from netobserv_tpu_torch.flow.perf_buffer import PerfBuffer, PerfTracer
from netobserv_tpu_torch.model.packet_record import PacketRecord

log = logging.getLogger("netobserv_tpu_torch.agent.packets")


class PacketFetcher(Protocol):
    def read_packet(self, timeout_s: float) -> Optional[bytes]: ...

    def close(self) -> None: ...


class FakePacketFetcher:
    def __init__(self):
        self._q: "queue.Queue[bytes]" = queue.Queue()

    def inject(self, raw: bytes) -> None:
        self._q.put(raw)

    def read_packet(self, timeout_s: float) -> Optional[bytes]:
        try:
            return self._q.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def close(self) -> None:
        pass


class PacketsAgent:
    def __init__(self, cfg: AgentConfig, fetcher: PacketFetcher,
                 exporter=None):
        self.cfg = cfg
        self.fetcher = fetcher
        self.exporter = exporter or GRPCPacketExporter(
            cfg.target_host, cfg.target_port,
            tls_ca=cfg.target_tls_ca_cert_path,
            tls_cert=cfg.target_tls_user_cert_path,
            tls_key=cfg.target_tls_user_key_path)
        buf = cfg.buffers_length
        self._pkt_q: "queue.Queue[PacketRecord]" = queue.Queue(maxsize=buf * 10)
        self._batch_q: "queue.Queue[list[PacketRecord]]" = queue.Queue(maxsize=buf)
        self.tracer = PerfTracer(fetcher, self._pkt_q)
        self.buffer = PerfBuffer(self._pkt_q, self._batch_q,
                                 timeout_s=min(cfg.cache_active_timeout, 0.5))
        self._stop = threading.Event()
        self._export_thread: Optional[threading.Thread] = None
        if cfg.flow_filter_rules and hasattr(fetcher, "program_filters"):
            fetcher.program_filters(cfg.parsed_filter_rules())
        # kernel-backed packet fetchers attach per-interface like the flow
        # datapath; replay/fake fetchers skip discovery
        self.iface_listener = None
        if getattr(fetcher, "needs_iface_discovery", False):
            from netobserv_tpu_torch.agent.interfaces_listener import (
                InterfaceListener,
            )
            self.iface_listener = InterfaceListener(cfg, fetcher)

    def run(self, stop: Optional[threading.Event] = None) -> None:
        self._export_thread = threading.Thread(
            target=self._export_loop, name="packet-export", daemon=True)
        self._export_thread.start()
        if self.iface_listener is not None:
            self.iface_listener.start()
        self.buffer.start()
        self.tracer.start()
        self._active_stop = stop = stop or self._stop
        stop.wait()
        self.shutdown()

    def stop(self) -> None:
        self._stop.set()
        active = getattr(self, "_active_stop", None)
        if active is not None:
            active.set()

    def shutdown(self) -> None:
        if self.iface_listener is not None:
            self.iface_listener.stop()
        self.tracer.stop()
        self.buffer.stop()
        self._stop.set()
        if self._export_thread:
            self._export_thread.join(timeout=2.0)
        # drain remaining batches
        while True:
            try:
                self.exporter.export_packets(self._batch_q.get_nowait())
            except queue.Empty:
                break
            except Exception as exc:
                log.error("final packet export failed: %s", exc)
                break
        self.exporter.close()
        self.fetcher.close()

    def _export_loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._batch_q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.exporter.export_packets(batch)
            except Exception as exc:
                log.error("packet export failed: %s", exc)
