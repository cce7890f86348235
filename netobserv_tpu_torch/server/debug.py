"""Debug HTTP endpoints (the pprof analog).

Counterpart of `netobserv_tpu/server/debug.py` (`_threads_dump`,
`_tracemalloc_dump`, `_gc_dump`, `_traces_dump`, `_executables_dump`,
`_jax_dump`, `start_debug_server`, `:1-184`). Routes (GET):

- ``/debug/threads``      a stack dump of every live thread;
- ``/debug/tracemalloc``  the top host allocation sites (the first hit
                          starts tracemalloc);
- ``/debug/gc``           gc counters and the commonest live object types;
- ``/debug/traces``       the flight recorder (`utils/tracing.snapshot`;
                          ``?limit=`` caps, ``?trace=`` picks one trace);
- ``/debug/executables``  the compile watch (`utils/retrace.snapshot`):
                          each captured fold's calls, host seconds,
                          captures and retraces;
- ``/debug/torch``        the counterpart of ``/debug/jax``: the torch
                          version, whether CUDA is available and
                          initialised, the device name and count and
                          `memory_allocated` / `memory_reserved` of each
                          device once CUDA is initialised, the captured
                          graphs and the compile watch. It reads CUDA state
                          only where the process already initialised CUDA,
                          so touching it never initialises CUDA on a CPU
                          exporter.

Every route is host work: none launches device work.
"""

from __future__ import annotations

import gc
import io
import json
import logging
import sys
import threading
import traceback
import tracemalloc
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("netobserv_tpu_torch.server.debug")

_JSON = "application/json"
_TEXT = "text/plain; charset=utf-8"


def _threads_dump(q=None) -> str:
    out = io.StringIO()
    frames = sys._current_frames()
    for t in threading.enumerate():
        out.write(f"--- thread {t.name} (daemon={t.daemon})\n")
        frame = frames.get(t.ident)
        if frame is not None:
            traceback.print_stack(frame, file=out)
        out.write("\n")
    return out.getvalue()


def _tracemalloc_dump(q=None, top: int = 25) -> str:
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return "tracemalloc started; hit this endpoint again for a snapshot\n"
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    return "".join(f"{s.size / 1024:.1f} KiB  {s.count} blocks  "
                   f"{s.traceback}\n" for s in stats)


def _gc_dump(q=None) -> str:
    counts = Counter(type(o).__name__ for o in gc.get_objects())
    lines = [f"gc counts: {gc.get_count()} thresholds: {gc.get_threshold()}\n"]
    lines += [f"{n:>10}  {name}\n" for name, n in counts.most_common(40)]
    return "".join(lines)


def _traces_dump(q=None) -> str:
    from netobserv_tpu_torch.utils import tracing

    q = q or {}
    limit = None
    if q.get("limit"):
        try:
            limit = max(0, int(q["limit"]))
        except ValueError:
            limit = None
    return json.dumps({
        "sampling_enabled": tracing.enabled(),
        "traces": tracing.snapshot(limit=limit, trace_id=q.get("trace")),
    }, separators=(",", ":"))


def _executables_dump(q=None) -> str:
    from netobserv_tpu_torch.utils import retrace

    return json.dumps({
        "executables": retrace.snapshot(),
        "retraces_total": retrace.total_retraces(),
    }, separators=(",", ":"))


def _torch_dump(q=None) -> str:
    import torch

    from netobserv_tpu_torch.utils import retrace

    out: dict = {"torch": torch.__version__,
                 "cuda_version": torch.version.cuda}
    try:
        out["cuda_available"] = torch.cuda.is_available()
        out["cuda_initialized"] = torch.cuda.is_initialized()
        if out["cuda_initialized"]:
            n = torch.cuda.device_count()
            out["device_count"] = n
            out["devices"] = [{
                "name": torch.cuda.get_device_name(i),
                "memory_allocated": torch.cuda.memory_allocated(i),
                "memory_reserved": torch.cuda.memory_reserved(i),
            } for i in range(n)]
    except Exception as exc:  # the debug surface answers on a broken driver
        out["error"] = str(exc)
    watch = retrace.snapshot()
    out["captured_graphs"] = sum(w["compiles"] for w in watch)
    out["retrace_watchdog"] = watch
    out["retraces_total"] = retrace.total_retraces()
    return json.dumps(out, separators=(",", ":"))


#: route -> (handler, content type, one-line description for the index)
_ROUTES = {
    "/debug/threads": (
        _threads_dump, _TEXT,
        "stack dump of every live thread"),
    "/debug/tracemalloc": (
        _tracemalloc_dump, _TEXT,
        "top host allocation sites (first hit arms tracemalloc)"),
    "/debug/gc": (
        _gc_dump, _TEXT,
        "gc counters and the most common live object types"),
    "/debug/traces": (
        _traces_dump, _JSON,
        "flight recorder: last completed fold/window traces, newest "
        "first, with per-stage durations (TRACE_SAMPLE; ?limit= caps, "
        "?trace= single-trace lookup)"),
    "/debug/executables": (
        _executables_dump, _JSON,
        "compile watch: each captured fold's calls, host seconds, "
        "captures and retraces"),
    "/debug/torch": (
        _torch_dump, _JSON,
        "torch and CUDA state (devices and memory once CUDA is "
        "initialised), captured graphs and the compile watch"),
}


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        url = urlparse(self.path)
        path = url.path
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if path in ("/", "/debug", "/debug/"):
            body = "".join(f"{route:<22} {desc}\n"
                           for route, (_fn, _ct, desc)
                           in sorted(_ROUTES.items()))
            ctype = _TEXT
        elif path in _ROUTES:
            fn, ctype, _desc = _ROUTES[path]
            body = fn(q)
        else:
            self.send_error(404)
            return
        payload = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):
        log.debug("debug http: " + fmt, *args)


def start_debug_server(addr: str) -> ThreadingHTTPServer:
    """Start the server on a daemon thread and return it. `addr` is
    "host:port" or ":port" (port 0 takes an ephemeral one,
    `server_address[1]`); stop it with `shutdown()` and `server_close()`."""
    host, _, port = addr.rpartition(":")
    srv = ThreadingHTTPServer((host or "0.0.0.0", int(port)), _Handler)
    t = threading.Thread(target=srv.serve_forever, name="debug-http",
                         daemon=True)
    t.start()
    log.info("debug server on %s:%d", host or "0.0.0.0",
             srv.server_address[1])
    return srv
