"""Env-gated fault-injection seam for the chaos harness.

A copy of `netobserv_tpu/utils/faultinject.py` (the whole module, lines
1-176), a registry of its own: arming a point of the JAX package never
arms the port's point of the same name, and the reverse.

Named fault points sit at STAGE BOUNDARIES (one per loop iteration / batch,
never per record): a stage loop calls ``fire("sketch.window_roll")`` and,
when that point is armed, the call raises, hangs, delays, or corrupts a
payload. Disarmed (the default, and always when ``FAULT_POINTS`` is unset)
a fire is a single module-bool check and an immediate return — zero
allocations, no locks, nothing on the fold path.

The port's points: ``sketch.ingest`` (the exporter's fold, inside its
containment), ``sketch.staging_wait`` (a staging ring's slot wait),
``sketch.window_timer``, ``sketch.window_roll`` and
``sketch.window_publish`` (the window thread), ``sketch.query_snapshot``
(a snapshot publish, inside its own containment), ``alerts.evaluate`` (the
alert engine's evaluation), ``alerts.sink`` (each delivery attempt of
an alert sink), ``sketch.delta_export`` (the exporter's delta frame
encode, inside its own containment), ``federation.delta_ingest`` (each
frame the aggregator receives, before its decode) and
``federation.window_timer`` and ``federation.window_roll`` (the
aggregator's window thread), ``federation.checkpoint`` (the aggregator's
checkpoint write, inside its own containment) and
``sketch.archive_write`` (an archive segment write of the exporter or the
aggregator, inside its own containment).

Arming:

- env: ``FAULT_POINTS="sketch.window_roll:crash;sketch.ingest:delay:0.05"``
  parsed once at import (and re-parsed by :func:`configure`). Spec grammar
  per point: ``name:action[:arg[:times]]``, points separated by ``;``.
- tests: :func:`arm`/:func:`clear`.

Actions:

- ``crash``        raise :class:`FaultInjected` at the point.
- ``hang``         block until the point is cleared (or ``arg`` seconds
                   elapse, if given), then raise SystemExit — a supervisor
                   that already replaced the hung thread must not get a
                   zombie double-processing its queue when the chaos test
                   releases it (SystemExit dies silently in a thread).
- ``delay``        sleep ``arg`` seconds, then continue normally.
- ``corrupt``      return a mangled copy of the payload (bytes are
                   truncated+bit-flipped; other payloads pass through).

Every trigger is counted in :data:`hits` so a chaos test can assert the
point actually fired.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Optional

log = logging.getLogger("netobserv_tpu_torch.faultinject")

_ACTIONS = ("crash", "hang", "delay", "corrupt")


class FaultInjected(RuntimeError):
    """Raised by an armed crash/hang fault point."""


class _Fault:
    __slots__ = ("name", "action", "arg", "times", "released")

    def __init__(self, name: str, action: str, arg: float = 0.0,
                 times: Optional[int] = None):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(one of {_ACTIONS})")
        self.name = name
        self.action = action
        self.arg = arg
        self.times = times  # None = unlimited
        self.released = threading.Event()  # hang release


# the hot-path gate: `_armed` is False whenever `_faults` is empty, so a
# disarmed fire() is one attribute load + one branch
_faults: dict[str, _Fault] = {}
_armed = False
_lock = threading.Lock()
hits: dict[str, int] = {}
#: hang faults currently blocking a thread; clear() releases them even
#: after a bounded-`times` hang was already popped from `_faults`
_hanging: list[_Fault] = []


def arm(name: str, action: str, arg: float = 0.0,
        times: Optional[int] = None) -> None:
    """Arm fault point `name`. `times` bounds the trigger count (e.g.
    ``times=1`` crashes a stage once and lets its restart run clean)."""
    global _armed
    with _lock:
        _faults[name] = _Fault(name, action, arg, times)
        _armed = True


def clear(name: Optional[str] = None) -> None:
    """Disarm one point (or all). Hung fire() calls are released."""
    global _armed
    with _lock:
        targets = [name] if name is not None else list(_faults)
        for n in targets:
            f = _faults.pop(n, None)
            if f is not None:
                f.released.set()
        # also release in-flight hangs (a bounded-`times` hang was already
        # popped from _faults at fire time but is still blocking a thread)
        for f in list(_hanging):
            if name is None or f.name == name:
                f.released.set()
                _hanging.remove(f)
        _armed = bool(_faults)


def configure(spec: Optional[str] = None) -> None:
    """(Re)parse a FAULT_POINTS spec string; None reads the env var."""
    clear()
    spec = os.environ.get("FAULT_POINTS", "") if spec is None else spec
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(f"bad FAULT_POINTS entry {part!r} "
                             "(want name:action[:arg[:times]])")
        name, action = bits[0], bits[1]
        arg = float(bits[2]) if len(bits) > 2 and bits[2] else 0.0
        times = int(bits[3]) if len(bits) > 3 else None
        arm(name, action, arg, times)
    if _faults:
        log.warning("fault injection ARMED: %s", ", ".join(sorted(_faults)))


def armed(name: str) -> bool:
    return _armed and name in _faults


def fire(name: str, payload: Any = None) -> Any:
    """The stage-boundary hook. Returns `payload` (possibly corrupted)."""
    if not _armed:  # the always-on cost: one load, one branch
        return payload
    with _lock:
        fault = _faults.get(name)
        if fault is None:
            return payload
        hits[name] = hits.get(name, 0) + 1
        if fault.action == "hang":
            _hanging.append(fault)
        if fault.times is not None:
            fault.times -= 1
            if fault.times <= 0:
                # exhausted: disarm, but DON'T release — a bounded hang
                # stays hung until clear() (that is its whole point)
                _faults.pop(name, None)
                _refresh_armed_locked()
    return _trigger(name, fault, payload)


def _refresh_armed_locked() -> None:
    global _armed
    _armed = bool(_faults)


def _trigger(name: str, fault: _Fault, payload: Any) -> Any:
    if fault.action == "crash":
        raise FaultInjected(f"injected crash at {name}")
    if fault.action == "hang":
        # block until clear() (or the optional bound); then die SILENTLY —
        # by release time the supervisor has usually replaced this thread,
        # and a zombie resuming its loop would double-process the queue
        # (threading swallows SystemExit without a traceback)
        fault.released.wait(timeout=fault.arg or None)
        raise SystemExit(f"injected hang at {name} released")
    if fault.action == "delay":
        time.sleep(fault.arg)
        return payload
    # corrupt
    if isinstance(payload, (bytes, bytearray)) and len(payload):
        mangled = bytearray(payload[:max(1, len(payload) // 2)])
        mangled[0] ^= 0xFF
        return bytes(mangled)
    return payload


# arm from the environment at import; unset -> nothing armed, fire() stays
# on the one-branch path
if os.environ.get("FAULT_POINTS"):
    configure()
