"""TC/TCX attachment of BPF programs.

Reference analog: the attach half of `pkg/tracer/tracer.go:431-598` — TCX
bpf_link attachment (with EEXIST adoption of an existing link) and a legacy
TC clsact/filter path, selected by TC_ATTACH_MODE (tcx | tc | any, reference
`pkg/agent/interfaces_listener.go:104-113`):

- **tcx**: BPF_LINK_CREATE on the interface's TCX hook (kernel >= 6.6) via
  raw bpf(2) — link-fd lifetime IS the attachment; no qdisc involved; other
  TCX programs on the hook keep running (mprog chain).
- **tc**: clsact qdisc + filter through the iproute2 `tc` binary (the path
  operators can replay by hand), with stale-filter cleanup between runs.
- **any**: try tcx, fall back to tc on kernels without TCX.

The port's copy of `netobserv_tpu/datapath/tc_attach.py`, kept so that
the port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

import errno
import logging
import os
import subprocess
from dataclasses import dataclass

log = logging.getLogger("netobserv_tpu_torch.datapath.tc")


class TcError(RuntimeError):
    """Reference: `netobserv_tpu/datapath/tc_attach.py:27`."""
    pass


@dataclass
class Attachment:
    """One live attachment; `kind` is "tcx" (link_fd valid) or "tc".

    Reference: `netobserv_tpu/datapath/tc_attach.py:32`."""

    kind: str
    if_name: str
    if_index: int
    direction: str
    link_fd: int = -1
    priority: int = 0

    def detach(self) -> None:
        """Reference: `netobserv_tpu/datapath/tc_attach.py:42`."""
        if self.kind == "tcx":
            try:
                os.close(self.link_fd)  # closing the bpf_link detaches
            except OSError:
                pass
        else:
            detach(self.if_name, self.direction, self.priority)


def attach_tcx(prog_fd: int, if_name: str, if_index: int,
               direction: str) -> Attachment:
    """TCX bpf_link attach with EEXIST adoption (reference
    tracer.go:454-488).

    Reference: `netobserv_tpu/datapath/tc_attach.py:52`."""
    from netobserv_tpu_torch.datapath import syscall_bpf

    try:
        fd = syscall_bpf.link_create_tcx(prog_fd, if_index, direction)
        log.info("TCX link attached to %s %s (link fd %d)", if_name,
                 direction, fd)
        return Attachment("tcx", if_name, if_index, direction, link_fd=fd)
    except OSError as exc:
        if exc.errno != errno.EEXIST:
            raise
        # this exact program is already in the hook's mprog chain (previous
        # instance / listener retry): adopt the existing link
        pid = syscall_bpf.prog_id_of(prog_fd)
        fd = syscall_bpf.find_tcx_link(if_index, direction, prog_id=pid)
        if fd is None:
            raise TcError(
                f"TCX attach to {if_name} {direction} returned EEXIST but "
                "no matching link found to adopt") from exc
        log.info("adopted existing TCX link on %s %s (link fd %d)", if_name,
                 direction, fd)
        return Attachment("tcx", if_name, if_index, direction, link_fd=fd)


def attach_mode(prog_fd: int, pin_path: str, if_name: str, if_index: int,
                direction: str, mode: str = "tcx", priority: int = 1,
                pre_legacy=None) -> Attachment:
    """Attach per TC_ATTACH_MODE: tcx | tc | any (try tcx, fall back).

    `pre_legacy` (optional callable) runs immediately before a legacy tc
    attach — the hook for once-per-interface stale clsact cleanup. It is NOT
    invoked when the TCX path succeeds, so third-party clsact state survives
    on TCX-capable kernels.

    Reference: `netobserv_tpu/datapath/tc_attach.py:79`."""
    if mode not in ("tcx", "tc", "any"):
        raise ValueError(f"unknown TC_ATTACH_MODE {mode!r}")
    if mode in ("tcx", "any"):
        try:
            return attach_tcx(prog_fd, if_name, if_index, direction)
        except OSError as exc:
            if mode == "tcx":
                raise
            log.info("TCX unavailable on %s (%s); falling back to legacy tc",
                     if_name, exc)
    if pre_legacy is not None:
        pre_legacy()
    attach_pinned(if_name, direction, pin_path, priority=priority)
    return Attachment("tc", if_name, if_index, direction, priority=priority)


def _tc(*args: str) -> str:
    """Reference: `netobserv_tpu/datapath/tc_attach.py:104`."""
    res = subprocess.run(["tc", *args], capture_output=True, text=True,
                         timeout=10)
    if res.returncode != 0:
        raise TcError(f"tc {' '.join(args)}: {res.stderr.strip()}")
    return res.stdout


def ensure_clsact(ifname: str) -> None:
    """Create the clsact qdisc if absent (idempotent).

    Reference: `netobserv_tpu/datapath/tc_attach.py:112`."""
    try:
        _tc("qdisc", "add", "dev", ifname, "clsact")
    except TcError as exc:
        if "Exclusivity flag on" not in str(exc) and "File exists" not in str(exc):
            raise


def attach_pinned(ifname: str, direction: str, pin_path: str,
                  priority: int = 1) -> None:
    """Attach a pinned classifier at <direction> (ingress|egress).

    Reference: `netobserv_tpu/datapath/tc_attach.py:121`."""
    ensure_clsact(ifname)
    _tc("filter", "add", "dev", ifname, direction, "prio", str(priority),
        "bpf", "object-pinned", pin_path, "direct-action")
    log.info("attached %s to %s %s", pin_path, ifname, direction)


def detach(ifname: str, direction: str, priority: int = 1) -> None:
    """Reference: `netobserv_tpu/datapath/tc_attach.py:130`."""
    _tc("filter", "del", "dev", ifname, direction, "prio", str(priority))


def remove_clsact(ifname: str) -> None:
    """Remove the clsact qdisc (drops all our filters with it) — the stale
    cleanup used between agent restarts.

    Reference: `netobserv_tpu/datapath/tc_attach.py:134`."""
    try:
        _tc("qdisc", "del", "dev", ifname, "clsact")
    except TcError:
        pass


def list_filters(ifname: str, direction: str) -> str:
    """Reference: `netobserv_tpu/datapath/tc_attach.py:143`."""
    return _tc("filter", "show", "dev", ifname, direction)
