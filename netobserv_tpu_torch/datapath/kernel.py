"""Kernel capability detection.

Reference analog: `pkg/kernel/kernel_utils.go` — uname-based version compare
driving the hook-pruning ladder (old kernels lose fentry/TCX/etc.) and
realtime-kernel detection.

The port's copy of `netobserv_tpu/datapath/kernel.py`, kept so that the
port imports nothing of the JAX package; each function names its
original by line.
"""

from __future__ import annotations

import functools
import os
import re

_VERSION_RE = re.compile(r"^(\d+)\.(\d+)(?:\.(\d+))?")


def version_code(release: str) -> int:
    """LINUX_VERSION_CODE-style comparable int from a release string.

    Reference: `netobserv_tpu/datapath/kernel.py:17`."""
    m = _VERSION_RE.match(release)
    if not m:
        return 0
    major, minor, patch = int(m.group(1)), int(m.group(2)), int(m.group(3) or 0)
    return (major << 16) | (minor << 8) | min(patch, 255)


@functools.lru_cache(maxsize=1)
def current_release() -> str:
    """Reference: `netobserv_tpu/datapath/kernel.py:27`."""
    return os.uname().release


def is_kernel_older_than(version: str, release: str | None = None) -> bool:
    """Reference: `netobserv_tpu/datapath/kernel.py:31`."""
    cur = version_code(release if release is not None else current_release())
    return cur != 0 and cur < version_code(version)


def is_realtime_kernel(release: str | None = None) -> bool:
    """-rt kernels need some hooks avoided (reference: `:100-125`).

    Reference: `netobserv_tpu/datapath/kernel.py:36`."""
    rel = release if release is not None else current_release()
    if "-rt" in rel:
        return True
    try:
        with open("/sys/kernel/realtime") as fh:
            return fh.read().strip() == "1"
    except OSError:
        return False


# capability ladder used by the loader (reference: tracer.go:164-173,1219+)
def supports_tcx(release: str | None = None) -> bool:
    """Reference: `netobserv_tpu/datapath/kernel.py:49`."""
    return not is_kernel_older_than("6.6", release)


def supports_fentry(release: str | None = None) -> bool:
    """Reference: `netobserv_tpu/datapath/kernel.py:53`."""
    return not is_kernel_older_than("5.7", release)


def supports_lookup_and_delete_batch(release: str | None = None) -> bool:
    """Reference: `netobserv_tpu/datapath/kernel.py:57`."""
    return not is_kernel_older_than("5.6", release)


def supports_ringbuf(release: str | None = None) -> bool:
    """Reference: `netobserv_tpu/datapath/kernel.py:61`."""
    return not is_kernel_older_than("5.8", release)
