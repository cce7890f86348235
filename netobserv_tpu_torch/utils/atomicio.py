"""Atomic small-file writes for the checkpoint/archive sidecar family.

A copy of `netobserv_tpu/utils/atomicio.py` (`fsync_dir`,
`write_bytes_atomic`, `write_json_atomic`), kept here because the port
imports nothing of the JAX package.

Every JSON sidecar the persistence planes keep next to their tensor data —
the checkpoint format stamp (``FORMAT.json``), the per-step ledger
sidecars (``META-<step>.json``), the publish-commit marker
(``PUBLISHED.json``) and the archive manifest (``MANIFEST.json``) — is a
tiny file whose TORN state is worse than its absent state: a crash
mid-write used to be able to leave half a JSON object that poisons the
next restore (the readers treat unparseable as absent, but a torn file
that still parses — e.g. truncated inside a string that happens to close —
would silently lie).

The discipline here is the classic write-temp + flush + fsync + rename:
after `os.replace` the path holds either the complete old bytes or the
complete new bytes, never a mix, even across power loss (the fsync orders
the data before the rename on journaling filesystems; the best-effort
directory fsync orders the rename itself). One helper, used by every
sidecar writer — new sidecar kinds must not re-grow unfsynced copies.
"""

from __future__ import annotations

import json
import os
from typing import Any


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a DIRECTORY (persists a rename). Platforms or
    filesystems that refuse directory fds just skip — the data-file fsync
    already happened, so the worst case is the pre-rename name surviving a
    power loss, which every sidecar reader treats as absent."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes_atomic(path: str, data: bytes) -> None:
    """Atomically replace `path` with `data` (temp + fsync + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


def write_json_atomic(path: str, obj: Any) -> None:
    """Atomically replace `path` with `obj` serialized as compact JSON."""
    write_bytes_atomic(
        path, json.dumps(obj, separators=(",", ":")).encode())
