"""stdout exporter: JSON flow lines, the smoke-test surface.

A copy of `netobserv_tpu/exporter/stdout_json.py` (lines 1-27): one
`Record.to_json_obj` a line, compact separators, flushed a batch.
(EXPORT=direct-flp writes FLP's field naming instead: `direct_flp.py`.)
"""

from __future__ import annotations

import json
import sys
from typing import IO, Optional

from netobserv_tpu_torch.exporter.base import Exporter
from netobserv_tpu_torch.model.record import Record


class StdoutJSONExporter(Exporter):
    """`StdoutJSONExporter` (`stdout_json.py:17-27`)."""

    name = "stdout"

    def __init__(self, stream: Optional[IO[str]] = None, metrics=None):
        self._stream = stream if stream is not None else sys.stdout

    def export_batch(self, records: list[Record]) -> None:
        for r in records:
            self._stream.write(
                json.dumps(r.to_json_obj(), separators=(",", ":")) + "\n")
        self._stream.flush()
