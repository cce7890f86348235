"""Mesh construction: a (data, sketch) grid of `torch.device`s.

Counterpart of `netobserv_tpu/parallel/mesh.py` (`DATA_AXIS`,
`SKETCH_AXIS`, `MeshSpec`, `make_mesh`). Axes:

- `data`: batch sharding; each shard folds its rows into a partial sketch
  of its own (the per-CPU map's counterpart);
- `sketch`: width sharding of the Count-Min planes by key ownership.

`make_mesh` takes every visible CUDA device unless the caller names the
devices. Only a list the caller passes may repeat a device (`["cuda:0"] *
4`, `["cpu"] * 8`): that is how a mesh runs on one card or on the CPU.
The reference's `shard_map_compat` has no counterpart: the port loops
over the grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from netobserv_tpu_torch.utils.platform import pick_device

DATA_AXIS = "data"
SKETCH_AXIS = "sketch"


@dataclass(frozen=True)
class MeshSpec:
    data: int
    sketch: int = 1

    @classmethod
    def parse(cls, text: str, n_devices: int) -> "MeshSpec":
        """Parse "4", "4x2", or "" (all devices on data axis)."""
        if not text:
            return cls(data=n_devices)
        parts = [int(p) for p in text.lower().split("x")]
        if len(parts) == 1:
            return cls(data=parts[0])
        if len(parts) == 2:
            return cls(data=parts[0], sketch=parts[1])
        raise ValueError(f"bad mesh shape {text!r} (want D or DxS)")


@dataclass(frozen=True)
class Mesh:
    """A (data, sketch) grid of devices: `devices[d][s]` holds the state of
    data shard d, sketch shard s."""

    devices: tuple

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's `shape`."""
        return {DATA_AXIS: len(self.devices),
                SKETCH_AXIS: len(self.devices[0])}

    @property
    def data(self) -> int:
        return len(self.devices)

    @property
    def sketch(self) -> int:
        return len(self.devices[0])

    @property
    def first(self) -> torch.device:
        """The device the roll's merge runs on."""
        return self.devices[0][0]

    def distinct(self) -> list[torch.device]:
        """The grid's devices, each once, in grid order."""
        out: list[torch.device] = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return out


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device (none on a box without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The (data, sketch) grid of `spec` over `devices` (default: every
    visible CUDA device; a caller's list may repeat one). A spec that
    needs more devices than it is given raises, naming both counts."""
    devs = ([pick_device(d) for d in devices] if devices is not None
            else visible_devices())
    spec = spec or MeshSpec(data=len(devs))
    n = spec.data * spec.sketch
    if spec.data < 1 or spec.sketch < 1:
        raise ValueError(f"mesh {spec} has an empty axis")
    if n > len(devs):
        raise ValueError(
            f"mesh {spec} needs {n} devices, have {len(devs)}")
    return Mesh(tuple(tuple(devs[d * spec.sketch + s]
                            for s in range(spec.sketch))
                      for d in range(spec.data)))
