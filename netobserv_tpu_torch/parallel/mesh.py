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

**Across processes** (`parallel/distributed.py` initialised with more
than one process): the global device list is each rank's local devices,
gathered in rank order once when the mesh is made (a collective: every
rank makes its meshes in the same order), so the data axis spans the
processes as the reference's `jax.devices()` does. Each grid cell knows
its owning rank (`Mesh.ranks`, JAX's `dev.process_index`), and
`addressable()` lists the cells this rank holds; a rank may hold none.
Another rank's device is only a label here. Two ranks may name one card
(`cuda:0` each): each holds its own cells on it. With one process
`ranks` is None and every cell is this process's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from netobserv_tpu_torch.parallel import distributed
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
    data shard d, sketch shard s. Across processes `ranks[d][s]` is the
    rank that holds it, `rank` this process's and `world` the process
    count (module docstring)."""

    devices: tuple
    ranks: Optional[tuple] = None
    rank: int = 0
    world: int = 1

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
    def multiprocess(self) -> bool:
        """Whether the mesh belongs to several processes (its roll then
        completes the merge across ranks)."""
        return self.world > 1

    def is_local(self, d: int, s: int) -> bool:
        """Whether this rank holds cell (d, s)."""
        return self.ranks is None or self.ranks[d][s] == self.rank

    def addressable(self) -> list[tuple[int, int]]:
        """The cells this rank holds, (data, sketch) in grid order."""
        return [(d, s) for d in range(self.data) for s in range(self.sketch)
                if self.is_local(d, s)]

    @property
    def first(self) -> torch.device:
        """The device the roll's merge runs on: this rank's first cell's."""
        d, s = self.addressable()[0]
        return self.devices[d][s]

    def distinct(self) -> list[torch.device]:
        """This rank's devices of the grid, each once, in grid order."""
        out: list[torch.device] = []
        for d, s in self.addressable():
            dev = self.devices[d][s]
            if dev not in out:
                out.append(dev)
        return out


def local_share(device: torch.device, spec: MeshSpec) -> list:
    """`device` repeated as this process's share of `spec`'s cells: all of
    them in one process, an even share of them across processes (a CPU
    mesh, SKETCH_DEVICES=cpu; join the process group first)."""
    n = spec.data * spec.sketch
    return [device] * -(-n // distributed.process_count())


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device (none on a box without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The (data, sketch) grid of `spec` over `devices` (default: every
    visible CUDA device; a caller's list may repeat one), across processes
    over every rank's devices in rank order (module docstring); no spec
    puts them all on the data axis. A spec that needs more devices than
    there are raises, naming both counts."""
    local = ([pick_device(d) for d in devices] if devices is not None
             else visible_devices())
    world = distributed.process_count()
    devs, owners = list(local), [0] * len(local)
    if world > 1:
        names = distributed.all_gather_object([str(d) for d in local])
        devs = [torch.device(n) for names_r in names for n in names_r]
        owners = [r for r, names_r in enumerate(names) for _ in names_r]
    spec = spec or MeshSpec(data=len(devs))
    n = spec.data * spec.sketch
    if spec.data < 1 or spec.sketch < 1:
        raise ValueError(f"mesh {spec} has an empty axis")
    if n > len(devs):
        raise ValueError(
            f"mesh {spec} needs {n} devices, have {len(devs)}")

    def grid(xs):
        return tuple(tuple(xs[d * spec.sketch + s]
                           for s in range(spec.sketch))
                     for d in range(spec.data))
    if world == 1:
        return Mesh(grid(devs))
    return Mesh(grid(devs), ranks=grid(owners),
                rank=distributed.process_index(), world=world)
