"""Multi-process initialization of the mesh, and the collectives its roll
needs.

Counterpart of `netobserv_tpu/parallel/distributed.py`
(`maybe_initialize_distributed`, `:35-79`). The reference runs one SPMD
program over every host's chips: `jax.distributed` wires the processes and
the mesh spans every device. Here the processes join one
`torch.distributed` process group, the mesh gathers each rank's devices in
rank order (`parallel/mesh.make_mesh`), every rank folds its own shards
with no cross-process call, and the roll completes the merge across ranks
with the collectives below (`parallel/merge.merge_states`).

Environment (the reference's contract):

    SKETCH_COORDINATOR   host:port of rank 0 (the rendezvous)
    SKETCH_NUM_PROCESSES total process count
    SKETCH_PROCESS_ID    this process's rank

The federation aggregator passes `prefixes=("FEDERATION_", "SKETCH_")`:
the first prefix whose COORDINATOR is set wins, and the other two
variables come from that prefix only, so an agent (which keeps the
default) never joins the aggregator's group on a shared node.

Differences from the reference (ROADMAP C5):

- A second configured call in one process returns True and does not init
  again (`jax.distributed.initialize` raises instead): a caller that names
  the backend can init before the exporter makes its own call.
- The backend follows the rank's devices, or the caller's `backend`: NCCL
  for CUDA devices (after `torch.cuda.set_device` on the first), gloo for
  the CPU; a mixed set raises. NCCL refuses two ranks on one card, so two
  ranks that share a card name gloo. The backend never changes because
  something failed: an init that fails raises.
- The reference's TPU pod auto-detection (`TPU_WORKER_HOSTNAMES`,
  `:67-77`) names a TPU scheduler and has no counterpart.

Both backends take the device tensors as they are: gloo copies a CUDA
tensor through the host itself (all-reduce, all-gather and the object
gather were each checked on CUDA tensors of two gloo ranks sharing one
H100; PERF.md), NCCL reduces on the device.

Only this module imports `torch.distributed`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger("netobserv_tpu_torch.parallel.distributed")

BACKENDS = ("gloo", "nccl")
#: every rank's device count summed, gathered at init (None before)
_global_devices: Optional[int] = None


def _resolve_env(prefixes: tuple[str, ...]) -> tuple[str, str, str, str]:
    """(prefix, coordinator, process count, process id) of the first
    prefix with COORDINATOR set (else the last prefix's, all empty); the
    reference's two `ValueError`s on a partial configuration."""
    prefix = next((p for p in prefixes
                   if os.environ.get(p + "COORDINATOR", "")), prefixes[-1])
    coord_key = prefix + "COORDINATOR"
    coord = os.environ.get(coord_key, "")
    nproc = os.environ.get(prefix + "NUM_PROCESSES", "")
    pid = os.environ.get(prefix + "PROCESS_ID", "")
    if coord and not nproc:
        raise ValueError(
            f"{coord_key} is set but {prefix}NUM_PROCESSES is not — "
            f"multi-host init needs both (plus {prefix}PROCESS_ID per "
            "worker)")
    if coord and nproc and not pid:
        raise ValueError(
            f"{prefix}PROCESS_ID must be set per worker (0..N-1) when "
            f"{coord_key}/{prefix}NUM_PROCESSES are configured")
    return prefix, coord, nproc, pid


def pick_backend(devices: Optional[Sequence] = None) -> str:
    """The backend the rank's devices call for: "nccl" for CUDA devices,
    "gloo" for the CPU (default devices: the visible cards, else the
    CPU). A mixed set raises."""
    if devices is None:
        devices = (["cuda:0"] if torch.cuda.is_available() else ["cpu"])
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"a rank's devices must be all CUDA or all CPU, "
                         f"not {sorted(kinds)}")
    return "nccl" if kinds == {"cuda"} else "gloo"


def maybe_initialize_distributed(prefixes: tuple[str, ...] = ("SKETCH_",),
                                 backend: Optional[str] = None,
                                 devices: Optional[Sequence] = None) -> bool:
    """Join the process group when configured; returns True if this
    process is one rank of several processes' mesh (module docstring).

    Safe to call unconditionally: with no configuration it does nothing
    and returns False. A second configured call returns True without a
    second init. `backend` names the backend ("gloo" or "nccl"); by
    default it follows `devices` (`pick_backend`). An init that fails
    raises."""
    if dist.is_initialized():
        return True
    _, coord, nproc, pid = _resolve_env(prefixes)
    if not (coord and nproc):
        return False
    if backend is None:
        backend = pick_backend(devices)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if backend == "nccl":
        first = (torch.device(devices[0]) if devices
                 else torch.device("cuda", 0))
        if first.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA, and "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(first)
    dist.init_process_group(backend, init_method="tcp://" + coord,
                            world_size=int(nproc), rank=int(pid))
    global _global_devices
    mine = len(devices) if devices is not None else max(
        1, torch.cuda.device_count())
    _global_devices = sum(all_gather_object(mine))
    log.info("process group initialized: rank %s/%s via %s (%s)",
             pid, nproc, coord, backend)
    return True


def process_count() -> int:
    """The number of processes in the group (1 when not initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 when not initialised)."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_device_count() -> int:
    """Every rank's devices summed, as the ranks gave them at init (the
    reference's `jax.device_count()`); one process: its visible cards,
    else 1 (the CPU)."""
    if _global_devices is not None and dist.is_initialized():
        return _global_devices
    return max(1, torch.cuda.device_count())


def backend() -> Optional[str]:
    """The group's backend, or None when not initialised."""
    return dist.get_backend() if dist.is_initialized() else None


def _reduce_(t: torch.Tensor, op) -> torch.Tensor:
    if process_count() > 1:
        dist.all_reduce(t, op=op)
    return t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over every rank, in place; every rank gets the same sum."""
    return _reduce_(t, dist.ReduceOp.SUM)


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """The element-wise maximum of `t` over every rank, in place."""
    return _reduce_(t, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (one shape and dtype on every rank), in rank
    order, on `t`'s device."""
    if process_count() == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return out


def all_gather_object(obj) -> list:
    """Every rank's picklable `obj`, in rank order (host work: mesh
    construction, checkpoints, `dist_tables`)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_object(obj, dst: int = 0) -> Optional[list]:
    """Every rank's picklable `obj` in rank order on rank `dst`, None on
    the others (one process: `[obj]`)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if process_index() == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def destroy() -> None:
    """Leave the process group (a no-op when not initialised)."""
    if dist.is_initialized():
        dist.destroy_process_group()
