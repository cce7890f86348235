"""Kernel 4: the fused signal-plane fold (`csrc/signal_fold.cu`).

Replaces the Pallas kernel `netobserv_tpu/ops/pallas/signal_kernel.py`
`update`. Eight value rows add into six m-wide tables (ddos, syn, drops,
synack, conv_fwd, conv_rev) and two aux tables (dscp bytes, drop causes)
over five index families (dst, src, pair, dscp, cause). Each block folds
its slice of the batch into a shared-memory copy of all eight tables and
flushes it with global atomics; see the source note.

`update` is the wrapper: CUDA tensors launch the kernel, CPU tensors take
`update_plain` (eight `index_add_`). In place on the tables (JAX donated
them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from netobserv_tpu_torch.ops.kernels._build import CudaKernel, check, on_cuda

SOURCE = "signal_fold.cu"
KERNEL = CudaKernel(SOURCE, "signal_fold", n_ptrs=10, n_ints=4)

#: value row -> index family: [ddos, syn, drops | synack | fwd, rev | dscp |
#: cause] over families [dst, src, pair, dscp, cause]
FAMILY = (0, 0, 0, 1, 2, 2, 3, 4)
N_VALS = 8
N_IDX = 5
#: width of the kernel's shared-memory aux rows (dscp, causes)
AUX_W = 256
#: shared memory one block may use on sm_90 (bytes)
SMEM_LIMIT = 232448


class SignalPlanes(NamedTuple):
    """The signal tables the fused fold updates (views of the state)."""

    ddos_rate: torch.Tensor   # f32[m]
    syn_rate: torch.Tensor    # f32[m]
    drops_rate: torch.Tensor  # f32[m]
    synack: torch.Tensor      # f32[m]
    conv_fwd: torch.Tensor    # f32[m]
    conv_rev: torch.Tensor    # f32[m]
    dscp_bytes: torch.Tensor  # f32[n_dscp]  (n_dscp <= AUX_W)
    drop_causes: torch.Tensor  # f32[n_causes] (n_causes <= AUX_W)


def update_plain(planes: SignalPlanes, idx: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """planes[j][idx[FAMILY[j]]] += vals[j] for each value row j, in place.
    Indices are already masked into their table's range."""
    for j, table in enumerate(planes):
        table.index_add_(0, idx[FAMILY[j]], vals[j])


def update(planes: SignalPlanes, idx: torch.Tensor,
           vals: torch.Tensor) -> None:
    """Fold one batch into every signal table in one pass, in place.

    idx: int64[5, B] — [dst, src, pair, dscp, cause] indices; vals:
    f32[8, B] — [ddos, syn, drops, synack, conv_fwd, conv_rev, dscp, cause]
    masses, already masked (0 = no-op)."""
    if not on_cuda(vals):
        update_plain(planes, idx, vals)
        return
    m = planes.ddos_rate.shape[0]
    n_dscp = planes.dscp_bytes.shape[0]
    n_cause = planes.drop_causes.shape[0]
    if n_dscp > AUX_W or n_cause > AUX_W:
        raise ValueError(f"aux tables must fit {AUX_W} entries")
    if (6 * m + 2 * AUX_W) * 4 > SMEM_LIMIT:
        raise ValueError(f"m={m}: the tables do not fit one block's shared "
                         "memory")
    n = vals.shape[1]
    dev = vals.device
    for name, t in zip(SignalPlanes._fields[:6], planes[:6]):
        check(t, name, torch.float32, (m,), dev)
    check(planes.dscp_bytes, "dscp_bytes", torch.float32, (n_dscp,), dev)
    check(planes.drop_causes, "drop_causes", torch.float32, (n_cause,), dev)
    check(idx, "idx", torch.int64, (N_IDX, n), dev)
    check(vals, "vals", torch.float32, (N_VALS, n), dev)
    KERNEL.launch([*planes, idx, vals], [n, m, n_dscp, n_cause], dev)
