"""Carry a sketch state across from the JAX package, and back.

The counterpart of carrying weights across: a state is a flat dict keyed by
the JAX `SketchState`'s dotted field paths ("cm_bytes.counts", "ddos.mean",
"heavy.h1", "window", ...) with the JAX dtypes (float32, int32, bool and
uint32 for key words and hashes). The EWMA baselines are not part of
`state_tables`, so a window's history crosses only this way. This module
sees numpy arrays only; flattening a JAX state into such a dict is the
caller's side (`jax.tree_util.tree_flatten_with_path`).
"""

from __future__ import annotations

import numpy as np
import torch

from netobserv_tpu_torch.ops import countmin, ewma, hll, quantile, topk
from netobserv_tpu_torch.sketch.state import SketchState
from netobserv_tpu_torch.utils.platform import pick_device

#: the NamedTuple type of every nested field of SketchState
_NESTED = {
    "cm_bytes": countmin.CountMin, "cm_pkts": countmin.CountMin,
    "heavy": topk.SlotTable, "hll_src": hll.HLL,
    "hll_per_dst": hll.PerDstHLL, "hll_per_src": hll.PerDstHLL,
    "hist_rtt": quantile.LogHist, "hist_dns": quantile.LogHist,
    "ddos": ewma.EWMA, "syn": ewma.EWMA, "drops_ewma": ewma.EWMA,
}


def field_paths() -> list[str]:
    """Every dotted leaf path of SketchState, in field order."""
    out = []
    for name in SketchState._fields:
        sub = _NESTED.get(name)
        out += [f"{name}.{f}" for f in sub._fields] if sub else [name]
    return out


def state_to_numpy(state: SketchState) -> dict[str, np.ndarray]:
    """Flatten a state into host arrays with the JAX dtypes (int64 uint32
    lanes become np.uint32)."""
    out = {}
    for path in field_paths():
        t = state
        for part in path.split("."):
            t = getattr(t, part)
        arr = t.detach().to("cpu", copy=True).numpy()
        out[path] = arr.astype(np.uint32) if arr.dtype == np.int64 else arr
    return out


_DTYPES = (np.float32, np.int32, np.bool_, np.uint32)


def state_from_numpy(fields: dict[str, np.ndarray],
                     device: str | torch.device | None = None
                     ) -> SketchState:
    """Build a state on `device` from a flat dict of every dotted path.
    uint32 arrays become int64 tensors; every other dtype is kept."""
    dev = pick_device(device)
    want = field_paths()
    missing = sorted(set(want) - set(fields))
    extra = sorted(set(fields) - set(want))
    if missing or extra:
        raise ValueError(f"state fields: missing {missing}, unexpected "
                         f"{extra}")

    def leaf(path: str) -> torch.Tensor:
        arr = np.asarray(fields[path])
        if arr.dtype not in _DTYPES:
            raise TypeError(f"{path}: dtype {arr.dtype} is not a JAX state "
                            "dtype")
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        return torch.from_numpy(np.array(arr)).to(dev)

    parts = {}
    for name in SketchState._fields:
        sub = _NESTED.get(name)
        parts[name] = (sub(*(leaf(f"{name}.{f}") for f in sub._fields))
                       if sub else leaf(name))
    return SketchState(**parts)
