"""Carry a sketch state across from the JAX package, and back.

The counterpart of carrying weights across: a state is a flat dict keyed by
the JAX `SketchState`'s dotted field paths ("cm_bytes.counts", "ddos.mean",
"heavy.h1", "window", ...) with the JAX dtypes (float32, int32, bool and
uint32 for key words and hashes). The EWMA baselines are not part of
`state_tables`, so a window's history crosses only this way. This module
sees numpy arrays only; flattening a JAX state into such a dict is the
caller's side (`jax.tree_util.tree_flatten_with_path`).

A tiered state (`sketch/tiered.TieredState`) carries the same way: its
tier arrays under "tables.cm_bytes.base", "tables.cm_bytes.mid", ...,
"tables.hll_src", ... with exactly the reference's dtypes (uint8 base and
packed HLL bytes, uint16 mid, uint32 top), and its wide remainder under
"rest." + the SketchState paths (the tier-covered fields there are the
reference's zero-size placeholders). The tier geometry is not an array:
like the reference's pytree aux data, the `TierSpec` travels beside the
dict, as the `spec` argument of `state_from_numpy`.

The resident feed's device key table crosses as the JAX package's
(slot_cap, 10) uint32 array (`key_table_to_numpy`, `key_table_from_numpy`),
and the lane-sharded feed's tables as its (R, slot_cap, 10) uint32 array
(`init_key_tables`, one table a region); each of the port's tables has one
more row, the sink of undefined new-key rows.
"""

from __future__ import annotations

import numpy as np
import torch

from netobserv_tpu_torch.ops import countmin, ewma, hll, quantile, topk
from netobserv_tpu_torch.sketch import tiered
from netobserv_tpu_torch.sketch.state import KEY_WORDS, SketchState
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


#: dotted path of every tier array of TieredState.tables -> its dtype
TIER_DTYPES = {
    **{f"tables.{p}.{f}": dt for p in ("cm_bytes", "cm_pkts")
       for f, dt in zip(tiered.TieredPlane._fields,
                        (np.uint8, np.uint16, np.uint32))},
    **{f"tables.{h}": np.uint8
       for h in ("hll_src", "hll_per_dst", "hll_per_src")},
}


def tiered_field_paths() -> list[str]:
    """Every dotted leaf path of a TieredState, tables first."""
    return [*TIER_DTYPES, *(f"rest.{p}" for p in field_paths())]


def get_leaf(obj, path: str):
    """The tensor of a state at a dotted field path."""
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """Flatten a SketchState or TieredState into host arrays with the JAX
    dtypes (int64 uint32 lanes become np.uint32; tier arrays keep their
    uint8/uint16/uint32)."""
    tier = isinstance(state, tiered.TieredState)
    out = {}
    for path in (tiered_field_paths() if tier else field_paths()):
        arr = get_leaf(state, path).detach().to("cpu", copy=True).numpy()
        out[path] = arr.astype(np.uint32) if arr.dtype == np.int64 else arr
    return out


_DTYPES = (np.float32, np.int32, np.bool_, np.uint32)


def state_from_numpy(fields: dict[str, np.ndarray],
                     device: str | torch.device | None = None,
                     spec: tiered.TierSpec | None = None):
    """Build a state on `device` from a flat dict of every dotted path: a
    SketchState, or with `spec` a TieredState. uint32 arrays of the wide
    state become int64 tensors; tier arrays keep their dtypes exactly."""
    dev = pick_device(device)
    if spec is not None:
        return _tiered_from_numpy(fields, dev, spec)
    return _wide_from_numpy(fields, dev)


def _check_paths(fields: dict, want: list[str]) -> None:
    missing = sorted(set(want) - set(fields))
    extra = sorted(set(fields) - set(want))
    if missing or extra:
        raise ValueError(f"state fields: missing {missing}, unexpected "
                         f"{extra}")


def _wide_from_numpy(fields: dict[str, np.ndarray],
                     dev: torch.device) -> SketchState:
    _check_paths(fields, field_paths())

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


def _tiered_from_numpy(fields: dict[str, np.ndarray], dev: torch.device,
                       spec: tiered.TierSpec) -> tiered.TieredState:
    _check_paths(fields, tiered_field_paths())

    def tier(path: str) -> torch.Tensor:
        arr = np.asarray(fields[path])
        if arr.dtype != TIER_DTYPES[path]:
            raise TypeError(f"{path}: dtype {arr.dtype}, expected "
                            f"{np.dtype(TIER_DTYPES[path])}")
        return torch.from_numpy(np.array(arr)).to(dev)

    planes = {p: tiered.TieredPlane(*(tier(f"tables.{p}.{f}")
                                      for f in tiered.TieredPlane._fields))
              for p in ("cm_bytes", "cm_pkts")}
    tables = tiered.TieredTables(
        **planes, **{h: tier(f"tables.{h}")
                     for h in ("hll_src", "hll_per_dst", "hll_per_src")})
    rest = _wide_from_numpy({p[len("rest."):]: v for p, v in fields.items()
                             if p.startswith("rest.")}, dev)
    return tiered.TieredState(tables, rest, spec)


def key_table_to_numpy(table: torch.Tensor) -> np.ndarray:
    """The port's key table, (slot_cap + 1, 10), or lane tables, (R,
    slot_cap + 1, 10), as the JAX package's (slot_cap, 10) or (R,
    slot_cap, 10) uint32 array: a host copy with the sink rows stripped."""
    if table.ndim not in (2, 3) or table.shape[-1] != KEY_WORDS:
        raise ValueError(f"key table must be ([R,] slot_cap + 1, "
                         f"{KEY_WORDS}), got {tuple(table.shape)}")
    return (table[..., :-1, :].detach().to("cpu", copy=True).numpy()
            .view(np.uint32))


def key_table_from_numpy(arr: np.ndarray,
                         device: str | torch.device | None = None
                         ) -> torch.Tensor:
    """A JAX package's (slot_cap, 10) key table, or (R, slot_cap, 10) lane
    tables, uint32, on `device`, with the port's sink row added to each."""
    arr = np.asarray(arr)
    if (arr.dtype != np.uint32 or arr.ndim not in (2, 3)
            or arr.shape[-1] != KEY_WORDS):
        raise ValueError(f"key table must be ([R,] slot_cap, {KEY_WORDS}) "
                         f"uint32, got {arr.dtype} {arr.shape}")
    sink = np.zeros((*arr.shape[:-2], 1, KEY_WORDS), np.uint32)
    rows = np.concatenate([arr, sink], axis=-2)
    return torch.from_numpy(rows.view(np.int32)).to(pick_device(device))
