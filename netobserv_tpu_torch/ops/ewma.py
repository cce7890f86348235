"""Streaming EWMA anomaly scoring over hashed destination buckets.

Counterpart of `netobserv_tpu/ops/ewma.py` (`EWMA`, `init`, `accumulate`,
`roll`). Per bucket: the current window's rate, and an exponentially
weighted mean and variance of past windows' rates. `accumulate` adds in
place; `roll` updates mean/var in place, zeroes the rate and returns the
window's z-scores (JAX donated the state).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EWMA(NamedTuple):
    mean: torch.Tensor     # f32[m] EW mean of per-window rates
    var: torch.Tensor      # f32[m] EW variance
    rate: torch.Tensor     # f32[m] current-window accumulator
    windows: torch.Tensor  # i32[] completed windows


def init(buckets: int, device: torch.device) -> EWMA:
    if buckets & (buckets - 1):
        raise ValueError("buckets must be a power of two")
    z = lambda: torch.zeros((buckets,), dtype=torch.float32,  # noqa: E731
                            device=device)
    return EWMA(z(), z(), z(), torch.zeros((), dtype=torch.int32,
                                           device=device))


def accumulate(s: EWMA, dst_h: torch.Tensor, values: torch.Tensor,
               valid: torch.Tensor) -> EWMA:
    """Add one batch's mass into the current window, bucketed by dst hash."""
    m = s.rate.shape[0]
    s.rate.index_add_(0, dst_h & (m - 1),
                      torch.where(valid, values.to(torch.float32), 0.0))
    return s


def roll(s: EWMA, alpha: float = 0.3) -> tuple[EWMA, torch.Tensor]:
    """Close the window in place; returns (the same state, z-scores f32[m]).
    The first two
    windows only seed the baseline (z = 0); the variance floor grows with
    the mean so a tiny noisy baseline does not alarm."""
    first = s.windows == 0
    warming = s.windows < 2
    diff = s.rate - s.mean
    floor = (0.05 * s.mean) ** 2 + 1.0
    z = torch.where(warming, 0.0, diff / torch.sqrt(s.var + floor))
    new_mean = torch.where(first, s.rate,
                           (1 - alpha) * s.mean + alpha * s.rate)
    new_var = torch.where(first, 0.0,
                          (1 - alpha) * (s.var + alpha * diff * diff))
    s.mean.copy_(new_mean)
    s.var.copy_(new_var)
    s.rate.zero_()
    s.windows.add_(1)
    return s, z
