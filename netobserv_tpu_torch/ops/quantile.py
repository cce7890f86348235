"""Log-bucketed latency histograms with quantile queries.

Counterpart of `netobserv_tpu/ops/quantile.py` (`gamma_for`, `init`,
`bucket_of`, `update`, `bucket_value`, `quantile`, `merge`). Buckets are log-gamma
spaced, so a quantile estimate has bounded relative error. `update` adds in
place (JAX donated the counts). `merge` adds two histograms; `merge_` adds
into the first in place.

`bucket_of` takes ceil(log(v) / log(gamma)) in f32. torch's and XLA's f32
`log` may round a value on a bucket edge differently, so a sample can land
one bucket apart in the two packages; the total mass is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEFAULT_GAMMA = 1.02
DEFAULT_MAX_VALUE = 10_000_000  # 10 s in microseconds


def gamma_for(n_buckets: int, max_value: float = DEFAULT_MAX_VALUE) -> float:
    """Gamma such that `max_value` still lands below the clip bucket."""
    return float(math.exp(math.log(max_value) / max(n_buckets - 2, 1)))


class LogHist(NamedTuple):
    counts: torch.Tensor  # f32[n_buckets]; bucket 0 holds zero samples

    @property
    def n_buckets(self) -> int:
        return self.counts.shape[0]


def init(n_buckets: int, device: torch.device) -> LogHist:
    return LogHist(torch.zeros((n_buckets,), dtype=torch.float32,
                               device=device))


#: f32 log(gamma) per (device, gamma), made once (`_log_gamma`)
_LOG_GAMMA: dict[tuple[torch.device, float], torch.Tensor] = {}


def _log_gamma(gamma: float, device: torch.device) -> torch.Tensor:
    """f32 log(gamma) as a 0-d tensor on `device`, made on first use and
    kept: a fold then copies nothing from host memory, which a CUDA graph
    could not capture. The value is the f32 rounding of math.log(gamma),
    as before."""
    return _constant(_LOG_GAMMA, math.log(gamma), gamma, device)


#: f32 gamma per (device, gamma), made once (`bucket_value`)
_GAMMA: dict[tuple[torch.device, float], torch.Tensor] = {}


def _constant(cache: dict, value: float, gamma: float,
              device: torch.device) -> torch.Tensor:
    key = (device, gamma)
    t = cache.get(key)
    if t is None:
        t = torch.tensor(value, dtype=torch.float32).to(device)
        cache[key] = t
    return t


def bucket_of(values: torch.Tensor, n_buckets: int,
              gamma: float = DEFAULT_GAMMA) -> torch.Tensor:
    """Bucket index (int64) for non-negative integer samples."""
    v = values.to(torch.float32)
    b = torch.ceil(torch.log(torch.clamp(v, min=1.0))
                   / _log_gamma(gamma, v.device))
    b = torch.clamp(b.to(torch.int32) + 1, 1, n_buckets - 1)
    return torch.where(values == 0, 0, b).to(torch.int64)


def update(h: LogHist, values: torch.Tensor, valid: torch.Tensor,
           gamma: float = DEFAULT_GAMMA) -> LogHist:
    h.counts.index_add_(0, bucket_of(values, h.n_buckets, gamma),
                        valid.to(torch.float32))
    return h


def bucket_value(bucket: torch.Tensor,
                 gamma: float = DEFAULT_GAMMA) -> torch.Tensor:
    """Representative value of a bucket (midpoint estimator 2g^b/(g+1))."""
    b = bucket.to(torch.float32) - 1.0
    # the f32 gamma made once per device, as `_log_gamma`: a roll inside a
    # CUDA graph copies nothing from host memory
    val = 2.0 * torch.pow(_constant(_GAMMA, gamma, gamma, b.device),
                          b) / (gamma + 1.0)
    return torch.where(bucket == 0, 0.0, val)


def quantile(h: LogHist, qs: torch.Tensor,
             gamma: float = DEFAULT_GAMMA) -> torch.Tensor:
    """Estimate quantiles qs in [0, 1]; f32[len(qs)] sample values."""
    c = torch.cumsum(h.counts, dim=0)
    n = c[-1]
    targets = torch.clamp(torch.ceil(qs * torch.clamp(n, min=1.0)), min=1.0)
    buckets = torch.searchsorted(c, targets - 0.5, side="left")
    return torch.where(n > 0, bucket_value(buckets, gamma), 0.0)


def merge(a: LogHist, b: LogHist) -> LogHist:
    return LogHist(a.counts + b.counts)


def merge_(a: LogHist, b: LogHist | torch.Tensor) -> LogHist:
    """`merge` into `a` in place (b a histogram or its counts)."""
    a.counts.add_(b.counts if isinstance(b, LogHist) else b)
    return a
