"""Histogram bucket edges (netobserv_tpu_torch/ops/quantile.bucket_of)
against the correctly rounded log.

A sample's bucket is ceil(log(v) / log(gamma)) + 1 in f32. For a sample
whose log lies on a bucket edge, the bucket depends on how the f32 log
rounds. The port's bucket equals the one the correctly rounded log gives
(the f64 log rounded once to f32) on every integer sample below 10^7 at
the default 1,024 buckets. The JAX package's bucket departs from it on a
few of them, by one bucket, because XLA's CPU log is an approximation. The
port cannot match the reference on those samples without copying that
approximation, so tests/test_torch_state.py bounds the difference.

Run as a script (`JAX_PLATFORMS=cpu python -m tests.test_torch_hist_edges`)
it prints the counts behind ROADMAP.md's note: the samples on which each
side's bucket, and each side's f32 log, differs from the correctly
rounded one."""

import functools
import json
import math

import numpy as np
import torch

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from netobserv_tpu.ops import quantile as jq
from netobserv_tpu_torch.ops import quantile as tq

N_SAMPLES = 10_000_000
N_BUCKETS = 1024


@functools.lru_cache(maxsize=1)
def edge_counts(n: int = N_SAMPLES, nb: int = N_BUCKETS) -> dict:
    """Buckets and f32 logs of the integer samples 1..n-1, each side
    against the correctly rounded log; the sample counts that differ."""
    gamma = jq.gamma_for(nb)
    v = np.arange(1, n, dtype=np.int32)
    vf = v.astype(np.float32)
    log_rn = np.log(v.astype(np.float64)).astype(np.float32)
    log_g = np.float32(math.log(gamma))
    want = np.clip(np.ceil(log_rn / log_g).astype(np.int32) + 1, 1, nb - 1)
    # torch picks a CPU kernel's vector path on its first call; a first
    # call that already runs on several threads can mix paths and round
    # differently (ROADMAP.md queue C), so one element goes first
    tq.bucket_of(torch.ones(1, dtype=torch.int32), nb, gamma)
    port = tq.bucket_of(torch.from_numpy(v), nb, gamma).numpy()
    ref = np.asarray(jax.jit(lambda x: jq.bucket_of(x, nb, gamma))(
        jnp.asarray(v)))
    port_log = torch.log(torch.from_numpy(vf)).numpy()
    ref_log = np.asarray(jax.jit(jnp.log)(jnp.asarray(vf)))
    return {
        "samples": int(v.size),
        "port_bucket_off": int((port != want).sum()),
        "reference_bucket_off": int((ref != want).sum()),
        "port_vs_reference_bucket_off": int((port != ref).sum()),
        "port_vs_reference_off_where_reference_is_off": int(
            ((port != ref) & (ref != want)).sum()),
        "max_reference_bucket_distance": int(np.abs(
            ref.astype(np.int64) - want).max()),
        "port_log_off": int((port_log != log_rn).sum()),
        "reference_log_off": int((ref_log != log_rn).sum()),
    }


def test_port_bucket_is_the_correctly_rounded_logs_bucket():
    c = edge_counts()
    assert c["port_bucket_off"] == 0


def test_every_port_vs_reference_difference_is_a_reference_departure():
    """Where the port and the reference disagree, the reference's bucket
    is the one off the correctly rounded log's, by one bucket, on at most
    1e-5 of the samples."""
    c = edge_counts()
    assert (c["port_vs_reference_bucket_off"]
            == c["port_vs_reference_off_where_reference_is_off"])
    assert c["reference_bucket_off"] <= 1e-5 * c["samples"]
    assert c["max_reference_bucket_distance"] <= 1


if __name__ == "__main__":
    print(json.dumps(edge_counts()))
