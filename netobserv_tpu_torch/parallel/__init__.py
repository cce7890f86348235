"""The mesh: one process drives a grid of devices as one sketch plane.

Counterpart of `netobserv_tpu/parallel/__init__.py` (`mesh.py`, `merge.py`).
The reference maps the agent's roles onto a device mesh: each device of
the `data` axis folds its shard of the flow stream into a partial sketch
with no collectives, the optional `sketch` axis splits the Count-Min
width by key ownership, and every cross-device step happens at the window
roll (sums for the linear sketches, maxima for the HLL registers, a
gather and re-selection for the heavy-hitter tables). Here the mesh is a
grid of `torch.device`s driven by one process, as one JAX process drives
every chip of its host; a grid may repeat one device, so a mesh runs on
one card or on the CPU. The multi-host tier (`parallel/distributed.py`,
`jax.distributed` in the reference) is not here.
"""

from netobserv_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshSpec, make_mesh,
)
from netobserv_tpu_torch.parallel.merge import (  # noqa: F401
    DistState, init_dist_state, make_merge_fn, make_sharded_ingest_fn,
    merge_states,
)
