"""The mesh: a grid of devices folds the flow stream as one sketch plane.

Counterpart of `netobserv_tpu/parallel/__init__.py` (`mesh.py`, `merge.py`,
`distributed.py`). The reference maps the agent's roles onto a device
mesh: each device of the `data` axis folds its shard of the flow stream
into a partial sketch with no collectives, the optional `sketch` axis
splits the Count-Min width by key ownership, and every cross-device step
happens at the window roll (sums for the linear sketches, maxima for the
HLL registers, a gather and re-selection for the heavy-hitter tables).
Here the mesh is a grid of `torch.device`s; a grid may repeat one device,
so a mesh runs on one card or on the CPU. The multi-host tier
(`distributed.py`, `jax.distributed` in the reference) joins several
processes into one process group: the mesh then spans every rank's
devices, each rank folds the shards it holds, and the roll completes the
merge across ranks with three collectives (`merge.merge_states`).
"""

from netobserv_tpu_torch.parallel.distributed import (  # noqa: F401
    maybe_initialize_distributed, process_count, process_index,
)
from netobserv_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshSpec, make_mesh,
)
from netobserv_tpu_torch.parallel.merge import (  # noqa: F401
    DistState, init_dist_state, make_merge_fn, make_sharded_ingest_fn,
    merge_states,
)
