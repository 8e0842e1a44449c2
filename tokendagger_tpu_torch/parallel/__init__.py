"""Distribution layer on ``torch.distributed``: meshes of ranks, the
sharded merge steps with summed counters, one long text sharded by bytes
(``sharded_text.ShardedTextEncoder``) and the window pipeline with its
windows sharded over a mesh (``resident_mesh.mesh_resident_pipeline``).

The JAX package's ``parallel/`` runs SPMD over a ``jax.sharding.Mesh``
from one controller (``shard_map``, ``psum``, ``ppermute``). Here each
rank is a process with one device that runs the same code on its shard:
``psum`` is ``all_reduce`` and the entry handoff an ``all_gather``, over
NCCL on cards and gloo on the CPU. Tables are replicated, rows and
windows sharded, and nothing crosses ranks in the hot loop but the
counters.
"""

from .mesh import (  # noqa: F401
    get_mesh,
    get_mesh_2d,
    shard_merge_rows,
    sharded_encode_step,
    sharded_encode_step_2d,
)
