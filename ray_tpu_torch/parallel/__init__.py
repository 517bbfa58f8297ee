"""ray_tpu_torch.parallel — the parallel layer of the port (counterpart of
``ray_tpu.parallel``): the named 6-axis ``DeviceMesh``, JAX's logical-axis
rules as DTensor placements, the process-group bring-up, the differentiable
collectives over one mesh axis (``collectives``) and the GPipe pipeline
(``pipeline``)."""

from ray_tpu_torch.parallel.mesh import (DEFAULT_AXIS_ORDER, DEFAULT_RULES,
                                         MeshSpec, build_mesh, distribute,
                                         logical_to_spec, mesh_from_string,
                                         named_sharding, placements,
                                         replicated, shard_constraint,
                                         shard_map_compat)
from ray_tpu_torch.parallel.multihost import (initialize_multihost,
                                              multihost_mesh, process_shard,
                                              spawn_ranks)

__all__ = ["DEFAULT_AXIS_ORDER", "DEFAULT_RULES", "MeshSpec", "build_mesh",
           "distribute", "logical_to_spec", "mesh_from_string",
           "named_sharding", "placements", "replicated", "shard_constraint",
           "shard_map_compat", "initialize_multihost", "multihost_mesh",
           "process_shard", "spawn_ranks"]
