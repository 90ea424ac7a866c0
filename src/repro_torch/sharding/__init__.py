"""Sharding rules, the active mesh and the collectives of the sharded paths
(the port of ``src/repro/sharding``)."""
from .rules import (NamedSharding, active_mesh, batch_axes, batch_partition,
                    data_sharding, data_spec, mesh_shape, param_fallbacks,
                    param_shardings, placements, replicated,
                    shard_dim, spec_for, suspend_mesh, use_mesh)

__all__ = ["NamedSharding", "active_mesh", "batch_axes", "batch_partition",
           "data_sharding", "data_spec", "mesh_shape", "param_fallbacks",
           "param_shardings", "placements", "replicated", "shard_dim",
           "spec_for", "suspend_mesh", "use_mesh"]
