"""mxnet_tpu_torch.sharding — named-mesh partitioning for the Module /
executor stack; counterpart of ``mxnet_tpu.sharding``.

The parallel layout is DATA instead of code:

* :func:`build_mesh` — multi-axis named meshes (``("data", "model")``)
  over contexts, with ``-1`` axis inference; the leading axis is the
  batch axis (mesh.py);
* :func:`match_partition_rules` / :class:`PartitionRules` — ordered regex
  rules over parameter names -> a ``PartitionSpec`` per parameter, with a
  replicated fallback, scalar short-circuit, explainable resolution, and
  presets for the bench models (rules.py);
* :func:`shard_params` / :func:`gather_params` — place or collect a param
  dict against the mesh as ``ShardedTensor`` pieces (placement.py).

The executor stack consumes these through ``Module.bind(..., mesh=...,
partition_rules=...)``: ``Executor.set_shardings`` stores every split
array as its pieces, and the executor's partitioned walk runs each node
over them (column- and row-parallel ``FullyConnected``, elementwise ops on
their inputs' split, every other op once on the gathered value), where the
JAX package's SPMD partitioner inserts the collectives into one program.
With no mesh and no rules, nothing changes.

Env knobs:

* ``MXNET_SHARDING_MESH`` / ``MXNET_SHARDING_RULES`` activate a layout
  for any existing training script without code changes;
* ``MXNET_SHARDING_VALIDATE`` gates the uneven-split error;
* ``MXNET_SHARDING_EXPLAIN`` logs the resolved rule table at bind.
"""
from ..base import register_env

from .mesh import MeshConfig, build_mesh, mesh_axes, mesh_fingerprint
from .rules import (PartitionRules, PRESETS, as_rules,
                    explain_partition_rules, get_preset,
                    match_partition_rules)
from .placement import (NamedSharding, gather_params, make_shardings,
                        param_bytes, place, shard_params, spec_shard_factor,
                        validate_specs)
from ..parallel.mesh import Mesh, PartitionSpec, ShardedTensor

__all__ = [
    "MeshConfig", "build_mesh", "mesh_axes", "mesh_fingerprint",
    "PartitionRules", "PRESETS", "as_rules", "get_preset",
    "match_partition_rules", "explain_partition_rules",
    "shard_params", "gather_params", "make_shardings", "place",
    "param_bytes", "spec_shard_factor", "validate_specs",
    "NamedSharding", "Mesh", "PartitionSpec", "ShardedTensor",
]

register_env("MXNET_SHARDING_MESH", "", str,
             "Mesh layout ('data=-1,model=2') applied by Module.bind when "
             "no mesh argument is passed. Empty keeps the default "
             "replicated data-parallel layout.")
register_env("MXNET_SHARDING_RULES", "", str,
             "Partition-rule preset name (see sharding.PRESETS) applied by "
             "Module.bind when no partition_rules argument is passed. "
             "Requires a mesh (argument or MXNET_SHARDING_MESH).")
register_env("MXNET_SHARDING_VALIDATE", 1, int,
             "Reject PartitionSpecs whose sharded dims don't divide evenly "
             "by their mesh axes. 0 skips the check.")
register_env("MXNET_SHARDING_EXPLAIN", 0, int,
             "Log the resolved rule table (param -> rule -> spec) at bind "
             "time.")
