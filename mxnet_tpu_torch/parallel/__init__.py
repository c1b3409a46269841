"""mxnet_tpu_torch.parallel — parallelism over a mesh of contexts;
counterpart of ``mxnet_tpu.parallel``.

The mesh is single-controller: one process, a named grid of contexts, one
context per logical shard (several may share a card).  ``shard_map`` runs a
per-shard function with the collectives the JAX package's code uses
(``axis_index``, ``ppermute``, ``psum``, ``all_gather``, ``all_to_all``),
moving tensors between shards with ``Tensor.to``.

* ``ring_attention`` — exact blockwise attention with K/V rotating around
  the ring, plain PyTorch.
* ``ring_flash_attention`` — the same ring with the flash kernels (K1
  forward, K2/K3 backward) as the per-block compute; dK/dV ride the ring
  home.
* ``ulysses_attention`` — all-to-all sequence parallelism.
* ``pipeline_spmd`` — the GPipe schedule over stacked homogeneous stages.
* ``moe_ffn`` — experts split over a mesh axis, exact dispatch, psum
  combine.
"""
from .mesh import (MeshConfig, Mesh, PartitionSpec, ShardedTensor,
                   make_mesh, data_parallel_mesh, shard, replicate,
                   current_mesh, set_current_mesh)
from .ring import (ring_attention, ring_flash_attention,
                   ulysses_attention, local_attention)
from .moe import moe_ffn, moe_ffn_reference
from .pipeline import pipeline_spmd
from ._compat import shard_map

__all__ = [
    "MeshConfig", "make_mesh", "data_parallel_mesh", "shard", "replicate",
    "current_mesh", "set_current_mesh",
    "ring_attention", "ring_flash_attention", "ulysses_attention",
    "local_attention", "moe_ffn", "moe_ffn_reference",
    "pipeline_spmd",
]
