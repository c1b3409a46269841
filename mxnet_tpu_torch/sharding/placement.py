"""Placing and collecting parameter dicts against a named mesh;
counterpart of ``mxnet_tpu/sharding/placement.py``.

An array on the mesh is a ``parallel.mesh.ShardedTensor`` held by an
``NDArray``: one piece per distinct block of the global tensor, on the
context of the first coordinate that holds it (``ShardedTensor.
canonical``), so a split weight really is stored as its pieces and a
replicated block has one copy.  ``shard_params`` / ``gather_params`` place
and collect name->NDArray dicts, and ``param_bytes`` accounts the bytes so
the memory win of a layout is a number (the telemetry gauges), not a
feeling.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..base import MXNetError
from ..parallel.mesh import (PartitionSpec, ShardedTensor, entry_axes,
                             entry_split, spec_axes)

__all__ = ["NamedSharding", "make_shardings", "shard_params",
           "gather_params", "validate_specs", "spec_shard_factor",
           "param_bytes", "place"]


class NamedSharding:
    """A (mesh, PartitionSpec) pair: where an array's pieces go
    (``jax.sharding.NamedSharding``'s surface)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and tuple(other.spec) == tuple(self.spec)

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self):
        return "NamedSharding(%s, %s)" % (self.spec, self.mesh)


def make_shardings(mesh, specs: Dict[str, object]) -> Dict[str, object]:
    """{name: PartitionSpec} -> {name: NamedSharding} on ``mesh``."""
    return {name: NamedSharding(mesh, spec) for name, spec in specs.items()}


def spec_shard_factor(mesh, spec) -> int:
    """How many ways a spec splits an array (product of its mesh axis
    sizes) — the per-device memory divisor."""
    factor = 1
    for entry in tuple(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        for ax in axes:
            factor *= int(mesh.shape[ax])
    return factor


def validate_specs(mesh, specs: Dict[str, object],
                   shapes: Dict[str, Tuple[int, ...]]) -> None:
    """Reject specs whose sharded dims don't divide evenly by their mesh
    axes: an uneven split of a weight is almost always a mis-written rule,
    so fail loudly with the parameter name (MXNET_SHARDING_VALIDATE=0
    skips the check; the port then fails where it splits the array)."""
    problems = []
    for name, spec in specs.items():
        shape = tuple(shapes.get(name, ()))
        for dim, entry in enumerate(tuple(spec)):
            if entry is None or dim >= len(shape):
                continue
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            factor = 1
            for ax in axes:
                if ax not in mesh.shape:
                    problems.append("%s: spec axis %r is not a mesh axis %s"
                                    % (name, ax, tuple(mesh.axis_names)))
                    factor = 0
                    break
                factor *= int(mesh.shape[ax])
            if factor and shape[dim] % factor != 0:
                problems.append(
                    "%s: dim %d (size %d) not divisible by the %d-way %r "
                    "split" % (name, dim, shape[dim], factor, entry))
    if problems:
        raise MXNetError("invalid partition specs for mesh %s:\n  %s"
                         % (dict((a, int(mesh.shape[a]))
                                 for a in mesh.axis_names),
                            "\n  ".join(problems)))


def _torch(x):
    """A tensor from an NDArray, a tensor or anything numpy takes."""
    import torch

    from ..ndarray import NDArray

    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, ShardedTensor):
        return x.full()
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _block(x, spec, mesh, coord):
    """``coord``'s block of the global tensor ``x`` under ``spec``, on
    that coordinate's device.  A dim split over a tuple of axes splits
    over their product, the first axis major."""
    for d, ax in enumerate(tuple(spec)):
        if ax is None:
            continue
        n, k = entry_split(ax, mesh, coord)
        if x.shape[d] % n:
            raise MXNetError("dim %d of size %d does not split over mesh "
                             "axis %r of size %d" % (d, x.shape[d], ax, n))
        size = x.shape[d] // n
        x = x.narrow(d, k * size, size)
    return x.to(mesh.torch_device(coord))


def blocks(x, mesh, spec) -> ShardedTensor:
    """The tensor ``x`` as a ShardedTensor with one piece per distinct
    block (each a copy, never a view of ``x``).  A dim splits over one
    mesh axis or over a tuple of axes (their product, the first major, as
    JAX's ``NamedSharding`` splits it)."""
    import torch

    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    for entry in spec:
        for ax in entry_axes(entry):
            if ax not in mesh.shape:
                raise MXNetError("spec axis %r is not a mesh axis %s"
                                 % (ax, tuple(mesh.axis_names)))
    named = spec_axes(spec)
    pieces = {}
    for coord in mesh.coords():
        if any(c and a not in named
               for a, c in zip(mesh.axis_names, coord)):
            continue
        piece = _block(x, spec, mesh, coord)
        pieces[coord] = piece.clone(memory_format=torch.contiguous_format) \
            if piece.device == x.device else piece.contiguous()
    return ShardedTensor(pieces, mesh, spec)


def place(x, mesh, spec):
    """Place one array (ShardedTensor / NDArray / tensor / numpy) onto the
    mesh under ``spec``: a ShardedTensor.  One already placed so passes
    through untouched; any other is gathered and split anew."""
    from ..ndarray import NDArray

    if isinstance(x, NDArray):
        x = x._data
    spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
    if isinstance(x, ShardedTensor) and x.same_layout(mesh, spec):
        return x
    return blocks(_torch(x), mesh, spec)


def shard_params(params: Dict[str, object], mesh,
                 specs: Optional[Dict[str, object]] = None,
                 validate: bool = True) -> Dict[str, object]:
    """Place a {name: NDArray} dict against ``mesh`` under ``specs``
    ({name: PartitionSpec}; missing names replicate).  Returns a new dict
    of NDArrays backed by ShardedTensors (an NDArray already so placed is
    returned as is)."""
    from ..ndarray import NDArray

    specs = specs or {}
    if validate:
        validate_specs(mesh, {k: specs.get(k, PartitionSpec())
                              for k in params},
                       {k: tuple(getattr(v, "shape", ()))
                        for k, v in params.items()})
    ctx = mesh.devices.flat[0]
    out = {}
    for name, arr in params.items():
        placed = place(arr, mesh, specs.get(name, PartitionSpec()))
        out[name] = arr if isinstance(arr, NDArray) and \
            placed is arr._data else NDArray(placed, ctx)
    return out


def _host(t) -> np.ndarray:
    import torch

    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return np.array(t.cpu().numpy())


def gather_params(params: Dict[str, object],
                  over_processes: bool = False) -> Dict[str, object]:
    """Collect a (possibly sharded) {name: NDArray} dict to host numpy.

    Mesh pieces concatenate locally.  With ``over_processes`` each
    process's value is its rows of a global array (the global batch of a
    ``dist_sync`` group): every process gets all of them, in rank order,
    through ``torch.distributed.all_gather`` (the explicit inverse of the
    split — NOT on any hot path)."""
    out = {}
    for name, arr in params.items():
        x = _torch(arr)
        if over_processes:
            from ..kvstore_dist import all_gather_rows

            x = all_gather_rows(x)
        out[name] = _host(x)
    return out


def param_bytes(arrays) -> Tuple[int, int]:
    """(per_device_bytes, replicated_bytes) for an iterable of arrays.

    ``replicated_bytes`` is what one device would hold if everything were
    fully replicated; ``per_device_bytes`` is the average residency per
    mesh coordinate under the current placement (each coordinate holds
    its block) — the telemetry gauge pair that makes a tensor-parallel
    memory win visible."""
    import torch

    from ..ndarray import NDArray

    per_device = 0.0
    replicated = 0
    for arr in arrays:
        if arr is None:
            continue
        x = arr._data if isinstance(arr, NDArray) else arr
        nbytes = x.numel() * torch.empty((), dtype=x.dtype).element_size()
        replicated += nbytes
        factor = spec_shard_factor(x.mesh, x.spec) \
            if isinstance(x, ShardedTensor) else 1
        per_device += nbytes / factor
    return int(per_device), replicated
