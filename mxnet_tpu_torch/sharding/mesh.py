"""Named-mesh construction — the device-layout half of the GSPMD layer;
counterpart of ``mxnet_tpu/sharding/mesh.py``.

The executor stack expresses parallelism as data (``PartitionSpec``s over a
named mesh), so the mesh itself must be easy to build correctly: axis sizes
that multiply to the device count and one ``-1`` axis inferred from the
rest.  The mesh is ``parallel.mesh.Mesh``, the one class ``parallel/``
uses too: a named grid of contexts, several of which may name one card
(``[gpu(0)] * 2`` runs two shards on one card).  Unlike
``parallel.make_mesh``, which orders axes canonically, ``build_mesh`` keeps
the order it is given: the LEADING axis is the batch axis.

The mesh is process-local.  Across the processes of a ``dist_sync`` group
the batch splits once more, outside the mesh (``module/executor_group``):
every process's batch is one shard of the global batch.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np

from ..base import MXNetError
from ..parallel.mesh import Mesh, _as_context, _cuda_contexts

__all__ = ["MeshConfig", "build_mesh", "mesh_axes", "mesh_fingerprint"]

AxisSpec = Union[Tuple[str, int], Sequence]


class MeshConfig:
    """Declarative mesh layout: ordered (axis_name, size) pairs, at most one
    size of ``-1`` (inferred so the product covers every device).

    Accepts, for convenience at every call site (Module.bind kwargs, env
    vars, CLI tools):

    * ``MeshConfig(("data", -1), ("model", 2))``
    * ``MeshConfig.parse("data=-1,model=2")``
    * an existing ``Mesh`` passes through :func:`build_mesh`.
    """

    def __init__(self, *axes: AxisSpec):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)) and axes[0] \
                and isinstance(axes[0][0], (list, tuple)):
            axes = tuple(axes[0])  # MeshConfig([("a", 1), ...]) form
        if not axes:
            raise MXNetError("MeshConfig needs at least one axis")
        names = []
        sizes = []
        for ax in axes:
            try:
                name, size = ax
            except (TypeError, ValueError):
                raise MXNetError(
                    "mesh axis must be a (name, size) pair, got %r" % (ax,))
            name = str(name)
            size = int(size)
            if size == 0 or size < -1:
                raise MXNetError(
                    "mesh axis %r size must be positive or -1 (inferred), "
                    "got %d" % (name, size))
            if name in names:
                raise MXNetError("duplicate mesh axis %r" % name)
            names.append(name)
            sizes.append(size)
        if sizes.count(-1) > 1:
            raise MXNetError(
                "at most one mesh axis may have size -1 (inferred), got %s"
                % list(zip(names, sizes)))
        self.names: Tuple[str, ...] = tuple(names)
        self.sizes: Tuple[int, ...] = tuple(sizes)

    @classmethod
    def parse(cls, text: str) -> "MeshConfig":
        """``"data=-1,model=2"`` -> MeshConfig (the env-var / CLI syntax)."""
        axes = []
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise MXNetError(
                    "mesh axis %r must be name=size (e.g. data=-1,model=2)"
                    % part)
            name, _, size = part.partition("=")
            try:
                axes.append((name.strip(), int(size)))
            except ValueError:
                raise MXNetError("mesh axis size %r is not an integer" % size)
        return cls(*axes)

    def resolve_sizes(self, num_devices: int) -> Tuple[int, ...]:
        """Concrete per-axis sizes for ``num_devices`` (fills the -1)."""
        fixed = 1
        for s in self.sizes:
            if s != -1:
                fixed *= s
        sizes = list(self.sizes)
        if -1 in sizes:
            if num_devices % fixed != 0:
                raise MXNetError(
                    "cannot infer mesh axis %r: %d devices not divisible by "
                    "the fixed axes %s" % (
                        self.names[sizes.index(-1)], num_devices,
                        {n: s for n, s in zip(self.names, self.sizes)
                         if s != -1}))
            sizes[sizes.index(-1)] = num_devices // fixed
        if int(np.prod(sizes)) != num_devices:
            raise MXNetError(
                "mesh %s covers %d devices but %d are available"
                % (dict(zip(self.names, sizes)), int(np.prod(sizes)),
                   num_devices))
        return tuple(sizes)

    def __repr__(self):
        return "MeshConfig(%s)" % ", ".join(
            "%s=%d" % (n, s) for n, s in zip(self.names, self.sizes))


def _as_config(axes) -> MeshConfig:
    if isinstance(axes, MeshConfig):
        return axes
    if isinstance(axes, str):
        return MeshConfig.parse(axes)
    if isinstance(axes, dict):
        return MeshConfig(*axes.items())
    return MeshConfig(*axes) if axes and isinstance(axes[0], (list, tuple)) \
        else MeshConfig(axes)


def build_mesh(axes="data=-1", devices=None) -> Mesh:
    """A ``Mesh`` with named axes over ``devices`` (contexts, which may
    repeat; default one per CUDA card, and without CUDA this raises).

    ``axes``: MeshConfig | "data=-1,model=2" | ((name, size), ...) | dict
    | an existing Mesh (returned as is).  Exactly one axis may be -1; its
    size is inferred.  The axes keep the given order and the contexts keep
    theirs, laid out row-major, so the leading axis is the outermost."""
    if isinstance(axes, Mesh):
        return axes
    cfg = _as_config(axes)
    if devices is None:
        devices = _cuda_contexts()
    flat = [_as_context(d) for d in np.asarray(devices,
                                               dtype=object).reshape(-1)]
    sizes = cfg.resolve_sizes(len(flat))
    grid = np.empty(len(flat), dtype=object)
    grid[:] = flat
    return Mesh(grid.reshape(sizes), cfg.names)


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` for a Mesh (insertion-ordered)."""
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def mesh_fingerprint(mesh) -> Tuple:
    """Stable identity of a mesh's layout: ordered (axis, size) pairs plus
    the flattened contexts (the JAX package's device ids: a context names
    its card)."""
    axes = tuple((str(n), int(mesh.shape[n])) for n in mesh.axis_names)
    devs = tuple(str(c) for c in np.asarray(mesh.devices,
                                            dtype=object).reshape(-1))
    return (axes, devs)
