"""Device meshes and placement helpers — counterpart of
``mxnet_tpu/parallel/mesh.py``.

The port's mesh is single-controller, as JAX's is: one process drives a
named grid of contexts, and each logical shard of the grid has a context
of its own.  Several shards may share one torch device (``devices=[gpu(0)]
* 4`` runs a four-shard ring on one card; ``cpu(0..7)`` are all the one
torch CPU device), so a mesh's size is the number of shards, not of cards.
Axes are roles ('data', 'pipe', 'expert', 'model', 'seq') ordered
canonically, as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["CANONICAL_AXES", "MeshConfig", "Mesh", "PartitionSpec",
           "ShardedTensor", "make_mesh", "data_parallel_mesh", "shard",
           "replicate", "current_mesh", "set_current_mesh"]

#: canonical axis order — data-parallel outermost
CANONICAL_AXES = ("data", "pipe", "expert", "model", "seq")


class MeshConfig:
    """Declarative mesh spec: axis name → size. Size -1 means 'absorb the
    remaining devices' (at most one axis may be -1)."""

    def __init__(self, **axes: int):
        self.axes = dict(axes)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        axes = dict(self.axes)
        unknown = [k for k, v in axes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = int(np.prod([v for v in axes.values() if v != -1])) or 1
        if unknown:
            if n_devices % known:
                raise ValueError(
                    "cannot infer axis %r: %d devices not divisible by %d"
                    % (unknown[0], n_devices, known))
            axes[unknown[0]] = n_devices // known
        total = int(np.prod(list(axes.values()))) if axes else 1
        if total != n_devices:
            raise ValueError(
                "mesh %r uses %d devices but %d are available"
                % (axes, total, n_devices))
        return axes


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None: not split), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple(self),)


class Mesh:
    """A named grid of contexts: ``devices`` is a numpy object array of
    ``Context`` with one dimension per axis, ``shape`` maps axis name to
    size (``jax.sharding.Mesh``'s surface)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of %d dims needs as many axis names, got "
                             "%s" % (self.devices.ndim, self.axis_names))
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every shard's coordinate, in row-major (flat) order."""
        return list(np.ndindex(*self.devices.shape))

    def torch_device(self, coord):
        return self.devices[tuple(coord)].torch_device()

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, list(self.devices.flat))


def _as_context(d) -> Context:
    if isinstance(d, Context):
        return d
    raise MXNetError("mesh devices are contexts (mt.gpu(i), mt.cpu(i)), "
                     "got %r" % (d,))


def _cuda_contexts():
    """One context per CUDA device; there is no CPU default."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetError("no CUDA device for a default mesh; pass devices="
                         "[mt.cpu(i) ...] to build one on the CPU")
    return [gpu(i) for i in range(n)]


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Build a named Mesh. ``axes`` maps axis name → size (-1 = remaining);
    default is a pure data-parallel mesh over all devices.  ``devices``
    (contexts; default one per CUDA device) may repeat a context."""
    if devices is None:
        devices = _cuda_contexts()
    devices = [_as_context(d) for d in devices]
    if not axes:
        axes = {"data": len(devices)}
    resolved = MeshConfig(**axes).resolve(len(devices))
    # order axes canonically so collectives on inner axes stay intra-group
    names = sorted(resolved, key=lambda a: (
        CANONICAL_AXES.index(a) if a in CANONICAL_AXES
        else len(CANONICAL_AXES)))
    shape = [resolved[a] for a in names]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), tuple(names))


def data_parallel_mesh(n: Optional[int] = None, devices=None) -> Mesh:
    devs = list(devices) if devices is not None else _cuda_contexts()
    if n is not None:
        devs = devs[:n]
    return make_mesh({"data": len(devs)}, devs)


def _spec(spec) -> PartitionSpec:
    return spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)


def entry_axes(entry):
    """The mesh axes one PartitionSpec entry splits its dim over: () for
    None, the axis itself, or a tuple of axes, the first one major
    (``P(("data", "model"), ...)``, as JAX's ``NamedSharding`` splits)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec):
    """Every mesh axis a spec names, in any entry."""
    return {a for entry in _spec(spec) for a in entry_axes(entry)}


def entry_split(entry, mesh: Mesh, coord=None):
    """(ways, index): how many pieces the entry cuts its dim into (the
    product of its axes' sizes) and, at ``coord``, which one (row-major
    over the axes, the first one major)."""
    ways, index = 1, 0
    for a in entry_axes(entry):
        n = int(mesh.shape[a])
        ways *= n
        if coord is not None:
            index = index * n + coord[mesh.axis_names.index(a)]
    return ways, index


def _local_piece(x, spec, mesh: Mesh, coord):
    """Shard ``coord``'s piece of the global tensor ``x`` under ``spec``,
    on that shard's device (a view when it already lies there)."""
    for d, name in enumerate(_spec(spec)):
        if name is None:
            continue
        n, k = entry_split(name, mesh, coord)
        if x.shape[d] % n:
            raise ValueError("dim %d of size %d does not split over mesh "
                             "axis %r of size %d" % (d, x.shape[d], name, n))
        size = x.shape[d] // n
        x = x.narrow(d, k * size, size)
    return x.to(mesh.torch_device(coord))


def _assemble(pieces, spec, mesh: Mesh):
    """The global tensor from per-shard pieces ({coord: tensor}) under
    ``spec``: concatenated along the named dims, replicas read from the
    coordinate 0 of every other axis; on shard 0's device."""
    import torch

    spec = _spec(spec)
    named = [(d, entry_axes(name)) for d, name in enumerate(spec)
             if name is not None]
    device = mesh.torch_device(mesh.coords()[0])

    def build(level, fixed):
        if level == len(named):
            coord = tuple(fixed.get(a, 0) for a in mesh.axis_names)
            return pieces[coord].to(device)
        d, axes = named[level]
        # the pieces along a tuple of axes in row-major order over them
        return torch.cat([build(level + 1, dict(fixed, **dict(zip(axes, k))))
                          for k in np.ndindex(*[int(mesh.shape[a])
                                                for a in axes])], dim=d)

    return build(0, {})


class ShardedTensor:
    """A global tensor laid out on a mesh: pieces (``shards[coord]``) on
    the shards' devices; ``full()`` gathers it.  ``shard`` makes one piece
    per coordinate.  The GSPMD layer (``sharding.place``) keeps one piece
    per distinct block instead, at the coordinate that is 0 on every axis
    the spec does not name (``canonical``), on that coordinate's context:
    the coordinates that repeat a block read it from there (``piece``), so
    a replicated block has one copy, which autograd and the optimizer see
    once.  ``shape``, ``dtype`` and ``numel`` describe the global tensor,
    so an ``NDArray`` can hold one."""

    def __init__(self, pieces, mesh: Mesh, spec):
        self.shards = pieces
        self.mesh = mesh
        self.spec = _spec(spec)

    def full(self):
        return _assemble(self.shards, self.spec, self.mesh)

    def canonical(self, coord):
        """The coordinate holding ``coord``'s block: 0 on every axis the
        spec does not name."""
        named = spec_axes(self.spec)
        return tuple(c if a in named else 0
                     for a, c in zip(self.mesh.axis_names, coord))

    def piece(self, coord):
        """``coord``'s block on its device (a differentiable copy when it
        is held at another coordinate on another device)."""
        got = self.shards.get(tuple(coord))
        if got is not None:
            return got
        return self.shards[self.canonical(coord)].to(
            self.mesh.torch_device(coord))

    @property
    def shape(self):
        import torch

        first = self.shards[self.canonical((0,) * len(self.mesh.axis_names))]
        dims = list(first.shape)
        for d, name in enumerate(self.spec):
            dims[d] *= entry_split(name, self.mesh)[0]
        return torch.Size(dims)

    @property
    def dtype(self):
        return next(iter(self.shards.values())).dtype

    def numel(self) -> int:
        return int(np.prod(tuple(self.shape)))

    def dim(self) -> int:
        return len(self.shape)

    def map(self, fn) -> "ShardedTensor":
        """The same layout with ``fn`` applied to every piece."""
        return ShardedTensor({c: fn(p) for c, p in self.shards.items()},
                             self.mesh, self.spec)

    def same_layout(self, mesh: Mesh, spec) -> bool:
        """Whether the pieces lie as ``spec`` on ``mesh`` would put them:
        the same spec over an equal grid of the same contexts."""
        return tuple(self.spec) == tuple(_spec(spec)) and (
            self.mesh is mesh or (
                self.mesh.axis_names == mesh.axis_names and
                self.mesh.devices.shape == mesh.devices.shape and
                list(self.mesh.devices.flat) == list(mesh.devices.flat)))

    @property
    def is_fully_replicated(self) -> bool:
        return all(name is None for name in self.spec)

    def __repr__(self):
        return "ShardedTensor(%s, %s)" % (self.spec, self.mesh)


def shard(x, mesh: Mesh, spec) -> ShardedTensor:
    """Place ``x`` on ``mesh`` with PartitionSpec ``spec`` (tuple of axis
    names / None, or a PartitionSpec)."""
    if isinstance(x, ShardedTensor):
        x = x.full()
    return ShardedTensor({c: _local_piece(x, spec, mesh, c)
                          for c in mesh.coords()}, mesh, spec)


def replicate(x, mesh: Mesh) -> ShardedTensor:
    return shard(x, mesh, PartitionSpec())


_local = threading.local()


def current_mesh():
    """The ambient mesh installed by ``set_current_mesh`` (None if unset)."""
    return getattr(_local, "mesh", None)


class set_current_mesh:
    """Context manager installing an ambient mesh, so higher layers can
    pick it up without plumbing."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_local, "mesh", None)
        _local.mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _local.mesh = self._prev
        return False
