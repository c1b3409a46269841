"""``shard_map`` and its collectives over the port's mesh — the
counterpart of ``mxnet_tpu/parallel/_compat.py`` and of the ``lax``
collectives the JAX package's per-shard functions call.

``shard_map(f, mesh=, in_specs=, out_specs=)`` splits its global inputs
into one piece per shard (``mesh._local_piece``), runs ``f`` on every
shard at once, one thread each, and concatenates the shards' outputs back
into global tensors under ``out_specs`` on shard 0's device.  Inside ``f``
the collectives ``axis_index``, ``ppermute``, ``psum``, ``all_gather`` and
``all_to_all`` (tiled) exchange values between the shards of one mesh axis:
every shard posts its value, all meet at a barrier, and each takes what it
receives with ``Tensor.to(its device)`` — a no-op view when both shards
share a device, so a received block must never be updated in place.  The
controller is single, so the whole computation is one autograd graph: a
collective's gradient needs no collective of its own, the backward of
``.to`` and of the sums carries it home.
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from .mesh import Mesh, PartitionSpec, ShardedTensor, _assemble, _local_piece

__all__ = ["shard_map", "axis_index", "ppermute", "psum", "all_gather",
           "all_to_all"]

#: seconds a shard waits at a collective before the call is given up
BARRIER_TIMEOUT = 600.0


class _Exchange:
    """One shard_map call's meeting point: a slot per shard and a barrier."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.coords = mesh.coords()
        self.flat = {c: i for i, c in enumerate(self.coords)}
        self.slots = [None] * len(self.coords)
        self.barrier = threading.Barrier(len(self.coords),
                                         timeout=BARRIER_TIMEOUT)

    def wait(self):
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise MXNetError("shard_map: another shard failed or a "
                             "collective timed out") from None


_state = threading.local()


def _shard():
    st = getattr(_state, "shard", None)
    if st is None:
        raise MXNetError("collectives run only inside a shard_map function")
    return st


def _post(value):
    """Every shard's value, once all shards posted theirs."""
    ex, i, _ = _shard()
    ex.slots[i] = value
    ex.wait()
    got = list(ex.slots)
    ex.wait()  # nobody posts the next collective before all have read
    return got


def _group(axis):
    """(flat indices of this shard's group along ``axis``, in axis order;
    this shard's coordinate on it)."""
    ex, _, coord = _shard()
    if axis not in ex.mesh.axis_names:
        raise MXNetError("unknown mesh axis %r (mesh axes %s)"
                         % (axis, ex.mesh.axis_names))
    p = ex.mesh.axis_names.index(axis)
    members = []
    for j in range(ex.mesh.shape[axis]):
        c = list(coord)
        c[p] = j
        members.append(ex.flat[tuple(c)])
    return members, coord[p]


def _device():
    ex, _, coord = _shard()
    return ex.mesh.torch_device(coord)


def axis_index(axis) -> int:
    """This shard's coordinate along ``axis``."""
    return _group(axis)[1]


def ppermute(x, axis, perm):
    """``lax.ppermute``: along ``axis``, shard ``dst`` receives ``src``'s x
    for each (src, dst) of ``perm``; a shard no pair names receives
    zeros."""
    import torch

    members, me = _group(axis)
    got = _post(x)
    src = [s for s, d in perm if d == me]
    if not src:
        return torch.zeros_like(x)
    return got[members[src[0]]].to(_device())


def psum(x, axis):
    """``lax.psum``: the sum of x over ``axis``, added in axis order on
    every shard (so every shard holds the same bits)."""
    members, _ = _group(axis)
    got = _post(x)
    dev = _device()
    acc = got[members[0]].to(dev)
    for m in members[1:]:
        acc = acc + got[m].to(dev)
    return acc


def all_gather(x, axis, *, dim=0, tiled=False):
    """``lax.all_gather``: every shard's x along ``axis``, stacked on a new
    ``dim`` (concatenated along it when ``tiled``)."""
    import torch

    members, _ = _group(axis)
    got = _post(x)
    pieces = [got[m].to(_device()) for m in members]
    return torch.cat(pieces, dim) if tiled else torch.stack(pieces, dim)


def all_to_all(x, axis, split_axis, concat_axis, tiled=True):
    """``lax.all_to_all(..., tiled=True)``: x split into n chunks along
    ``split_axis``; shard j receives chunk j of every shard, concatenated
    along ``concat_axis`` in axis order."""
    import torch

    if not tiled:
        raise MXNetError("all_to_all: only the tiled form is ported")
    members, me = _group(axis)
    n = len(members)
    if x.shape[split_axis] % n:
        raise ValueError("all_to_all: dim %d of size %d does not split %d "
                         "ways" % (split_axis, x.shape[split_axis], n))
    got = _post(x)
    dev = _device()
    return torch.cat([got[m].chunk(n, split_axis)[me].to(dev)
                      for m in members], concat_axis)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _broadcast_spec(spec, tree):
    """A spec given for a whole pytree applies to each of its leaves."""
    if isinstance(spec, PartitionSpec) or spec is None:
        return _tree_map(lambda _: spec, tree)
    return spec


def _piece(x, spec, mesh, coord):
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and x.spec == PartitionSpec(*(spec or ())):
            return x.piece(coord)
        x = x.full()
    if spec is None:
        return x
    return _local_piece(x, spec, mesh, coord)


def shard_map(f, *, mesh: Mesh, in_specs, out_specs, check_vma=None):
    """Run ``f`` once per shard of ``mesh`` on its pieces of the inputs
    (split by ``in_specs``) and assemble the outputs (``out_specs``).
    ``check_vma`` is accepted for the JAX signature."""
    import torch

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError("shard_map: %d inputs for %d in_specs"
                             % (len(args), len(in_specs)))
        coords = mesh.coords()
        specs = [_broadcast_spec(s, a) for s, a in zip(in_specs, args)]
        local = [tuple(_tree_map(lambda x, s: _piece(x, s, mesh, c), a, s)
                       for a, s in zip(args, specs)) for c in coords]
        ex = _Exchange(mesh)
        results = [None] * len(coords)
        errors = [None] * len(coords)
        grad = torch.is_grad_enabled()

        def worker(i):
            torch.set_grad_enabled(grad)
            dev = mesh.torch_device(coords[i])
            if dev.type == "cuda":
                torch.cuda.set_device(dev)  # the thread's current context
            _state.shard = (ex, i, coords[i])
            try:
                results[i] = f(*local[i])
            except BaseException as e:  # raised by the caller below
                errors[i] = e
                ex.barrier.abort()
            finally:
                _state.shard = None

        threads = [threading.Thread(target=worker, args=(i,), daemon=True,
                                    name="shard-%d" % i)
                   for i in range(len(coords))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            first = next((e for e in failed if not isinstance(e, MXNetError)
                          or "another shard" not in str(e)), failed[0])
            raise first
        return _assemble_tree(dict(zip(coords, results)),
                              _broadcast_spec(out_specs, results[0]), mesh,
                              coords)

    return run


def _assemble_tree(by_coord, spec, mesh, coords):
    first = by_coord[coords[0]]
    if isinstance(first, (list, tuple)) and not isinstance(spec,
                                                           PartitionSpec):
        return type(first)(_assemble_tree({c: v[i] for c, v in
                                           by_coord.items()}, spec[i], mesh,
                                          coords)
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _assemble_tree({c: v[k] for c, v in by_coord.items()},
                                  spec[k], mesh, coords) for k in first}
    return _assemble(by_coord, spec, mesh)
