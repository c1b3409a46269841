"""Sharded checkpoints — the sharded half of ``mxnet_tpu/checkpoint.py``.

The ``.params`` format (``nd.save``/``nd.load``, ``model.save_checkpoint``)
stays the interchange format.  A sharded checkpoint is keyed by the same
name->array dicts and written as the pieces the arrays are stored in, so
a tensor-parallel layout saves and restores without a whole-tensor gather:

* ``prefix-symbol.json`` beside ``prefix-NNNN.orbax/`` (the JAX package's
  directory name and API);
* in the directory, one ``.params`` stream (``nd.save``) per piece and
  process, ``piece-<coordinate>.rank<r>.params``, holding every array's
  block at that mesh coordinate (an unsharded array's one piece is in
  ``piece-whole.rank<r>.params``), and ``layout.json``, the arrays'
  global shapes, the specs their pieces were cut by and the axes of the
  mesh they were cut on;
* the sidecars of the JAX package, each through ``filesystem.
  atomic_write``: ``partition_specs.json`` (its JSON form),
  ``extra_state.pkl`` (``random.get_state()``) and, last, the
  ``mxnet_complete`` marker.

The JAX package's payload is an orbax tree (tensorstore); the port writes
its own, so it cannot read an orbax payload written by the JAX package,
nor the JAX package one written by the port (a kept difference).

The AOT half: ``aot_bundle_path``, ``save_aot_bundle`` and
``attach_aot_bundle`` write and attach ``prefix-NNNN.aot/``, the
compile-once bundle (``compile_cache.save_bundle``/``attach_bundle``)
beside the params.  A bundle the JAX package wrote is refused with
``MXNetError``, as a bundle of another topology is.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

from .base import MXNetError

__all__ = ["save_sharded_checkpoint", "load_sharded_checkpoint",
           "load_sharded_checkpoint_state", "load_partition_specs",
           "aot_bundle_path", "save_aot_bundle", "attach_aot_bundle"]

# written (by process 0) only after every process's pieces have landed; a
# directory without it is a crash-torn save
_COMPLETE_MARKER = "mxnet_complete"

# per-parameter PartitionSpec metadata saved next to the weights, so a
# tensor-parallel layout restores onto a fresh mesh (same axis names)
_SPEC_FILE = "partition_specs.json"

# the random stream (random.get_state()) pickled next to the weights —
# restoring it is half of bit-deterministic resume
_STATE_FILE = "extra_state.pkl"

# the arrays' global shapes and dtypes and the saving mesh's axes
_LAYOUT_FILE = "layout.json"


def _path(prefix, epoch):
    return os.path.abspath("%s-%04d.orbax" % (prefix, epoch))


# the tag of an unsharded array's one piece
_WHOLE = "whole"


def _piece_file(coord, rank):
    tag = _WHOLE if coord is None else "-".join(str(c) for c in coord)
    return "piece-%s.rank%d.params" % (tag, rank)


def _spec_to_json(spec):
    return [list(e) if isinstance(e, (tuple, list)) else
            (None if e is None else str(e)) for e in tuple(spec)]


def _spec_from_json(entries):
    from .parallel.mesh import PartitionSpec

    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in entries])


def _group():
    from . import kvstore_dist

    return kvstore_dist._rank(), kvstore_dist._world()


def _barrier():
    from . import kvstore_dist

    if kvstore_dist._world() > 1:
        kvstore_dist._dist().barrier()


def save_sharded_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                            partition_specs=None):
    """Write ``prefix-symbol.json`` + ``prefix-<epoch>.orbax/``.  In a
    multi-process job every process calls this collectively and writes its
    own pieces.

    Each array's PartitionSpec (read off its pieces, or from
    ``partition_specs`` = {name: PartitionSpec} overrides) is saved as
    ``partition_specs.json``, so the layout restores onto a fresh mesh via
    ``load_sharded_checkpoint(..., mesh=...)``."""
    from . import ndarray as nd
    from . import random as _random
    from .filesystem import atomic_write
    from .parallel.mesh import ShardedTensor

    rank, _ = _group()
    if symbol is not None and rank == 0:
        # one writer: processes saving together must not race on it
        symbol.save("%s-symbol.json" % prefix)
    path = _path(prefix, epoch)
    os.makedirs(path, exist_ok=True)
    if rank == 0 and os.path.exists(os.path.join(path, _COMPLETE_MARKER)):
        os.remove(os.path.join(path, _COMPLETE_MARKER))
    overrides = partition_specs or {}
    files, specs, layout = {}, {}, {"mesh": None, "arrays": {}}
    for grp, sub in (("arg", arg_params or {}), ("aux", aux_params or {})):
        specs[grp], layout["arrays"][grp] = {}, {}
        for name, arr in sub.items():
            x = arr._data if isinstance(arr, nd.NDArray) else arr
            if isinstance(x, ShardedTensor):
                layout["mesh"] = [[a, int(x.mesh.shape[a])]
                                  for a in x.mesh.axis_names]
                pieces, cut = x.shards, x.spec
            else:
                pieces, cut = {None: x}, ()
            specs[grp][name] = _spec_to_json(overrides.get(name, cut))
            layout["arrays"][grp][name] = {"shape": list(x.shape),
                                           "spec": _spec_to_json(cut)}
            for coord, piece in pieces.items():
                files.setdefault(coord, {})["%s:%s" % (grp, name)] = \
                    nd.NDArray(piece.detach(), nd._context_of(piece.device))
    for stale in os.listdir(path):
        if stale.endswith(".rank%d.params" % rank):
            os.remove(os.path.join(path, stale))
    for coord, arrays in files.items():
        nd.save(os.path.join(path, _piece_file(coord, rank)), arrays)
    _barrier()
    if rank == 0:
        atomic_write(os.path.join(path, _LAYOUT_FILE),
                     lambda f: f.write(json.dumps(layout).encode()),
                     op="ckpt.write")
        atomic_write(os.path.join(path, _SPEC_FILE),
                     lambda f: f.write(json.dumps(specs, indent=1).encode()),
                     op="ckpt.write")
        blob = pickle.dumps({"rng": _random.get_state()},
                            protocol=pickle.HIGHEST_PROTOCOL)
        atomic_write(os.path.join(path, _STATE_FILE),
                     lambda f: f.write(blob), op="ckpt.state")
        # the sidecars land BEFORE the marker: a complete checkpoint always
        # has its layout metadata
        atomic_write(os.path.join(path, _COMPLETE_MARKER),
                     lambda f: f.write(b"ok\n"), op="ckpt.write")
    _barrier()
    return path


def load_sharded_checkpoint_state(prefix, epoch, restore_rng=False):
    """The extra-state dict saved inside a sharded checkpoint (the random
    stream), or None without one.  ``restore_rng`` feeds the stream back
    into ``random``."""
    from . import random as _random

    try:
        with open(os.path.join(_path(prefix, epoch), _STATE_FILE),
                  "rb") as f:
            state = pickle.load(f)
    except OSError:
        return None
    if restore_rng and "rng" in state:
        _random.set_state(state["rng"])
    return state


def load_partition_specs(prefix, epoch):
    """{"arg"/"aux": {name: PartitionSpec}} saved with the checkpoint, or
    None without spec metadata."""
    spec_path = os.path.join(_path(prefix, epoch), _SPEC_FILE)
    if not os.path.exists(spec_path):
        return None
    with open(spec_path) as f:
        raw = json.load(f)
    return {grp: {k: _spec_from_json(v) for k, v in sub.items()}
            for grp, sub in raw.items()}


def _read_pieces(path, ctx_of):
    """{(group, name): {coord: NDArray}}: every piece file of this
    process (rank 0's where it wrote none), each read onto the context
    ``ctx_of(coord)`` gives (None: the context it was saved from); the
    coordinate of an unsharded array's one piece is None."""
    from . import ndarray as nd

    rank, _ = _group()
    names = sorted(os.listdir(path))
    mine = [n for n in names if n.endswith(".rank%d.params" % rank)]
    if not mine:
        mine = [n for n in names if n.endswith(".rank0.params")]
    out = {}
    for fname in mine:
        tag = fname[len("piece-"):fname.index(".rank")]
        coord = None if tag == _WHOLE else \
            tuple(int(c) for c in tag.split("-"))
        for key, arr in nd.load(os.path.join(path, fname),
                                ctx_of(coord)).items():
            grp, _, name = key.partition(":")
            out.setdefault((grp, name), {})[coord] = arr
    return out


def load_sharded_checkpoint(prefix, epoch, shardings=None, mesh=None):
    """-> (symbol_or_None, arg_params, aux_params) as NDArray dicts.

    ``shardings``: optional ``{"arg"/"aux": {name: sharding.
    NamedSharding}}`` restoring those arrays onto a mesh.  ``mesh``:
    rebuild the shardings from the checkpoint's own
    ``partition_specs.json`` against this mesh (same axis names).  Where
    the target mesh has the saving mesh's axes and sizes and the array's
    spec is the one its pieces were cut by, each piece is read straight
    onto its own coordinate's context, with no whole-tensor gather;
    elsewhere the array is assembled and split anew.  Without either,
    every array comes back whole, on the context it was saved from."""
    from . import ndarray as nd
    from . import symbol as sym
    from .parallel.mesh import ShardedTensor
    from .sharding.mesh import build_mesh
    from .sharding.placement import NamedSharding, place

    path = _path(prefix, epoch)
    if not os.path.isdir(path):
        raise MXNetError("no sharded checkpoint at %s" % path)
    if not os.path.exists(os.path.join(path, _COMPLETE_MARKER)):
        raise MXNetError(
            "sharded checkpoint %s is incomplete (no completion marker): "
            "the saving job likely crashed mid-write — fall back to an "
            "earlier epoch" % path)
    if mesh is not None and shardings is None:
        saved = load_partition_specs(prefix, epoch)
        if saved is None:
            raise MXNetError(
                "checkpoint %s has no partition-spec metadata; pass "
                "explicit shardings= to restore onto a mesh" % path)
        known = set(mesh.axis_names)
        for grp, sub in saved.items():
            for name, spec in sub.items():
                used = {ax for e in tuple(spec) if e is not None
                        for ax in (e if isinstance(e, tuple) else (e,))}
                if not used <= known:
                    raise MXNetError(
                        "checkpoint spec for %s/%s uses mesh axes %s absent "
                        "from the target mesh %s"
                        % (grp, name, sorted(used - known),
                           tuple(mesh.axis_names)))
        shardings = {grp: {k: NamedSharding(mesh, spec)
                           for k, spec in sub.items()}
                     for grp, sub in saved.items()}
    shardings = shardings or {}
    with open(os.path.join(path, _LAYOUT_FILE)) as f:
        layout = json.load(f)
    axes = [tuple(a) for a in layout["mesh"] or ()]
    targets = [t for sub in shardings.values() for t in sub.values()
               if t is not None]
    grid = targets[0].mesh if targets and [
        (a, int(targets[0].mesh.shape[a]))
        for a in targets[0].mesh.axis_names] == axes else None
    pieces = _read_pieces(path, lambda coord: None if grid is None or
                          coord is None else grid.devices[coord])
    out = {"arg": {}, "aux": {}}
    for (grp, name), by_coord in pieces.items():
        target = shardings.get(grp, {}).get(name)
        if None in by_coord:
            held, ctx = by_coord[None]._data, by_coord[None].context
        else:
            ctx = next(iter(by_coord.values())).context
            held = ShardedTensor(
                {c: a._data for c, a in by_coord.items()},
                grid or build_mesh(axes, [ctx] * int(
                    np.prod([n for _, n in axes]))),
                _spec_from_json(layout["arrays"][grp][name]["spec"]))
        if target is not None:
            out[grp][name] = nd.NDArray(
                place(held, target.mesh, target.spec),
                target.mesh.devices.flat[0])
        else:
            out[grp][name] = nd.NDArray(
                held.full() if isinstance(held, ShardedTensor) else held,
                ctx)
    symbol = None
    sym_path = "%s-symbol.json" % prefix
    if os.path.exists(sym_path):
        symbol = sym.load(sym_path)
    return symbol, out["arg"], out["aux"]


# ---------------------------------------------------------------------------
# AOT bundles — the compiled half of a checkpoint.  Params say WHAT the
# model computes; the bundle carries what a fresh replica needs to warm
# without building anything (plan entries, the kernels' libraries and
# cubins, the tuning winners) and a warm-up manifest.
# ---------------------------------------------------------------------------

def aot_bundle_path(prefix, epoch):
    """``prefix-NNNN.aot/`` next to the params — same naming family as
    ``prefix-NNNN.params`` / ``prefix-NNNN.orbax``."""
    return os.path.abspath("%s-%04d.aot" % (prefix, epoch))


def save_aot_bundle(prefix, epoch, entries, warmup=None):
    """Write the AOT bundle beside a checkpoint.

    ``entries``: primed ``compile_cache.CachedFunction`` wrappers —
    typically ``InferenceServer.compiled_entries()``, one per warmed
    bucket.  ``warmup``: a manifest dict (input shapes, buckets, dtype)
    recording how to re-drive the same warm-up.  Returns the bundle
    path."""
    from . import compile_cache

    return compile_cache.save_bundle(aot_bundle_path(prefix, epoch),
                                     entries, warmup=warmup)


def attach_aot_bundle(prefix, epoch, mesh=None):
    """Attach ``prefix-NNNN.aot/`` as a read-only compile-cache overlay;
    returns the manifest (or None when no bundle exists).  Raises
    :class:`MXNetError` when the bundle was written by another framework
    or for another device topology or mesh."""
    from . import compile_cache, faults

    # chaos seam: checkpoint.aot.attach:ioerr=1 simulates a torn or
    # unreadable bundle mid-fault-in (the platform leak-path drill)
    faults.fire("checkpoint.aot.attach")
    path = aot_bundle_path(prefix, epoch)
    if not os.path.exists(os.path.join(path, compile_cache.MANIFEST_NAME)):
        return None
    return compile_cache.attach_bundle(path, mesh=mesh)
