"""KVStore — parameter synchronization, counterpart of
``mxnet_tpu/kvstore.py``.

``local`` and ``device`` (and the ``local_*`` aliases) keep one stored
array per key in one process.  Push semantics are the reference's
(kvstore_local.h:50-95): the values pushed for one key are summed on the
first value's device; with an updater installed the update runs on push
and pull returns the stored weight; without one the store holds the last
push's sum.  Pulling into an array on another device copies onto that
array's device.  ``dist_sync``/``dist_device_sync``/``dist`` are
``kvstore_dist.DistSyncKVStore`` over ``torch.distributed``; ``rank`` and
``num_workers`` come from its process group.  ``dist_async`` (the parameter
server) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

from .base import MXNetError
from .ndarray import NDArray
from . import ndarray as nd
from . import optimizer as opt

__all__ = ["KVStore", "create"]


def _key_list(key):
    return (key if isinstance(key, (list, tuple)) else [key]), \
        not isinstance(key, (list, tuple))


def _val_list(value, nkeys):
    if isinstance(value, (list, tuple)) and nkeys == 1 and \
            not isinstance(value[0], (list, tuple)):
        return [list(value)]
    if nkeys == 1:
        return [value if isinstance(value, list) else [value]]
    out = []
    for v in value:
        out.append(v if isinstance(v, list) else [v])
    return out


def _as_nd(v) -> NDArray:
    return v if isinstance(v, NDArray) else nd.array(v)


def _merge(vlist):
    """The sum of one key's pushed values, on the first value's device."""
    merged = vlist[0]
    if len(vlist) > 1:
        acc = vlist[0]._data
        for v in vlist[1:]:
            acc = acc + v._data.to(acc.device)
        merged = NDArray(acc, vlist[0].context)
    return merged


class KVStore:
    """Single-process key-value store (reference kvstore.h:26-286 'local' /
    'device')."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store: Dict[Union[int, str], NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None

    # -- identity ----------------------------------------------------------
    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        if "dist" in self._type:
            from .kvstore_dist import _rank

            return _rank()
        return 0

    @property
    def num_workers(self) -> int:
        if "dist" in self._type:
            from .kvstore_dist import _world

            return _world()
        return 1

    # -- data plane --------------------------------------------------------
    def init(self, key, value):
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, v in zip(keys, vals):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % str(k))
            self._store[k] = _as_nd(v[0]).copy()

    def _reduce(self, merged: NDArray) -> NDArray:
        """The sum over workers of a locally merged push (one worker
        here)."""
        return merged

    def push(self, key, value, priority=0):
        """Sum pushed values per key; run the updater on the sum if one is
        installed (reference KVStoreLocal::Push, kvstore_local.h:50)."""
        keys, _ = _key_list(key)
        vals = _val_list(value, len(keys))
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                raise MXNetError("push to uninitialized key %s" % str(k))
            merged = self._reduce(_merge([_as_nd(v) for v in vlist]))
            stored = self._store[k]
            if merged.context != stored.context:
                merged = merged.as_in_context(stored.context)
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                # no updater: the store holds the merged sum of this push
                # (reference KVStoreLocal::Push CopyFromTo(merged, &local))
                stored._set(merged._data.clone())

    def pull(self, key, out=None, priority=0):
        import torch

        keys, _ = _key_list(key)
        outs = _val_list(out, len(keys))
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("pull of uninitialized key %s" % str(k))
            src = self._store[k]._data
            for o in olist:
                # keep the destination's device and dtype: a pull copies
                # into the array, wherever it lives
                with torch.no_grad():
                    o._data.copy_(src)

    # -- synchronization ---------------------------------------------------
    def wait(self, keys=None):
        """Block until outstanding ops on ``keys`` (all, when None) have
        completed.  Synchronous flavors finish every push/pull before
        returning, so this is a no-op; ``comm_engine.AsyncKVStore``
        overrides it with a real barrier."""

    def wait_all(self):
        """Block until every outstanding op has completed (no-op here)."""

    def drain(self, timeout=None):
        """Finish outstanding async work (no-op for synchronous stores).
        Returns True once everything completed."""
        return True

    # -- control plane -----------------------------------------------------
    def set_optimizer(self, optimizer):
        """Install an optimizer as the store-side updater."""
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    def _barrier(self):
        pass

    def _send_command_to_servers(self, head, body):
        pass

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def create(name="local") -> KVStore:
    """Create a KVStore (reference KVStore::Create, kvstore.cc:17-45).
    'local'/'device' and the 'local_*' aliases → in-process aggregation;
    'dist_sync'/'dist_device_sync'/'dist' → the synchronous multi-process
    store over ``torch.distributed``; 'dist_async' is not ported yet."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name not in ("local", "local_update_cpu", "local_allreduce_cpu",
                    "local_allreduce_device", "device", "dist_sync",
                    "dist_device_sync", "dist_async", "dist"):
        raise MXNetError("unknown KVStore type %s" % name)
    if name == "dist_async":
        raise MXNetError(
            "kvstore 'dist_async' (the parameter server of kvstore_server.py, "
            "with elastic membership and wire compression) is not ported "
            "yet: it is slice A.4c of the port; use 'dist_sync'")
    if name in ("dist_sync", "dist_device_sync", "dist"):
        from .kvstore_dist import DistSyncKVStore

        return DistSyncKVStore(name)
    return KVStore(name)
