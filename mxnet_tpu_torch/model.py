"""Model-level helpers: checkpoints, the kvstore decision and the legacy
``FeedForward`` training API — counterpart of ``mxnet_tpu/model.py``.

``save_checkpoint`` writes ``prefix-symbol.json`` and ``prefix-%04d.params``
(the ``.params`` bytes ``nd.save`` writes in both packages) with the JAX
package's sidecars: the CRC32 file, the ``.state`` pickle, the
``-last-good`` marker and the pruned retention ring;
``load_checkpoint`` reads them back, ``find_latest_checkpoint`` picks the
newest intact (or last-good) epoch and ``load_checkpoint_state`` reads the
``.state`` pickle.  File names and bytes are the JAX package's, so each
package finds and loads the other's checkpoints; only ``.state``'s
``rng`` entry is per package (the JAX package's threefry key, this one's
generator states), and restoring the other package's raises
:class:`ForeignRNGStateError`.  ``FeedForward`` is the JAX package's
thin adapter over ``Module``: ``fit``, ``predict``, ``score``, ``save`` and
``load``; ``ctx=None`` is the current context, the card unless the caller
sets another.  ``_create_kvstore`` resolves a kvstore spec as the reference
does (model.py:40-77): none for one device unless the store is ``dist_*``,
``update_on_kvstore`` off for ``local`` when no parameter reaches 16M
elements; ``_update_params_on_kvstore`` pushes in backward order and pulls,
leaving an async store's traffic in flight when asked (over a sync-mode
parameter server it waits at a barrier between the two, which the JAX
package does not).
"""
from __future__ import annotations

import collections
import glob
import logging
import os
import pickle
import re
import struct

import numpy as np

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_checkpoint_state", "find_latest_checkpoint",
           "ForeignRNGStateError", "FeedForward"]


class ForeignRNGStateError(MXNetError):
    """``restore_rng`` was asked to restore a random state this package did
    not write (the JAX package's threefry key): each package's ``.state``
    keeps its own random stream; the rest of the state crosses."""

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """Resolve a kvstore spec to (kv, update_on_kvstore) (reference
    model.py:40-77)."""
    from . import kvstore as kvs

    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            # a single device group needs no kvstore round trip
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values()) \
                    if arg_params else 0
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore, skip_indices=()):
    """Every parameter into the store; with the update on the store, its
    value (rank 0's, for ``dist_sync``) pulled back into the executor.
    ``skip_indices``: parameters routed elsewhere (a row_sparse slot's
    table lives sharded on the servers' sparse plane and must never be
    shipped as a dense copy)."""
    skip = frozenset(skip_indices)
    for idx, param_on_devs in enumerate(param_arrays):
        if idx in skip:
            continue
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_order=None, defer_wait=False):
    """Centralized update: push grads, pull weights (reference model.py:88).

    All pushes are issued first, in ``param_order`` (backward order, the
    order gradients become available), each with ``priority=-index``;
    pulls follow in forward order.  On an async store nothing here blocks:
    with ``defer_wait`` the caller waits later (``Module._wait_async_comm``),
    otherwise a final ``wait_all`` restores the synchronous contract."""
    n = len(param_arrays)
    if param_order is None:
        param_order = range(n - 1, -1, -1)
    for index in param_order:
        if grad_arrays[index] is not None:
            kvstore.push(index, grad_arrays[index], priority=-index)
    if getattr(kvstore, "sync_rounds", False):
        # a sync-mode server applies a round once every worker pushed; a
        # pull before then would read the weights from before the round
        kvstore._barrier()
    for index in range(n):
        if grad_arrays[index] is not None:
            kvstore.pull(index, param_arrays[index], priority=-index)
    if not defer_wait:
        kvstore.wait_all()


def _update_params(param_arrays, grad_arrays, updater, num_device=1,
                   kvstore=None):
    """The replicated-updater path: with a kvstore, each gradient is pushed
    and the sum pulled back into it first; then the updater on every
    parameter with a gradient, all at once through ``Updater.update_list``
    (one list update), or one call each for a plain function."""
    items = [(index * num_device, grad, arg) for index, (arg, grad)
             in enumerate(zip(param_arrays, grad_arrays)) if grad is not None]
    if kvstore:
        for index, grad, _ in items:
            kvstore.push(index, grad, priority=-index)
            kvstore.pull(index, grad, priority=-index)
        kvstore.wait_all()
    if hasattr(updater, "update_list"):
        if items:
            updater.update_list(*(list(c) for c in zip(*items)))
        return
    for index, grad, arg in items:
        updater(index, grad, arg)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    max_to_keep=None, extra_state=None,
                    mark_last_good=False):
    """Write prefix-symbol.json + prefix-%04d.params and the sidecars.

    The params land atomically with a CRC32 sidecar (``.params.crc32``), so
    :func:`find_latest_checkpoint` can reject a torn or corrupted file.
    ``prefix-%04d.state`` pickles ``{"rng": random.get_state()}`` merged
    with ``extra_state`` (e.g. ``DataIter.state_dict()``).
    ``mark_last_good`` stamps this epoch into ``prefix-last-good``, the
    epoch discovery prefers; ``max_to_keep`` then prunes all but the newest
    N epochs (params, CRC and state), never the marked one."""
    from . import random as _random
    from .filesystem import atomic_write

    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict, checksum=True, op="ckpt.write")
    state = {"rng": _random.get_state()}
    if extra_state:
        state.update(extra_state)
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    atomic_write("%s-%04d.state" % (prefix, epoch),
                 lambda f: f.write(blob), checksum=False, op="ckpt.state")
    if mark_last_good:
        _mark_last_good(prefix, epoch)
    if max_to_keep is not None:
        _prune_checkpoints(prefix, int(max_to_keep))
    logging.info("Saved checkpoint to \"%s\"", param_name)


def _last_good_path(prefix):
    return "%s-last-good" % prefix


def _mark_last_good(prefix, epoch):
    """Atomically stamp ``epoch`` as the rollback target for ``prefix``."""
    from .filesystem import atomic_write

    atomic_write(_last_good_path(prefix),
                 lambda f: f.write(("%04d\n" % epoch).encode("ascii")),
                 checksum=False, op="ckpt.state")


def _read_last_good(prefix):
    """The epoch :func:`_mark_last_good` stamped, or None."""
    try:
        with open(_last_good_path(prefix), "r") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _saved_epochs(prefix):
    """(epoch, path) of every ``prefix-NNNN.params`` on disk."""
    out = []
    for path in glob.glob("%s-[0-9][0-9][0-9][0-9].params" % prefix):
        m = re.search(r"-(\d{4})\.params$", path)
        if m:
            out.append((int(m.group(1)), path))
    return out


def _prune_checkpoints(prefix, max_to_keep):
    """Delete all but the newest ``max_to_keep`` epochs of ``prefix``
    (params, CRC and state sidecars), never the last-good one."""
    if max_to_keep < 1:
        return
    keep_always = _read_last_good(prefix)
    epochs = sorted((ep for ep, _ in _saved_epochs(prefix)), reverse=True)
    for ep in epochs[max_to_keep:]:
        if ep == keep_always:
            continue
        for suffix in (".params", ".params.crc32", ".state"):
            try:
                os.remove("%s-%04d%s" % (prefix, ep, suffix))
            except OSError:
                pass


def load_checkpoint_state(prefix, epoch, restore_rng=False):
    """The ``.state`` dict :func:`save_checkpoint` wrote (None without
    one).  ``restore_rng`` feeds its random state back into ``random``;
    a state the JAX package wrote carries its threefry key instead and
    raises :class:`ForeignRNGStateError`."""
    from . import random as _random

    try:
        with open("%s-%04d.state" % (prefix, epoch), "rb") as f:
            state = pickle.load(f)
    except OSError:
        return None
    if restore_rng and "rng" in state:
        rng = state["rng"]
        if not isinstance(rng, dict) or "generators" not in rng:
            raise ForeignRNGStateError(
                "%s-%04d.state holds another package's random state (%s); "
                "this package restores only its own generator states — "
                "load it with restore_rng=False" % (
                    prefix, epoch, sorted(rng) if isinstance(rng, dict)
                    else type(rng).__name__))
        _random.set_state(rng)
    return state


def _checkpoint_ok(path):
    """Is ``path`` a loadable .params file?  The CRC sidecar's verdict when
    there is one, else the container's magic."""
    from .filesystem import verify_crc_sidecar

    verdict = verify_crc_sidecar(path)
    if verdict is not None:
        return verdict
    try:
        with open(path, "rb") as f:
            head = f.read(8)
        return len(head) == 8 and struct.unpack("<Q", head)[0] == nd._MAGIC
    except OSError:
        return False


def find_latest_checkpoint(prefix, prefer_last_good=True):
    """The newest intact epoch of ``prefix`` (prefix-%04d.params), or None.

    Files that fail their CRC sidecar, or carry no sidecar and a bad magic,
    are skipped.  With ``prefer_last_good`` an intact ``prefix-last-good``
    epoch wins over anything newer."""
    if prefer_last_good:
        marked = _read_last_good(prefix)
        if marked is not None and \
                _checkpoint_ok("%s-%04d.params" % (prefix, marked)):
            return marked
    best = None
    for ep, path in _saved_epochs(prefix):
        if not _checkpoint_ok(path):
            logging.warning("skipping corrupt checkpoint %s", path)
            continue
        best = ep if best is None else max(best, ep)
    return best


def load_checkpoint(prefix, epoch, ctx=None):
    """(symbol, arg_params, aux_params) of a checkpoint; arrays go to
    ``ctx``, or to the context each array's header records."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API over ``Module``, so the reference's scripts
    run unchanged: ``fit`` builds a ``Module`` from the training iterator's
    names and trains it; ``predict``/``score`` run the trained module, or
    one bound to ``arg_params``/``aux_params`` (after ``load``).  ``ctx``
    None is the current context."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self, data, label_name="softmax_label"):
        from .module import Module

        data_names = [d[0] for d in data.provide_data]
        label_names = [lab[0] for lab in data.provide_label] or [label_name]
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs on ``X`` (an iterator, or arrays with
        labels ``y``), with the optimizer and its kwargs given at
        construction."""
        train_data = self._as_iter(X, y)
        mod = self._get_module(train_data)
        optimizer_params = dict(self.kwargs)
        optimizer_params.setdefault("learning_rate", 0.01)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=optimizer_params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _bound_module(self, data, with_labels):
        if self._module is None:  # e.g. right after FeedForward.load
            mod = self._get_module(data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label if with_labels else None,
                     for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=False)
            self._module = mod
        return self._module

    def predict(self, X, num_batch=None):
        """The outputs on ``X`` as numpy, padding rows dropped."""
        data = self._as_iter(X, None)
        outs = self._bound_module(data, False).predict(data,
                                                       num_batch=num_batch)
        return outs.asnumpy() if hasattr(outs, "asnumpy") else outs

    def score(self, X, y=None, eval_metric="acc"):
        """The value of ``eval_metric`` on ``X``."""
        data = self._as_iter(X, y)
        return self._bound_module(data, True).score(data, eval_metric)[0][1]

    def _as_iter(self, X, y):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, self.numpy_batch_size, shuffle=False)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)
