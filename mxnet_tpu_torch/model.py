"""Model-level helpers: checkpoints and the kvstore decision — counterpart
of ``mxnet_tpu/model.py`` for the training slice.

``save_checkpoint`` writes ``prefix-symbol.json`` and ``prefix-%04d.params``
(the ``.params`` bytes ``nd.save`` writes in both packages);
``load_checkpoint`` reads them back.  The port has no kvstore yet:
``_create_kvstore`` accepts what needs none — ``None``, or ``"local"`` /
``"device"`` on one device — and raises for anything else (several
devices, ``dist_*``, a KVStore object).  The JAX package's sidecars (CRC,
PRNG state, last-good marker, retention ring) are not ported.
"""
from __future__ import annotations

import collections
import logging

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = collections.namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore) for a kvstore spec: always (None, False)
    here, where one device needs no kvstore round trip."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str) and kvstore in ("local", "device") and \
            num_device == 1:
        return None, False
    raise MXNetError(
        "kvstore %r over %d device(s) is not ported yet: the port trains on "
        "one device with kvstore None or 'local'" % (kvstore, num_device))


def _update_params(param_arrays, grad_arrays, updater, num_device=1,
                   kvstore=None):
    """The replicated-updater path: the updater on every parameter with a
    gradient."""
    if kvstore is not None:
        raise MXNetError("_update_params: no kvstore in the port")
    for index, (arg, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        updater(index * num_device, grad, arg)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write prefix-symbol.json + prefix-%04d.params."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


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
