"""Predictor — the serving/inference path.

Counterpart of ``mxnet_tpu/predictor.py`` (the reference C predict API,
c_predict_api.cc:41-280: load symbol JSON + param blob -> filter arg/aux
dicts -> InferShape -> static bind -> SetInput/Forward/GetOutput).  The
default context is the card, ``gpu(0)``; without CUDA a default-context
Predictor raises.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from .base import MXNetError
from .context import Context, gpu

__all__ = ["Predictor"]


class Predictor:
    """Static bound forward over a trained (symbol, params) checkpoint.

    Parameters
    ----------
    symbol : Symbol | str
        A Symbol, a path to ``prefix-symbol.json``, or a JSON string.
    params : dict | str
        ``{name: NDArray}`` (``arg:``/``aux:`` prefixes allowed, as stored
        by ``save_checkpoint``) or a path to a ``.params`` file.
    input_shapes : dict
        ``{input_name: shape}`` — static shapes, like MXPredCreate's
        input_keys/shape arrays.
    ctx : Context, default ``gpu(0)``
    """

    def __init__(self, symbol, params, input_shapes: Dict[str, Sequence[int]],
                 ctx: Optional[Context] = None, dtype=np.float32):
        from . import ndarray as nd
        from . import symbol as sym

        if isinstance(symbol, str):
            if os.path.exists(symbol):
                symbol = sym.load(symbol)
            else:
                symbol = sym.load_json(symbol)
        if isinstance(params, str):
            params = nd.load(params)
        arg_params, aux_params = {}, {}
        for k, v in params.items():
            tp, _, name = k.partition(":")
            if tp == "arg":
                arg_params[name] = v
            elif tp == "aux":
                aux_params[name] = v
            else:
                arg_params[k] = v

        self._ctx = ctx or gpu()
        self._symbol = symbol
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._dtype = np.dtype(dtype)

        arg_shapes, _, aux_shapes = symbol.infer_shape(**self._input_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from the given inputs")

        args = {}
        self._synthesized = set()
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in self._input_shapes:
                args[name] = nd.zeros(shape, self._ctx, dtype=self._dtype)
            elif name in arg_params:
                p = arg_params[name]
                if tuple(p.shape) != tuple(shape):
                    raise MXNetError(
                        "param %s shape %s does not match inferred %s"
                        % (name, tuple(p.shape), shape))
                # reshape() passes live device NDArrays: share, don't copy
                args[name] = p.as_in_context(self._ctx) \
                    if isinstance(p, nd.NDArray) else nd.array(p, self._ctx)
            else:
                # the reference allocates missing args without initializing
                # them (c_predict_api.cc:190-195); zero-fill for determinism
                # — loss labels in a saved training symbol bind as zeros
                args[name] = nd.zeros(shape, self._ctx, dtype=self._dtype)
                self._synthesized.add(name)
        aux = {}
        for name in symbol.list_auxiliary_states():
            if name not in aux_params:
                raise MXNetError("missing auxiliary state %r" % name)
            a = aux_params[name]
            aux[name] = a.as_in_context(self._ctx) \
                if isinstance(a, nd.NDArray) else nd.array(a, self._ctx)

        self._exec = symbol.bind(self._ctx, args, args_grad=None,
                                 grad_req="null", aux_states=aux)

    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_shapes, ctx=None,
                        dtype=np.float32):
        """Build a predictor straight from ``save_checkpoint`` files
        (``prefix-symbol.json`` + ``prefix-%04d.params``)."""
        return cls("%s-symbol.json" % prefix,
                   "%s-%04d.params" % (prefix, epoch),
                   input_shapes, ctx=ctx, dtype=dtype)

    # -- MXPredSetInput / MXPredForward / MXPredGetOutput parity ----------
    def set_input(self, name, value):
        if name not in self._input_shapes:
            raise MXNetError("unknown input %r" % name)
        self._exec.arg_dict[name][:] = value

    def forward(self, **inputs):
        for name, value in inputs.items():
            self.set_input(name, value)
        self._exec.forward(is_train=False)
        return self.get_outputs()

    def get_output(self, index):
        return self._exec.outputs[index]

    def get_outputs(self):
        return list(self._exec.outputs)

    def reshape(self, input_shapes):
        """Re-bind for new static input shapes (MXPredReshape).  Inputs not
        named keep their current shapes; parameters are shared."""
        params = {("arg:%s" % k): v for k, v in self._exec.arg_dict.items()
                  if k not in self._input_shapes
                  and k not in self._synthesized}
        params.update({("aux:%s" % k): v
                       for k, v in self._exec.aux_dict.items()})
        merged = dict(self._input_shapes)
        merged.update({k: tuple(v) for k, v in input_shapes.items()})
        return Predictor(self._symbol, params, merged, self._ctx, self._dtype)
