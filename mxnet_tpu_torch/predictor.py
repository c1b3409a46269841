"""Predictor — the serving/inference path.

Counterpart of ``mxnet_tpu/predictor.py`` (the reference C predict API,
c_predict_api.cc:41-280: load symbol JSON + param blob -> filter arg/aux
dicts -> InferShape -> static bind -> SetInput/Forward/GetOutput).  The
default context is the card, ``gpu(0)``; without CUDA a default-context
Predictor raises.

``Predictor.export``/``load_exported`` (the amalgamation story): where the
JAX package serializes its jitted forward with ``jax.export``, the port's
artifact is one file under its own magic holding the inputs' and
outputs' metadata, the symbol JSON and the ``.params`` bytes;
``load_exported`` rebuilds the forward from it, on the card by default.
Each package refuses the other's artifact by its magic (``MXNetError``).
"""
from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .base import MXNetError
from .context import Context, gpu

__all__ = ["Predictor", "load_exported"]

_EXPORT_MAGIC = b"MXTTEXP01"


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
            # arguments the inputs do not determine (the generation
            # engine's KV pool planes, bound as shared params) take the
            # shapes of the arrays given for them
            known = {k: tuple(v.shape) for k, v in arg_params.items()
                     if k in symbol.list_arguments() and hasattr(v, "shape")}
            known.update(self._input_shapes)
            arg_shapes, _, aux_shapes = symbol.infer_shape(**known)
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
        # the inputs' bytes are the CUDA graphs' static buffers
        self._exec._cache_inputs = frozenset(self._input_shapes) | \
            frozenset(self._synthesized)

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

    # -- AOT export (amalgamation equivalent) -----------------------------
    def export(self, path):
        """Write this predictor as one artifact: the inputs' names, shapes
        and dtype, the outputs' names, the symbol JSON and the parameters
        (``arg:``/``aux:``, the ``.params`` bytes).  ``load_exported``
        serves it without the code that built the model."""
        from . import ndarray as nd

        params = {("arg:%s" % k): v for k, v in self._exec.arg_dict.items()
                  if k not in self._input_shapes
                  and k not in self._synthesized}
        params.update({("aux:%s" % k): v
                       for k, v in self._exec.aux_dict.items()})
        buf = io.BytesIO()
        nd._save_stream(buf, params)
        blob = buf.getvalue()
        sym_json = self._symbol.tojson().encode()
        meta = json.dumps({
            "inputs": [[n, list(s), self._dtype.name]
                       for n, s in self._input_shapes.items()],
            "outputs": self._symbol.list_outputs(),
            "symbol_bytes": len(sym_json),
            "params_bytes": len(blob)}).encode()
        from .filesystem import atomic_write

        def writer(f):
            f.write(_EXPORT_MAGIC)
            f.write(len(meta).to_bytes(8, "little"))
            f.write(meta)
            f.write(sym_json)
            f.write(blob)

        atomic_write(path, writer, op="predictor.export")
        return path


class _ExportedPredictor:
    """A reloaded artifact: callable without the original model code.
    ``forward(**inputs)`` runs on ``ctx`` (default ``gpu(0)``)."""

    def __init__(self, meta, symbol_json, params_blob, ctx=None):
        self._meta = meta
        self.input_names = [m[0] for m in meta["inputs"]]
        self.output_names = meta["outputs"]
        self._symbol_json = symbol_json
        self._params_blob = params_blob
        self._ctx = ctx
        self._pred = None

    def _predictor(self):
        if self._pred is None:
            from . import ndarray as nd

            params = nd._load_stream(io.BytesIO(self._params_blob),
                                     self._ctx or gpu())
            shapes = {n: tuple(s) for n, s, _ in self._meta["inputs"]}
            dtype = self._meta["inputs"][0][2] if self._meta["inputs"] \
                else "float32"
            self._pred = Predictor(self._symbol_json, params, shapes,
                                   ctx=self._ctx, dtype=dtype)
        return self._pred

    def forward(self, **inputs):
        vals = {}
        for name, shape, dtype in self._meta["inputs"]:
            if name not in inputs:
                raise MXNetError("missing input %r" % name)
            vals[name] = np.asarray(inputs[name], dtype=dtype)
        return self._predictor().forward(**vals)


def load_exported(path, ctx=None):
    """Reload an artifact written by ``Predictor.export`` (deploy time
    needs only this loader).  An artifact of the JAX package (or any other
    file) raises :class:`MXNetError`."""
    with open(path, "rb") as f:
        magic = f.read(len(_EXPORT_MAGIC))
        if magic != _EXPORT_MAGIC:
            raise MXNetError("%s is not an exported predictor artifact of "
                             "this package" % path)
        mlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(mlen).decode())
        symbol_json = f.read(meta["symbol_bytes"]).decode()
        blob = f.read(meta["params_bytes"])
    if len(blob) != meta["params_bytes"]:
        raise MXNetError("%s is torn: its parameters are cut short" % path)
    return _ExportedPredictor(meta, symbol_json, blob, ctx)
