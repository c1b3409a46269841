"""Initialization ops: ``_zeros``, ``_ones``, ``_full``, ``_arange``,
``zeros_like``, ``ones_like`` and ``_set_value``.

Counterparts of ``mxnet_tpu/ops/init_ops.py:1-81``, with the same names,
parameters and shape inference.  The source ops have no input to take a
device from: they write to ``OpContext.device`` (the executor's device, the
context ``nd`` resolves, or ``meta`` during shape inference) and raise
without one.  ``_arange``'s values are computed in float64 on the host as
numpy does, then converted, as the JAX op does.
"""
from __future__ import annotations

import numpy as np
import torch

from .param import Param, torch_dtype
from .registry import register

_INIT_SPEC = {
    "shape": Param("shape", ()),
    "dtype": Param("dtype", "float32"),
    "ctx": Param(str, ""),
}


def _init_infer(attrs, in_shapes):
    return in_shapes, [tuple(attrs.get("shape") or ())], []


def _filled(opctx, attrs, name, value):
    return torch.full(tuple(attrs.get("shape") or ()), value,
                      dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=opctx.source_device(name))


@register("_zeros", inputs=(), params=dict(_INIT_SPEC),
          infer_shape=_init_infer, hint="zeros")
def _zeros(opctx, attrs):
    return _filled(opctx, attrs, "_zeros", 0)


@register("_ones", inputs=(), params=dict(_INIT_SPEC),
          infer_shape=_init_infer, hint="ones")
def _ones(opctx, attrs):
    return _filled(opctx, attrs, "_ones", 1)


@register("_full", inputs=(),
          params={**_INIT_SPEC, "value": Param(float, 0.0)},
          infer_shape=_init_infer, hint="full")
def _full(opctx, attrs):
    return _filled(opctx, attrs, "_full", attrs.get("value", 0.0))


def _arange_vals(attrs):
    start = attrs.get("start", 0.0)
    stop = attrs.get("stop")
    step = attrs.get("step", 1.0)
    rep = int(attrs.get("repeat", 1))
    if stop is None:
        start, stop = 0.0, start
    vals = np.arange(start, stop, step)
    if rep > 1:
        vals = np.repeat(vals, rep)
    return vals


@register("_arange", inputs=(),
          params={"start": Param(float, 0.0),
                  "stop": Param("float-or-none", None),
                  "step": Param(float, 1.0), "repeat": Param(int, 1),
                  "dtype": Param("dtype", "float32"), "ctx": Param(str, "")},
          infer_shape=lambda attrs, s: (s, [(len(_arange_vals(attrs)),)], []),
          hint="arange")
def _arange(opctx, attrs):
    device = opctx.source_device("_arange")
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    vals = _arange_vals(attrs)
    if device.type == "meta":
        return torch.empty(vals.shape, dtype=dtype, device=device)
    return torch.from_numpy(vals).to(device=device, dtype=dtype)


@register("zeros_like")
def _zeros_like(opctx, attrs, x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(opctx, attrs, x):
    return torch.ones_like(x)


@register("_set_value", inputs=(), params={"src": Param(float, 0.0)})
def _set_value(opctx, attrs, *a):
    """Imperative fill: a float32 scalar that ``out=`` broadcasts into its
    array (reference: ndarray.cc's _set_value NDArray function)."""
    return torch.tensor(attrs.get("src", 0.0), dtype=torch.float32,
                        device=opctx.source_device("_set_value"))
