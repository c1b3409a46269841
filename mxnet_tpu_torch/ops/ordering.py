"""Ordering ops: ``sort``, ``argsort`` and ``topk``.

Counterparts of ``mxnet_tpu/ops/ordering.py:19-108``, with the same names,
parameters, output counts and shape inference; indices come back as floats
of the data's dtype.  Every order is built on the stable
``torch.sort(stable=True)``, so ties fall where the JAX package puts them:
``argsort`` flips the stable ascending order for ``is_ascend=False`` (the
last of equal values first), and ``topk`` puts the lower index first in
either direction, as ``lax.top_k`` does (``torch.topk`` promises no order
on ties).
"""
from __future__ import annotations

import torch

from .param import Param
from .registry import register

_SORT_SPEC = {"axis": Param("int-or-none", -1), "is_ascend": Param(bool, True)}


def _along(x, axis):
    """(x, axis) with the axis None meaning the flattened array."""
    if axis is None:
        return x.reshape(-1), 0
    return x, axis % x.ndim


@register("sort", params=dict(_SORT_SPEC))
def _sort(opctx, attrs, x):
    x, axis = _along(x, attrs.get("axis", -1))
    out = torch.sort(x, dim=axis, stable=True).values
    if not attrs.get("is_ascend", True):
        out = torch.flip(out, (axis,))
    return out


@register("argsort", params=dict(_SORT_SPEC), no_grad_inputs=("data",))
def _argsort(opctx, attrs, x):
    x, axis = _along(x, attrs.get("axis", -1))
    idx = torch.sort(x, dim=axis, stable=True).indices
    if not attrs.get("is_ascend", True):
        idx = torch.flip(idx, (axis,))
    return idx.to(x.dtype)


_TOPK_SPEC = {
    "axis": Param("int-or-none", -1),
    "k": Param(int, 1),
    "ret_typ": Param(str, "indices", enum=("value", "indices", "mask", "both")),
    "is_ascend": Param(bool, False),
}


def _topk_outputs(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


def _topk_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    n = _topk_outputs(attrs)
    if ishape is None:
        return in_shapes, [None] * n, []
    axis = attrs.get("axis", -1)
    k = attrs.get("k", 1)
    if attrs.get("ret_typ", "indices") == "mask":
        return in_shapes, [tuple(ishape)], []
    if axis is None:
        out = (k,)
    else:
        out = list(ishape)
        out[axis % len(ishape)] = k
        out = tuple(out)
    return in_shapes, [out] * n, []


@register("topk", params=dict(_TOPK_SPEC), num_outputs=_topk_outputs,
          infer_shape=_topk_infer, no_grad_inputs=("data",))
def _topk(opctx, attrs, x):
    """The k largest (``is_ascend``: smallest) along ``axis`` (the
    flattened array when None), in order, the lower index first among
    equal values: their values, their indices as floats, both, or a mask
    of the data's shape with 1 at each."""
    axis = attrs.get("axis", -1)
    k = int(attrs.get("k", 1))
    ret = attrs.get("ret_typ", "indices")
    xm = x.reshape(1, -1) if axis is None else x.movedim(axis % x.ndim, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=not attrs.get(
        "is_ascend", False), stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret == "mask":
        mask = torch.zeros_like(xm).scatter(-1, idx, 1.0)
        if axis is None:
            return mask.reshape(x.shape)
        return mask.movedim(-1, axis % x.ndim)
    if axis is None:
        vals, idx = vals.reshape(-1), idx.reshape(-1)
    else:
        vals = vals.movedim(-1, axis % x.ndim)
        idx = idx.movedim(-1, axis % x.ndim)
    fidx = idx.to(x.dtype)
    if ret == "value":
        return vals
    if ret == "indices":
        return fidx
    return vals, fidx
