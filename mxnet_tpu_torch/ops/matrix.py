"""Shape ops: ``Reshape`` with MXNet's special codes, ``Flatten``,
``slice_axis``, ``Concat`` and ``SliceChannel``.

Counterparts of ``mxnet_tpu/ops/matrix.py`` (``:74``, ``:83-92``, ``:133``,
``:252-271``, ``:291``).
``SliceChannel`` returns views of its input, so the attention kernel that
consumes its q/k/v outputs reads them through strides without a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from .param import Param
from .registry import register


def _reshape_target(ishape, target):
    """MXNet Reshape special codes (matrix_op-inl.h ReshapeParam): 0 copy dim,
    -1 infer, -2 copy remaining, -3 merge next two, -4 split (use next two)."""
    out = []
    src = list(ishape)
    i = 0
    t = list(target)
    k = 0
    while k < len(t):
        s = t[k]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = t[k + 1], t[k + 2]
            k += 2
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
        else:
            out.append(s)
            i += 1
        k += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(ishape)) if ishape else 1
        out[out.index(-1)] = total // known
    return tuple(int(d) for d in out)


def _reshape_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    target = attrs.get("shape") or attrs.get("target_shape")
    return in_shapes, [_reshape_target(ishape, target)], []


@register("Reshape", aliases=("reshape",),
          params={"shape": Param("shape", ()),
                  "target_shape": Param("shape-or-none", None),
                  "keep_highest": Param(bool, False),
                  "reverse": Param(bool, False)},
          infer_shape=_reshape_infer, hint="reshape")
def _reshape(opctx, attrs, x):
    target = attrs.get("shape") or attrs.get("target_shape")
    return torch.reshape(x, _reshape_target(tuple(x.shape), target))


@register("slice_axis",
          params={"axis": Param(int, required=True), "begin": Param(int, 0),
                  "end": Param("int-or-none", None)})
def _slice_axis(opctx, attrs, x):
    axis = attrs["axis"] % x.ndim
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(attrs.get("begin", 0), attrs.get("end"))
    return x[tuple(idx)]


def _slice_channel_outputs(attrs):
    return int(attrs.get("num_outputs", 1))


def _slice_channel_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    n = int(attrs.get("num_outputs", 1))
    if ishape is None:
        return in_shapes, [None] * n, []
    axis = attrs.get("axis", 1) % len(ishape)
    out = list(ishape)
    out[axis] //= n
    if attrs.get("squeeze_axis") and out[axis] == 1:
        del out[axis]
    return in_shapes, [tuple(out)] * n, []


@register("SliceChannel", aliases=("split",),
          params={"num_outputs": Param(int, required=True),
                  "axis": Param(int, 1),
                  "squeeze_axis": Param(bool, False)},
          num_outputs=_slice_channel_outputs, infer_shape=_slice_channel_infer,
          hint="slicechannel")
def _slice_channel(opctx, attrs, x):
    n = int(attrs["num_outputs"])
    axis = attrs.get("axis", 1) % x.ndim
    if x.shape[axis] % n:
        raise ValueError("SliceChannel: axis %d of extent %d does not split "
                         "into %d equal parts" % (axis, x.shape[axis], n))
    parts = torch.split(x, x.shape[axis] // n, dim=axis)
    if attrs.get("squeeze_axis"):
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _flatten_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    return in_shapes, [(ishape[0], int(np.prod(ishape[1:]))
                        if len(ishape) > 1 else 1)], []


@register("Flatten", aliases=("flatten",), infer_shape=_flatten_infer,
          hint="flatten")
def _flatten(opctx, attrs, x):
    return x.reshape(x.shape[0], -1)


def _concat_infer(attrs, in_shapes):
    dim = attrs.get("dim", 1)
    known = [s for s in in_shapes if s is not None]
    if not known:
        return in_shapes, [None], []
    base = list(known[0])
    total = 0
    for s in in_shapes:
        if s is None:
            return in_shapes, [None], []
        total += s[dim]
    base[dim] = total
    return in_shapes, [tuple(base)], []


@register("Concat", aliases=("concat",), key_var_num_args="num_args",
          params={"num_args": Param(int, required=True), "dim": Param(int, 1)},
          infer_shape=_concat_infer, hint="concat")
def _concat(opctx, attrs, *args):
    return torch.cat(args, dim=attrs.get("dim", 1))
