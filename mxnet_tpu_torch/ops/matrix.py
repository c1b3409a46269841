"""Shape and product ops: ``Reshape`` with MXNet's special codes,
``Flatten``, ``slice_axis``, ``Concat``, ``SliceChannel``, ``transpose``,
``expand_dims``, ``SwapAxis``, ``Cast``, ``slice`` and the slice
assignments, ``clip``, ``repeat``, ``tile``, ``reverse``, ``where``,
``dot``, ``batch_dot``, ``Pad`` and ``Crop``.

Counterparts of ``mxnet_tpu/ops/matrix.py``, with the same names, aliases,
parameters and shape inference.  ``dot`` and ``batch_dot`` are plain
products (``torch.tensordot``/``torch.matmul``, TF32 off), as the JAX
package leaves them to XLA.
``SliceChannel`` returns views of its input, so the attention kernel that
consumes its q/k/v outputs reads them through strides without a copy.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .param import Param, torch_dtype
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


# ---------------------------------------------------------------------------
# Layout ops, slicing and assignment
# ---------------------------------------------------------------------------


@register("transpose", params={"axes": Param("shape", ())})
def _transpose(opctx, attrs, x):
    """``x`` with its axes permuted by ``axes``, reversed when none."""
    axes = attrs.get("axes") or tuple(reversed(range(x.ndim)))
    return x.permute(*axes)


@register("expand_dims", params={"axis": Param(int, required=True)})
def _expand_dims(opctx, attrs, x):
    return x.unsqueeze(attrs["axis"])


@register("SwapAxis", aliases=("swapaxes", "SwapAxes"),
          params={"dim1": Param(int, 0), "dim2": Param(int, 0)},
          hint="swapaxis")
def _swapaxis(opctx, attrs, x):
    return x.transpose(attrs.get("dim1", 0), attrs.get("dim2", 0))


@register("Cast", aliases=("cast",),
          params={"dtype": Param("dtype", required=True)}, hint="cast")
def _cast(opctx, attrs, x):
    return x.to(torch_dtype(attrs["dtype"]))


def _box(begin, end):
    """The index of the box [begin, end) (an end of 0 runs to the end)."""
    return tuple(slice(b, e if e != 0 else None) for b, e in zip(begin, end))


@register("slice", aliases=("crop",),
          params={"begin": Param("shape", required=True),
                  "end": Param("shape", required=True)})
def _slice(opctx, attrs, x):
    return x[_box(attrs["begin"], attrs["end"])]


@register("_slice_assign", aliases=("_crop_assign",), inputs=("lhs", "rhs"),
          params={"begin": Param("shape", required=True),
                  "end": Param("shape", required=True)})
def _slice_assign(opctx, attrs, lhs, rhs):
    """A copy of ``lhs`` with the box [begin, end) set to ``rhs``."""
    out = lhs.clone()
    out[_box(attrs["begin"], attrs["end"])] = rhs
    return out


@register("_crop_assign_scalar",
          params={"begin": Param("shape", required=True),
                  "end": Param("shape", required=True),
                  "scalar": Param(float, 0.0)})
def _crop_assign_scalar(opctx, attrs, x):
    out = x.clone()
    out[_box(attrs["begin"], attrs["end"])] = attrs.get("scalar", 0.0)
    return out


@register("clip", params={"a_min": Param(float, required=True),
                          "a_max": Param(float, required=True)})
def _clip(opctx, attrs, x):
    return torch.clamp(x, attrs["a_min"], attrs["a_max"])


@register("repeat", params={"repeats": Param(int, required=True),
                            "axis": Param("int-or-none", None)})
def _repeat(opctx, attrs, x):
    """Each element ``repeats`` times along ``axis`` (of the flattened
    array when None), as ``np.repeat``."""
    return torch.repeat_interleave(x, attrs["repeats"], dim=attrs.get("axis"))


@register("tile", params={"reps": Param("shape", required=True)})
def _tile(opctx, attrs, x):
    return torch.tile(x, tuple(attrs["reps"]))


@register("reverse", aliases=("flip",),
          params={"axis": Param("shape", required=True)})
def _reverse(opctx, attrs, x):
    axis = attrs["axis"]
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


@register("where", inputs=("condition", "x", "y"))
def _where(opctx, attrs, cond, x, y):
    return torch.where(cond.to(torch.bool), x, y)


@register("_identity_with_attr_like_rhs", inputs=("lhs", "rhs"),
          no_grad_inputs=("rhs",))
def _identity_like_rhs(opctx, attrs, lhs, rhs):
    return lhs


# ---------------------------------------------------------------------------
# dot / batch_dot: plain products (torch.matmul, TF32 off)
# ---------------------------------------------------------------------------

_DOT_SPEC = {"transpose_a": Param(bool, False),
             "transpose_b": Param(bool, False)}


def _dot_infer(attrs, in_shapes):
    """The JAX package's rule, kept as it is: it takes ``rhs``'s first axis
    as the contracted one, where the op (``np.dot``) contracts its
    second-to-last, so the two disagree once ``rhs`` has 3 or more axes
    (ROADMAP C)."""
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    ta, tb = attrs.get("transpose_a", False), attrs.get("transpose_b", False)
    if len(a) == 1 and len(b) == 1:
        return in_shapes, [(1,)], []
    am = a[::-1] if ta else a
    bm = b[::-1] if tb else b
    return in_shapes, [tuple(am[:-1] + bm[1:])], []


def _reversed_axes(x):
    return x.permute(*reversed(range(x.ndim)))


@register("dot", inputs=("lhs", "rhs"), params=dict(_DOT_SPEC),
          infer_shape=_dot_infer)
def _dot(opctx, attrs, a, b):
    """``np.dot``: the last axis of ``lhs`` against the second-to-last of
    ``rhs`` (its only one when 1-d), each transposed first (every axis
    reversed) on request; two vectors give shape (1,)."""
    if attrs.get("transpose_a", False):
        a = _reversed_axes(a)
    if attrs.get("transpose_b", False):
        b = _reversed_axes(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b).reshape((1,))
    return torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))


def _batch_dot_infer(attrs, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    ta, tb = attrs.get("transpose_a", False), attrs.get("transpose_b", False)
    m = a[2] if ta else a[1]
    n = b[1] if tb else b[2]
    return in_shapes, [(a[0], m, n)], []


@register("batch_dot", inputs=("lhs", "rhs"), params=dict(_DOT_SPEC),
          infer_shape=_batch_dot_infer)
def _batch_dot(opctx, attrs, a, b):
    if attrs.get("transpose_a", False):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_b", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# Pad / Crop
# ---------------------------------------------------------------------------


def _pad_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    pw = attrs["pad_width"]
    out = tuple(ishape[i] + pw[2 * i] + pw[2 * i + 1]
                for i in range(len(ishape)))
    return in_shapes, [out], []


def _pad_index(n, lo, hi, mode, device):
    """Source positions of an axis of extent ``n`` padded by (lo, hi):
    ``edge`` repeats the end values, ``reflect`` mirrors about them (the
    end values once), as ``np.pad`` does."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return pos.clamp(0, n - 1)
    period = 2 * (n - 1)
    pos = torch.remainder(pos, period)
    return torch.where(pos >= n, period - pos, pos)


@register("Pad", aliases=("pad",),
          params={"mode": Param(str, "constant",
                                enum=("constant", "edge", "reflect")),
                  "pad_width": Param("shape", required=True),
                  "constant_value": Param(float, 0.0)},
          infer_shape=_pad_infer, hint="pad")
def _pad(opctx, attrs, x):
    """``np.pad`` of every axis by ``pad_width``'s (before, after) pairs:
    a constant, or gathers of the edge or mirrored positions (whose
    gradient sums into the sources, as the JAX op's does)."""
    pw = attrs["pad_width"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        flat = []
        for i in reversed(range(x.ndim)):
            flat += [pw[2 * i], pw[2 * i + 1]]
        return F.pad(x, flat, value=attrs.get("constant_value", 0.0))
    for i in range(x.ndim):
        lo, hi = pw[2 * i], pw[2 * i + 1]
        if lo or hi:
            x = torch.index_select(
                x, i, _pad_index(x.shape[i], lo, hi, mode, x.device))
    return x


def _crop_inputs(attrs):
    return ["data", "crop_like"] if int(attrs.get("num_args", 1)) == 2 \
        else ["data"]


@register("Crop", inputs=_crop_inputs,
          params={"num_args": Param(int, 1), "offset": Param("shape", (0, 0)),
                  "h_w": Param("shape", (0, 0)),
                  "center_crop": Param(bool, False)},
          no_grad_inputs=("crop_like",), hint="crop")
def _crop_op(opctx, attrs, x, *rest):
    """Spatial crop of NCHW data to ``h_w`` or ``crop_like``'s height and
    width, at ``offset`` or centred."""
    if rest:
        th, tw = rest[0].shape[2], rest[0].shape[3]
    else:
        th, tw = attrs["h_w"]
    h, w = x.shape[2], x.shape[3]
    if attrs.get("center_crop"):
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = attrs.get("offset", (0, 0))
    return x[:, :, oy:oy + th, ox:ox + tw]
