"""Elementwise, scalar, broadcast and reduce op families.

Counterpart of ``mxnet_tpu/ops/elemwise.py`` in plain torch, with the same
names, aliases, params and symbol-name hints: ``_UNARY`` (``:39-90``),
``_copy``/``_CrossDeviceCopy``/``_broadcast``/``BlockGrad``/``make_loss``/
``softmax``/``log_softmax``/``smooth_l1`` (``:92-190``), ``_BINARY`` and
``_COMPARE`` (``:192-244``), ``_SCALAR`` (``:246-297``, what NDArray and
Symbol arithmetic dispatch to), the broadcast family with
``broadcast_axis``/``broadcast_to`` (``:299-385``) and the reductions,
``argmax``/``argmin``, ``norm`` and ``add_n`` (``:387-504``).

As in the JAX package, comparisons return the inputs' dtype (1 or 0, the
reference's pre-bool convention), ``argmax``/``argmin`` return float
indices, and integer reductions keep the input's integer type.
"""
from __future__ import annotations

import torch

from .param import Param
from .registry import register

# ---------------------------------------------------------------------------
# Unary ops
# ---------------------------------------------------------------------------


def _round_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _gamma(x):
    """Γ(x) with its sign for negative non-integers, as
    ``jax.scipy.special.gamma``: (-1)^floor(x) below zero."""
    mag = torch.exp(torch.lgamma(x))
    odd = torch.remainder(torch.floor(x), 2) == 1
    return torch.where((x < 0) & odd, -mag, mag)


_UNARY = {
    "abs": torch.abs,
    "arccos": torch.arccos,
    "arccosh": torch.arccosh,
    "arcsin": torch.arcsin,
    "arcsinh": torch.arcsinh,
    "arctan": torch.arctan,
    "arctanh": torch.arctanh,
    "ceil": torch.ceil,
    "cos": torch.cos,
    "cosh": torch.cosh,
    "degrees": torch.rad2deg,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "fix": torch.trunc,
    "floor": torch.floor,
    "gamma": _gamma,
    "gammaln": torch.lgamma,
    "log": torch.log,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "negative": torch.negative,
    "radians": torch.deg2rad,
    "rint": torch.round,  # half to even, as jnp.rint
    "round": _round_away,  # half away from zero, the reference's round
    "rsqrt": torch.rsqrt,
    "sigmoid": torch.sigmoid,
    "sign": torch.sign,
    "sin": torch.sin,
    "sinh": torch.sinh,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "tan": torch.tan,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "erf": torch.erf,
    # 0.5·x·(1 + erf(x/√2)): jax.nn.gelu(approximate=False)
    "gelu": torch.nn.functional.gelu,
}


def _register_unary(name, fn):
    @register(name, inputs=("data",), hint=name.lstrip("_"))
    def _fn(opctx, attrs, x, _fn=fn):
        return _fn(x)


for _name, _tfn in _UNARY.items():
    _register_unary(_name, _tfn)


@register("_copy", aliases=("identity", "_copyto"), hint="copy")
def _copy(opctx, attrs, x):
    return x


@register("_CrossDeviceCopy", hint="crossdevicecopy")
def _cross_device_copy(opctx, attrs, x):
    """Identity at the op level: one executor runs on one device here, so
    a graph loaded from reference JSON with this node runs unchanged."""
    return x


def _broadcast_fun_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    out = list(d)
    out[attrs["axis"]] = attrs["size"]
    return in_shapes, [tuple(out)], []


@register("_broadcast", params={"axis": Param(int, required=True),
                                "size": Param(int, required=True)},
          infer_shape=_broadcast_fun_infer, hint="broadcastfun")
def _broadcast_fun(opctx, attrs, x):
    """Broadcast the size-1 axis ``axis`` to ``size``."""
    shape = list(x.shape)
    shape[attrs["axis"]] = attrs["size"]
    return x.expand(tuple(shape))


@register("BlockGrad", aliases=("stop_gradient",), hint="blockgrad")
def _block_grad(opctx, attrs, x):
    return x.detach()


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` whatever the head
    gradient (reference make_loss, elemwise_unary_op.cc)."""

    @staticmethod
    def forward(ctx, x, grad_scale):
        ctx.grad_scale = grad_scale
        return x.clone()

    @staticmethod
    def backward(ctx, ct):
        return torch.full_like(ct, ctx.grad_scale), None


@register("make_loss", params={"grad_scale": Param(float, 1.0)},
          hint="make_loss")
def _make_loss(opctx, attrs, x):
    return _MakeLoss.apply(x, attrs.get("grad_scale", 1.0))


_TEMP = {"axis": Param(int, -1), "temperature": Param("float-or-none", None)}


@register("softmax", params=dict(_TEMP))
def _softmax(opctx, attrs, x):
    t = attrs.get("temperature")
    if t:
        x = x / t
    return torch.softmax(x, dim=attrs.get("axis", -1))


@register("log_softmax", params=dict(_TEMP))
def _log_softmax(opctx, attrs, x):
    t = attrs.get("temperature")
    if t:
        x = x / t
    return torch.log_softmax(x, dim=attrs.get("axis", -1))


@register("smooth_l1", params={"scalar": Param(float, 1.0)})
def _smooth_l1(opctx, attrs, x):
    """0.5·(s·x)² where |x| < 1/s², else |x| - 0.5/s²."""
    s2 = attrs.get("scalar", 1.0) ** 2
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


# ---------------------------------------------------------------------------
# Binary elementwise (same-shape) + comparison
# ---------------------------------------------------------------------------

_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
    "elemwise_div": torch.div,
    "_grad_add": torch.add,
    "_power": torch.pow,
    "_maximum": torch.maximum,
    "_minimum": torch.minimum,
    "_hypot": torch.hypot,
    "_mod": torch.remainder,  # sign of the divisor, as jnp.mod
}

_BINARY_ALIASES = {
    "elemwise_add": ("_add", "_plus", "_Plus"),
    "elemwise_sub": ("_sub", "_minus", "_Minus"),
    "elemwise_mul": ("_mul", "_Mul"),
    "elemwise_div": ("_div", "_Div"),
    "_power": ("_Power", "pow"),
    "_maximum": ("_Maximum",),
    "_minimum": ("_Minimum",),
    "_mod": ("_Mod",),
}

_COMPARE = {
    "_equal": torch.eq,
    "_not_equal": torch.ne,
    "_greater": torch.gt,
    "_greater_equal": torch.ge,
    "_lesser": torch.lt,
    "_lesser_equal": torch.le,
}


def _register_binary(name, fn, aliases=(), compare=False):
    @register(name, inputs=("lhs", "rhs"), aliases=aliases,
              hint=name.lstrip("_"))
    def _fn(opctx, attrs, lhs, rhs, _fn=fn, _cmp=compare):
        out = _fn(lhs, rhs)
        if _cmp:
            out = out.to(torch.result_type(lhs, rhs))
        return out


for _name, _tfn in _BINARY.items():
    _register_binary(_name, _tfn, _BINARY_ALIASES.get(_name, ()))
for _name, _tfn in _COMPARE.items():
    _register_binary(_name, _tfn, (_name[1:].title().replace("_", ""),),
                     compare=True)


# ---------------------------------------------------------------------------
# Scalar variants
# ---------------------------------------------------------------------------

_SCALAR_SPEC = {"scalar": Param(float, required=True)}


def _hypot_scalar(x, s):
    return torch.hypot(x, torch.full_like(x, s))


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.clamp(x, min=s),
    "_minimum_scalar": lambda x, s: torch.clamp(x, max=s),
    "_hypot_scalar": _hypot_scalar,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
}

_SCALAR_ALIASES = {
    "_plus_scalar": ("_PlusScalar",),
    "_minus_scalar": ("_MinusScalar",),
    "_rminus_scalar": ("_RMinusScalar",),
    "_mul_scalar": ("_MulScalar",),
    "_div_scalar": ("_DivScalar",),
    "_rdiv_scalar": ("_RDivScalar",),
    "_power_scalar": ("_PowerScalar",),
    "_rpower_scalar": ("_RPowerScalar",),
    "_maximum_scalar": ("_MaximumScalar",),
    "_minimum_scalar": ("_MinimumScalar",),
}


def _register_scalar(name, fn, aliases=()):
    @register(name, inputs=("data",), params=dict(_SCALAR_SPEC),
              aliases=aliases, hint=name.lstrip("_"))
    def _fn(opctx, attrs, x, _fn=fn):
        return _fn(x, attrs["scalar"])


for _name, _tfn in _SCALAR.items():
    _register_scalar(_name, _tfn, _SCALAR_ALIASES.get(_name, ()))


# ---------------------------------------------------------------------------
# Broadcast binary family
# ---------------------------------------------------------------------------

_BROADCAST = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
}

_BROADCAST_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
}

_BROADCAST_ALIASES = {
    "broadcast_add": ("broadcast_plus",),
    "broadcast_sub": ("broadcast_minus",),
}

for _name, _tfn in _BROADCAST.items():
    _register_binary(_name, _tfn, _BROADCAST_ALIASES.get(_name, ()))
for _name, _tfn in _BROADCAST_CMP.items():
    _register_binary(_name, _tfn, compare=True)


def _axes_sizes(attrs):
    axes = attrs.get("axis") or ()
    sizes = attrs.get("size") or ()
    if isinstance(axes, int):
        axes = (axes,)
    if isinstance(sizes, int):
        sizes = (sizes,)
    return axes, sizes


def _broadcast_axis_shape(ishape, attrs):
    out = list(ishape)
    for ax, sz in zip(*_axes_sizes(attrs)):
        out[ax] = sz
    return tuple(out)


def _infer_broadcast_axis(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    return in_shapes, [_broadcast_axis_shape(ishape, attrs)], []


@register("broadcast_axis", params={"axis": Param("shape", ()),
                                    "size": Param("shape", ())},
          aliases=("broadcast_axes",), infer_shape=_infer_broadcast_axis)
def _broadcast_axis(opctx, attrs, x):
    return x.expand(_broadcast_axis_shape(x.shape, attrs))


def _broadcast_to_shape(ishape, attrs):
    """The target shape, a 0 keeping the input's extent."""
    return tuple(ishape[i] if s == 0 else s
                 for i, s in enumerate(attrs.get("shape") or ()))


def _infer_broadcast_to(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    return in_shapes, [_broadcast_to_shape(ishape, attrs)], []


@register("broadcast_to", params={"shape": Param("shape", ())},
          infer_shape=_infer_broadcast_to)
def _broadcast_to(opctx, attrs, x):
    return x.expand(_broadcast_to_shape(x.shape, attrs))


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

_REDUCE_SPEC = {
    "axis": Param("shape-or-none", None),
    "keepdims": Param(bool, False),
    "exclude": Param(bool, False),
}


def _norm_axis(attrs, ndim):
    axis = attrs.get("axis")
    if axis is None or axis == ():
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if attrs.get("exclude"):
        axis = tuple(i for i in range(ndim) if i not in axis)
    return axis


def _reduce_out_shape(ishape, axis, keepdims):
    if axis is None:
        return (1,) * len(ishape) if keepdims else ()
    out = list(ishape)
    for a in sorted(axis, reverse=True):
        if keepdims:
            out[a] = 1
        else:
            del out[a]
    return tuple(out)


def _reduce_infer(attrs, in_shapes):
    (ishape,) = in_shapes
    if ishape is None:
        return in_shapes, [None], []
    axis = _norm_axis(attrs, len(ishape))
    return in_shapes, [_reduce_out_shape(ishape, axis,
                                         attrs.get("keepdims", False))], []


def _prod(x, dims, keepdim):
    """torch.prod takes one axis: reduce them one at a time, last first."""
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dims, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dims,
                 keepdim)


def _mean(x, dims, keepdim):
    if not x.is_floating_point():
        x = x.to(torch.float32)  # jnp.mean of integers is float32
    return torch.mean(x, dim=dims, keepdim=keepdim)


_REDUCE = {
    "sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "mean": _mean,
    "prod": _prod,
    "nansum": lambda x, d, k: torch.nansum(x, dim=d, keepdim=k),
    "nanprod": _nanprod,
    "max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
}

_REDUCE_ALIASES = {"sum": ("sum_axis",), "max": ("max_axis",),
                   "min": ("min_axis",)}


def _register_reduce(name, fn, aliases=()):
    @register(name, inputs=("data",), params=dict(_REDUCE_SPEC),
              aliases=aliases, infer_shape=_reduce_infer, hint=name)
    def _fn(opctx, attrs, x, _fn=fn):
        axis = _norm_axis(attrs, x.ndim)
        dims = tuple(range(x.ndim)) if axis is None else axis
        out = _fn(x, dims, attrs.get("keepdims", False))
        if not x.is_floating_point() and x.dtype != torch.bool \
                and out.dtype != x.dtype and name != "mean":
            out = out.to(x.dtype)  # torch widens int32 sums to int64
        return out


for _name, _tfn in _REDUCE.items():
    _register_reduce(_name, _tfn, _REDUCE_ALIASES.get(_name, ()))


_ARG_SPEC = {"axis": Param("int-or-none", None), "keepdims": Param(bool, False)}


def _register_argreduce(name, fn):
    def infer(attrs, in_shapes):
        (ishape,) = in_shapes
        if ishape is None:
            return in_shapes, [None], []
        axis = attrs.get("axis")
        ax = None if axis is None else (axis % len(ishape),)
        return in_shapes, [_reduce_out_shape(ishape, ax,
                                             attrs.get("keepdims", False))], []

    @register(name, inputs=("data",), params=dict(_ARG_SPEC), infer_shape=infer)
    def _fn(opctx, attrs, x, _fn=fn):
        axis = attrs.get("axis")
        out = _fn(x) if axis is None else _fn(x, dim=axis)
        if attrs.get("keepdims", False) and axis is not None:
            out = out.unsqueeze(axis % x.ndim)
        # float indices, the reference's pre-integer-dtype convention
        return out.to(torch.float32 if x.dtype == torch.float64 else x.dtype)


_register_argreduce("argmax", torch.argmax)
_register_argreduce("argmin", torch.argmin)


@register("argmax_channel")
def _argmax_channel(opctx, attrs, x):
    return torch.argmax(x, dim=1).to(x.dtype)


@register("norm", infer_shape=lambda attrs, s: (s, [(1,)], []))
def _norm(opctx, attrs, x):
    return torch.sqrt(torch.sum(torch.square(x))).reshape((1,))


# ---------------------------------------------------------------------------
# N-ary sum (ElementWiseSum / add_n)
# ---------------------------------------------------------------------------


@register("add_n", key_var_num_args="num_args", inputs=("data",),
          params={"num_args": Param(int, required=True)},
          aliases=("ElementWiseSum", "_sum"), hint="add_n")
def _add_n(opctx, attrs, *args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out

