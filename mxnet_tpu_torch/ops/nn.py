"""Layer ops: those of the transformer LM (``FullyConnected``,
``LayerNorm``, the ``SoftmaxOutput`` loss) and of the image classifiers
(``Activation``, ``Convolution``, ``Pooling``, ``BatchNorm``, ``Dropout``,
``LRN``).

Counterparts of ``mxnet_tpu/ops/nn.py`` (``:37-49``, ``:118-128``,
``:135-219``, ``:282-424``, ``:458-482``, ``:502-535``, ``:540-602``), with
the same names, aliases, parameters and shape inference.  The products the
JAX package leaves to XLA are plain torch: ``torch.matmul`` and
``F.conv1d/2d/3d`` (cuDNN on the card in bf16; float32 on torch's own CUDA
convolution, which is float32-accurate where cuDNN's default is not).
Every op differentiates under autograd but SoftmaxOutput, which carries
its own loss gradient as the JAX package's custom vjp does.  BatchNorm rounds where the JAX op rounds (scale
and shift to the data's dtype before ``data·scale + shift``); Dropout draws
its mask from the generator in its ``OpContext``, so its masks are not the
JAX package's threefry masks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .param import Param
from .registry import register

# The port's float32 numerics: float32 products run in full float32, as
# XLA's do on the CPU.  TF32 keeps about three decimal digits, so it is
# switched off for cuBLAS and cuDNN alike, whatever torch's defaults are.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _fc_inputs(attrs):
    return ["data", "weight"] if attrs.get("no_bias") else \
        ["data", "weight", "bias"]


def _fc_infer(attrs, in_shapes):
    d = in_shapes[0]
    nh = attrs["num_hidden"]
    if d is None:
        return in_shapes, [None], []
    if attrs.get("flatten", True) or len(d) <= 2:
        in_dim = int(np.prod(d[1:])) if len(d) > 1 else 1
        out = (d[0], nh)
    else:
        # flatten=False: FC applies to the trailing axis only
        in_dim = d[-1]
        out = tuple(d[:-1]) + (nh,)
    shapes = [d, (nh, in_dim)]
    if not attrs.get("no_bias"):
        shapes.append((nh,))
    return shapes, [out], []


@register("FullyConnected", inputs=_fc_inputs,
          params={"num_hidden": Param(int, required=True),
                  "no_bias": Param(bool, False),
                  "flatten": Param(bool, True)},
          infer_shape=_fc_infer, hint="fullyconnected")
def _fully_connected(opctx, attrs, data, weight, *rest):
    if data.ndim > 2 and attrs.get("flatten", True):
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if rest:
        out = out + rest[0]
    return out


def _layer_norm_infer(attrs, in_shapes):
    d = in_shapes[0]
    n_out = 3 if attrs.get("output_mean_var") else 1
    if d is None:
        return in_shapes, [None] * n_out, []
    axis = int(attrs.get("axis", -1)) % len(d)
    outs = [tuple(d)]
    if attrs.get("output_mean_var"):
        red = tuple(v for i, v in enumerate(d) if i != axis)
        outs += [red, red]
    return [tuple(d), (d[axis],), (d[axis],)], outs, []


@register("LayerNorm", inputs=("data", "gamma", "beta"),
          params={"axis": Param(int, -1), "eps": Param(float, 1e-5),
                  "output_mean_var": Param(bool, False)},
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
          infer_shape=_layer_norm_infer, hint="layernorm")
def _layer_norm(opctx, attrs, data, gamma, beta):
    """Layer normalization over one axis, statistics in f32 even for bf16
    activations.  With ``output_mean_var`` the outputs are (out, mean,
    std), upstream's layer_norm-inl.h contract."""
    eps = attrs.get("eps", 1e-5)
    axis = int(attrs.get("axis", -1)) % data.ndim
    x = data.to(torch.float32)
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, unbiased=False)
    norm = ((x - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    out = norm * gamma.reshape(bshape).to(data.dtype) \
        + beta.reshape(bshape).to(data.dtype)
    if attrs.get("output_mean_var"):
        return (out, mean.squeeze(axis).to(data.dtype),
                torch.sqrt(var + eps).squeeze(axis).to(data.dtype))
    return out


def _softmax_label_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if attrs.get("multi_output"):
        lshape = (d[0],) + tuple(d[2:])
    else:
        lshape = tuple(d[:-1]) if len(d) > 1 else (d[0],)
    return [d, lshape], [tuple(d)], []


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward is the loss gradient
    ``_softmax_output_bwd`` of the JAX package: the head gradient is
    ignored (softmax_output-inl.h:131), the data gradient is
    (softmax - onehot(label)) · grad_scale / norm, ignored labels get none,
    and the label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, normalization):
        out = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, ignore_label, multi_output, use_ignore,
                   normalization)
        return out

    @staticmethod
    def backward(ctx, ct):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, multi_output, use_ignore, normalization = \
            ctx.cfg
        axis = 1 if multi_output else out.ndim - 1
        nclass = out.shape[axis]
        ilabel = label.to(torch.int64)
        cls_shape = [1] * out.ndim
        cls_shape[axis] = nclass
        classes = torch.arange(nclass, device=out.device).reshape(cls_shape)
        # out-of-range labels (the ignore label among them) one-hot to zeros,
        # as jax.nn.one_hot does
        onehot = (ilabel.unsqueeze(axis) == classes).to(out.dtype)
        grad = out - onehot
        valid = torch.ones(label.shape, dtype=out.dtype, device=out.device)
        if use_ignore:
            valid = (label != ignore_label).to(out.dtype)
            grad = grad * valid.unsqueeze(axis)
        if normalization == "batch":
            norm = float(label.shape[0])
        elif normalization == "valid":
            norm = torch.clamp(valid.sum(), min=1.0)
        else:
            norm = 1.0
        grad = grad * (grad_scale / norm)
        return (grad.to(out.dtype), torch.zeros_like(label), None, None, None,
                None, None)


@register("SoftmaxOutput", inputs=("data", "label"),
          params={"grad_scale": Param(float, 1.0),
                  "ignore_label": Param(float, -1.0),
                  "multi_output": Param(bool, False),
                  "use_ignore": Param(bool, False),
                  "preserve_shape": Param(bool, False),
                  "normalization": Param(str, "null",
                                         enum=("null", "batch", "valid")),
                  "out_grad": Param(bool, False)},
          infer_shape=_softmax_label_infer, no_grad_inputs=("label",),
          aliases=("Softmax",), hint="softmaxoutput")
def _softmax_output(opctx, attrs, data, label):
    """Softmax over the class axis (the last, or axis 1 with
    ``multi_output``); its gradient is the cross-entropy loss gradient."""
    return _SoftmaxOutput.apply(
        data, label, attrs.get("grad_scale", 1.0),
        attrs.get("ignore_label", -1.0), bool(attrs.get("multi_output")),
        bool(attrs.get("use_ignore")), attrs.get("normalization", "null"))


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------


@register("Activation",
          params={"act_type": Param(str, required=True,
                                    enum=("relu", "sigmoid", "tanh",
                                          "softrelu"))},
          hint="activation")
def _activation(opctx, attrs, x):
    t = attrs["act_type"]
    if t == "relu":
        return torch.relu(x)
    if t == "sigmoid":
        return torch.sigmoid(x)
    if t == "tanh":
        return torch.tanh(x)
    return F.softplus(x)  # softrelu


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

_CONV_SPEC = {
    "kernel": Param("shape", required=True),
    "stride": Param("shape", ()),
    "dilate": Param("shape", ()),
    "pad": Param("shape", ()),
    "num_filter": Param(int, required=True),
    "num_group": Param(int, 1),
    "workspace": Param(int, 1024),
    "no_bias": Param(bool, False),
    "cudnn_tune": Param(str, ""),
    "cudnn_off": Param(bool, False),
    "layout": Param(str, ""),
}


def _conv_inputs(attrs):
    return ["data", "weight"] if attrs.get("no_bias") else \
        ["data", "weight", "bias"]


def _tup(v, nd, default):
    if not v:
        return (default,) * nd
    return tuple(v)


def _conv_out_dim(x, k, s, p, d):
    return (x + 2 * p - (d * (k - 1) + 1)) // s + 1


def _conv_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    kernel = attrs["kernel"]
    nd = len(kernel)
    stride = _tup(attrs.get("stride"), nd, 1)
    pad = _tup(attrs.get("pad"), nd, 0)
    dil = _tup(attrs.get("dilate"), nd, 1)
    nf, ng = attrs["num_filter"], attrs.get("num_group", 1)
    wshape = (nf, data[1] // ng) + tuple(kernel)
    shapes = [data, wshape] + ([] if attrs.get("no_bias") else [(nf,)])
    spatial = tuple(
        _conv_out_dim(data[2 + i], kernel[i], stride[i], pad[i], dil[i])
        for i in range(nd))
    return shapes, [(data[0], nf) + spatial], []


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _no_cudnn():
    """cuDNN off for one call, every other cuDNN setting kept."""
    b = torch.backends.cudnn
    return b.flags(enabled=False, benchmark=b.benchmark,
                   deterministic=b.deterministic, allow_tf32=b.allow_tf32)


class _WideConv(torch.autograd.Function):
    """A float32 (or float64) convolution on the card by torch's own CUDA
    convolution (im2col and cuBLAS products, TF32 off), forward and
    backward, with cuDNN off around each call.  cuDNN's default algorithm
    for some float32 shapes is not float32-accurate with TF32 off (the
    weight gradient of LeNet's first layer, one input channel, 5x5;
    chip_smoke.py's ``conv_precision_check`` measures it), where the JAX
    package's float32 convolutions are."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dil, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, dil, groups)
        with _no_cudnn():
            return torch.ops.aten.convolution(x, w, None, stride, pad, dil,
                                              False, [0] * len(stride),
                                              groups)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        stride, pad, dil, groups = ctx.conf
        with _no_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                ct, x, w, None, stride, pad, dil, False, [0] * len(stride),
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw, None, None, None, None


@register("Convolution", inputs=_conv_inputs, params=dict(_CONV_SPEC),
          infer_shape=_conv_infer, aliases=("Convolution_v1",),
          hint="convolution")
def _convolution(opctx, attrs, data, weight, *rest):
    """N-d convolution over NC(D)HW data, OI(D)HW weights; the output in
    the data's dtype (bf16 in, bf16 out), the bias added after it.  On the
    card bf16 runs on cuDNN, float32 on torch's own CUDA convolution
    (``_WideConv``)."""
    kernel = attrs["kernel"]
    nd = len(kernel)
    conf = (_tup(attrs.get("stride"), nd, 1), _tup(attrs.get("pad"), nd, 0),
            _tup(attrs.get("dilate"), nd, 1), attrs.get("num_group", 1))
    if data.is_cuda and data.dtype in (torch.float32, torch.float64):
        out = _WideConv.apply(data, weight, *conf)
    else:
        out = _CONV[nd](data, weight, None, *conf)
    if rest:
        out = out + rest[0].reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_POOL_SPEC = {
    "kernel": Param("shape", required=True),
    "pool_type": Param(str, "max", enum=("max", "avg", "sum")),
    "global_pool": Param(bool, False),
    "pooling_convention": Param(str, "valid", enum=("valid", "full")),
    "stride": Param("shape", ()),
    "pad": Param("shape", ()),
    "cudnn_off": Param(bool, False),
}


def _pool_out_dim(x, k, s, p, full):
    if full:
        return int(np.ceil((x + 2 * p - k) / s)) + 1
    return (x + 2 * p - k) // s + 1


def _pool_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    nd = len(data) - 2
    if attrs.get("global_pool"):
        return in_shapes, [tuple(data[:2]) + (1,) * nd], []
    kernel = attrs["kernel"]
    stride = _tup(attrs.get("stride"), nd, 1)
    pad = _tup(attrs.get("pad"), nd, 0)
    full = attrs.get("pooling_convention", "valid") == "full"
    spatial = tuple(
        _pool_out_dim(data[2 + i], kernel[i], stride[i], pad[i], full)
        for i in range(nd))
    return in_shapes, [tuple(data[:2]) + spatial], []


def _window_max(x, kernel, stride):
    """Max over windows with no padding: torch's max pooling for floating
    dtypes (its gradient goes to the first maximum of a window, as the
    JAX package's select-and-scatter does), the windows unfolded for
    integer dtypes, which it does not pool."""
    nd = len(kernel)
    if x.is_floating_point():
        if nd == 1:
            return F.max_pool1d(x, kernel, stride)
        return (F.max_pool2d if nd == 2 else F.max_pool3d)(x, kernel, stride)
    for i in range(nd):
        x = x.unfold(2 + i, kernel[i], stride[i])
    return x.amax(dim=tuple(range(-nd, 0)))


def _window_sum(x, kernel, stride):
    """Sum over windows with no padding, in the data's dtype: torch's 2-d
    average pooling with divisor 1, the windows unfolded in 1 and 3 d
    (torch has no bf16 3-d average pooling on the CPU)."""
    nd = len(kernel)
    if nd == 2:
        return F.avg_pool2d(x, kernel, stride, divisor_override=1)
    for i in range(nd):
        x = x.unfold(2 + i, kernel[i], stride[i])
    return x.sum(dim=tuple(range(-nd, 0)))


@register("Pooling", params=dict(_POOL_SPEC), infer_shape=_pool_infer,
          aliases=("Pooling_v1",), hint="pooling")
def _pooling(opctx, attrs, x):
    """Max, avg or sum pooling in 1-3 d.  The reference's output size
    (``pooling_convention`` valid or full) comes from explicit padding,
    ``pad`` before each dim and what the last window needs after it: -inf
    (an integer dtype's least value) for max, 0 for avg and sum, then
    windows with no padding.  avg divides by the full window size, padding
    included."""
    nd = x.ndim - 2
    ptype = attrs.get("pool_type", "max")
    if attrs.get("global_pool"):
        kernel = tuple(x.shape[2:])
        stride = (1,) * nd
        pad = (0,) * nd
    else:
        kernel = tuple(attrs["kernel"])
        stride = _tup(attrs.get("stride"), nd, 1)
        pad = _tup(attrs.get("pad"), nd, 0)
    full = attrs.get("pooling_convention", "valid") == "full"
    pads = []  # F.pad order: the last dim first
    for i in reversed(range(nd)):
        out = _pool_out_dim(x.shape[2 + i], kernel[i], stride[i], pad[i],
                            full)
        need = max((out - 1) * stride[i] + kernel[i] - x.shape[2 + i], 0)
        pads += [pad[i], max(need - pad[i], 0)]
    if ptype == "max":
        if any(pads):
            fill = float("-inf") if x.is_floating_point() else \
                torch.iinfo(x.dtype).min
            x = F.pad(x, pads, value=fill)
        return _window_max(x, kernel, stride)
    if any(pads):
        x = F.pad(x, pads)
    summed = _window_sum(x, kernel, stride)
    if ptype == "sum":
        return summed
    return summed / int(np.prod(kernel))


# ---------------------------------------------------------------------------
# BatchNorm — aux states (moving_mean, moving_var) returned updated
# ---------------------------------------------------------------------------


def _bn_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None, None, None], []
    c = (d[1] if len(d) > 1 else d[0],)
    nout = 3 if attrs.get("output_mean_var") else 1
    outs = [tuple(d)] + ([c, c] if nout == 3 else [])
    return [d, c, c], outs, [c, c]


class _StatsF32(torch.autograd.Function):
    """(mean, mean of squares) over ``axes``, accumulated in float32 (or
    x's wider dtype) from data of a narrower dtype, each in one read of
    ``x`` (the mean of squares as the norm, squared).  It saves ``x`` as it
    is, where autograd of ``x.float().square().mean()`` would keep a
    float32 copy of every bf16 activation.  The gradient is autodiff's,
    ct_mean/N + (ct_sq/N)·(2x), summed in float32 and rounded to x's dtype
    once (autodiff rounds each term, then adds them)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.save_for_backward(x)
        wide = torch.promote_types(x.dtype, torch.float32)
        mean = torch.mean(x, dim=axes, dtype=wide)
        norm = torch.linalg.vector_norm(x, 2, dim=axes, dtype=wide)
        return mean, torch.square(norm) / (x.numel() // max(1, mean.numel()))

    @staticmethod
    def backward(ctx, ct_mean, ct_sq):
        (x,) = ctx.saved_tensors
        count = x.numel() // ct_mean.numel()
        shape = [1] * x.ndim
        shape[1 if x.ndim > 1 else 0] = -1
        return torch.addcmul((ct_mean / count).reshape(shape), x,
                             (2.0 * ct_sq / count).reshape(shape)).to(
                                 x.dtype), None


@register("BatchNorm", inputs=("data", "gamma", "beta"),
          aux=("moving_mean", "moving_var"),
          params={"eps": Param(float, 1e-3), "momentum": Param(float, 0.9),
                  "fix_gamma": Param(bool, True),
                  "use_global_stats": Param(bool, False),
                  "output_mean_var": Param(bool, False)},
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
          infer_shape=_bn_infer, aliases=("CuDNNBatchNorm",),
          hint="batchnorm")
def _batch_norm(opctx, attrs, data, gamma, beta, moving_mean, moving_var):
    """Batch normalization over every axis but 1, statistics in float32:
    float32 data two-pass (centred variance), narrower data one pass,
    max(E[x²] − E[x]², 0).  Training updates the moving statistics from
    the detached batch statistics; ``use_global_stats`` or inference uses
    them.  scale = γ·rsqrt(var + eps) and shift = β − mean·rsqrt(var +
    eps)·γ are formed in float32 and rounded to the data's dtype, then
    out = data·scale + shift, as the JAX op rounds."""
    eps = attrs.get("eps", 1e-3)
    momentum = attrs.get("momentum", 0.9)
    use_global = attrs.get("use_global_stats", False) or not opctx.is_train
    axes = (0,) + tuple(range(2, data.ndim))
    bshape = (1, -1) + (1,) * (data.ndim - 2) if data.ndim > 1 else (-1,)
    if attrs.get("fix_gamma", True):
        gamma = torch.ones_like(gamma)
    if use_global:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    elif data.dtype == torch.float32:
        mean = torch.mean(data, dim=axes)
        var = torch.mean(torch.square(data - mean.reshape(bshape)), dim=axes)
    else:
        mean, meansq = _StatsF32.apply(data, axes)
        var = torch.clamp(meansq - torch.square(mean), min=0.0)
    if not use_global:
        new_mm = momentum * moving_mean + (1 - momentum) * mean.detach()
        new_mv = momentum * moving_var + (1 - momentum) * var.detach()
    inv = torch.rsqrt(var + eps)
    g32 = gamma.to(torch.float32)
    scale = (g32 * inv).to(data.dtype).reshape(bshape)
    shift = (beta.to(torch.float32) - mean * inv * g32).to(
        data.dtype).reshape(bshape)
    out = data * scale + shift
    if attrs.get("output_mean_var"):
        return (out, mean.to(data.dtype), var.to(data.dtype), new_mm, new_mv)
    return out, new_mm, new_mv


# ---------------------------------------------------------------------------
# LRN and Dropout
# ---------------------------------------------------------------------------


@register("LRN", params={"alpha": Param(float, 1e-4),
                         "beta": Param(float, 0.75),
                         "knorm": Param(float, 2.0),
                         "nsize": Param(int, required=True)},
          hint="lrn")
def _lrn(opctx, attrs, x):
    """Cross-channel local response norm: the window sum of x² over
    ``nsize`` channels, zero-padded by nsize//2 on each side, then
    x·(knorm + α/nsize·Σ)^−β, in the data's dtype."""
    nsize = attrs["nsize"]
    alpha, beta = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75)
    knorm = attrs.get("knorm", 2.0)
    half = nsize // 2
    sq = F.pad(torch.square(x), [0, 0] * (x.ndim - 2) + [half, half])
    channels = sq.shape[1] - nsize + 1
    ssum = sq.narrow(1, 0, channels)
    for i in range(1, nsize):
        ssum = ssum + sq.narrow(1, i, channels)
    return x * torch.pow(knorm + alpha / nsize * ssum, -beta)


@register("Dropout", params={"p": Param(float, 0.5)}, stochastic=True,
          hint="dropout")
def _dropout(opctx, attrs, x):
    """Identity in inference, at p <= 0 or with no generator; in training
    each element is kept with probability 1 - p, drawn from the
    ``OpContext`` generator, and scaled by 1 / (1 - p)."""
    p = attrs.get("p", 0.5)
    if not opctx.is_train or p <= 0.0 or opctx.generator is None:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=opctx.generator,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
