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
    backward, with cuDNN off around each call; ``transposed`` with
    ``out_pad`` the transposed convolution (Deconvolution, bilinear
    UpSampling).  cuDNN's default algorithm for some float32 shapes is not
    float32-accurate with TF32 off (the weight gradient of LeNet's first
    layer, one input channel, 5x5; chip_smoke.py's
    ``conv_precision_check`` measures it), where the JAX package's float32
    convolutions are."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dil, groups, transposed=False,
                out_pad=None):
        out_pad = list(out_pad or [0] * len(stride))
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, dil, transposed, out_pad, groups)
        with _no_cudnn():
            return torch.ops.aten.convolution(x, w, None, stride, pad, dil,
                                              transposed, out_pad, groups)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        with _no_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                ct, x, w, None, *ctx.conf,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None, None, None


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


# ---------------------------------------------------------------------------
# LeakyReLU
# ---------------------------------------------------------------------------


def _leaky_inputs(attrs):
    if attrs.get("act_type", "leaky") == "prelu":
        return ["data", "gamma"]
    return ["data"]


def _leaky_infer(attrs, in_shapes):
    d = in_shapes[0]
    if attrs.get("act_type", "leaky") == "prelu":
        g = (d[1],) if d is not None else in_shapes[1]
        return [d, g], [d], []
    return in_shapes, [d], []


@register("LeakyReLU", inputs=_leaky_inputs,
          params={"act_type": Param(str, "leaky",
                                    enum=("rrelu", "leaky", "prelu", "elu")),
                  "slope": Param(float, 0.25),
                  "lower_bound": Param(float, 0.125),
                  "upper_bound": Param(float, 0.334)},
          infer_shape=_leaky_infer, stochastic=True, hint="leakyrelu")
def _leaky_relu(opctx, attrs, x, *rest):
    """x where x > 0, else: slope·x (leaky), slope·(eˣ − 1) (elu), γ·x
    with a learned γ per channel (prelu), or (rrelu) a slope drawn from
    U(lower_bound, upper_bound) per element from the ``OpContext``
    generator in training, their mean in inference."""
    t = attrs.get("act_type", "leaky")
    if t == "leaky":
        return torch.where(x > 0, x, attrs.get("slope", 0.25) * x)
    if t == "elu":
        return torch.where(x > 0, x, attrs.get("slope", 0.25) *
                           torch.expm1(x))
    if t == "prelu":
        gamma = rest[0].reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x > 0, x, gamma * x)
    lo, up = attrs.get("lower_bound", 0.125), attrs.get("upper_bound", 0.334)
    if opctx.is_train and opctx.generator is not None:
        slope = (torch.rand(x.shape, generator=opctx.generator,
                            device=x.device) * (up - lo) + lo).to(x.dtype)
    else:
        slope = (lo + up) / 2.0
    return torch.where(x > 0, x, slope * x)


# ---------------------------------------------------------------------------
# Deconvolution
# ---------------------------------------------------------------------------

_DECONV_SPEC = dict(_CONV_SPEC)
_DECONV_SPEC.update({
    "adj": Param("shape", ()),
    "target_shape": Param("shape", ()),
})


def _deconv_infer(attrs, in_shapes):
    """The JAX package's rule, kept as it is: with ``target_shape`` it
    gives that spatial size, which the op (like the JAX op) never crops or
    pads to (ROADMAP C)."""
    data = in_shapes[0]
    if data is None:
        return in_shapes, [None], []
    kernel = attrs["kernel"]
    nd = len(kernel)
    stride = _tup(attrs.get("stride"), nd, 1)
    pad = _tup(attrs.get("pad"), nd, 0)
    adj = _tup(attrs.get("adj"), nd, 0)
    nf, ng = attrs["num_filter"], attrs.get("num_group", 1)
    wshape = (data[1], nf // ng) + tuple(kernel)
    shapes = [data, wshape] + ([] if attrs.get("no_bias") else [(nf,)])
    tgt = attrs.get("target_shape")
    if tgt:
        spatial = tuple(tgt)
    else:
        spatial = tuple(
            stride[i] * (data[2 + i] - 1) + kernel[i] - 2 * pad[i] + adj[i]
            for i in range(nd))
    return shapes, [(data[0], nf) + spatial], []


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_transpose(data, weight, stride, pad, adj, groups):
    """The transposed convolution of NC(D)HW data by a (C, F/g, *k)
    weight: size s·(x − 1) + k − 2p + adj per spatial axis.  On the card
    in float32 by ``_WideConv``, else ``F.conv_transpose1d/2d/3d``."""
    nd = data.ndim - 2
    dil = (1,) * nd
    if data.is_cuda and data.dtype in (torch.float32, torch.float64):
        return _WideConv.apply(data, weight, list(stride), list(pad),
                               list(dil), groups, True, list(adj))
    return _CONV_T[nd](data, weight, None, stride, pad, adj, groups, dil)


@register("Deconvolution", inputs=_conv_inputs, params=dict(_DECONV_SPEC),
          infer_shape=_deconv_infer, hint="deconvolution")
def _deconvolution(opctx, attrs, data, weight, *rest):
    """Transposed convolution (the backward of Convolution), with ``adj``
    added after the last position of each axis.  As in the JAX op,
    ``dilate`` and ``target_shape`` do not change the result."""
    kernel = attrs["kernel"]
    nd = len(kernel)
    out = _conv_transpose(data, weight, _tup(attrs.get("stride"), nd, 1),
                          _tup(attrs.get("pad"), nd, 0),
                          _tup(attrs.get("adj"), nd, 0),
                          attrs.get("num_group", 1))
    if rest:
        out = out + rest[0].reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------------------------------
# InstanceNorm, L2Normalization, SoftmaxActivation
# ---------------------------------------------------------------------------


@register("InstanceNorm", inputs=("data", "gamma", "beta"),
          params={"eps": Param(float, 1e-3)},
          infer_shape=lambda attrs, s: (
              [s[0], (s[0][1],), (s[0][1],)] if s[0] is not None else s,
              [s[0]], []),
          hint="instancenorm")
def _instance_norm(opctx, attrs, data, gamma, beta):
    """Each sample and channel normalized over its spatial axes (variance
    without the Bessel factor), then γ and β per channel."""
    eps = attrs.get("eps", 1e-3)
    axes = tuple(range(2, data.ndim))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, keepdim=True, unbiased=False)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization",
          params={"eps": Param(float, 1e-10),
                  "mode": Param(str, "instance",
                                enum=("instance", "spatial", "channel"))},
          hint="l2normalization")
def _l2_normalization(opctx, attrs, x):
    """x / sqrt(Σx² + eps), the sum over all but the batch axis
    (instance), over the channel axis (channel) or the spatial axes
    (spatial)."""
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        axes = tuple(range(1, x.ndim))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.ndim))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                      + attrs.get("eps", 1e-10))
    return x / norm


@register("SoftmaxActivation",
          params={"mode": Param(str, "instance",
                                enum=("instance", "channel"))},
          hint="softmaxactivation")
def _softmax_activation(opctx, attrs, x):
    """Softmax over axis 1 (channel) or over all but the batch axis
    (instance)."""
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


# ---------------------------------------------------------------------------
# Loss outputs: each ignores its head gradient, as the JAX package's custom
# vjps do (regression_output-inl.h, svm_output-inl.h, make_loss-inl.h)
# ---------------------------------------------------------------------------


class _Regression(torch.autograd.Function):
    """out = fwd(data); the data gradient is bwd(out, label) ·
    grad_scale / num_output (the label's size per sample), the label's
    zero."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, ct):
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.cfg
        num_output = int(np.prod(label.shape[1:])) if label.ndim > 1 else 1
        diff = out - label.reshape(out.shape)
        if kind == "mae":
            diff = torch.sign(diff)
        g = diff * (grad_scale / num_output)
        return g.to(out.dtype), torch.zeros_like(label), None, None


def _regression_label_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    lshape = (d[0],) if len(d) == 2 and d[1] == 1 else tuple(d)
    return [d, lshape], [tuple(d)], []


def _register_regression(name, kind):
    @register(name, inputs=("data", "label"),
              params={"grad_scale": Param(float, 1.0)},
              infer_shape=_regression_label_infer, no_grad_inputs=("label",),
              hint=name.lower())
    def _op(opctx, attrs, data, label):
        return _Regression.apply(data, label, attrs.get("grad_scale", 1.0),
                                 kind)


_register_regression("LinearRegressionOutput", "linear")
_register_regression("LogisticRegressionOutput", "logistic")
_register_regression("MAERegressionOutput", "mae")


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the hinge-loss gradient (squared, or linear with
    ``use_linear``) of margin − data·(±1) against the label's class."""

    @staticmethod
    def forward(ctx, data, label, margin, coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, ct):
        data, label = ctx.saved_tensors
        margin, coef, use_linear = ctx.cfg
        classes = torch.arange(data.shape[-1], device=data.device)
        onehot = (label.to(torch.int64).unsqueeze(-1) == classes).to(
            data.dtype)
        sign = 1 - 2 * onehot  # -1 at the true class, +1 elsewhere
        dist = margin - data * (2 * onehot - 1)
        viol = (dist > 0).to(data.dtype)
        if use_linear:
            grad = coef * sign * viol
        else:
            grad = 2 * coef * sign * viol * dist
        return grad.to(data.dtype), torch.zeros_like(label), None, None, None


@register("SVMOutput", inputs=("data", "label"),
          params={"margin": Param(float, 1.0),
                  "regularization_coefficient": Param(float, 1.0),
                  "use_linear": Param(bool, False)},
          infer_shape=_softmax_label_infer, no_grad_inputs=("label",),
          hint="svmoutput")
def _svm_output(opctx, attrs, data, label):
    return _SVMOutput.apply(data, label, attrs.get("margin", 1.0),
                            attrs.get("regularization_coefficient", 1.0),
                            bool(attrs.get("use_linear", False)))


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the gradient is ``grad_scale`` everywhere,
    divided by the batch size (``batch``) or by the count of forward
    values above ``valid_thresh``, at least 1 (``valid``), in the data's
    dtype.  The head gradient is ignored."""

    @staticmethod
    def forward(ctx, x, grad_scale, normalization, valid_thresh):
        ctx.cfg = (x.shape, x.dtype, grad_scale, normalization)
        if normalization == "valid":
            ctx.save_for_backward(torch.clamp(
                torch.sum((x > valid_thresh).to(x.dtype)), min=1.0))
        return x.clone()

    @staticmethod
    def backward(ctx, ct):
        shape, dtype, gs, norm = ctx.cfg
        if norm == "batch":
            grad = torch.full(shape, gs / shape[0], dtype=dtype,
                              device=ct.device)
        else:
            grad = torch.full(shape, gs, dtype=dtype, device=ct.device)
            if norm == "valid":
                grad = grad / ctx.saved_tensors[0]
        return grad, None, None, None


@register("MakeLoss",
          params={"grad_scale": Param(float, 1.0),
                  "valid_thresh": Param(float, 0.0),
                  "normalization": Param(str, "null",
                                         enum=("null", "batch", "valid"))},
          hint="makeloss")
def _make_loss_layer(opctx, attrs, x):
    """The legacy MakeLoss layer: identity forward, a constant gradient
    (``_MakeLoss``)."""
    return _MakeLoss.apply(x, attrs.get("grad_scale", 1.0),
                           attrs.get("normalization", "null"),
                           attrs.get("valid_thresh", 0.0))


@register("softmax_cross_entropy", inputs=("data", "label"),
          no_grad_inputs=("label",),
          infer_shape=lambda attrs, s: (s, [(1,)], []))
def _softmax_cross_entropy(opctx, attrs, data, label):
    """−Σ log softmax(data)[label], over the batch, as shape (1,)."""
    logp = torch.log_softmax(data, dim=-1)
    classes = torch.arange(data.shape[-1], device=data.device)
    onehot = (label.to(torch.int64).unsqueeze(-1) == classes).to(data.dtype)
    return -torch.sum(onehot * logp).reshape((1,))


class _KLSparse(torch.autograd.Function):
    """Identity forward; the gradient adds the KL-sparsity penalty's
    gradient at the batch's mean activation ``rho`` per channel."""

    @staticmethod
    def forward(ctx, x, rho, target, penalty):
        ctx.save_for_backward(rho)
        ctx.cfg = (x.ndim, x.dtype, target, penalty)
        return x.clone()

    @staticmethod
    def backward(ctx, ct):
        (rho,) = ctx.saved_tensors
        ndim, dtype, st, pen = ctx.cfg
        kl_grad = pen * (-st / (rho + 1e-12) + (1 - st) / (1 - rho + 1e-12))
        bshape = (1, -1) + (1,) * (ndim - 2)
        return ct + kl_grad.reshape(bshape).to(dtype), None, None, None


@register("IdentityAttachKLSparseReg",
          aux=("moving_avg",),
          params={"sparseness_target": Param(float, 0.1),
                  "penalty": Param(float, 0.001),
                  "momentum": Param(float, 0.9)},
          infer_shape=lambda attrs, s: (
              s, [s[0]], [(s[0][1],) if s[0] is not None else None]),
          hint="identityattachklsparsereg")
def _identity_kl_sparse(opctx, attrs, data, moving_avg):
    """Identity with a KL-sparsity penalty on the (sigmoid) activations'
    gradient; ``moving_avg`` follows the batch mean per channel."""
    mom = attrs.get("momentum", 0.9)
    rho = torch.mean(data, dim=tuple(i for i in range(data.ndim) if i != 1))
    new_avg = mom * moving_avg + (1 - mom) * rho.detach()
    out = _KLSparse.apply(data, rho.detach(),
                          attrs.get("sparseness_target", 0.1),
                          attrs.get("penalty", 0.001))
    return out, new_avg


# ---------------------------------------------------------------------------
# UpSampling
# ---------------------------------------------------------------------------


def _upsampling_inputs(attrs):
    n = int(attrs.get("num_args", 1))
    if attrs.get("sample_type") == "bilinear":
        return ["data", "weight"]
    return ["arg%d" % i for i in range(n)] if n > 1 else ["data"]


def _upsampling_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    s = attrs["scale"]
    out = (d[0], sum(x[1] for x in in_shapes if x is not None)
           if len(in_shapes) > 1 and attrs.get("sample_type") != "bilinear"
           else d[1], d[2] * s, d[3] * s)
    if attrs.get("sample_type") == "bilinear":
        k = 2 * s - s % 2
        return [d, (d[1], 1, k, k)], [out], []
    return in_shapes, [out], []


@register("UpSampling", inputs=_upsampling_inputs, key_var_num_args="num_args",
          params={"scale": Param(int, required=True),
                  "num_filter": Param(int, 0),
                  "sample_type": Param(str, required=True,
                                       enum=("nearest", "bilinear")),
                  "multi_input_mode": Param(str, "concat",
                                            enum=("concat", "sum")),
                  "num_args": Param(int, 1), "workspace": Param(int, 512)},
          infer_shape=_upsampling_infer, hint="upsampling")
def _upsampling(opctx, attrs, *args):
    """nearest: each input's pixels repeated ``scale`` times along H and
    W, several inputs concatenated on the channels or summed; bilinear:
    the transposed convolution of each channel by its own (k, k) filter,
    k = 2·scale − scale % 2, stride ``scale``, padding ceil((scale − 1)/2)
    (on the card in float32 by ``_WideConv``)."""
    s = attrs["scale"]
    if attrs["sample_type"] == "nearest":
        outs = [x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
                for x in args]
        if len(outs) == 1:
            return outs[0]
        if attrs.get("multi_input_mode", "concat") == "sum":
            out = outs[0]
            for o in outs[1:]:
                out = out + o
            return out
        return torch.cat(outs, dim=1)
    data, weight = args
    pad = (s - 1) // 2 if s % 2 else s // 2
    return _conv_transpose(data, weight, (s, s), (pad, pad), (0, 0),
                           data.shape[1])
