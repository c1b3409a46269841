"""Layer ops of the transformer LM: ``FullyConnected``, ``LayerNorm`` and
the ``SoftmaxOutput`` loss.

Counterparts of ``mxnet_tpu/ops/nn.py`` (``:118-128``, ``:458-482``,
``:540-602``).  FullyConnected is a plain ``torch.matmul``, the product the
JAX package leaves to XLA.  FullyConnected and LayerNorm differentiate
under autograd; SoftmaxOutput carries its own loss gradient, as the JAX
package's custom vjp does.
"""
from __future__ import annotations

import numpy as np
import torch

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
