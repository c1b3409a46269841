"""Fused optimizer update ops — what the optimizers execute.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (``sgd_update``,
``sgd_mom_update``, ``adam_update``, ``rmsprop_update``,
``rmspropalex_update``, ``:37-91``; reference optimizer_op.cc:18-73), in
plain torch.  Called as the JAX package's ``mx.nd`` functions are:

    nd.adam_update(weight, grad, mean, var, out=weight, lr=0.01, ...)

The new weight is written into ``out`` (a new array when ``out`` is None)
and the states are updated in place, all under ``torch.no_grad()``.  The
arguments are NDArrays or torch tensors; ``optimizer.py`` calls them on
tensors from the fused train step.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update"]


def _t(x):
    return x if isinstance(x, torch.Tensor) else x._data


def _prep_grad(weight, grad, rescale_grad, clip_gradient, wd):
    g = _t(grad).to(weight.dtype) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight
    return g


def _write(out, weight_arr, new):
    """The new weight into ``out`` (in place), or a new array like the
    weight when there is none."""
    if out is None:
        from ..ndarray import NDArray

        if isinstance(weight_arr, torch.Tensor):
            return new
        return NDArray(new, weight_arr.context)
    _t(out).copy_(new)
    return out


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    return w


@torch.no_grad()
def sgd_update(weight, grad, out=None, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    w = _t(weight)
    g = _prep_grad(w, grad, rescale_grad, clip_gradient, wd)
    return _write(out, weight, w - lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, out=None, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    w, m = _t(weight), _t(mom)
    g = _prep_grad(w, grad, rescale_grad, clip_gradient, wd)
    m.copy_(momentum * m - lr * g)
    return _write(out, weight, w + m)


@torch.no_grad()
def adam_update(weight, grad, mean, var, out=None, *, lr, beta1=0.9,
                beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    w, m, v = _t(weight), _t(mean), _t(var)
    g = _prep_grad(w, grad, rescale_grad, clip_gradient, wd)
    m.copy_(beta1 * m + (1 - beta1) * g)
    v.copy_(beta2 * v + (1 - beta2) * g.square())
    return _write(out, weight, w - lr * m / (v.sqrt() + epsilon))


@torch.no_grad()
def rmsprop_update(weight, grad, n, out=None, *, lr, gamma1=0.95,
                   epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    w, n_ = _t(weight), _t(n)
    g = _prep_grad(w, grad, rescale_grad, clip_gradient, wd)
    n_.copy_((1 - gamma1) * g.square() + gamma1 * n_)
    new = w - lr * g / (n_ + epsilon).sqrt()
    return _write(out, weight, _clip_weights(new, clip_weights))


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g, delta, out=None, *, lr,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    w, n_, g_, d_ = _t(weight), _t(n), _t(g), _t(delta)
    gr = _prep_grad(w, grad, rescale_grad, clip_gradient, wd)
    n_.copy_((1 - gamma1) * gr.square() + gamma1 * n_)
    g_.copy_((1 - gamma1) * gr + gamma1 * g_)
    d_.copy_(gamma2 * d_ - lr * gr / (n_ - g_.square() + epsilon).sqrt())
    return _write(out, weight, _clip_weights(w + d_, clip_weights))
