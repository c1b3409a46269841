"""Fused optimizer update ops: ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update``.

Counterparts of ``mxnet_tpu/ops/optimizer_ops.py:19-91`` (reference
optimizer_op.cc:18-73), registered with the same inputs, aux names,
``Param`` specs and defaults, so ``sym.sgd_mom_update`` builds and graph
JSON that holds one loads.  As in the JAX package the states are aux
inputs: the op returns the new weight and the new states, the imperative
layer writes the states back into their arrays and the weight into
``out``:

    nd.adam_update(weight, grad, mean, var, out=weight, lr=0.01, ...)

Each formula is written once, over lists of tensors updated in place by
``torch._foreach_*`` ops (``prep_grads``, ``sgd_step``, ``adam_step``,
``rmsprop_step``, ``rmspropalex_step``): the optimizers of
``optimizer.py`` run them over every array of a device and dtype at once,
and each op here runs them over a one-element list of copies, so an op and
the list update give the same bits.  The order is the JAX op's (rescale,
clip, then wd · weight added to the gradient); where one fused op
(``_foreach_add_(.., alpha=)``, ``_foreach_addcmul_``,
``_foreach_addcdiv_``) stands for two of the JAX package's, it rounds once
where the JAX package rounds twice.
"""
from __future__ import annotations

import torch

from .param import Param
from .registry import register

_COMMON = {
    "lr": Param(float, required=True),
    "wd": Param(float, 0.0),
    "rescale_grad": Param(float, 1.0),
    "clip_gradient": Param(float, -1.0),
}


# -- the formulas over lists (gradients are scratch) ------------------------
def prep_grads(grads, weights, rescale, clip, wds):
    """grads ← clip(grads · rescale) + wd · weight, in place; ``wds`` None
    (the rules that add wd elsewhere) or one per array, 0 skipped."""
    if rescale != 1.0:
        torch._foreach_mul_(grads, rescale)
    clamp(grads, clip)
    if wds is not None:
        add_wd(grads, weights, wds)


def add_wd(grads, weights, wds):
    """grad += wd · weight for the arrays whose wd is not 0: wd · weight
    rounded, then the sum, as the JAX package writes it."""
    idx = [k for k, wd in enumerate(wds) if wd]
    if idx:
        decay = torch._foreach_mul([weights[k] for k in idx],
                                   [wds[k] for k in idx])
        torch._foreach_add_([grads[k] for k in idx], decay)


def clamp(tensors, bound):
    if bound is not None and bound > 0:
        torch._foreach_clamp_min_(tensors, -bound)
        torch._foreach_clamp_max_(tensors, bound)


def sgd_step(weights, grads, moms, lrs, momentum):
    """mom = momentum · mom - lr · g, weight += mom; without momentum
    states (``moms`` None) weight -= lr · g."""
    torch._foreach_mul_(grads, lrs)
    if moms is None:
        torch._foreach_sub_(weights, grads)
        return
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, grads)
    torch._foreach_add_(weights, moms)


def adam_step(weights, grads, means, variances, lrs, beta1, beta2, epsilon):
    """mean, var ← their moving averages; weight -= lr · mean / (sqrt(var)
    + epsilon), ``lrs`` with the bias correction folded in."""
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(variances, beta2)
    torch._foreach_addcmul_(variances, grads, grads, value=1.0 - beta2)
    denom = torch._foreach_sqrt(variances)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_addcdiv_(weights, means, denom, [-lr for lr in lrs])


def rmsprop_step(weights, grads, ns, lrs, gamma1, epsilon, clip_weights):
    """n ← (1 - gamma1) · g² + gamma1 · n; weight -= lr · g / sqrt(n +
    epsilon), clipped to ``clip_weights``."""
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_addcmul_(ns, grads, grads, value=1.0 - gamma1)
    denom = torch._foreach_add(ns, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_addcdiv_(weights, grads, denom, [-lr for lr in lrs])
    clamp(weights, clip_weights)


def rmspropalex_step(weights, grads, ns, gs, deltas, lrs, gamma1, gamma2,
                     epsilon, clip_weights):
    """Graves' centered RMSProp: n and g the moving averages of g² and g,
    delta ← gamma2 · delta - lr · g / sqrt(n - g² + epsilon), weight +=
    delta, clipped to ``clip_weights``."""
    torch._foreach_mul_(ns, gamma1)
    torch._foreach_addcmul_(ns, grads, grads, value=1.0 - gamma1)
    torch._foreach_mul_(gs, gamma1)
    torch._foreach_add_(gs, grads, alpha=1.0 - gamma1)
    denom = torch._foreach_addcmul(ns, gs, gs, value=-1.0)
    torch._foreach_add_(denom, epsilon)
    torch._foreach_sqrt_(denom)
    torch._foreach_mul_(deltas, gamma2)
    torch._foreach_addcdiv_(deltas, grads, denom, [-lr for lr in lrs])
    torch._foreach_add_(weights, deltas)
    clamp(weights, clip_weights)


# -- the registered ops: the formulas over one array's copies ---------------
def _copies(attrs, weight, grad, *states):
    """([new weight], [scratch gradient], [[new state]] per state), the
    gradient rescaled (into a new tensor, as the list update does with
    gradients it does not own), clipped and with wd · weight added."""
    w = [weight.clone()]
    g = torch._foreach_mul([grad.to(weight.dtype)],
                           attrs.get("rescale_grad", 1.0))
    prep_grads(g, w, 1.0, attrs.get("clip_gradient", -1.0),
               [attrs.get("wd", 0.0)])
    return w, g, [[s.clone()] for s in states]


@register("sgd_update", inputs=("weight", "grad"), params=dict(_COMMON))
@torch.no_grad()
def _sgd_update(opctx, attrs, weight, grad):
    w, g, _ = _copies(attrs, weight, grad)
    sgd_step(w, g, None, [attrs["lr"]], 0.0)
    return w[0]


@register("sgd_mom_update", inputs=("weight", "grad"), aux=("mom",),
          params={**_COMMON, "momentum": Param(float, 0.0)})
@torch.no_grad()
def _sgd_mom_update(opctx, attrs, weight, grad, mom):
    w, g, (m,) = _copies(attrs, weight, grad, mom)
    sgd_step(w, g, m, [attrs["lr"]], attrs.get("momentum", 0.0))
    return w[0], m[0]


@register("adam_update", inputs=("weight", "grad"), aux=("mean", "var"),
          params={**_COMMON, "beta1": Param(float, 0.9),
                  "beta2": Param(float, 0.999),
                  "epsilon": Param(float, 1e-8)})
@torch.no_grad()
def _adam_update(opctx, attrs, weight, grad, mean, var):
    w, g, (m, v) = _copies(attrs, weight, grad, mean, var)
    adam_step(w, g, m, v, [attrs["lr"]], attrs.get("beta1", 0.9),
              attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-8))
    return w[0], m[0], v[0]


@register("rmsprop_update", inputs=("weight", "grad"), aux=("n",),
          params={**_COMMON, "gamma1": Param(float, 0.95),
                  "epsilon": Param(float, 1e-8),
                  "clip_weights": Param(float, -1.0)})
@torch.no_grad()
def _rmsprop_update(opctx, attrs, weight, grad, n):
    w, g, (n_,) = _copies(attrs, weight, grad, n)
    rmsprop_step(w, g, n_, [attrs["lr"]], attrs.get("gamma1", 0.95),
                 attrs.get("epsilon", 1e-8), attrs.get("clip_weights", -1.0))
    return w[0], n_[0]


@register("rmspropalex_update", inputs=("weight", "grad"),
          aux=("n", "g", "delta"),
          params={**_COMMON, "gamma1": Param(float, 0.95),
                  "gamma2": Param(float, 0.9),
                  "epsilon": Param(float, 1e-8),
                  "clip_weights": Param(float, -1.0)})
@torch.no_grad()
def _rmspropalex_update(opctx, attrs, weight, grad, n, g_state, delta):
    w, g, (n_, gs, d) = _copies(attrs, weight, grad, n, g_state, delta)
    rmspropalex_step(w, g, n_, gs, d, [attrs["lr"]],
                     attrs.get("gamma1", 0.95), attrs.get("gamma2", 0.9),
                     attrs.get("epsilon", 1e-8),
                     attrs.get("clip_weights", -1.0))
    return w[0], n_[0], gs[0], d[0]
