"""Kernel-backed ops — ``register_kernel_op``, the port's counterpart of
``mx.register_pallas_op`` (``mxnet_tpu/ops/pallas_op.py``).

A caller hands in a function that wraps a hand-written kernel (a CUDA
kernel of ``csrc/``, or a user's kernel compiled at run time by
``mx.rtc.MXRtc``) and gets a first-class registered op back, visible as
``mx.sym.<name>`` and ``mx.nd.<name>`` and trainable through executors and
``Module``:

    def kernel(attrs, x):          # attrs: parsed op params
        return my_cuda_wrapper(x)

    mx.register_kernel_op("my_op", kernel,
                          params={"alpha": Param(float, 1.0)})

A kernel launched through ``ctypes`` is invisible to autograd, so training
through it needs ``bwd`` (and optionally ``fwd`` for residual control):

    def fwd(attrs, *inputs):   -> (output, residuals)
    def bwd(attrs, residuals, cotangent) -> tuple of input cotangents

With ``bwd`` the op runs inside a ``torch.autograd.Function``.
``_contrib_FlashAttention`` (ops/attention.py) is registered through this
exact mechanism.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

__all__ = ["register_kernel_op", "refresh_surfaces"]


def register_kernel_op(name: str, fn: Callable, bwd: Optional[Callable] = None,
                       fwd: Optional[Callable] = None, inputs=("data",),
                       params=None, infer_shape=None, num_outputs=1,
                       aliases=(), hint=None):
    """Register ``fn(attrs, *tensors)`` as op ``name``.

    Parameters
    ----------
    fn : the kernel wrapper.  Receives the parsed attr dict first, then the
        input tensors.
    bwd : optional gradient, ``bwd(attrs, residuals, cotangent) -> input
        cotangents`` (the bare output cotangent for single-output ops).
    fwd : optional ``fwd(attrs, *tensors) -> (out, residuals)``; defaults to
        saving the inputs as residuals.  Residuals are a tuple; its tensors
        are kept with ``save_for_backward``.
    inputs / params / infer_shape / num_outputs / aliases : the registry
        surface, identical to internal op registration (ops/registry.py).
    """
    from .registry import register

    if fwd is not None and bwd is None:
        raise ValueError(
            "register_kernel_op: fwd without bwd has no effect — supply "
            "bwd (custom gradient) or drop fwd")

    decorator = register(name, inputs=tuple(inputs), params=dict(params or {}),
                         infer_shape=infer_shape, num_outputs=num_outputs,
                         aliases=tuple(aliases), hint=hint or name.lower())

    if bwd is None:
        def _op(opctx, attrs, *tensors):
            return fn(attrs, *tensors)
    else:
        import torch

        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, attrs, *tensors):
                if fwd is not None:
                    out, res = fwd(attrs, *tensors)
                else:
                    out, res = fn(attrs, *tensors), tensors
                ctx.attrs = attrs
                # tensor residuals go through save_for_backward: an output
                # held on ctx directly would form a reference cycle that
                # keeps every step's activations alive until the next GC
                res = tuple(res)
                is_tensor = [isinstance(r, torch.Tensor) for r in res]
                ctx.save_for_backward(*(r for r, t in zip(res, is_tensor)
                                        if t))
                ctx.is_tensor = is_tensor
                ctx.others = [None if t else r
                              for r, t in zip(res, is_tensor)]
                return out

            @staticmethod
            def backward(ctx, ct):
                saved = iter(ctx.saved_tensors)
                res = tuple(next(saved) if t else r
                            for r, t in zip(ctx.others, ctx.is_tensor))
                return (None,) + tuple(bwd(ctx.attrs, res, ct))

        def _op(opctx, attrs, *tensors):
            return _Fn.apply(attrs, *tensors)

    _op.__name__ = "kernel_op_%s" % name
    decorator(_op)

    refresh_surfaces()
    return _op


def refresh_surfaces() -> None:
    """Late registration: ops registered after package import also appear
    on the already-generated ``mx.sym`` and ``mx.nd`` surfaces.  During the
    package's own import each of those modules generates its surface after
    every op has loaded, so only a module that has finished is refreshed."""
    pkg = __package__.rsplit(".", 1)[0]
    sym_mod = sys.modules.get(pkg + ".symbol")
    if sym_mod is not None and hasattr(sym_mod, "_init_symbol_module"):
        sym_mod._init_symbol_module()
    nd_mod = sys.modules.get(pkg + ".ndarray")
    if nd_mod is not None and hasattr(nd_mod, "_init_ops"):
        nd_mod._init_ops()
