"""``mt.th`` — call PyTorch functions on NDArrays; counterpart of
``mxnet_tpu/torch.py``.

The reference bridges Torch7 tensor math into MXNet (python/mxnet/torch.py
over plugin/torch/): ``mx.th.foo`` runs a torch function on MXNet arrays.
The port's arrays already are torch tensors, so the bridge hands each
NDArray's own tensor to the function, on its device, with no copy through
numpy, and wraps every tensor result as an NDArray on the device it came
back on.  A function that writes its input in place writes the NDArray
(the reference's torch functions mutate MXNet arrays so too).  Where the
JAX package converts to CPU tensors and back, results here stay on the
inputs' device (a kept difference, ROADMAP.md C).  An array stored as
pieces on a mesh is gathered first.  This runs outside the executor's
graphs; for an op inside one use the registry (``register_kernel_op``).
"""
from __future__ import annotations

import sys
import types

import numpy as np

__all__ = ["apply", "is_available"]


def is_available() -> bool:
    """Always true: the port is built on torch."""
    return True


def _to_torch(v):
    import torch

    from .ndarray import NDArray, _dense

    if isinstance(v, NDArray):
        return _dense(v._data)
    if isinstance(v, np.ndarray):
        arr = np.ascontiguousarray(v)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr)
    if isinstance(v, (list, tuple)):
        return type(v)(_to_torch(x) for x in v)
    return v


def _from_torch(v):
    import torch

    from .ndarray import NDArray, _context_of

    if isinstance(v, torch.Tensor):
        return NDArray(v.detach(), _context_of(v.device))
    if isinstance(v, (list, tuple)):
        # torch's named tuples (svd, topk ...) come back as plain tuples
        return (list if isinstance(v, list) else tuple)(
            _from_torch(x) for x in v)
    return v


def apply(fn, *args, **kwargs):
    """Run ``fn`` (a torch callable or a dotted name like ``"fft.rfft"``)
    on NDArray/numpy arguments; NDArrays come back out."""
    import torch

    if isinstance(fn, str):
        obj = torch
        for part in fn.split("."):
            obj = getattr(obj, part)
        fn = obj
    out = fn(*[_to_torch(a) for a in args],
             **{k: _to_torch(v) for k, v in kwargs.items()})
    return _from_torch(out)


class _TorchModule(types.ModuleType):
    """Attribute access forwards to torch: ``mt.th.exp(x)``,
    ``mt.th.linalg.svd(m)`` — the reference's generated mx.th surface."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        import torch

        target = getattr(torch, name)
        if isinstance(target, types.ModuleType):
            return _TorchNamespace(target)
        if callable(target):
            return lambda *a, **kw: apply(target, *a, **kw)
        return target


class _TorchNamespace:
    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        target = getattr(self._mod, name)
        if isinstance(target, types.ModuleType):
            return _TorchNamespace(target)
        if callable(target):
            return lambda *a, **kw: apply(target, *a, **kw)
        return target


sys.modules[__name__].__class__ = _TorchModule
