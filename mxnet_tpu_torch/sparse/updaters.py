"""Server-placed row-wise optimizers for the sparse parameter plane, the
port's own copy of ``mxnet_tpu/sparse/updaters.py``: numpy, so a row update
is the JAX package's bit for bit.

These run *inside* KVStoreServer: the worker ships touched-row gradients
(push_rows) and the server applies the update lazily per row, keeping the
optimizer state (e.g. AdaGrad accumulators) server-side — ZeRO-style
memory relief for workers, which never hold the full table or any
optimizer state.

Everything here must be picklable: the updater travels over the wire
(set_sparse_optimizer) and is journaled verbatim into the server
snapshot, so crash-restart resumes with bit-identical state.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SparseSGD", "SparseAdaGrad", "get_sparse_updater"]


class _SparseOptimizer(object):
    """Base: vectorized over the batch of touched rows of one push."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0):
        self.lr = float(learning_rate)
        self.wd = float(wd)
        self.rescale_grad = float(rescale_grad)

    def state_shape(self, row_shape):
        """Shape of the per-row state block, or None for stateless."""
        return None

    def update_rows(self, weight_rows, grad_rows, state_rows):
        """In-place update of weight_rows (nnz, dim); state_rows is the
        matching (nnz,)+state_shape block or None.  Must mutate both in
        place so the server's row store sees the result."""
        raise NotImplementedError


class SparseSGD(_SparseOptimizer):
    """w -= lr * (rescale_grad * g + wd * w); optional momentum keeps a
    per-row velocity on the server."""

    def __init__(self, learning_rate=0.01, wd=0.0, momentum=0.0,
                 rescale_grad=1.0):
        super(SparseSGD, self).__init__(learning_rate, wd, rescale_grad)
        self.momentum = float(momentum)

    def state_shape(self, row_shape):
        return tuple(row_shape) if self.momentum else None

    def update_rows(self, weight_rows, grad_rows, state_rows):
        g = grad_rows * self.rescale_grad
        if self.wd:
            g = g + self.wd * weight_rows
        if self.momentum:
            state_rows *= self.momentum
            state_rows -= self.lr * g
            weight_rows += state_rows
        else:
            weight_rows -= self.lr * g


class SparseAdaGrad(_SparseOptimizer):
    """Per-row AdaGrad: h += g^2; w -= lr * g / (sqrt(h) + eps).  The
    accumulator h lives on the server beside the row."""

    def __init__(self, learning_rate=0.01, wd=0.0, eps=1e-7,
                 rescale_grad=1.0):
        super(SparseAdaGrad, self).__init__(learning_rate, wd, rescale_grad)
        self.eps = float(eps)

    def state_shape(self, row_shape):
        return tuple(row_shape)

    def update_rows(self, weight_rows, grad_rows, state_rows):
        g = grad_rows * self.rescale_grad
        if self.wd:
            g = g + self.wd * weight_rows
        state_rows += g * g
        weight_rows -= self.lr * g / (np.sqrt(state_rows) + self.eps)


_REGISTRY = {"sgd": SparseSGD, "adagrad": SparseAdaGrad}


def get_sparse_updater(name, **kwargs):
    """Factory: get_sparse_updater('adagrad', learning_rate=0.1)."""
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError("unknown sparse optimizer %r (have: %s)"
                         % (name, sorted(_REGISTRY)))
    return cls(**kwargs)


def from_dense_optimizer(opt):
    """Map a worker-side mxnet_tpu_torch.optimizer.Optimizer onto its
    server-placed sparse twin, preserving lr/wd/rescale_grad so sparse and
    dense slots train under identical hyperparameters."""
    kind = type(opt).__name__.lower()
    lr = getattr(opt, "lr", 0.01)
    wd = getattr(opt, "wd", 0.0)
    rescale = getattr(opt, "rescale_grad", 1.0)
    if kind == "adagrad":
        return SparseAdaGrad(learning_rate=lr, wd=wd, rescale_grad=rescale)
    momentum = getattr(opt, "momentum", 0.0) if kind == "sgd" else 0.0
    return SparseSGD(learning_rate=lr, wd=wd, momentum=momentum,
                     rescale_grad=rescale)
