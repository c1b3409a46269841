"""Optimizers — weight update rules; counterpart of
``mxnet_tpu/optimizer.py``.

Ported: the ``Optimizer`` base (``register``/``create``, lr and wd
multipliers from the symbol's attrs and the no-wd default for biases,
``rescale_grad``, ``clip_gradient``, per-index update counts), ``SGD``
(with momentum), ``Adam`` (bias correction folded into the lr),
``Updater``/``get_updater``.  Each rule is written once, over the fused
update ops of ``ops/optimizer_ops.py``: ``update`` runs it on NDArrays for
the eager path (``Module.update`` without the fused step, the updater),
``update_tensors`` on tensors in place for ``Executor.fused_step`` — the
counterpart of the JAX package's traced ``pure_update``.  The other
optimizers of the JAX package (DCASGD, NAG, SGLD, ccSGD, AdaGrad, RMSProp,
AdaDelta, Test) are queued in ROADMAP.md.
"""
from __future__ import annotations

import logging
import math
import pickle
from typing import Dict

from .ndarray import NDArray
from .ops import optimizer_ops as ops

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]


def _zeros_like(weight):
    import torch

    return NDArray(torch.zeros_like(weight._data), weight.context)


class Optimizer:
    """Base optimizer: owns lr/wd multipliers, per-index update counts,
    gradient rescale/clip, and creates the per-parameter state."""

    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        assert isinstance(klass, type)
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("New optimizer %s is overriding existing one", name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        assert isinstance(param_idx2name, dict), \
            "param_idx2name should be a dict of param indexes to names."
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def __getstate__(self):
        # the symbol is read only at construction; keep pickles small
        state = self.__dict__.copy()
        state["sym"] = None
        return state

    def create_state(self, index, weight):
        """The state NDArray(s) for ``index`` (None if stateless)."""
        return None

    def update(self, index, weight, grad, state):
        """Update NDArray ``weight`` (and ``state``) in place from
        ``grad``."""
        self._update_count(index)
        self.update_tensors(index, weight._data, grad._data,
                            _tensors(state), self._index_update_count[index])

    def update_tensors(self, index, weight, grad, state, t):
        """Update tensor ``weight`` and the tensor(s) ``state`` in place
        from ``grad``, at update count ``t`` (bias correction); the lr and
        wd of ``index`` come with their multipliers.  The caller has
        advanced the update count."""
        raise NotImplementedError("virtual Optimizer.update_tensors")

    @classmethod
    def has_tensor_update(cls):
        return cls.update_tensors is not Optimizer.update_tensors

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0

    # -- multipliers -------------------------------------------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
                elif name in attr and "lr_mult" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["lr_mult"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """No-wd default for biases/betas: params not ending in
        _weight/_gamma get wd_mult 0."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
                elif name in attr and "wd_mult" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["wd_mult"])
        self.wd_mult.update(args_wd_mult)

    # -- bookkeeping -------------------------------------------------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


create = Optimizer.create_optimizer
register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay, over the fused
    sgd_update / sgd_mom_update ops."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def update_tensors(self, index, weight, grad, state, t):
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self._clip())
        if state is not None:
            ops.sgd_mom_update(weight, grad, state, out=weight,
                               momentum=self.momentum, **kwargs)
        else:
            ops.sgd_update(weight, grad, out=weight, **kwargs)


@register
class Adam(Optimizer):
    """Adam over the fused adam_update op, with the bias correction folded
    into the effective lr: lr · sqrt(1 - beta2^t) / (1 - beta1^t)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight),   # mean
                _zeros_like(weight))   # var

    def update_tensors(self, index, weight, grad, state, t):
        lr = self._get_lr(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        ops.adam_update(weight, grad, mean, var, out=weight, lr=lr,
                        wd=self._get_wd(index), beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self._clip())


class Updater:
    """Applies an optimizer on (index, grad, weight), keeping each index's
    state."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, object] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        self.states = pickle.loads(states)

    def get_states(self):
        return pickle.dumps(self.states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)


def _tensors(state):
    """An optimizer state (NDArray, tuple of them, or None) as tensors."""
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_tensors(s) for s in state)
    return state._data
