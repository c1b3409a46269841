"""Optimizers — weight update rules; counterpart of
``mxnet_tpu/optimizer.py``.

The ``Optimizer`` base (``register``/``create``, lr and wd multipliers
from the symbol's attrs and the no-wd default for biases, ``rescale_grad``,
``clip_gradient``, per-index update counts), every rule of the JAX package
(SGD, DCASGD, NAG, SGLD, ccSGD, Adam, AdaGrad, RMSProp, AdaDelta, Test) and
``Updater``/``get_updater``.

Each rule is written once, as an update over a *list* of arrays
(``update_tensors_list``): the arrays are grouped by device and dtype, and
each group is updated by in-place ``torch._foreach_*`` ops, a few launches
for all of its arrays, with each array's lr and wd passed as scalar lists.
That is the counterpart of the JAX package's fused step, which traces every
array's ``pure_update`` into one XLA program.  ``Executor.fused_step``
runs it once over all of its arrays; the two-phase path runs it through
``Updater.update_list``; ``update`` and ``update_tensors`` are its
one-array case.  The formulas are ``pure_update``'s: the gradient is
rescaled, then clipped, then (where the rule adds it there) wd · weight is
added; Adam folds its bias correction into lr and adds eps after
sqrt(v); AdaDelta takes no lr.  SGD's, Adam's and RMSProp's formulas are
the registered update ops' own (``ops/optimizer_ops.py``), so the list
update gives those ops' bits.  Where one fused op
(``_foreach_add_(.., alpha=)``, ``_foreach_addcmul_``,
``_foreach_addcdiv_``) stands for two of the JAX package's, it rounds once
where the JAX package rounds twice.

The gradients a caller hands in are read, never written, unless it owns
them (``owned_grads``: the fused step, whose gradients nobody sees);
otherwise the rescaled copy is made a chunk of at most ``_CHUNK`` elements
at a time, which bounds the temporaries.

While the training guardian's re-warm ramp runs, every lr is multiplied by
``guardian.current_lr_mult()`` (``_get_lr``), as in the JAX package.
"""
from __future__ import annotations

import logging
import math
import pickle
from typing import Dict

import torch

from . import guardian as _guardian
from . import random as _random
from .ndarray import NDArray
from .ops import optimizer_ops as ops
from .ops.optimizer_ops import add_wd as _add_wd

__all__ = ["Optimizer", "SGD", "DCASGD", "NAG", "SGLD", "ccSGD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Test", "Updater", "get_updater",
           "create", "register"]

#: elements of one chunk of a device/dtype group: a list update allocates
#: its temporaries (the rescaled gradients when it does not own them, a
#: rule's denominators) for one chunk at a time
_CHUNK = 1 << 27


def _zeros_like(weight):
    return NDArray(torch.zeros_like(weight._data), weight.context)


class Optimizer:
    """Base optimizer: owns lr/wd multipliers, per-index update counts,
    gradient rescale/clip, and creates the per-parameter state."""

    opt_registry: Dict[str, type] = {}
    #: whether the gradient is clipped by ``clip_gradient`` (Test's is not)
    _clips = True
    #: whether the eager update advances the update count (Test's does not)
    _counts = True

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

    # -- the update --------------------------------------------------------
    def update(self, index, weight, grad, state):
        """Update NDArray ``weight`` (and ``state``) in place from
        ``grad``."""
        self.update_list([index], [weight], [grad], [state])

    def update_list(self, indices, weights, grads, states):
        """Update every NDArray of ``weights`` (and its state) in place
        from ``grads``, advancing each index's update count; the
        gradients are not written."""
        if self._counts:
            for index in indices:
                self._update_count(index)
        ts = [self._index_update_count.get(i, self.num_update)
              for i in indices]
        self.update_tensors_list(indices, [w._data for w in weights],
                                 [g._data for g in grads],
                                 [_tensors(s) for s in states], ts)

    def update_tensors(self, index, weight, grad, state, t):
        """Update tensor ``weight`` and the tensor(s) ``state`` in place
        from ``grad``, at update count ``t``: the one-array case of
        :meth:`update_tensors_list`."""
        self.update_tensors_list([index], [weight], [grad], [state], [t])

    def update_tensors_list(self, indices, weights, grads, states, ts,
                            owned_grads=False):
        """The list update: tensors ``weights`` and their states updated in
        place from ``grads``, each at its own update count in ``ts`` (bias
        correction), with the lr and wd of its index.  The caller has
        advanced the update counts.  The arrays are grouped by device and
        dtype, in order of first appearance, so a list gives the same
        groups whichever path hands it over.  With ``owned_grads`` the
        gradients are scratch and end overwritten; without, they are read
        only."""
        indices, weights, grads, states, ts = _over_pieces(
            indices, weights, grads, states, ts)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        groups: Dict[tuple, list] = {}
        for k, w in enumerate(weights):
            groups.setdefault((w.device, w.dtype), []).append(k)
        # a profiler range, so that a trace can group the update's kernels
        with torch.no_grad(), torch.profiler.record_function(
                "list_update:" + type(self).__name__):
            for members in groups.values():
                for chunk in _chunks(members, weights):
                    w = [weights[k] for k in chunk]
                    self._update_group(
                        w, self._scaled_grads([grads[k] for k in chunk], w,
                                              owned_grads),
                        [states[k] for k in chunk], [lrs[k] for k in chunk],
                        [wds[k] for k in chunk], [ts[k] for k in chunk])

    def _scaled_grads(self, grads, weights, owned):
        """The gradients rescaled (and clipped): in place when owned and
        already of the weights' dtype, else as new tensors."""
        if any(g.dtype != w.dtype for g, w in zip(grads, weights)):
            grads = [g.to(w.dtype, copy=not owned)
                     for g, w in zip(grads, weights)]
            owned = True
        if owned:
            # an autograd gradient may be an expanded view (a sum's): not
            # writable in place
            grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
            ops.prep_grads(grads, weights, self.rescale_grad, None, None)
        else:
            grads = torch._foreach_mul(grads, self.rescale_grad)
        if self._clips:
            ops.clamp(grads, self.clip_gradient)
        return grads

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        """One rule over one device/dtype group: ``grads`` are rescaled and
        clipped scratch tensors."""
        raise NotImplementedError("virtual Optimizer._update_group")

    @classmethod
    def has_tensor_update(cls):
        return cls._update_group is not Optimizer._update_group

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
        if _guardian._governor is not None:
            # guardian re-warm ramp after an anomaly burst; a plain
            # None-check when no ramp is live
            lr *= _guardian.current_lr_mult()
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


def _chunks(members, weights):
    """``members`` (indices into ``weights``) in runs of at most ``_CHUNK``
    elements (one array may exceed it alone)."""
    run, size = [], 0
    for k in members:
        n = weights[k].numel()
        if run and size + n > _CHUNK:
            yield run
            run, size = [], 0
        run.append(k)
        size += n
    if run:
        yield run


def _column(states, i):
    return [s[i] for s in states]


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay: mom = momentum · mom - lr · g,
    weight += mom (without momentum, weight -= lr · g)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        _add_wd(grads, weights, wds)
        ops.sgd_step(weights, grads, None if states[0] is None else states,
                     lrs, self.momentum)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD: the gradient plus wd · weight plus
    lamda · g² · (weight - previous weight), then SGD's step; the state is
    (momentum or None, the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (_zeros_like(weight), weight.copy())

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        mom, prev = _column(states, 0), _column(states, 1)
        # lamda · g · g · (prev - weight), the JAX package's term negated
        comp = torch._foreach_mul(grads, self.lamda)
        torch._foreach_mul_(comp, grads)
        torch._foreach_sub_(prev, weights)
        torch._foreach_mul_(comp, prev)
        _add_wd(grads, weights, wds)
        torch._foreach_sub_(grads, comp)
        del comp
        torch._foreach_copy_(prev, weights)
        torch._foreach_mul_(grads, lrs)
        if mom[0] is None:
            torch._foreach_sub_(weights, grads)
            return
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_sub_(mom, grads)
        torch._foreach_add_(weights, mom)


@register
class NAG(SGD):
    """Nesterov accelerated SGD: gw = g + wd · weight, mom = momentum · mom
    + gw, weight -= lr · (gw + momentum · mom)."""

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        _add_wd(grads, weights, wds)
        if states[0] is not None:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_add_(states, grads)
            torch._foreach_add_(grads, states, alpha=self.momentum)
        torch._foreach_mul_(grads, lrs)
        torch._foreach_sub_(weights, grads)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: weight -= lr / 2 · (g + wd ·
    weight), plus N(0, sqrt(lr)) noise drawn from the weight's device's
    ``random.optimizer_generator`` (never the generator the ops draw
    from)."""

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        _add_wd(grads, weights, wds)
        torch._foreach_mul_(grads, [lr / 2 for lr in lrs])
        torch._foreach_sub_(weights, grads)
        gen = _random.optimizer_generator(weights[0].device)
        for noise, lr in zip(grads, lrs):
            noise.normal_(0.0, math.sqrt(lr), generator=gen)
        torch._foreach_add_(weights, grads)


@register
class ccSGD(SGD):
    """Same update as SGD; kept for API parity (the reference's C++-side
    SGD)."""


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the effective lr:
    lr · sqrt(1 - beta2^t) / (1 - beta1^t); weight -= lr_t · mean /
    (sqrt(var) + epsilon)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight),   # mean
                _zeros_like(weight))   # var

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        _add_wd(grads, weights, wds)
        lrs = [lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
               for lr, t in zip(lrs, ts)]
        ops.adam_step(weights, grads, _column(states, 0), _column(states, 1),
                      lrs, self.beta1, self.beta2, self.epsilon)


@register
class AdaGrad(Optimizer):
    """AdaGrad: history += g², weight -= lr · (g / sqrt(history + eps) +
    wd · weight)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        torch._foreach_addcmul_(states, grads, grads)
        denom = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(grads, denom)
        del denom
        _add_wd(grads, weights, wds)
        torch._foreach_mul_(grads, lrs)
        torch._foreach_sub_(weights, grads)


@register
class RMSProp(Optimizer):
    """RMSProp: Tieleman's variant by default, Graves' centered variant
    with ``centered=True``; the weights clipped to ``clip_weights``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight),  # n
                    _zeros_like(weight),  # g
                    _zeros_like(weight))  # delta
        return (_zeros_like(weight),)     # n

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        _add_wd(grads, weights, wds)
        if not self.centered:
            ops.rmsprop_step(weights, grads, _column(states, 0), lrs,
                             self.gamma1, self.epsilon, self.clip_weights)
        else:
            ops.rmspropalex_step(weights, grads, _column(states, 0),
                                 _column(states, 1), _column(states, 2), lrs,
                                 self.gamma1, self.gamma2, self.epsilon,
                                 self.clip_weights)


@register
class AdaDelta(Optimizer):
    """AdaDelta: no lr; delta = sqrt(E[dx²] + eps) / sqrt(E[g²] + eps) · g,
    weight -= delta + wd · weight."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight),  # E[g^2]
                _zeros_like(weight))  # E[dx^2]

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        acc_g, acc_delta = _column(states, 0), _column(states, 1)
        rho = self.rho
        torch._foreach_mul_(acc_g, rho)
        torch._foreach_addcmul_(acc_g, grads, grads, value=1.0 - rho)
        ratio = torch._foreach_add(acc_delta, self.epsilon)
        torch._foreach_sqrt_(ratio)
        denom = torch._foreach_add(acc_g, self.epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(ratio, denom)
        del denom
        torch._foreach_mul_(grads, ratio)
        del ratio
        torch._foreach_mul_(acc_delta, rho)
        torch._foreach_addcmul_(acc_delta, grads, grads, value=1.0 - rho)
        _add_wd(grads, weights, wds)
        torch._foreach_sub_(weights, grads)


@register
class Test(Optimizer):
    """Trivial test optimizer: weight += grad · rescale, and the state
    becomes the new weight.  The gradient is not clipped, and the eager
    update does not advance the update count."""

    _clips = False
    _counts = False

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def _update_group(self, weights, grads, states, lrs, wds, ts):
        torch._foreach_add_(weights, grads)
        torch._foreach_copy_(states, weights)


class Updater:
    """Applies an optimizer on (index, grad, weight), keeping each index's
    state."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, object] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = _new_state(self.optimizer, index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_list(self, indices, grads, weights):
        """Every (index, grad, weight) at once: one list update when the
        optimizer has one, else ``update`` per index."""
        for index, weight in zip(indices, weights):
            if index not in self.states:
                self.states[index] = _new_state(self.optimizer, index,
                                                weight)
        states = [self.states[i] for i in indices]
        if type(self.optimizer).has_tensor_update():
            self.optimizer.update_list(indices, weights, grads, states)
            return
        for index, weight, grad, state in zip(indices, weights, grads,
                                              states):
            self.optimizer.update(index, weight, grad, state)

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


def _new_state(optimizer, index, weight):
    """``optimizer.create_state`` for the NDArray ``weight``; for one
    stored as pieces on a mesh, each piece's state, held as pieces under
    the parameter's spec."""
    from .parallel.mesh import ShardedTensor

    x = weight._data
    if not isinstance(x, ShardedTensor):
        return optimizer.create_state(index, weight)
    per = {c: optimizer.create_state(index, NDArray(p, weight.context))
           for c, p in x.shards.items()}

    def merge(states):
        first = next(iter(states.values()))
        if first is None:
            return None
        if isinstance(first, (list, tuple)):
            return type(first)(merge({c: s[i] for c, s in states.items()})
                               for i in range(len(first)))
        return NDArray(ShardedTensor({c: s._data for c, s in states.items()},
                                     x.mesh, x.spec), first.context)

    return merge(per)


def _over_pieces(indices, weights, grads, states, ts):
    """The list update's arguments with every weight stored as pieces
    (a ShardedTensor) expanded into them, its gradient's and states'
    pieces beside each: the update then groups pieces of one card by
    device and dtype like any other arrays."""
    from .parallel.mesh import ShardedTensor

    if not any(isinstance(w, ShardedTensor) for w in weights):
        return indices, weights, grads, states, ts

    def piece(x, c):
        if isinstance(x, (list, tuple)):
            return tuple(piece(s, c) for s in x)
        return x.shards[c] if isinstance(x, ShardedTensor) else x

    out = ([], [], [], [], [])
    for i, w, g, st, t in zip(indices, weights, grads, states, ts):
        keys = list(w.shards) if isinstance(w, ShardedTensor) else [None]
        for c in keys:
            for col, v in zip(out, (i, piece(w, c), piece(g, c),
                                    piece(st, c), t)):
                col.append(v)
    return out
