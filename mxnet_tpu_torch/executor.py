"""Executor — binds a Symbol to a device and runs it, forward and backward.

Counterpart of ``mxnet_tpu/executor.py``.  Where the JAX package lowers the
graph to one jitted XLA function and differentiates it with ``jax.vjp``,
here ``_GraphPlan.run`` walks the topologically sorted nodes eagerly in
PyTorch, each op on tensors of the bound device, and autograd takes the
gradients; ops with kernels of their own carry their backward as a
``torch.autograd.Function`` (``_contrib_FlashAttention``, the
``SoftmaxOutput`` loss).

Kept from the JAX package: ``grad_req`` write/add/null per argument (by
name, as a list or for all), with the inputs an op declares
non-differentiable (``no_grad_inputs``) forced to null; ``args_grad``,
``grad_dict``, ``grad_arrays``; ``forward(is_train)``,
``backward(out_grads)`` (a loss op ignores its head gradient),
``forward_backward``; aux states written back on a training forward;
mixed precision (``compute_dtype`` casts float32 arguments not in
``cast_exclude`` inside the step, gradients come back float32 to the
float32 arrays); and ``fused_step``: forward, backward and the optimizer's
update as one call, in place on the float32 parameters.

Left out, with their reason: jit, buffer donation and the compile cache
(PyTorch runs eagerly; a CUDA graph is the later tool), SPMD shardings and
``group2ctx`` placement (one device per executor in this port), the
training guardian's on-device step guard, the autotuner, remat
(``MXNET_BACKWARD_DO_MIRROR``) and the monitor callback.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .base import MXNetError
from .context import Context
from .ndarray import _torch_dtype
from .ops import OpContext
from .optimizer import _tensors

__all__ = ["Executor"]


class _GraphPlan:
    """Static plan for a symbol: topo order, entry wiring, aux bookkeeping,
    and for each entry the number of nodes that read it."""

    def __init__(self, symbol):
        from .symbol import _topo_sort

        self.symbol = symbol
        self.nodes = _topo_sort(symbol._outputs)
        self.arg_names = [n.name for n in self.nodes if n.is_variable]
        self.aux_names: List[str] = []
        for n in self.nodes:
            self.aux_names.extend(n.aux_names())
        self.output_entries = [(id(node), idx) for node, idx in symbol._outputs]
        self.output_names = symbol.list_outputs()
        self.readers: Dict[tuple, int] = {}
        for n in self.nodes:
            for p, idx in n.inputs:
                e = (id(p), idx)
                self.readers[e] = self.readers.get(e, 0) + 1

    def no_grad_args(self) -> List[str]:
        """Variables fed straight into an input its op declares
        non-differentiable (labels, token ids)."""
        out = []
        for n in self.nodes:
            if n.is_variable or not n.op.no_grad_inputs:
                continue
            for iname, (p, _) in zip(n.op.input_names(n.attrs), n.inputs):
                if iname in n.op.no_grad_inputs and p.is_variable:
                    out.append(p.name)
        return out

    def run(self, args: Dict[str, Any], aux: Dict[str, Any], is_train: bool):
        """Execute the graph on tensors.  An intermediate is released as
        soon as its last reader has run, so peak memory follows the live
        activations (and, under autograd, what the backward keeps)."""
        vals: Dict[tuple, Any] = {}
        left = dict(self.readers)
        keep = set(self.output_entries)
        new_aux: Dict[str, Any] = {}
        for n in self.nodes:
            if n.is_variable:
                if n.name not in args:
                    raise MXNetError("missing argument %r" % n.name)
                vals[(id(n), 0)] = args[n.name]
                continue
            ins = [vals[(id(p), idx)] for p, idx in n.inputs]
            aux_in = tuple(aux[a] for a in n.aux_names())
            outs, aux_out = n.op.apply(OpContext(is_train=is_train), n.attrs,
                                       ins, aux_in)
            del ins
            for i, o in enumerate(outs):
                vals[(id(n), i)] = o
            for aname, a in zip(n.aux_names(), aux_out):
                new_aux[aname] = a
            for p, idx in n.inputs:
                e = (id(p), idx)
                left[e] -= 1
                if left[e] == 0 and e not in keep:
                    del vals[e]
        return [vals[e] for e in self.output_entries], new_aux


class Executor:
    def __init__(self, symbol, ctx: Context, args, args_grad=None,
                 grad_req="write", aux_states=None, compute_dtype=None,
                 cast_exclude=()):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._plan = plan = _GraphPlan(symbol)
        # mixed precision: float32 args are cast to compute_dtype inside the
        # step; parameters, gradients and aux stay float32.  cast_exclude
        # names what keeps full precision (labels).  As in the JAX package,
        # everything else is cast, token ids included: bf16 ids above 256
        # are rounded before Embedding truncates them (ROADMAP.md §C).
        self._compute_dtype = None if compute_dtype is None else \
            _torch_dtype(compute_dtype)
        self._cast_exclude = frozenset(cast_exclude)

        if isinstance(args, dict):
            self.arg_dict = {k: self._as_nd(v) for k, v in args.items()}
            missing = [a for a in plan.arg_names if a not in self.arg_dict]
            if missing:
                raise MXNetError("bind missing arguments: %s" % missing)
        else:
            args = list(args)
            if len(args) != len(plan.arg_names):
                raise MXNetError("bind expects %d args, got %d"
                                 % (len(plan.arg_names), len(args)))
            self.arg_dict = {n: self._as_nd(a)
                             for n, a in zip(plan.arg_names, args)}
        self.arg_arrays = [self.arg_dict[n] for n in plan.arg_names]

        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in plan.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(plan.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in plan.arg_names}
        for name, req in self._grad_req.items():
            if req not in ("write", "add", "null"):
                raise MXNetError("grad_req %r for %s: expected write, add or "
                                 "null" % (req, name))
        for name in plan.no_grad_args():
            self._grad_req[name] = "null"
        if args_grad is None:
            self.grad_dict = {}
        elif isinstance(args_grad, dict):
            self.grad_dict = {k: self._as_nd(v) for k, v in args_grad.items()}
        else:
            self.grad_dict = {n: self._as_nd(g)
                              for n, g in zip(plan.arg_names, args_grad)
                              if g is not None}
        for name in list(self.grad_dict):
            if self._grad_req.get(name, "null") == "null":
                del self.grad_dict[name]
        self.grad_arrays = [self.grad_dict.get(n) for n in plan.arg_names]

        aux_states = aux_states if aux_states is not None else []
        if isinstance(aux_states, dict):
            self.aux_dict = {k: self._as_nd(v) for k, v in aux_states.items()}
        else:
            self.aux_dict = {n: self._as_nd(a)
                             for n, a in zip(plan.aux_names, aux_states)}
        for aname in plan.aux_names:
            if aname not in self.aux_dict:
                raise MXNetError("bind missing auxiliary state %r" % aname)
        self.aux_arrays = [self.aux_dict[n] for n in plan.aux_names]
        self._output_arrays: List = []

    def _as_nd(self, v):
        """Bound arrays live on the executor's context: an NDArray already
        there is shared, anything else is copied there."""
        from . import ndarray as nd

        if isinstance(v, nd.NDArray):
            return v.as_in_context(self._ctx)
        return nd.array(v, self._ctx)

    @property
    def outputs(self) -> List:
        return self._output_arrays

    @property
    def output_dict(self) -> Dict[str, Any]:
        return dict(zip(self._plan.output_names, self._output_arrays))

    # ------------------------------------------------------------------
    def _cast(self, args):
        cdt = self._compute_dtype
        if cdt is None:
            return args
        return {k: v.to(cdt) if k not in self._cast_exclude
                and v.dtype == torch.float32 else v for k, v in args.items()}

    def _write_inputs(self, kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            self.arg_dict[k][:] = v

    def _set_outputs(self, outs):
        from . import ndarray as nd

        self._output_arrays = [nd.NDArray(o.detach(), self._ctx)
                               for o in outs]

    def forward(self, is_train: bool = False, **kwargs):
        self._write_inputs(kwargs)
        args = {k: v._data for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        self._output_arrays = []  # release the previous call's outputs
        with torch.no_grad():
            outs, new_aux = self._plan.run(self._cast(args), aux, is_train)
        if is_train:
            for k, v in new_aux.items():
                self.aux_dict[k]._set(v)
        self._set_outputs(outs)
        return self._output_arrays

    def backward(self, out_grads=None, is_train: bool = True):
        """Gradients of the bound arguments into ``grad_dict``.  Like the
        JAX package, this re-runs the forward (without writing aux states)
        and differentiates it; loss ops ignore ``out_grads``."""
        self._forward_backward(out_grads, is_train, update_aux=False,
                               set_outputs=False)

    def forward_backward(self, out_grads=None, is_train: bool = True,
                         **kwargs):
        """Forward, gradients and aux update in one call — the training
        step Module runs."""
        self._write_inputs(kwargs)
        self._forward_backward(out_grads, is_train, update_aux=True,
                               set_outputs=True)
        return self._output_arrays

    def _grads(self, diff_names, out_grads, is_train):
        """(outputs, new aux, {name: gradient}) of one differentiated
        forward over the arguments ``diff_names``."""
        leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                  for n in diff_names}
        args = {k: leaves.get(k, v._data) for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        with torch.enable_grad():
            outs, new_aux = self._plan.run(self._cast(args), aux, is_train)
        if out_grads is None:
            ogs = [None] * len(outs)
        elif isinstance(out_grads, (list, tuple)):
            ogs = list(out_grads)
        else:
            ogs = [out_grads]
        heads, cts = [], []
        for o, og in zip(outs, ogs):
            if not o.requires_grad:
                continue
            if og is None:
                og = torch.ones_like(o)
            elif not isinstance(og, torch.Tensor):
                og = og._data if hasattr(og, "_data") else torch.as_tensor(og)
            heads.append(o)
            cts.append(og.to(o.device, o.dtype))
        names = list(leaves)
        got = torch.autograd.grad(heads, [leaves[n] for n in names], cts,
                                  allow_unused=True) if heads else \
            [None] * len(names)
        grads = {n: g if g is not None else torch.zeros_like(leaves[n])
                 for n, g in zip(names, got)}
        return [o.detach() for o in outs], new_aux, grads

    def _forward_backward(self, out_grads, is_train, update_aux, set_outputs):
        from . import ndarray as nd

        plan = self._plan
        diff_names = [n for n in plan.arg_names
                      if self._grad_req.get(n, "null") != "null"]
        if not diff_names:
            if set_outputs:
                self.forward(is_train=is_train)
            return
        outs, new_aux, grads = self._grads(diff_names, out_grads, is_train)
        for name in diff_names:
            g = grads[name]
            held = self.grad_dict.get(name)
            if self._grad_req[name] == "add" and held is not None:
                held._set(held._data + g)
            elif held is not None:
                held._set(g)
            else:
                self.grad_dict[name] = nd.NDArray(g, self._ctx)
        self.grad_arrays = [self.grad_dict.get(n) for n in plan.arg_names]
        if update_aux:
            for k, v in new_aux.items():
                self.aux_dict[k]._set(v.detach())
        if set_outputs:
            self._set_outputs(outs)

    # ------------------------------------------------------------------
    def fused_step(self, optimizer, updater, param_names):
        """One train step: forward, autograd backward and the optimizer's
        update of every parameter with a gradient, in one call
        (counterpart of the JAX package's jitted ``fused_step``).  Inputs
        must already be in ``arg_dict``.  The gradients are never exposed,
        and the update writes the float32 parameters and optimizer states
        in place under ``torch.no_grad()``.  ``param_names`` gives the
        updater's index space (position == index), as Module wires it."""
        infos = []
        for idx, name in enumerate(param_names):
            if self._grad_req.get(name, "null") == "null":
                continue
            if self._grad_req[name] == "add":
                raise MXNetError("fused_step: grad_req 'add' for %s; use "
                                 "forward_backward and the updater" % name)
            if idx not in updater.states:
                updater.states[idx] = optimizer.create_state(
                    idx, self.arg_dict[name])
            infos.append((name, idx))
            optimizer._update_count(idx)
        t = optimizer.num_update
        outs, new_aux, grads = self._grads([n for n, _ in infos], None, True)
        with torch.no_grad():
            for name, idx in infos:
                optimizer.update_tensors(
                    idx, self.arg_dict[name]._data, grads.pop(name),
                    _tensors(updater.states[idx]), t)
        for k, v in new_aux.items():
            self.aux_dict[k]._set(v.detach())
        self._set_outputs(outs)
        return self._output_arrays

    # ------------------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" not in arguments" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" not in aux states" % name)
