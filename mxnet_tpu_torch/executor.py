"""Executor — binds a Symbol to a device and runs it.

Counterpart of ``mxnet_tpu/executor.py`` for the serving slice.  Where the
JAX package lowers the graph to one jitted XLA function, here
``_GraphPlan.run`` walks the topologically sorted nodes eagerly in PyTorch,
each op on tensors of the bound device.  Inference only: ``grad_req`` other
than ``"null"`` raises until the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .base import MXNetError
from .context import Context
from .ops import OpContext

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

    def run(self, args: Dict[str, Any], aux: Dict[str, Any], is_train: bool):
        """Execute the graph on tensors.  An intermediate is released as
        soon as its last reader has run, so peak memory follows the live
        activations rather than the whole graph."""
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
                 grad_req="write", aux_states=None):
        reqs = grad_req.values() if isinstance(grad_req, dict) else \
            [grad_req] if isinstance(grad_req, str) else grad_req
        if args_grad is not None or any(r != "null" for r in reqs):
            raise NotImplementedError(
                "Executor: gradients (grad_req other than 'null') come with "
                "the training slice; bind with grad_req='null'")
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._plan = plan = _GraphPlan(symbol)

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

        aux_states = aux_states if aux_states is not None else []
        if isinstance(aux_states, dict):
            self.aux_dict = {k: self._as_nd(v) for k, v in aux_states.items()}
        else:
            self.aux_dict = {n: self._as_nd(a)
                             for n, a in zip(plan.aux_names, aux_states)}
        for aname in plan.aux_names:
            if aname not in self.aux_dict:
                raise MXNetError("bind missing auxiliary state %r" % aname)
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

    def forward(self, is_train: bool = False, **kwargs):
        from . import ndarray as nd

        if is_train:
            raise NotImplementedError(
                "Executor.forward(is_train=True) comes with the training "
                "slice")
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            self.arg_dict[k][:] = v
        args = {k: v._data for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        self._output_arrays = []  # release the previous request's outputs
        with torch.no_grad():
            outs, _ = self._plan.run(args, aux, is_train)
        self._output_arrays = [nd.NDArray(o, self._ctx) for o in outs]
        return self._output_arrays
