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
float32 arrays); stochastic ops (``Dropout``) drawing from the device's
generator, with ``backward`` replaying the draws of the forward before it;
and ``fused_step``: forward, backward and the optimizer's update (one
list update over every parameter, the step's own gradients its scratch)
as one call, in place on the float32 parameters.

Model parallelism: ``group2ctx`` maps each ``ctx_group`` attr to a
context; a node of a placed group runs there, its inputs moved by
``Tensor.to`` (a differentiable copy, so gradients travel back), as the
JAX package puts a ``jax.device_put`` in front of it.  ``shared_exec``
lends its graph plan to an executor of the same symbol.

Data parallelism (``_set_data_parallel``, what ``DataParallelExecutorGroup``
binds over several contexts): one executor holds the arrays of the whole
batch on the first context and walks its plan in lockstep over the
shards.  The batch inputs split into equal pieces, one per context; each
shard's parameters are differentiable copies of the one master, so one
backward leaves the whole batch's gradient on the master, as the JAX
package's single mesh executor holds it.  An op the registry marks
batch-local (``Op.is_batch_local``) runs once per shard when shape
inference at the shard's batch shows each of its outputs split along axis
0; every other op gathers its inputs' shards, runs once on the whole batch
on the first context and is split again where a batch-local op reads it,
so an op sees the whole batch wherever it reduces over it (BatchNorm's
statistics, a loss normalized by the batch), as in the JAX package.

The monitor callback (``set_monitor_callback``, what ``Monitor.install``
sets): ``forward`` hands it every node output by output name, as the JAX
package's forward does.

Left out, with their reason: jit, buffer donation and the compile cache
(PyTorch runs eagerly; a CUDA graph is the later tool), SPMD shardings
(``set_shardings``, slice A.4b of the port), the training guardian's
on-device step guard, the autotuner and remat
(``MXNET_BACKWARD_DO_MIRROR``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import random as _random
from .base import MXNetError
from .context import Context
from .ops.param import torch_dtype
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
        self.stochastic = any(n.op is not None and n.op.stochastic
                              for n in self.nodes)
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

    def placement_map(self, group2ctx) -> Dict[int, Context]:
        """Node id → Context from the ``ctx_group`` attrs (reference: the
        nnvm PlaceDevice pass, src/executor/graph_executor.cc:230-320)."""
        if not group2ctx:
            return {}
        placement = {}
        for n in self.nodes:
            if n.is_variable:
                continue
            group = None
            for store in (n.attr_dict, n.attrs):
                group = store.get("ctx_group") or store.get("__ctx_group__")
                if group:
                    break
            if group and group in group2ctx:
                placement[id(n)] = Context(group2ctx[group])
        return placement

    def run(self, args: Dict[str, Any], aux: Dict[str, Any], is_train: bool,
            device, generator=None, placement=None, dp=None, internals=None):
        """Execute the graph on tensors of ``device``.  An intermediate is
        released as soon as its last reader has run, so peak memory follows
        the live activations (and, under autograd, what the backward keeps).
        Stochastic ops draw from ``generator`` in topological order.  A
        node ``placement`` names runs on that context's device, its inputs
        and aux states moved there.  With ``dp`` (a ``_DataParallel``)
        every value is a ``_Value`` and ``dp`` runs each node over the
        shards; the outputs come back whole on the first context.  A list
        ``internals`` gets (node, output index, tensor) for every node
        output, whole."""
        vals: Dict[tuple, Any] = {}
        left = dict(self.readers)
        keep = set(self.output_entries)
        new_aux: Dict[str, Any] = {}
        for n in self.nodes:
            if n.is_variable:
                if n.name not in args:
                    raise MXNetError("missing argument %r" % n.name)
                v = args[n.name]
                vals[(id(n), 0)] = v if dp is None else dp.value(n, 0, v)
                continue
            ins = [vals[(id(p), idx)] for p, idx in n.inputs]
            aux_in = tuple(aux[a] for a in n.aux_names())
            if dp is not None:
                outs, aux_out = dp.apply(n, ins, aux_in, is_train, generator)
            else:
                dev = device
                if placement and id(n) in placement:
                    dev = placement[id(n)].torch_device()
                    ins = [x.to(dev) for x in ins]
                    aux_in = tuple(a.to(dev) for a in aux_in)
                opctx = OpContext(is_train, generator if n.op.stochastic
                                  else None, dev)
                outs, aux_out = n.op.apply(opctx, n.attrs, ins, aux_in)
            del ins
            for i, o in enumerate(outs):
                vals[(id(n), i)] = o
                if internals is not None:
                    internals.append((n, i, o if dp is None
                                      else dp.gathered(o)))
            for aname, a in zip(n.aux_names(), aux_out):
                new_aux[aname] = a
            for p, idx in n.inputs:
                e = (id(p), idx)
                left[e] -= 1
                if left[e] == 0 and e not in keep:
                    del vals[e]
        outs = [vals[e] for e in self.output_entries]
        if dp is not None:
            outs = [dp.gathered(v) for v in outs]
        return outs, new_aux


class Executor:
    def __init__(self, symbol, ctx: Context, args, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 shared_exec=None, compute_dtype=None, cast_exclude=()):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        if shared_exec is not None and shared_exec._symbol is symbol:
            self._plan = plan = shared_exec._plan
        else:
            self._plan = plan = _GraphPlan(symbol)
        self._group2ctx = dict(group2ctx or {})
        self._placement = plan.placement_map(self._group2ctx)
        # data parallelism over several contexts (_set_data_parallel)
        self._dp = None
        # called with {name: gradient} right after each backward, before
        # anything reads or applies them (the multi-process group's
        # all-reduce)
        self._grad_hook = None
        # mixed precision: float32 args are cast to compute_dtype inside the
        # step; parameters, gradients and aux stay float32.  cast_exclude
        # names what keeps full precision (labels).  As in the JAX package,
        # everything else is cast, token ids included: bf16 ids above 256
        # are rounded before Embedding truncates them (ROADMAP.md §C).
        self._compute_dtype = None if compute_dtype is None else \
            torch_dtype(compute_dtype)
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
        # the device generator's state before the last forward: backward
        # re-runs that forward on a generator set to it, so stochastic ops
        # draw the same numbers (the JAX package reuses the forward's key)
        self._last_rng = None
        self._monitor_callback = None

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

    def _run(self, args, aux, is_train, generator, internals=None):
        """The graph over the bound (uncast) argument tensors: on the
        executor's device, placed by ``group2ctx``, or over the data-
        parallel shards."""
        return self._plan.run(self._cast(args), aux, is_train,
                              self._ctx.torch_device(), generator,
                              self._placement, self._dp, internals)

    def _set_data_parallel(self, contexts, batch_names):
        """Run over ``contexts`` from now on, the arguments ``batch_names``
        split along axis 0, one equal piece per context."""
        if self._placement:
            raise MXNetError("group2ctx placement and data parallelism "
                             "over several contexts do not combine")
        self._dp = _DataParallel(self, contexts, batch_names)

    def _home(self, t):
        """A tensor the graph left on another device (a placed node's
        output, a gathered aux state), back on the executor's."""
        return t.to(self._ctx.torch_device())

    def _generator(self, remember: bool):
        """The device generator stochastic ops draw from, or None when the
        graph has none; with ``remember`` its state is kept for
        ``backward``."""
        if not self._plan.stochastic:
            return None
        gen = _random.generator(self._ctx.torch_device())
        if remember:
            self._last_rng = gen.get_state()
        return gen

    def _replay_generator(self):
        """A generator in the state the last forward started from (the
        device generator itself if there was none)."""
        if self._last_rng is None:
            return self._generator(remember=False)
        gen = torch.Generator(device=self._ctx.torch_device())
        gen.set_state(self._last_rng)
        return gen

    def _write_inputs(self, kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %r" % k)
            self.arg_dict[k][:] = v

    def _set_outputs(self, outs):
        from . import ndarray as nd

        self._output_arrays = [
            nd.NDArray(o.detach(), self._placement.get(e[0], self._ctx))
            for o, e in zip(outs, self._plan.output_entries)]

    def set_monitor_callback(self, callback):
        """``callback(name, NDArray)`` for every node output of each
        ``forward``; None removes it."""
        self._monitor_callback = callback

    def forward(self, is_train: bool = False, **kwargs):
        from . import ndarray as nd

        self._write_inputs(kwargs)
        args = {k: v._data for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        self._output_arrays = []  # release the previous call's outputs
        gen = self._generator(remember=True)
        internals = [] if self._monitor_callback is not None else None
        with torch.no_grad():
            outs, new_aux = self._run(args, aux, is_train, gen, internals)
        for n, i, o in internals or ():
            self._monitor_callback(
                n.op.output_names(n.attrs, n.name)[i],
                nd.NDArray(o, self._placement.get(id(n), self._ctx)))
        if is_train:
            for k, v in new_aux.items():
                self.aux_dict[k]._set(self._home(v))
        self._set_outputs(outs)
        return self._output_arrays

    def backward(self, out_grads=None, is_train: bool = True):
        """Gradients of the bound arguments into ``grad_dict``.  Like the
        JAX package, this re-runs the forward (without writing aux states)
        and differentiates it; loss ops ignore ``out_grads``."""
        self._forward_backward(out_grads, is_train, update_aux=False,
                               set_outputs=False,
                               generator=self._replay_generator())

    def forward_backward(self, out_grads=None, is_train: bool = True,
                         **kwargs):
        """Forward, gradients and aux update in one call — the training
        step Module runs."""
        self._write_inputs(kwargs)
        self._forward_backward(out_grads, is_train, update_aux=True,
                               set_outputs=True,
                               generator=self._generator(remember=True))
        return self._output_arrays

    def _grads(self, diff_names, out_grads, is_train, generator):
        """(outputs, new aux, {name: gradient}) of one differentiated
        forward over the arguments ``diff_names``."""
        leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                  for n in diff_names}
        args = {k: leaves.get(k, v._data) for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        with torch.enable_grad():
            outs, new_aux = self._run(args, aux, is_train, generator)
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
        if self._grad_hook is not None:
            self._grad_hook(grads)
        return [o.detach() for o in outs], new_aux, grads

    def _forward_backward(self, out_grads, is_train, update_aux, set_outputs,
                          generator):
        from . import ndarray as nd

        plan = self._plan
        diff_names = [n for n in plan.arg_names
                      if self._grad_req.get(n, "null") != "null"]
        if not diff_names:
            if set_outputs:
                self.forward(is_train=is_train)
            return
        outs, new_aux, grads = self._grads(diff_names, out_grads, is_train,
                                           generator)
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
                self.aux_dict[k]._set(self._home(v.detach()))
        if set_outputs:
            self._set_outputs(outs)

    # ------------------------------------------------------------------
    def fused_step(self, optimizer, updater, param_names):
        """One train step: forward, autograd backward and the optimizer's
        update of every parameter with a gradient, in one call
        (counterpart of the JAX package's jitted ``fused_step``).  Inputs
        must already be in ``arg_dict``.  The gradients are never exposed:
        the optimizer's list update takes them as scratch, and writes the
        float32 parameters and optimizer states in place.
        ``param_names`` gives the updater's index space (position ==
        index), as Module wires it."""
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
        outs, new_aux, grads = self._grads([n for n, _ in infos], None, True,
                                           self._generator(remember=True))
        # one list update over every array; the gradients are this step's
        # own, so the update may use them as scratch
        optimizer.update_tensors_list(
            [idx for _, idx in infos],
            [self.arg_dict[name]._data for name, _ in infos],
            [grads.pop(name) for name, _ in infos],
            [_tensors(updater.states[idx]) for _, idx in infos],
            [t] * len(infos), owned_grads=True)
        for k, v in new_aux.items():
            self.aux_dict[k]._set(self._home(v.detach()))
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


class _DataParallel:
    """An executor's plan run in lockstep over the shards of the batch (see
    the module docstring).  Each graph entry is classified once, at bind,
    by shape inference at the whole batch and at one shard's batch:
    "shard" (axis 0 scales with the batch: split along it), "rep" (the
    same shape at both: one value for every shard) or "whole" (neither:
    only the whole batch's value exists)."""

    def __init__(self, executor, contexts, batch_names):
        from .symbol import _forward_infer

        plan = executor._plan
        self.plan = plan
        self.devices = [c.torch_device() for c in contexts]
        self.n = n = len(self.devices)
        batch_names = frozenset(batch_names)
        shapes = {k: tuple(v.shape) for k, v in executor.arg_dict.items()}
        for name in batch_names:
            if shapes[name][0] % n:
                raise MXNetError("batch size %d is not divisible by the %d "
                                 "contexts" % (shapes[name][0], n))
        whole, _ = _forward_infer(plan.symbol, shapes)
        part, _ = _forward_infer(plan.symbol, {
            k: ((s[0] // n,) + s[1:] if k in batch_names else s)
            for k, s in shapes.items()}, tolerant=True)
        self.kind = {}
        for e, g in whole.items():
            s = part.get(e)
            if s is None:
                self.kind[e] = "whole"
            elif tuple(s) == tuple(g):
                self.kind[e] = "rep"
            elif len(s) == len(g) and len(g) and g[0] == s[0] * n and \
                    tuple(g[1:]) == tuple(s[1:]):
                self.kind[e] = "shard"
            else:
                self.kind[e] = "whole"
        self.local = {}
        for node in plan.nodes:
            if node.is_variable:
                continue
            outs = [(id(node), i) for i in range(node.num_outputs())]
            ins = [(id(p), idx) for p, idx in node.inputs]
            self.local[id(node)] = (
                node.op.is_batch_local(node.attrs) and not node.aux_names()
                and all(self.kind.get(e) == "shard" for e in outs)
                and all(self.kind.get(e) in ("shard", "rep") for e in ins))

    def gathered_ops(self):
        """Names of the ops that run once on the whole batch."""
        return sorted({n.op.name for n in self.plan.nodes
                       if not n.is_variable and not self.local[id(n)]})

    def value(self, node, i, tensor=None, pieces=None):
        """Output ``i`` of ``node`` as a ``_Value``: the whole batch's
        ``tensor`` or the shards' ``pieces``."""
        return _Value(self.kind.get((id(node), i)) == "shard", tensor,
                      pieces)

    def gathered(self, v):
        """The whole batch's tensor on the first context."""
        if v.whole is None:
            v.whole = torch.cat([p.to(self.devices[0]) for p in v.pieces])
        return v.whole

    def piece(self, v, i):
        """Shard ``i``'s tensor on its context: its piece of a split value,
        or the device's one copy of any other (a parameter's cast master is
        cast once, and shards sharing a card share the copy)."""
        if v.split:
            if v.pieces is None:
                v.pieces = [x.to(d) for x, d in
                            zip(self.gathered(v).chunk(self.n), self.devices)]
            return v.pieces[i]
        dev = self.devices[i]
        if dev not in v.copies:
            v.copies[dev] = self.gathered(v).to(dev)
        return v.copies[dev]

    def apply(self, node, ins, aux_in, is_train, generator):
        """One node over the shards: per shard where it is batch-local,
        else once on the whole batch on the first context."""
        if self.local[id(node)]:
            per = [node.op.apply(OpContext(is_train, None, dev), node.attrs,
                                 [self.piece(v, i) for v in ins], ())[0]
                   for i, dev in enumerate(self.devices)]
            return [self.value(node, j, pieces=list(p))
                    for j, p in enumerate(zip(*per))], ()
        opctx = OpContext(is_train, generator if node.op.stochastic
                          else None, self.devices[0])
        outs, aux_out = node.op.apply(opctx, node.attrs,
                                      [self.gathered(v) for v in ins], aux_in)
        return [self.value(node, j, o) for j, o in enumerate(outs)], aux_out


class _Value:
    """An entry's value in a data-parallel run: the whole batch's tensor on
    the first context or one piece per shard, whichever its node made, and
    the other forms, made from it when a reader first asks and kept while
    the entry lives."""

    __slots__ = ("split", "whole", "pieces", "copies")

    def __init__(self, split, whole=None, pieces=None):
        self.split = split      # axis 0 divides over the shards
        self.whole = whole
        self.pieces = pieces
        self.copies = {}        # device -> the unsplit value there
