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

Tensor parallelism (``set_shardings``, what the executor group calls under
``Module.bind(mesh=, partition_rules=)``): the same walk over a named mesh
(``_Partitioned``), whose leading axis splits the batch.  Every argument
with a spec other than the batch's is stored as its pieces (a
``ShardedTensor``); a node runs by its strategy: column- and row-parallel
``FullyConnected`` on the weight's pieces (the row-parallel partial
products summed differentiably, the bias added once after the sum),
elementwise ops on their inputs' split, every other op once on the
gathered value, as GSPMD runs a custom call with no partitioning rule.
Gathers and splits are ``torch.cat`` and ``narrow``, so autograd leaves
each gradient on its parameter's pieces and the list update runs over
them.  Where the JAX package's SPMD partitioner places the collectives in
one program, the port moves tensors with ``Tensor.to`` between the
coordinates' devices.  Under a process group every process's batch is one
shard of the global batch: the ops that are not batch-local in the step's
mode gather it over the group, and the loss counts once over the group.

The monitor callback (``set_monitor_callback``, what ``Monitor.install``
sets): ``forward`` hands it every node output by output name, as the JAX
package's forward does.

The compile cache (``compile_cache``): with ``MXNET_COMPILE_CACHE_DIR``
set or an AOT bundle attached, ``forward(is_train=False)``,
``forward_backward`` and ``fused_step`` go through
``compile_cache.maybe_cached`` under the kinds ``_cache_kind`` (``"fwd"``
unless a caller such as the generation engine names another),
``"fwdbwd"`` and ``"fused"``: content-keyed entries, and for the kinds
of ``compile_cache.GRAPH_KINDS`` on the card (``"fwd"`` and the engine's
prefill kinds) a CUDA graph captured at the first call and replayed after
it (in ``_graph_pool``, which a replica's buckets share).  With the cache
off nothing is wrapped.

Remat (``MXNET_BACKWARD_DO_MIRROR``, read once per step key when the key's
step is first built, as the JAX package reads it when it first traces the
key): the differentiated run of the whole graph goes through non-reentrant
``torch.utils.checkpoint``, so the forward keeps no residual and the
backward runs it again to remake them, as ``jax.checkpoint`` of the whole
differentiated function does.  The recompute draws from a generator of its
own started from the state the forward started from, so a stochastic op
makes the same draws twice, and its aux states are thrown away: aux is
written once, from the first forward.  ``fused_step`` consults the
``fused_step`` autotune site once per step key: in record mode it scores
remat off and on by the roofline of the step's cost (``hlo_analysis`` on
meta tensors, the recompute counted), and the step runs the winner's remat,
which the step's compile-cache key carries.

The NaiveEngine (``MXNET_ENGINE_TYPE=NaiveEngine``, read when the executor
is built): no compile-cache entry and no CUDA graph, and the device is
synchronized after every node of the plan, so an asynchronous fault
surfaces at the node that caused it, and an error names that node and its
op.

The training guardian's step guard (``guardian.enabled()``, part of the
fused step's key): the step reduces finiteness over every gradient and
floating output, and the float32 global gradient norm (an overflow counts
as non-finite), on the device, and reads that verdict on the host once,
before the list update (``_guard_verdict``: (ok, norm)).  A non-finite
step skips the update and the aux write, so every parameter, optimizer
state and aux state keeps its bits; the optimizer's update counts still
advance, as the JAX package counts before its program runs.  Where the
JAX package selects with a ``where`` inside one program, the port's list
update writes in place, so the verdict is read first (a kept difference,
ROADMAP.md C: one host read per guarded step).

The cost model (``hlo_analysis``): the first build of each fused-step key
records ``_fused_introspect`` = (``_fused``, the step as a function of its
tensors, and their shapes), which ``telemetry.fused_cost_analysis`` counts
on meta tensors, and sets ``_fused_new_compile`` for the step monitor.
``fused_step``, ``forward`` and ``forward_backward`` are profiler spans
(``Executor.fused_step``, ``Executor.forward``,
``Executor.forward_backward``).

Left out, with their reason: jit and buffer donation (PyTorch runs
eagerly, and donation has no torch counterpart).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import profiler as _prof
from . import random as _random
from .base import MXNetError, env, naive_engine
from .context import Context
from .ops.param import torch_dtype
from .ops import OpContext
from .optimizer import _new_state, _tensors

__all__ = ["Executor"]


def _items(x):
    """(key, tensor) of each piece of ``x`` (a tensor is its one piece)."""
    from .parallel.mesh import ShardedTensor

    return list(x.shards.items()) if isinstance(x, ShardedTensor) \
        else [(None, x)]


def _like(x, pieces):
    """An array of ``x``'s layout from ``pieces`` keyed as ``_items``'s."""
    from .parallel.mesh import ShardedTensor

    return ShardedTensor(pieces, x.mesh, x.spec) \
        if isinstance(x, ShardedTensor) else pieces[None]


def _map(x, fn):
    """``fn`` over a tensor, or over each piece of a ShardedTensor."""
    from .parallel.mesh import ShardedTensor

    return x.map(fn) if isinstance(x, ShardedTensor) else fn(x)


def _zip(x, y, fn):
    """``fn`` over the matching pieces of two arrays of one layout."""
    from .parallel.mesh import ShardedTensor

    if isinstance(x, ShardedTensor):
        return ShardedTensor({c: fn(p, y.shards[c])
                              for c, p in x.shards.items()}, x.mesh, x.spec)
    return fn(x, y)


def _guard_check(grads, outs):
    """The guardian's step verdict, read on the host in one transfer: (every
    gradient and floating output finite and the float32 global gradient
    norm finite, that norm).  The norm of the squares overflows for a
    finite but huge gradient (an exponent bit-flip), which counts as
    non-finite, as in the JAX package.  An output is checked by its largest
    |value| (``_foreach_norm`` at inf: one reduction per output, NaN and
    inf propagate, nothing overflows or is allocated at its size).  On
    meta tensors (the cost model's walk) the pass is counted and the
    verdict is not read."""
    dev = grads[0].device if grads else outs[0].device
    gnorm = torch.zeros((), dtype=torch.float32, device=dev)
    if grads:
        norms = torch._foreach_norm([g.float() for g in grads])
        gnorm = torch.stack([n.to(dev) for n in norms]).square().sum().sqrt()
    checks = [gnorm]
    floats = [o for o in outs if o.is_floating_point()]
    if floats:
        checks += [n.to(dev, torch.float32)
                   for n in torch._foreach_norm(floats, float("inf"))]
    verdict = torch.stack([torch.isfinite(torch.stack(checks)).all().float(),
                           gnorm])
    if verdict.is_meta:
        return True, float("nan")
    host = verdict.cpu()
    return bool(host[0]), float(host[1])


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
        self._fingerprint = None

    def fingerprint(self) -> str:
        """Content hash of the graph (serialized symbol), the JAX
        package's: the process-independent half of a persistent
        compile-cache key."""
        if self._fingerprint is None:
            import hashlib

            self._fingerprint = hashlib.sha256(
                self.symbol.tojson().encode()).hexdigest()[:16]
        return self._fingerprint

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
            device, generator=None, placement=None, dp=None, internals=None,
            sync=False):
        """Execute the graph on tensors of ``device``.  An intermediate is
        released as soon as its last reader has run, so peak memory follows
        the live activations (and, under autograd, what the backward keeps).
        Stochastic ops draw from ``generator`` in topological order.  A
        node ``placement`` names runs on that context's device, its inputs
        and aux states moved there.  With ``dp`` (a ``_Partitioned``)
        every value is a ``_Value`` and ``dp`` runs each node over the
        shards; the outputs come back whole on the first context.  A list
        ``internals`` gets (node, output index, tensor) for every node
        output, whole.  With ``sync`` (the NaiveEngine) the device is
        synchronized after every node."""
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
            try:
                if dp is not None:
                    dev = dp.home
                    outs, aux_out = dp.apply(n, ins, aux_in, is_train,
                                             generator)
                else:
                    dev = device
                    if placement and id(n) in placement:
                        dev = placement[id(n)].torch_device()
                        ins = [x.to(dev) for x in ins]
                        aux_in = tuple(a.to(dev) for a in aux_in)
                    opctx = OpContext(is_train, generator if n.op.stochastic
                                      else None, dev)
                    outs, aux_out = n.op.apply(opctx, n.attrs, ins, aux_in)
                if sync and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception as exc:
                if not sync:
                    raise
                # the NaiveEngine: an error, the op's own or the device
                # queue's, names the node where it arose
                raise MXNetError("node %s (op %s): %s: %s" % (
                    n.name, n.op.name, type(exc).__name__, exc)) from exc
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
        # the partitioned walk over a mesh (_set_data_parallel,
        # set_shardings) and, under set_shardings, the mesh and the specs
        # of the arrays stored as pieces
        self._dp = None
        self._shard_mesh = None
        self._shard_specs = {}
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
        # compile-cache wrappers by call key (only while the cache is on);
        # the entry label of this executor's inference forwards ("fwd";
        # the generation engine names its executors "gen-step", ...); the
        # graph memory pool a replica's buckets share; and the arguments
        # that are inputs, whose bytes count as the graphs' static buffers
        self._jit_cache: Dict[Any, Any] = {}
        self._cache_kind = "fwd"
        self._graph_pool = None
        self._cache_inputs = frozenset()
        # the step keys whose fused_step site has been consulted
        self._fused_sites = set()
        # remat of each step key, fixed when the key's step is first built
        self._remat: Dict[Any, bool] = {}
        # the NaiveEngine: no compile cache, a device sync after each node
        self._naive = naive_engine()

    def _cached(self, kind, key, fn):
        """``fn`` wrapped by the compile cache under ``kind`` (kept per
        ``key``), or ``fn`` itself while the cache is off or under the
        NaiveEngine."""
        if self._naive:
            return fn
        hit = self._jit_cache.get(key)
        if hit is None:
            from . import compile_cache as _cc

            hit = _cc.maybe_cached(fn, kind, key, self)
            if hit is fn:
                return fn
            self._jit_cache[key] = hit
        return hit

    def release_cache(self):
        """Drop this executor's compile-cache wrappers and their CUDA
        graphs (a paged-out replica hands their memory back)."""
        self._jit_cache.clear()
        self._graph_pool = None

    def _bound(self):
        return ({k: v._data for k, v in self.arg_dict.items()},
                {k: v._data for k, v in self.aux_dict.items()})

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
        return {k: _map(v, lambda t: t.to(cdt))
                if k not in self._cast_exclude and v.dtype == torch.float32
                else v for k, v in args.items()}

    def _run(self, args, aux, is_train, generator, internals=None,
             device=None):
        """The graph over the bound (uncast) argument tensors: on the
        executor's device (or ``device``: the cost model's meta walk),
        placed by ``group2ctx``, or over the data-parallel shards."""
        return self._plan.run(self._cast(args), aux, is_train,
                              device or self._ctx.torch_device(), generator,
                              self._placement, self._dp, internals,
                              sync=self._naive and device is None)

    def _remat_of(self, key):
        """Remat of step key ``key``: ``MXNET_BACKWARD_DO_MIRROR`` as it is
        when the key's step is first built."""
        if key not in self._remat:
            self._remat[key] = bool(env("MXNET_BACKWARD_DO_MIRROR", 0, int))
        return self._remat[key]

    def _remat_run(self, args, aux, is_train, generator, device):
        """``_run`` of the differentiated arguments under non-reentrant
        ``torch.utils.checkpoint``: the forward saves no residual and the
        backward runs it again (whole-graph remat, ``jax.checkpoint(f)``).
        The recompute draws from a fresh generator set to the state the
        forward started from (``preserve_rng_state`` would restore only
        the default generators), and its outputs and aux states are
        dropped: only the first run's are returned."""
        from torch.utils.checkpoint import checkpoint

        state = None if generator is None else generator.get_state()
        runs = []

        def f(args):
            gen = generator
            if runs and state is not None:
                gen = torch.Generator(device=generator.device)
                gen.set_state(state)
            runs.append(1)
            return self._run(args, aux, is_train, gen, device=device)

        return checkpoint(f, args, use_reentrant=False,
                          preserve_rng_state=False)

    def _set_data_parallel(self, contexts, batch_names, group=False):
        """Run over ``contexts`` from now on, the arguments ``batch_names``
        split along axis 0, one equal piece per context; with ``group``,
        every process's batch is one shard of the process group's."""
        from .sharding import build_mesh

        if self._placement:
            raise MXNetError("group2ctx placement and data parallelism "
                             "over several contexts do not combine")
        mesh = build_mesh((("data", len(contexts)),), list(contexts))
        self._dp = _Partitioned(self, mesh, batch_names, group=group)

    def set_shardings(self, mesh, arg_specs=None, aux_specs=None,
                      group=False):
        """Tensor/data-parallel placement over a named mesh
        (``sharding.build_mesh``; its leading axis is the batch axis).

        ``arg_specs``/``aux_specs`` map argument/aux names to
        ``PartitionSpec``s (unnamed arrays are replicated).  An argument
        whose spec splits axis 0 over the leading axis and nothing else is
        a batch input: it stays whole on the first context and the walk
        splits it.  Every other bound argument, gradient buffer and aux
        state is stored as its pieces (a ``ShardedTensor``), and from now
        on each step runs over the mesh by the partitioned walk
        (``_Partitioned``).  With ``group`` every process's batch is one
        shard of the process group's.  Unknown names raise."""
        from .parallel.mesh import PartitionSpec
        from .sharding import place

        if self._placement:
            raise MXNetError("group2ctx placement and set_shardings do not "
                             "combine")
        specs = dict(arg_specs or {})
        if aux_specs:
            specs.update(aux_specs)
        known = set(self.arg_dict) | set(self.aux_dict) | set(self.grad_dict)
        unknown = sorted(set(specs) - known)
        if unknown:
            raise MXNetError(
                "set_shardings: specs name no bound argument/aux: %s"
                % unknown)
        lead = mesh.axis_names[0]
        specs = {k: v if isinstance(v, PartitionSpec) else PartitionSpec(*v)
                 for k, v in specs.items()}
        batch = [k for k in self.arg_dict if k in specs and
                 tuple(specs[k])[:1] == (lead,) and
                 all(a is None for a in tuple(specs[k])[1:])]
        self._shard_mesh = mesh
        self._shard_specs = {k: v for k, v in specs.items()
                             if k not in batch}
        for arrs in (self.arg_dict, self.aux_dict, self.grad_dict):
            for name, arr in arrs.items():
                if name not in batch:
                    arr._set(place(arr._data, mesh, self._shard_specs.get(
                        name, PartitionSpec())))
        self._dp = _Partitioned(self, mesh, batch, self._shard_specs, group)

    def _write_arg(self, name, value, aux=False):
        """The write path for bound arrays (the JAX package's name for
        it): ``NDArray.__setitem__`` writes in place, into the pieces of a
        sharded array."""
        target = (self.aux_dict if aux else self.arg_dict)[name]
        target[:] = value

    def _home(self, t):
        """A tensor the graph left on another device (a placed node's
        output, a gathered aux state), back on the executor's."""
        return t.to(self._ctx.torch_device())

    def _store_aux(self, new_aux):
        """The step's new aux states into ``aux_dict``: on the executor's
        context, or split under their specs on the mesh."""
        for k, v in new_aux.items():
            v = v.detach()
            if self._shard_mesh is None:
                self.aux_dict[k]._set(self._home(v))
                continue
            from .parallel.mesh import PartitionSpec
            from .sharding import place

            self.aux_dict[k]._set(place(v, self._shard_mesh,
                                        self._shard_specs.get(
                                            k, PartitionSpec())))

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
            self._write_arg(k, v)

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
        with _prof.Frame("Executor.forward", "exec"):
            return self._forward(is_train, kwargs)

    def _forward(self, is_train, kwargs):
        from . import ndarray as nd

        self._write_inputs(kwargs)
        args = {k: v._data for k, v in self.arg_dict.items()}
        aux = {k: v._data for k, v in self.aux_dict.items()}
        self._output_arrays = []  # release the previous call's outputs
        gen = self._generator(remember=True)
        internals = [] if self._monitor_callback is not None else None
        if is_train or internals is not None:
            with torch.no_grad():
                outs, new_aux = self._run(args, aux, is_train, gen,
                                          internals)
        else:
            kind = self._cache_kind
            outs, new_aux = self._cached(kind, (kind, False), self._infer)(
                args, aux, generator=gen)
        for n, i, o in internals or ():
            self._monitor_callback(
                n.op.output_names(n.attrs, n.name)[i],
                nd.NDArray(o, self._placement.get(id(n), self._ctx)))
        if is_train:
            self._store_aux(new_aux)
        self._set_outputs(outs)
        return self._output_arrays

    def _infer(self, args, aux, generator=None):
        """The inference walk over the bound tensors ``args``/``aux`` (what
        a CUDA graph of this executor captures)."""
        with torch.no_grad():
            return self._run(args, aux, False, generator)

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
        with _prof.Frame("Executor.forward_backward", "exec"):
            self._write_inputs(kwargs)
            self._forward_backward(out_grads, is_train, update_aux=True,
                                   set_outputs=True,
                                   generator=self._generator(remember=True))
        return self._output_arrays

    def _grads(self, args, aux, diff_names, out_grads, is_train, generator,
               device=None, remat=False):
        """(outputs, new aux, {name: gradient}) of one differentiated
        forward of the tensors ``args``/``aux`` (the bound ones, or the
        cost model's meta tensors) over the arguments ``diff_names``; with
        ``remat`` the forward is run again inside the backward."""
        leaves = {n: _map(args[n], lambda t: t.detach().requires_grad_(True))
                  for n in diff_names}
        args = {k: leaves.get(k, v) for k, v in args.items()}
        with torch.enable_grad():
            if remat:
                outs, new_aux = self._remat_run(args, aux, is_train,
                                                generator, device)
            else:
                outs, new_aux = self._run(args, aux, is_train, generator,
                                          device=device)
        if out_grads is None:
            ogs = [None] * len(outs)
        elif isinstance(out_grads, (list, tuple)):
            ogs = list(out_grads)
        else:
            ogs = [out_grads]
        heads, cts = [], []
        for e, o, og in zip(self._plan.output_entries, outs, ogs):
            if not o.requires_grad:
                continue
            if og is None:
                og = torch.ones_like(o)
            elif not isinstance(og, torch.Tensor):
                og = og._data if hasattr(og, "_data") else torch.as_tensor(og)
            og = og.to(o.device, o.dtype)
            share = 1.0 if self._dp is None else self._dp.head_share(e)
            heads.append(o)
            cts.append(og if share == 1.0 else og * share)
        flat = [(n, c, t) for n in leaves for c, t in _items(leaves[n])]
        got = torch.autograd.grad(heads, [t for _, _, t in flat], cts,
                                  allow_unused=True) if heads else \
            [None] * len(flat)
        pieces: Dict[str, dict] = {n: {} for n in leaves}
        for (n, c, t), g in zip(flat, got):
            pieces[n][c] = g if g is not None else torch.zeros_like(t)
        grads = {n: _like(leaves[n], pieces[n]) for n in leaves}
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
        key = ("fwdbwd", is_train, tuple(diff_names))
        outs, new_aux, grads = self._cached("fwdbwd", key, self._grads)(
            *self._bound(), diff_names=diff_names, out_grads=out_grads,
            is_train=is_train, generator=generator,
            remat=self._remat_of(key))
        for name in diff_names:
            g = grads[name]
            held = self.grad_dict.get(name)
            if self._grad_req[name] == "add" and held is not None:
                held._set(_zip(held._data, g, torch.add))
            elif held is not None:
                held._set(g)
            else:
                self.grad_dict[name] = nd.NDArray(g, self._ctx)
        self.grad_arrays = [self.grad_dict.get(n) for n in plan.arg_names]
        if update_aux:
            self._store_aux(new_aux)
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
        from . import guardian as _guardian

        guard = _guardian.enabled()
        key = ("fused", type(optimizer).__name__, tuple(param_names),
               ("guard", int(guard)))
        first_build = key not in self._fused_sites
        infos = []
        for idx, name in enumerate(param_names):
            if self._grad_req.get(name, "null") == "null":
                continue
            if self._grad_req[name] == "add":
                raise MXNetError("fused_step: grad_req 'add' for %s; use "
                                 "forward_backward and the updater" % name)
            if idx not in updater.states:
                updater.states[idx] = _new_state(optimizer, idx,
                                                 self.arg_dict[name])
            infos.append((name, idx))
            optimizer._update_count(idx)
        states = [_tensors(updater.states[idx]) for _, idx in infos]
        step = dict(optimizer=optimizer, infos=infos,
                    t=optimizer.num_update, guard=guard)
        if first_build:  # the site, once per step's key
            self._fused_sites.add(key)
            remat = self._remat_of(key)
            tuned = self._autotune_fused(key, states, step, remat)
            if tuned is not None:
                self._remat[key] = bool(tuned.get("remat", remat))
        step["remat"] = self._remat[key]
        with _prof.Frame("Executor.fused_step", "exec"):
            outs, new_aux, verdict = self._cached("fused", key, self._fused)(
                *self._bound(), states=states,
                generator=self._generator(remember=True), **step)
            self._guard_verdict = verdict
            if verdict is None or verdict[0]:
                self._store_aux(new_aux)
            # a poisoned step writes nothing but its outputs
            self._set_outputs(outs)
        if first_build:
            # what the cost model counts, once per key; the step monitor
            # consumes the flag
            self._fused_introspect = self._fused_abstract(states, step)
            self._fused_new_compile = True
        return self._output_arrays

    def _fused_abstract(self, states, step):
        """(fn, abstract) of the fused step for
        ``hlo_analysis.lower_and_analyze``: ``_fused`` itself over meta
        tensors of the bound arguments, aux and optimizer states.  (None,
        None) where the walk is placed or partitioned over several
        contexts, or a hook reads the gradients."""
        if self._placement or self._dp is not None or \
                self._grad_hook is not None:
            return None, None
        from functools import partial

        from .hlo_analysis import TensorSpec

        def specs(x):
            if isinstance(x, dict):
                return {k: specs(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(specs(v) for v in x)
            return x if x is None else TensorSpec(x.shape, x.dtype)

        args, aux = self._bound()
        return (partial(self._fused, device=torch.device("meta"), **step),
                (specs(args), specs(aux), specs(states)))

    def _autotune_fused(self, stable_key, states, step, env_remat):
        """The ``fused_step`` site's config for this step, or None (autotune
        off, or nothing recorded).  A record-mode miss scores each
        candidate of ``spaces.fused_step(donate_allowed=False)`` (remat off
        and on; donation has no torch counterpart) by the roofline of the
        step it would run, counted by the cost model on meta tensors
        (``build_fn``: ``_fused_abstract`` with the candidate's remat), as
        the JAX package scores the lowered programs by XLA's cost
        analysis.  Any failure leaves the step at ``env_remat``."""
        try:
            from . import autotune

            if not autotune.enabled():
                return None
            args, aux = self._bound()
            from .compile_cache import _signature

            key = {"graph": self._plan.fingerprint(),
                   "static": repr(stable_key),
                   "compute_dtype": str(self._compute_dtype),
                   "sig": repr(_signature(self, (args, aux))),
                   "remat_env": int(env_remat),
                   "donate_allowed": False}

            def build(cand):
                return self._fused_abstract(
                    states, dict(step, remat=bool(cand["remat"])))

            return autotune.get_or_tune(
                "fused_step", key,
                candidates=autotune.spaces.fused_step(donate_allowed=False),
                build_fn=build, default=None)
        except Exception:
            return None

    def _fused(self, args, aux, states, optimizer, infos, t, guard=False,
               generator=None, device=None, remat=False):
        """The fused step as a function of its tensors: the forward and
        backward of ``args``/``aux`` (the forward run again in the backward
        under ``remat``) and one list update of the parameters ``infos``
        names ((name, updater index)) and their ``states``, in place.
        Returns (outputs, new aux, the guard's verdict or None); under the
        guard a non-finite step updates nothing."""
        outs, new_aux, grads = self._grads(
            args, aux, [n for n, _ in infos], None, True, generator, device,
            remat)
        verdict = None
        if guard:
            verdict = _guard_check(
                [g for name, _ in infos for _, g in _items(grads[name])],
                outs)
            if not verdict[0]:
                return outs, new_aux, verdict
        # one list update over every array; the gradients are this step's
        # own, so the update may use them as scratch
        optimizer.update_tensors_list(
            [idx for _, idx in infos], [args[name] for name, _ in infos],
            [grads.pop(name) for name, _ in infos], states,
            [t] * len(infos), owned_grads=True)
        return outs, new_aux, verdict

    # ------------------------------------------------------------------
    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound to the input shapes ``kwargs``, sharing
        this one's plan and every array whose shape stays (the reference's
        shared memory pool, graph_executor.cc:483-529); the others are
        new zero-filled arrays."""
        from . import ndarray as nd

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes for reshape")

        def keep(cur, shape):
            return cur if tuple(cur.shape) == tuple(shape) else \
                nd.zeros(shape, self._ctx, dtype=cur.dtype)

        args = {n: keep(self.arg_dict[n], s)
                for n, s in zip(self._plan.arg_names, arg_shapes)}
        aux = {n: keep(self.aux_dict[n], s)
               for n, s in zip(self._plan.aux_names, aux_shapes)}
        grads = {n: nd.zeros(args[n].shape, self._ctx, dtype=args[n].dtype)
                 for n in self.grad_dict}
        return Executor(self._symbol, self._ctx, args, grads or None,
                        self._grad_req, aux, group2ctx=self._group2ctx,
                        shared_exec=self)

    # ------------------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self._write_arg(name, arr)
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" not in arguments" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self._write_arg(name, arr, aux=True)
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" not in aux states" % name)




def _spec_layout(spec, lead, mesh):
    """(split, m) of an array stored under ``spec``: whether axis 0 splits
    over the leading (batch) axis, and the one other (dim, axis) split, if
    any; None when the walk cannot read the pieces as they lie (more
    splits, a dim split over several axes of size above 1, the batch axis
    elsewhere), and then it gathers them."""
    from .parallel.mesh import entry_axes

    named = []
    for d, entry in enumerate(spec):
        axes = [ax for ax in entry_axes(entry) if mesh.shape[ax] > 1]
        if len(axes) > 1:
            return None
        named += [(d, ax) for ax in axes]
    split = bool(named) and named[0] == (0, lead)
    rest = named[1:] if split else named
    if len(rest) > 1 or any(ax == lead for _, ax in rest):
        return None
    return split, (rest[0] if rest else None)


class _Partitioned:
    """An executor's plan run over the coordinates of a named mesh (see
    the module docstring): one executor, its arrays on the first context
    or, under ``set_shardings``, as pieces on the mesh.

    Each graph entry is classified once, at bind, by shape inference at the
    whole batch and at one coordinate's batch: "shard" (axis 0 scales with
    the batch: split along it over the leading axis), "rep" (the same shape
    at both: one value for every shard) or "whole" (neither).  Beside that,
    an entry may be split along one other dim over another mesh axis (its
    ``m``, a (dim, axis) pair), propagated from the parameters' specs by
    each node's strategy, from the op's ``partition`` mark in the registry:

    * ``col`` — ``FullyConnected`` whose weight's rows are split: each
      piece computes its own slice of the output columns (``m`` = (1, ax));
    * ``row`` — ``FullyConnected`` whose weight's columns are split: the
      input's last dim is split the same way, each piece makes a partial
      product, the partials are summed (differentiably) and a replicated
      bias is added once, after the sum;
    * ``elem`` — an elementwise op whose inputs and outputs have one shape
      keeps its inputs' split;
    * ``same`` — a reshape to its input's own shape (as between Megatron's
      fc1 and fc2) passes its input's pieces through;
    * ``one`` — every other op gathers its inputs' ``m`` splits and runs on
      the whole value (the flash kernels too: GSPMD has no partitioning
      rule for them either, so they run once per layer on the whole heads).

    Along the batch, a node runs per shard of the leading axis when the
    registry marks it batch-local and its outputs split (the data
    parallelism of several contexts), else once on the whole batch.  Under a
    process group (``group``) every process's batch is one shard of a
    global batch: a node that is not batch-local in this mode (training or
    not) gathers its batch-split inputs over the group (``_GatherRows``),
    runs on the global batch and keeps its own rows of each batch-split
    output; a batch-local one runs on the process's own rows with no
    collective.  The loss is counted once over the group: each process's
    backward starts from its own rows' head gradients and 1/world of a
    head every process holds whole, and a loss layer run on the global
    batch (which ignores its head gradient and so gives every process the
    whole batch's gradient) passes on only its own rows of the gathered
    inputs' gradient and 1/world of the others'."""

    def __init__(self, executor, mesh, batch_names, specs=None, group=False):
        from . import kvstore_dist
        from .symbol import _forward_infer

        plan = executor._plan
        self.plan = plan
        self.mesh = mesh
        self.axes = mesh.axis_names
        self.lead = self.axes[0]
        self.nb = n = int(mesh.shape[self.lead])
        self.coords = mesh.coords()
        self.home = mesh.torch_device(self.coords[0])
        self.world = kvstore_dist._world() if group else 1
        self.rank = kvstore_dist._rank() if group else 0
        specs = specs or {}
        batch_names = frozenset(batch_names)
        shapes = {k: tuple(v.shape) for k, v in executor.arg_dict.items()}
        for name in batch_names:
            if shapes[name][0] % n:
                raise MXNetError("batch size %d is not divisible by the "
                                 "%d-way %r split" % (shapes[name][0], n,
                                                      self.lead))
        local, _ = _forward_infer(plan.symbol, shapes)
        whole = local if self.world == 1 else _forward_infer(
            plan.symbol, {k: ((s[0] * self.world,) + s[1:]
                              if k in batch_names else s)
                          for k, s in shapes.items()})[0]
        part, _ = _forward_infer(plan.symbol, {
            k: ((s[0] // n,) + s[1:] if k in batch_names else s)
            for k, s in shapes.items()}, tolerant=True)
        scale = n * self.world
        self.shape = local
        self.kind = {}
        for e, g in whole.items():
            s = part.get(e)
            if s is None:
                self.kind[e] = "whole"
            elif tuple(s) == tuple(g):
                self.kind[e] = "rep"
            elif len(s) == len(g) and len(g) and g[0] == s[0] * scale and \
                    tuple(g[1:]) == tuple(s[1:]):
                self.kind[e] = "shard"
            else:
                self.kind[e] = "whole"
        self.local = {}
        # under a group, per mode: whether a node runs on the process's rows
        self.own = {True: {}, False: {}}
        self.m = {}
        self.strategy = {}
        for node in plan.nodes:
            if node.is_variable:
                spec = specs.get(node.name)
                lay = None if spec is None else \
                    _spec_layout(spec, self.lead, mesh)
                self.m[(id(node), 0)] = lay[1] if lay else None
                continue
            outs = [(id(node), i) for i in range(node.num_outputs())]
            ins = [(id(p), idx) for p, idx in node.inputs]
            rows = all(self.kind.get(e) == "shard" for e in outs) and \
                all(self.kind.get(e) in ("shard", "rep") for e in ins)
            for mode in (True, False):
                self.own[mode][id(node)] = rows and \
                    node.op.is_batch_local(node.attrs, mode)
            self.local[id(node)] = self.own[True][id(node)] and \
                not node.aux_names()
            strat, want, out_m = self._strategy(node, ins, outs)
            self.strategy[id(node)] = (strat, want)
            for e in outs:
                self.m[e] = out_m

    def _strategy(self, node, ins, outs):
        """(strategy, the ``m`` each input is read with, the outputs'
        ``m``) of one node."""
        ms = [self.m.get(e) for e in ins]
        op = node.op
        if not node.aux_names() and not op.stochastic:
            if op.partition == "dense" and \
                    len(self.shape.get(ins[0], ())) == 2:
                wm = ms[1]
                if wm is not None and wm[0] == 0:
                    return "col", [None, wm, wm][:len(ins)], (1, wm[1])
                if wm is not None and wm[0] == 1:
                    return "row", [wm, wm, None][:len(ins)], None
            split = {m for m in ms if m is not None}
            shape = self.shape.get(outs[0])
            if len(split) == 1 and \
                    all(self.shape.get(e) == shape for e in ins + outs):
                m = split.pop()
                if op.partition == "elementwise":
                    return "elem", [m] * len(ins), m
                if op.partition == "reshape":
                    return "same", [m], m
        return "one", [None] * len(ins), None

    def gathered_ops(self):
        """Names of the ops that run once on the whole batch."""
        return sorted({n.op.name for n in self.plan.nodes
                       if not n.is_variable and not self.local[id(n)]})

    # -- values -----------------------------------------------------------
    def value(self, node, i, tensor):
        """A variable's value: ``tensor`` (whole, on the first context) or
        a ShardedTensor's pieces, read as they lie where the walk can."""
        from .parallel.mesh import ShardedTensor

        if not isinstance(tensor, ShardedTensor):
            return _Value(whole=tensor)
        lay = _spec_layout(tensor.spec, self.lead, self.mesh)
        m = self.m.get((id(node), i))
        if lay is None or lay[1] != m or \
                (lay[0] and self.kind.get((id(node), i)) != "shard"):
            return _Value(whole=tensor.full())
        return _Value(pieces=dict(tensor.shards), split=lay[0], m=m)

    def _canon(self, coord, split, m):
        """The coordinate holding ``coord``'s piece of a value laid out so."""
        used = {self.lead} if split else set()
        if m is not None:
            used.add(m[1])
        return tuple(c if a in used else 0 for a, c in zip(self.axes, coord))

    def _at(self, coord, axis, k):
        coord = list(coord)
        coord[self.axes.index(axis)] = k
        return tuple(coord)

    def gathered(self, v):
        """The whole (process-local) tensor on the first context."""
        if v.whole is None:
            import torch

            rows = []
            for b in range(self.nb if v.split else 1):
                c = self._at(self.coords[0], self.lead, b)
                if v.m is None:
                    rows.append(v.pieces[c].to(self.home))
                    continue
                d, ax = v.m
                rows.append(torch.cat(
                    [v.pieces[self._at(c, ax, k)].to(self.home)
                     for k in range(self.mesh.shape[ax])], dim=d))
            v.whole = rows[0] if len(rows) == 1 else torch.cat(rows)
        return v.whole

    def view(self, v, coord, split, m):
        """``coord``'s tensor of value ``v`` laid out with batch ``split``
        and model split ``m``, on that coordinate's device; kept while the
        value lives, so coordinates sharing a card share it."""
        dev = self.mesh.torch_device(coord)
        key = (split, m, self._canon(coord, split, m), dev)
        got = v.views.get(key)
        if got is not None:
            return got
        if v.pieces is not None and v.split == split and v.m == m:
            t = v.pieces[self._canon(coord, split, m)]
        elif v.pieces is not None and v.split == split and \
                v.m is not None and m is None:
            import torch

            d, ax = v.m
            t = torch.cat([self.view(v, self._at(coord, ax, k), split, v.m)
                           .to(dev) for k in range(self.mesh.shape[ax])],
                          dim=d)
        elif m is not None and v.m is None:
            base = self.view(v, coord, split, None)
            d, ax = m
            size = base.shape[d] // self.mesh.shape[ax]
            t = base.narrow(d, coord[self.axes.index(ax)] * size, size)
        else:
            t = self.gathered(v)
            if split:
                t = t.chunk(self.nb)[coord[0]]
            if m is not None:
                d, ax = m
                size = t.shape[d] // self.mesh.shape[ax]
                t = t.narrow(d, coord[self.axes.index(ax)] * size, size)
        t = t.to(dev)
        v.views[key] = t
        return t

    # -- nodes ------------------------------------------------------------
    def _run_coords(self, split, axis):
        """The coordinates a node runs at: one per piece along the batch
        (``split``) and along ``axis``."""
        used = ({self.lead} if split else set()) | \
            ({axis} if axis is not None else set())
        return [c for c in self.coords
                if all(k == 0 or a in used for a, k in zip(self.axes, c))]

    def apply(self, node, ins, aux_in, is_train, generator):
        """One node over the mesh by its strategy."""
        strat, want = self.strategy[id(node)]
        split = self.local[id(node)]
        ein = [(id(p), idx) for p, idx in node.inputs]
        nout = node.num_outputs()
        if strat == "one" and not split:
            return self._apply_once(node, ins, ein, aux_in, is_train,
                                    generator)
        splits = [split and self.kind.get(e) == "shard" for e in ein]
        if strat == "same":
            v = ins[0]
            return [_Value(v.whole, v.pieces, v.split, v.m)], ()
        if strat == "row":
            return self._apply_row(node, ins, want, splits, split, is_train)
        out_m = None if strat == "one" else \
            ((1, want[1][1]) if strat == "col" else want[0])
        pieces = [{} for _ in range(nout)]
        for c in self._run_coords(split, out_m[1] if out_m else None):
            outs, _ = node.op.apply(
                OpContext(is_train, None, self.mesh.torch_device(c)),
                node.attrs, [self.view(v, c, s, m)
                             for v, s, m in zip(ins, splits, want)], ())
            for j, o in enumerate(outs):
                pieces[j][c] = o
        return [_Value(pieces=p, split=split, m=out_m) for p in pieces], ()

    def _apply_row(self, node, ins, want, splits, split, is_train):
        """Row-parallel FullyConnected: partial products over the pieces
        of the contraction, summed, then the bias."""
        ax = want[1][1]
        attrs = dict(node.attrs, no_bias=True)
        pieces = {}
        for c in self._run_coords(split, None):
            dev = self.mesh.torch_device(c)
            total = None
            for k in range(self.mesh.shape[ax]):
                ck = self._at(c, ax, k)
                (p,), _ = node.op.apply(
                    OpContext(is_train, None, self.mesh.torch_device(ck)),
                    attrs,
                    [self.view(ins[0], ck, splits[0], want[0]),
                     self.view(ins[1], ck, False, want[1])], ())
                total = p.to(dev) if total is None else total + p.to(dev)
            if len(ins) > 2:
                total = total + self.view(ins[2], c, False, None)
            pieces[c] = total
        return [_Value(pieces=pieces, split=split)], ()

    def head_share(self, e):
        """The share of output ``e``'s head gradient this process counts:
        all of it for its own rows, 1/world where every process of the
        group holds the output whole."""
        if self.world == 1 or self.kind.get(e) == "shard":
            return 1.0
        return 1.0 / self.world

    def _apply_once(self, node, ins, ein, aux_in, is_train, generator):
        """The node once on the whole batch on the first context (the
        global batch under a process group, unless the node is batch-local
        in this mode)."""
        from .parallel.mesh import ShardedTensor

        xs = [self.gathered(v) for v in ins]
        group = self.world > 1 and not self.own[bool(is_train)][id(node)]
        if group:
            loss = node.op.loss
            xs = [_GatherRows.apply(x, self.world, self.rank, loss)
                  if self.kind.get(e) == "shard" else
                  _Share.apply(x, self.world)
                  if loss and x.requires_grad else x
                  for x, e in zip(xs, ein)]
        aux_in = tuple(a.full() if isinstance(a, ShardedTensor)
                       else a.to(self.home) for a in aux_in)
        opctx = OpContext(is_train, generator if node.op.stochastic
                          else None, self.home)
        outs, aux_out = node.op.apply(opctx, node.attrs, xs, aux_in)
        vals = []
        for j, o in enumerate(outs):
            shard = self.kind.get((id(node), j)) == "shard"
            if shard and group:
                rows = o.shape[0] // self.world
                o = o.narrow(0, self.rank * rows, rows)
            vals.append(_Value(whole=o))
        return vals, aux_out


class _Value:
    """An entry's value in a partitioned run: the whole (process-local)
    tensor on the first context, or its pieces keyed by the coordinate
    holding each (``split``: they split along the batch; ``m``: the dim
    and axis of their other split), and the other layouts, made from it
    when a reader first asks and kept while the entry lives."""

    __slots__ = ("whole", "pieces", "split", "m", "views")

    def __init__(self, whole=None, pieces=None, split=False, m=None):
        self.whole = whole
        self.pieces = pieces
        self.split = split
        self.m = m
        self.views = {}


class _GatherRows(torch.autograd.Function):
    """Every process's rows along axis 0, in rank order.  The backward
    keeps this process's rows of the gradient summed over the group; for a
    loss layer's input (``own``), whose gradient every process holds whole,
    of its own gradient."""

    @staticmethod
    def forward(ctx, x, world, rank, own):
        from .kvstore_dist import all_gather_rows

        ctx.rank, ctx.rows, ctx.own = rank, x.shape[0], own
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        from .kvstore_dist import allreduce_sum_

        if not ctx.own:
            g = g.contiguous().clone()
            allreduce_sum_([g])
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None, None, None


class _Share(torch.autograd.Function):
    """The identity; the backward takes 1/world of the gradient, for a
    value every process holds whole whose gradient is summed over the
    group."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None
