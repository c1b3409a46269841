"""DataParallelExecutorGroup — the data-parallel engine of the frontend;
counterpart of ``mxnet_tpu/module/executor_group.py``.

The JAX package binds ONE executor jitted over a mesh of every context,
shards the batch on the mesh's 'data' axis and replicates the parameters.
The port binds one executor too: its arrays (parameters, gradients, aux
states and the whole batch) live on the first context, and over several
contexts it runs in lockstep over the shards (``Executor._set_data_
parallel``): each shard a piece of the batch on its own context, every
parameter a differentiable copy of the one master, so one backward leaves
the whole batch's gradient on the master and an op that reduces over the
batch sees all of it.  Several contexts may name one card.  ``workload``
(work_load_list) is accepted for API parity, but only even splits are
supported, and a batch the contexts do not divide raises.

With a named mesh and partition rules (``mesh=``/``partition_rules=``,
the GSPMD rule path) the batch splits over the mesh's leading axis, each
parameter's ``PartitionSpec`` is resolved from the rules at bind and
checked by ``validate_specs``, and ``Executor.set_shardings`` stores every
split parameter as its pieces; the partitioned walk then runs tensor
parallelism (column- and row-parallel ``FullyConnected``) beside the data
parallelism.  A string or ``MeshConfig`` mesh is resolved over the
Module's own contexts (the JAX package resolves it over ``jax.devices()``).

Under a multi-process group (``kvstore_dist``'s, ``dist_mesh`` not False)
every process's batch is one shard of the global batch, as on the JAX
package's mesh spanning processes: an op that is not batch-local in its
mode (BatchNorm's statistics and moving averages in training) runs on the
batch gathered over the group and each process keeps its own rows, the
loss counted once over the group, and the gradients are summed over the
group right after each backward, before anything reads or applies them:
every worker then applies the same update to its replica.  Such a gather
is a collective every process must reach; out of training BatchNorm,
Dropout and the loss layers need none.  ``dist_mesh=False`` keeps every
process on its own batch.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .. import ndarray as nd
from ..executor import Executor
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _as_desc(shapes):
    return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
            for s in shapes or []]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, compute_dtype=None,
                 dist_mesh=None, mesh=None, partition_rules=None):
        from .. import kvstore_dist

        self.symbol = symbol
        self.contexts = list(contexts)
        self.compute_dtype = compute_dtype
        if workload and len(set(workload)) > 1:
            raise MXNetError(
                "work_load_list with uneven splits is unsupported: the "
                "shards of a data-parallel step are equal")
        self.param_names = list(param_names)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = list(fixed_param_names or [])
        self.state_names = list(state_names or [])
        self.logger = logger
        data_names = [d.name for d in _as_desc(data_shapes)]
        if grad_req != "null" and for_training:
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = ("null" if k in self.fixed_param_names
                                        else grad_req)
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad else "null"
                else:
                    self.grad_req[k] = "null"
        else:
            self.grad_req = {k: "null" for k in self.arg_names}
        self._multiprocess = dist_mesh is not False and \
            kvstore_dist._world() > 1
        self._mesh = None
        self._rules = None        # PartitionRules (the rule path)
        self._param_specs = None  # resolved {name: PartitionSpec} at bind
        self._data_axis = "data"
        if mesh is not None or partition_rules is not None:
            from .. import sharding

            self._rules = sharding.as_rules(
                partition_rules if partition_rules is not None
                else "replicated")
            self._mesh = sharding.build_mesh(
                mesh if mesh is not None else "data=-1", self.contexts)
            self._data_axis = self._mesh.axis_names[0]
        self.batch_size = None
        self.slices = None
        self.execs = []
        self._monitor_callback = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    # ------------------------------------------------------------------
    def decide_slices(self, data_shapes):
        """Batch → per-context slices (reference executor_group.py:207);
        raises when the contexts do not divide the batch."""
        major_axis = [DataDesc.get_batch_axis(getattr(s, "layout", None))
                      for s in data_shapes]
        for desc, axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            batch_size = desc.shape[axis]
            if self.batch_size is not None:
                if batch_size != self.batch_size:
                    raise MXNetError("all data must have the same batch "
                                     "size: %s" % (data_shapes,))
                continue
            self.batch_size = batch_size
            n = len(self.contexts) if self._mesh is None else \
                int(self._mesh.shape[self._data_axis])
            if batch_size % n != 0:
                raise MXNetError(
                    "batch size %d is not divisible by the %d-way 'data' "
                    "split over the contexts" % (batch_size, n))
            step = batch_size // n
            self.slices = [slice(i * step, (i + 1) * step)
                           for i in range(n)]
        return major_axis

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        """Bind the group's executor on the first context, over every
        context when there are several."""
        self.data_shapes = _as_desc(data_shapes)
        self.label_shapes = _as_desc(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.data_layouts = self.decide_slices(self.data_shapes)
        if self.label_shapes:
            self.label_layouts = self.decide_slices(self.label_shapes)

        input_shapes = {d.name: d.shape
                        for d in self.data_shapes + self.label_shapes}
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError("shape inference failed at bind")
        arg_types, _, aux_types = self.symbol.infer_type(**{
            d.name: getattr(d, "dtype", np.float32)
            for d in self.data_shapes + self.label_shapes})
        ctx = self.contexts[0]
        shared_exec = shared_group.execs[0] if shared_group else None
        pool = shared_exec.arg_dict if shared_exec is not None else {}
        args = {}
        for n, s, t in zip(self.arg_names, arg_shapes, arg_types):
            if n in self.param_names and n in pool:
                args[n] = pool[n]  # bucketing shares parameter memory
            else:
                args[n] = nd.zeros(s, ctx, dtype=t)
        grads = {n: nd.zeros(s, ctx, dtype=t)
                 for n, s, t in zip(self.arg_names, arg_shapes, arg_types)
                 if self.grad_req.get(n, "null") != "null"}
        shared_aux = shared_exec.aux_dict if shared_exec is not None else {}
        aux = {}
        for n, s, t in zip(self.aux_names, aux_shapes, aux_types):
            held = shared_aux.get(n)
            aux[n] = held if held is not None and \
                tuple(held.shape) == tuple(s) else nd.zeros(s, ctx, dtype=t)
        executor = Executor(self.symbol, ctx, args, grads or None,
                            self.grad_req, aux, shared_exec=shared_exec,
                            compute_dtype=self.compute_dtype,
                            cast_exclude=self.label_names)
        if self._rules is not None:
            self._apply_rule_shardings(
                executor, dict(zip(self.arg_names, arg_shapes)),
                dict(zip(self.aux_names, aux_shapes)))
        elif len(self.contexts) > 1 or self._multiprocess:
            executor._set_data_parallel(self.contexts,
                                        self.data_names + self.label_names,
                                        group=self._multiprocess)
        if self._multiprocess:
            executor._grad_hook = self._allreduce
        if self._monitor_callback is not None:
            executor.set_monitor_callback(self._monitor_callback)
        self.execs = [executor]
        # the executor rebinds these arrays' buffers in place, so the lists
        # stay valid across steps
        self.param_arrays = [executor.arg_dict[n] for n in self.param_names]
        self.grad_arrays = [executor.grad_dict.get(n)
                            for n in self.param_names]
        self.aux_arrays = [executor.aux_dict[n] for n in self.aux_names]
        self.data_arrays = [executor.arg_dict[n] for n in self.data_names]
        self.label_arrays = [executor.arg_dict[n] for n in self.label_names]
        self.input_grad_arrays = [executor.grad_dict.get(n)
                                  for n in self.data_names] \
            if self.inputs_need_grad else []

    def _apply_rule_shardings(self, executor, arg_shapes, aux_shapes):
        """Resolve the rules against the inferred shapes and hand the whole
        layout to ``Executor.set_shardings``: batch inputs split on the
        leading mesh axis, every other argument and aux state gets its
        rule's PartitionSpec."""
        from .. import sharding
        from ..base import env
        from ..parallel.mesh import PartitionSpec

        batch_names = set(self.data_names) | set(self.label_names)
        ruled = {name: tuple(shape) for name, shape in
                 list(arg_shapes.items()) + list(aux_shapes.items())
                 if name not in batch_names}
        specs = self._rules.match(ruled)
        if env("MXNET_SHARDING_VALIDATE", 1, int):
            sharding.validate_specs(self._mesh, specs, ruled)
        if env("MXNET_SHARDING_EXPLAIN", 0, int):
            self.logger.info(
                "partition rules (%s) on mesh %s:\n%s", self._rules.name,
                sharding.mesh_axes(self._mesh),
                self._rules.explain_str(ruled))
        self._param_specs = specs
        all_specs = dict(specs)
        for name in batch_names:
            all_specs[name] = PartitionSpec(self._data_axis)
        executor.set_shardings(self._mesh, all_specs,
                               group=self._multiprocess)
        self._note_shard_bytes(executor)

    def _note_shard_bytes(self, executor):
        """The gauge pair that makes a layout's memory win a number: the
        average parameter+aux bytes per mesh coordinate against the fully
        replicated layout's."""
        from .. import sharding, telemetry

        arrays = [executor.arg_dict[n] for n in self.param_names]
        arrays += [executor.aux_dict[n] for n in self.aux_names]
        per_dev, repl = sharding.param_bytes(arrays)
        telemetry.gauge(
            "mxtpu_params_sharded_bytes",
            "Average per-device parameter+aux bytes under the active "
            "sharding").set(per_dev)
        telemetry.gauge(
            "mxtpu_params_replicated_bytes",
            "Per-device parameter+aux bytes if fully replicated").set(repl)

    def _replicate(self, x):
        """``x`` replicated on the group's mesh; an array already so placed
        passes through untouched."""
        from ..parallel.mesh import PartitionSpec
        from ..sharding import place

        return place(x, self._mesh, PartitionSpec())

    @staticmethod
    def _allreduce(grads):
        """Sum this step's gradients over the process group (every piece
        of an array stored on a mesh)."""
        from ..executor import _items
        from ..kvstore_dist import allreduce_sum_

        allreduce_sum_([t for g in grads.values() for _, t in _items(g)])

    def backward_param_order(self):
        """Parameter indices in the order their gradients become available
        — last layer first (``param_names`` follows the forward order); the
        centralized update path issues kvstore pushes in this order."""
        return list(range(len(self.param_names) - 1, -1, -1))

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new input shapes, keeping the trained parameters and
        aux states (the reference reshapes in place,
        executor_group.py:378)."""
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        old = self.execs[0] if self.execs else None
        self.batch_size = None
        self.bind_exec(data_shapes, label_shapes)
        if old is not None:
            new = self.execs[0]
            for name in self.param_names:
                new.arg_dict[name]._set(old.arg_dict[name]._data)
            for name in self.aux_names:
                new.aux_dict[name]._set(old.aux_dict[name]._data)

    # ------------------------------------------------------------------
    def set_params(self, arg_params, aux_params):
        """Write the given arrays into the bound ones (split into the
        pieces of those stored on the mesh)."""
        self.execs[0].copy_params_from(arg_params, aux_params)

    def get_params(self, arg_params, aux_params):
        """Copy the current parameters into the given dicts, whole (an
        array stored as pieces on the mesh is gathered; the weighted merge
        across devices of the reference is a no-op: the group keeps one
        master)."""
        ex = self.execs[0]
        for name in self.param_names:
            arg_params[name][:] = ex.arg_dict[name]
        for name in self.aux_names:
            aux_params[name][:] = ex.aux_dict[name]

    # ------------------------------------------------------------------
    def _load_batch(self, data_batch):
        """Copy the batch into the bound input arrays on the first
        context; the executor splits it over the contexts."""
        ex = self.execs[0]
        arrays = list(zip(self.data_names, data_batch.data))
        if self.label_names and getattr(data_batch, "label", None):
            arrays += list(zip(self.label_names, data_batch.label))
        for name, src in arrays:
            dst = ex.arg_dict[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise MXNetError("batch shape %s for %s does not match bound "
                                 "shape %s" % (tuple(src.shape), name,
                                               tuple(dst.shape)))
            dst[:] = src

    def forward(self, data_batch, is_train=None):
        self._load_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        self.execs[0].forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        self.execs[0].backward(out_grads)

    def forward_backward(self, data_batch):
        self._load_batch(data_batch)
        self.execs[0].forward_backward()

    def fused_step(self, data_batch, optimizer, updater):
        """Forward, backward and the optimizer update in one call
        (Executor.fused_step)."""
        self._load_batch(data_batch)
        self.execs[0].fused_step(optimizer, updater, self.param_names)

    def get_outputs(self, merge_multi_context=True):
        return list(self.execs[0].outputs)

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        return [self.execs[0].grad_dict.get(n) for n in self.data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        self._monitor_callback = mon.stat_helper \
            if hasattr(mon, "stat_helper") else mon
        for executor in self.execs:
            executor.set_monitor_callback(self._monitor_callback)
