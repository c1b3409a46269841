"""DataParallelExecutorGroup over one context — counterpart of
``mxnet_tpu/module/executor_group.py``.

The JAX package binds one executor jitted over a mesh of every context and
shards the batch on it.  The port binds one executor on one device; more
than one context raises until the multi-device slice.  Batches arrive as
host NDArrays and are copied into the bound input arrays at load."""
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
                 grad_req="write", state_names=None, compute_dtype=None):
        if len(contexts) != 1:
            raise MXNetError(
                "the port trains on one device: got contexts %s (multi-"
                "device data parallelism is not ported yet)" % (contexts,))
        if shared_group is not None:
            raise MXNetError("shared_module is not ported yet")
        self.symbol = symbol
        self.contexts = contexts
        self.compute_dtype = compute_dtype
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
        self.bind_exec(data_shapes, label_shapes)

    def bind_exec(self, data_shapes, label_shapes):
        """Bind the single executor on the group's one context."""
        self.data_shapes = _as_desc(data_shapes)
        self.label_shapes = _as_desc(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        batch = {d.shape[DataDesc.get_batch_axis(getattr(d, "layout", None))]
                 for d in self.data_shapes + self.label_shapes}
        if len(batch) != 1:
            raise MXNetError("all data must have the same batch size: %s"
                             % (self.data_shapes + self.label_shapes,))
        self.batch_size = batch.pop()

        input_shapes = {d.name: d.shape
                        for d in self.data_shapes + self.label_shapes}
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError("shape inference failed at bind")
        arg_types, _, aux_types = self.symbol.infer_type(**{
            d.name: getattr(d, "dtype", np.float32)
            for d in self.data_shapes + self.label_shapes})
        ctx = self.contexts[0]
        args = {n: nd.zeros(s, ctx, dtype=t)
                for n, s, t in zip(self.arg_names, arg_shapes, arg_types)}
        grads = {n: nd.zeros(s, ctx, dtype=t)
                 for n, s, t in zip(self.arg_names, arg_shapes, arg_types)
                 if self.grad_req.get(n, "null") != "null"}
        aux = {n: nd.zeros(s, ctx, dtype=t)
               for n, s, t in zip(self.aux_names, aux_shapes, aux_types)}
        executor = Executor(self.symbol, ctx, args, grads or None,
                            self.grad_req, aux,
                            compute_dtype=self.compute_dtype,
                            cast_exclude=self.label_names)
        self.execs = [executor]
        # the executor rebinds these arrays' buffers in place, so the lists
        # stay valid across steps
        self.param_arrays = [executor.arg_dict[n] for n in self.param_names]
        self.grad_arrays = [executor.grad_dict.get(n)
                            for n in self.param_names]
        self.aux_arrays = [executor.aux_dict[n] for n in self.aux_names]
        self.data_arrays = [executor.arg_dict[n] for n in self.data_names]
        self.label_arrays = [executor.arg_dict[n] for n in self.label_names]

    # ------------------------------------------------------------------
    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params)

    def get_params(self, arg_params, aux_params):
        """Copy the current parameters into the given dicts."""
        ex = self.execs[0]
        for name in self.param_names:
            arg_params[name][:] = ex.arg_dict[name]
        for name in self.aux_names:
            aux_params[name][:] = ex.aux_dict[name]

    # ------------------------------------------------------------------
    def _load_batch(self, data_batch):
        """Copy the batch into the bound input arrays on the device."""
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
