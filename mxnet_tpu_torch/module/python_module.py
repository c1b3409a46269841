"""PythonModule — modules written in Python, with no symbol; counterpart
of ``mxnet_tpu/module/python_module.py``.

``PythonModule`` is the base (no parameters, no optimizer);
``PythonLossModule`` is a loss head whose forward passes its data through
and whose backward calls ``grad_func(scores, labels)``, the gradient put on
the scores' context.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A convenient base for modules written in Python."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        if isinstance(data_names, tuple):
            data_names = list(data_names)
        if isinstance(label_names, tuple):
            label_names = list(label_names)
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return (dict(), dict())

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            pass
        else:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert grad_req == "write", "Python module only supports write gradient"
        self.binded = True

        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        assert [d.name for d in self._data_shapes] == self._data_names
        if label_shapes is not None:
            self._label_shapes = [l if isinstance(l, DataDesc) else DataDesc(*l)
                                  for l in label_shapes]
        else:
            self._label_shapes = None
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss layer in Python: forward is identity, backward calls a
    user-provided gradient function."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(list(data_names), list(label_names),
                         [name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "PythonLossModule is a loss head"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad, self._scores.context)
            self._scores_grad = grad
        else:
            raise NotImplementedError("provide grad_func to PythonLossModule")

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]
