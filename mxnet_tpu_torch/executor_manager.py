"""The legacy executor manager — counterpart of
``mxnet_tpu/executor_manager.py``: ``_split_input_slice`` (a batch split
over workers in proportion to their loads), ``_check_arguments`` (no
duplicate argument or aux names) and ``DataParallelExecutorManager``, the
pre-``Module`` training plumbing ``FeedForward`` used, as a thin adapter
over ``module.executor_group.DataParallelExecutorGroup``.

Over several contexts the group splits the batch evenly between them
(``DataParallelExecutorGroup``); an uneven ``work_load_list`` raises there.
"""
from __future__ import annotations

import logging
from typing import List

from .base import MXNetError

__all__ = ["DataParallelExecutorManager"]


def _split_input_slice(batch_size: int, work_load_list: List[float]):
    """``batch_size`` split into one slice per worker, in proportion to
    ``work_load_list``."""
    total = sum(work_load_list)
    if total <= 0:
        raise ValueError("Invalid workload")
    slices = []
    start = 0
    for i, load in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            stop = batch_size
        else:
            stop = min(int(round(start + batch_size * load / total)),
                       batch_size)
        if stop <= start:
            raise ValueError(
                "Too many slices. Some splits are empty (batch %d over %d "
                "workers)" % (batch_size, len(work_load_list)))
        slices.append(slice(start, stop))
        start = stop
    return slices


def _check_arguments(symbol):
    """Refuse duplicate argument or auxiliary-state names."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        dup = [n for n in set(arg_names) if arg_names.count(n) > 1]
        raise ValueError(
            "Find duplicated argument name, please make the weight name "
            "non-duplicated, duplicates: %s" % dup)
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise ValueError("Find duplicated auxiliary param name")


class DataParallelExecutorManager:
    """Bind once over the contexts, then ``load_data_batch`` / ``forward``
    / ``backward`` / ``update_metric``."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        if sym_gen is not None:
            raise NotImplementedError(
                "sym_gen (per-bucket symbols) is not supported by this "
                "adapter; use BucketingModule for bucketed training")
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        if work_load_list is None:
            work_load_list = [1] * len(self._ctx)
        if len(work_load_list) != len(self._ctx):
            raise MXNetError("Invalid settings for work load.")
        _check_arguments(symbol)
        self._arg_names = arg_names or symbol.list_arguments()
        self._aux_names = aux_names or symbol.list_auxiliary_states()
        data_names = [d[0] for d in train_data.provide_data]
        label_names = [lab[0] for lab in (train_data.provide_label or [])]
        self._param_names = param_names or [
            n for n in self._arg_names
            if n not in data_names and n not in label_names]
        from .module.executor_group import DataParallelExecutorGroup

        self._group = DataParallelExecutorGroup(
            symbol, self._ctx, work_load_list,
            train_data.provide_data, train_data.provide_label,
            self._param_names, for_training=True, inputs_need_grad=False,
            logger=logger)
        self._batch = None
        self.slices = _split_input_slice(
            train_data.batch_size if hasattr(train_data, "batch_size")
            else train_data.provide_data[0][1][0], work_load_list)

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params):
        self._group.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self._group.get_params(arg_params, aux_params)

    @property
    def param_names(self):
        return self._param_names

    @property
    def param_arrays(self):
        return self._group.param_arrays

    @property
    def grad_arrays(self):
        return self._group.grad_arrays

    @property
    def aux_arrays(self):
        return self._group.aux_arrays

    # -- the step ----------------------------------------------------------
    def load_data_batch(self, data_batch):
        self._batch = data_batch

    def forward(self, is_train=False):
        if self._batch is None:
            raise MXNetError("call load_data_batch before forward")
        self._group.forward(self._batch, is_train=is_train)

    def backward(self):
        self._group.backward()

    def update_metric(self, metric, labels):
        self._group.update_metric(metric, labels)
