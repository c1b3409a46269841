"""Module — the training API over (symbol, data, label); counterpart of
``mxnet_tpu/module/module.py`` on one device.

``bind`` builds a one-context executor group; ``init_params``,
``set_params``, ``get_params``; ``init_optimizer`` (kvstore None or
"local" on one device); ``forward``/``backward``/``forward_backward``/
``update``; ``save_checkpoint``/``load``.  As in the JAX package, when the
optimizer has a tensor update rule and every gradient is written (not
added), ``forward_backward`` defers the batch and ``update`` runs forward,
backward and the update as one ``Executor.fused_step``; a caller that asks
for outputs or gradients in between gets the two-phase path for that batch.
Left out: shardings and
meshes, ``shared_module``/bucketing, the guardian, telemetry and the
monitor hook.
"""
from __future__ import annotations

import logging

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..model import _create_kvstore, _update_params, load_checkpoint
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, compute_dtype=None):
        super().__init__(logger=logger)
        # mixed precision: compute in compute_dtype (bf16), keep float32
        # parameters, gradients and optimizer state
        self._compute_dtype = compute_dtype
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = list(context)
        self._work_load_list = work_load_list or [1] * len(self._context)

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused_ok = False
        self._fused_pending = None

    # ------------------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a saved checkpoint (its parameters are set at
        bind)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Save symbol + params (+ optimizer states)."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outs = self._exec_group.get_outputs()
        return list(zip(self._output_names, [o.shape for o in outs]))

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._flush_fused_pending()
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Initialize the parameters: from ``arg_params``/``aux_params``
        where given, else with ``initializer`` (default Uniform(0.01))."""
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. init_params call ignored.")
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None and not (arg_params and aux_params):
            initializer = Uniform(0.01)
        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {
                name: nd.zeros(arr.shape, ctx, dtype=arr.dtype)
                for name, arr in zip(self._exec_group.param_names,
                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd.zeros(arr.shape, ctx, dtype=arr.dtype)
                for name, arr in zip(self._exec_group.aux_names,
                                     self._exec_group.aux_arrays)}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cache_arr = cache[name]
                if cache_arr is not arr:
                    if tuple(cache_arr.shape) != tuple(arr.shape):
                        raise MXNetError(
                            "shape mismatch for %s: loaded %s vs expected %s"
                            % (name, cache_arr.shape, arr.shape))
                    arr[:] = cache_arr
            else:
                if not allow_missing and cache is not None:
                    raise RuntimeError("%s is not presented in the provided "
                                       "arg_params" % name)
                if initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. set_params call ignored.")
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor for these input shapes."""
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module is not ported yet")
        assert not (for_training is False and inputs_need_grad)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        from ..io import DataDesc

        as_desc = lambda shapes: [s if isinstance(s, DataDesc)  # noqa: E731
                                  else DataDesc(s[0], s[1]) for s in shapes]
        self._data_shapes = as_desc(data_shapes)
        self._label_shapes = as_desc(label_shapes) if label_shapes else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, None, self.logger,
            self._fixed_param_names, grad_req, state_names=self._state_names,
            compute_dtype=self._compute_dtype)
        if self.params_initialized:
            # parameters loaded before bind (Module.load): onto the device
            ctx = self._context[0]
            self._arg_params = {k: v.as_in_context(ctx)
                                for k, v in self._arg_params.items()}
            self._aux_params = {k: v.as_in_context(ctx)
                                for k, v in self._aux_params.items()}
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer; rescale_grad defaults to 1/batch."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size "
                    "(%s vs. %s). Is this intended?",
                    optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._fused_ok = self._decide_fused()
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _decide_fused(self):
        """Whether update() runs forward, backward and the optimizer as one
        ``Executor.fused_step``."""
        if not type(self._optimizer).has_tensor_update():
            return False
        if any(self._exec_group.grad_req.get(n) == "add"
               for n in self._param_names):
            return False
        return not self.inputs_need_grad

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._flush_fused_pending()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._flush_fused_pending()
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """Forward and backward of one batch; on the fused path the batch
        waits for update(), which runs it with the optimizer."""
        assert self.binded and self.params_initialized
        if self._fused_ok and self.optimizer_initialized:
            self._flush_fused_pending()
            self._fused_pending = data_batch
            return
        self._exec_group.forward_backward(data_batch)

    def _flush_fused_pending(self):
        """Gradients or outputs are wanted before update(): run the pending
        batch on the two-phase path."""
        if self._fused_pending is not None:
            batch, self._fused_pending = self._fused_pending, None
            self._exec_group.forward_backward(batch)

    def update(self):
        """Apply the optimizer to every parameter with a gradient."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._fused_pending is not None:
            batch, self._fused_pending = self._fused_pending, None
            self._exec_group.fused_step(batch, self._optimizer, self._updater)
            return
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=1)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        self._flush_fused_pending()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        self._flush_fused_pending()
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._flush_fused_pending()
        self._exec_group.update_metric(eval_metric, labels)

    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())
