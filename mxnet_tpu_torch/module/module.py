"""Module — the training API over (symbol, data, label); counterpart of
``mxnet_tpu/module/module.py``.

``bind`` builds a ``DataParallelExecutorGroup`` over the module's contexts
(one or several, which may share a card; ``shared_module`` lends its
parameter arrays); ``init_params``, ``set_params``, ``get_params``;
``init_optimizer`` with the reference's kvstore paths — none, ``local``,
``device`` or ``dist_sync``: the centralized update through the store
(wrapped by the async comm engine unless ``MXNET_KVSTORE_ASYNC=0``), or
the replicated updater; ``forward``/``backward``/``forward_backward``/
``update``; ``save_checkpoint``/``load``.  As in the JAX package, when
the optimizer has a list update rule, every gradient is written (not
added) and no store applies the update, ``forward_backward`` defers the
batch and ``update`` runs forward, backward and the update as one
``Executor.fused_step``; a caller that asks for outputs or gradients in
between gets the two-phase path for that batch, and ``install_monitor``
turns the fused step off so the monitor sees every tensor.  Under a multi-process
group (``dist_sync`` over several workers, ``dist_mesh`` not False)
every worker's batch is one shard of the global batch, the gradients are
summed over the workers inside the step and every worker applies the
update itself.  ``bind(mesh=, partition_rules=)`` (or
``MXNET_SHARDING_MESH``/``MXNET_SHARDING_RULES``) lays the parameters out
on a named mesh by regex rules (``sharding``): the update then runs inside
the fused step over the parameters' pieces and a store passed in is a
facade.  ``BucketingModule`` binds one Module per bucket over the default
bucket's (``shared_module``).

Telemetry (``MXNET_TELEMETRY``): a ``StepMonitor`` per module, built on
first use, takes each step's begin (and input signature, the recompile
detector), end and batch size, and one cost count per new fused-step key.
The training guardian (``fit`` sets ``_guardian``): on the fused path the
step's own guard skips a poisoned update and its verdict feeds the
guardian's ladder (``_guardian_action``); on the eager path
``_guardian_observe_eager`` checks the host copies of the gradients, and
a fault plan that targets ``guardian.grad`` corrupts them first, so such
a plan turns the fused step off.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup, _as_desc

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, compute_dtype=None, dist_mesh=None):
        super().__init__(logger=logger)
        # dist_mesh: None sums the gradients over the process group when
        # there is one (dist_sync's data plane); False keeps the module
        # process-local
        self._dist_mesh = dist_mesh
        # mixed precision: compute in compute_dtype (bf16), keep float32
        # parameters, gradients and optimizer state
        self._compute_dtype = compute_dtype
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = list(context)
        self._work_load_list = work_load_list or [1] * len(self._context)
        assert len(self._work_load_list) == len(self._context)

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
        self._tm_mon = None  # telemetry.StepMonitor, created when enabled
        self._guardian = None  # the guardian fit runs under, if any
        self._guardian_action = "ok"

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
            self._wait_async_comm()
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
             grad_req="write", mesh=None, partition_rules=None):
        """Bind the executor group for these input shapes; with
        ``shared_module`` (bound, initialized) its parameter arrays and its
        optimizer are shared.

        ``mesh`` / ``partition_rules`` opt into the GSPMD layer: a named
        mesh (a ``sharding.Mesh``, a ``sharding.MeshConfig`` or the string
        form ``"data=-1,model=2"``, the last two resolved over this
        Module's contexts) plus regex partition rules (a
        ``sharding.PartitionRules``, a preset name, or a raw ``[(regex,
        PartitionSpec), ...]`` list).  The batch splits on the leading
        mesh axis; parameters follow their matching rule.  With neither
        given, ``MXNET_SHARDING_MESH`` / ``MXNET_SHARDING_RULES`` activate
        a layout from the environment; with nothing set nothing changes."""
        if mesh is None and partition_rules is None:
            from ..base import env

            mesh = env("MXNET_SHARDING_MESH", "", str) or None
            partition_rules = env("MXNET_SHARDING_RULES", "", str) or None
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        assert not (for_training is False and inputs_need_grad)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = _as_desc(data_shapes)
        self._label_shapes = _as_desc(label_shapes) if label_shapes else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, self.logger,
            self._fixed_param_names, grad_req, state_names=self._state_names,
            compute_dtype=self._compute_dtype, dist_mesh=self._dist_mesh,
            mesh=mesh, partition_rules=partition_rules)
        if _telemetry.enabled() and self._exec_group._mesh is not None:
            self._telemetry_monitor().note_mesh(self._exec_group._mesh)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self.params_initialized:
            # parameters loaded before bind (Module.load): onto the device
            ctx = self._context[0]
            self._arg_params = {k: v.as_in_context(ctx)
                                for k, v in self._arg_params.items()}
            self._aux_params = {k: v.as_in_context(ctx)
                                for k, v in self._aux_params.items()}
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # ------------------------------------------------------------------
    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes = _as_desc(data_shapes)
        self._label_shapes = _as_desc(label_shapes) if label_shapes else None
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install the optimizer and the kvstore (reference module.py:432);
        rescale_grad defaults to 1/(batch x workers): every process of the
        group when the step sums the gradients, else the workers of a sync
        store."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        multiprocess = self._exec_group._multiprocess
        if multiprocess and kvstore and kvstore.type == "dist_async":
            # dist_async needs each worker's own gradient at the server;
            # the step has already summed them over the group: the two
            # data planes cannot compose
            raise MXNetError(
                "dist_async requires per-worker gradients: construct the "
                "Module with dist_mesh=False to train process-local "
                "replicas against the parameter server")
        if multiprocess and kvstore and "dist" in kvstore.type:
            # the gradients are summed over the workers inside the step
            # and every worker applies the identical update to its
            # replica: the store is the control plane (init broadcast,
            # barrier, rank)
            update_on_kvstore = False
        if self._exec_group._rules is not None:
            # on a mesh the update runs inside the fused step over the
            # parameters' pieces: a store is only a facade
            update_on_kvstore = False
        if kvstore and update_on_kvstore:
            # the centralized update rides the async comm engine
            # (MXNET_KVSTORE_ASYNC=0 keeps the synchronous loop)
            from ..comm_engine import maybe_async

            kvstore = maybe_async(kvstore)
        batch_size = self._exec_group.batch_size
        if multiprocess:
            # the step sums the gradients over every worker whatever the
            # store, so the default scale counts every worker's batch
            from ..kvstore_dist import _world

            batch_size *= _world()
        elif kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            # one executor whatever the number of contexts: updater
            # indices are plain parameter positions
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
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?",
                    optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore,
                                skip_indices=self._sparse_param_indices())
            if not update_on_kvstore and "dist" in kvstore.type and \
                    multiprocess:
                # rank 0's init, broadcast by the store, back into every
                # replica so all start identical
                for idx, name in enumerate(self._param_names):
                    kvstore.pull(idx, self._arg_params[name], priority=-idx)
                self._exec_group.set_params(self._arg_params,
                                            self._aux_params)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        if kvstore and "dist" in kvstore.type and \
                os.environ.get("MXNET_KVSTORE_ELASTIC", "0") == "1":
            # the elastic preemption path: SIGTERM drains the comm ops,
            # leaves the membership and exits 0
            from ..kvstore import install_preemption_handler

            install_preemption_handler(kvstore)
        self.optimizer_initialized = True
        self._fused_ok = self._decide_fused()
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _sparse_param_indices(self):
        """Parameter indices routed around the dense kvstore path: none
        here; ``sparse.SparseEmbeddingModule`` returns its row_sparse
        slots, whose tables live sharded on the servers."""
        return ()

    def _decide_fused(self):
        """Whether update() runs forward, backward and the optimizer as one
        ``Executor.fused_step``: the replicated updater without a store
        round trip, a list update rule, plain grad_req 'write', and no
        monitor (which reads every tensor of the forward).  A fault plan
        that corrupts ``guardian.grad`` rewrites host-visible gradients,
        which the fused step never has: such a plan keeps the eager loop.
        ``MXNET_FUSED_STEP=0`` is the escape hatch back to it."""
        from .. import faults as _faults
        from ..base import env

        if env("MXNET_FUSED_STEP", "1", str) == "0":
            return False
        if _faults.targets_corruption("guardian.grad"):
            return False
        if self._update_on_kvstore or self._updater is None:
            return False
        if self._kvstore is not None and "dist" in self._kvstore.type \
                and not self._exec_group._multiprocess:
            # one-worker dist: keep the eager kvstore loop
            return False
        if not type(self._optimizer).has_tensor_update():
            return False
        if any(self._exec_group.grad_req.get(n) == "add"
               for n in self._param_names):
            return False
        if self._exec_group._monitor_callback is not None:
            return False
        return not self.inputs_need_grad

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        self._fused_ok = self._decide_fused()

    def _wait_async_comm(self):
        """Drain deferred kvstore traffic before the parameters are read:
        update() leaves pushes and pulls in flight on an async store, and
        the executor reads the parameter tensors directly (no NDArray read
        guard fires), so the overlap window closes here."""
        kv = self._kvstore
        if kv is not None and self._update_on_kvstore:
            kv.wait_all()

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._flush_fused_pending()
        self._wait_async_comm()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._flush_fused_pending()
        self._exec_group.backward(out_grads=out_grads)

    def _telemetry_monitor(self):
        """Per-module StepMonitor, created on first use; callers must gate
        on ``telemetry.enabled()`` so the off path allocates nothing."""
        if self._tm_mon is None:
            self._tm_mon = _telemetry.StepMonitor(
                _telemetry, device=self._context[0].torch_device())
        return self._tm_mon

    def forward_backward(self, data_batch):
        """Forward and backward of one batch; on the fused path the batch
        waits for update(), which runs it with the optimizer."""
        assert self.binded and self.params_initialized
        if _telemetry.enabled():
            mon = self._telemetry_monitor()
            mon.step_begin()
            mon.note_batch(data_batch)  # recompile fingerprint
        if self._fused_ok and self.optimizer_initialized:
            self._flush_fused_pending()
            self._fused_pending = data_batch
            return
        self._wait_async_comm()
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
        self._guardian_action = "ok"
        if self._fused_pending is not None:
            batch, self._fused_pending = self._fused_pending, None
            self._exec_group.fused_step(batch, self._optimizer, self._updater)
            g = self._guardian
            if g is not None and self._exec_group.execs:
                # the step's guard already skipped a poisoned update; its
                # verdict (read on the host by the step) feeds the ladder
                verdict = getattr(self._exec_group.execs[0],
                                  "_guard_verdict", None)
                if verdict is not None:
                    ok, gnorm = verdict
                    self._guardian_action = g.observe(finite=ok,
                                                      gnorm=gnorm)
            if _telemetry.enabled():
                self._telemetry_step_end()
            return
        from .. import faults as _faults

        if _faults.targets_corruption("guardian.grad"):
            self._corrupt_grads()
        self._update_eager()
        if _telemetry.enabled():
            self._telemetry_step_end()

    def _update_eager(self):
        """The eager update: through the store, or the updater over the
        gradients unless the guardian answers an anomaly."""
        if self._update_on_kvstore:
            # pushes go out in backward order with priority=-index; the
            # wait is deferred so an async store overlaps its traffic with
            # the metric and the next batch — forward() closes the window
            _update_params_on_kvstore(
                self._exec_group.param_arrays, self._exec_group.grad_arrays,
                self._kvstore,
                param_order=self._exec_group.backward_param_order(),
                defer_wait=True)
            return
        # on a multi-process group the gradients are already summed over
        # the workers, and on a mesh they are the whole batch's: the store
        # must not reduce them again
        kv = None if self._exec_group._multiprocess or \
            self._exec_group._rules is not None else self._kvstore
        if self._guardian_observe_eager() != "ok":
            # anomalous batch: parameters and updater state untouched —
            # the eager path's counterpart of the fused guard's skip
            return
        _update_params(self._exec_group.param_arrays,
                       self._exec_group.grad_arrays, updater=self._updater,
                       num_device=1, kvstore=kv)

    def _each_grad(self):
        for arr in self._exec_group.grad_arrays:
            for a in (arr if isinstance(arr, list) else [arr]):
                if a is not None:
                    yield a

    def _corrupt_grads(self):
        """Run every host-visible gradient past the fault plan's corrupt
        hook (nan/bitflip kinds on the ``guardian.grad`` op); an armed rule
        rewrites the chosen element in place.  Reached only when a plan
        targets corruption, so the normal path never copies gradients to
        the host."""
        from .. import faults as _faults

        for a in self._each_grad():
            before = a.asnumpy()
            after = _faults.corrupt("guardian.grad", before)
            if after is not before:
                a[:] = after

    def _guardian_observe_eager(self):
        """Host-side guard for the eager update path: finiteness + global
        grad-norm over every gradient, fed to the guardian's response
        ladder.  Returns the action ("ok" = apply this batch)."""
        g = self._guardian
        if g is None:
            return "ok"
        finite = True
        # accumulate the norm in float32, as the fused guard does: a
        # finite-but-huge corruption (exponent bit-flip ~1e38) overflows
        # the square-sum and reads as non-finite right here
        sq = np.float32(0)
        with np.errstate(over="ignore"):  # overflow IS the signal
            for a in self._each_grad():
                v = np.asarray(a.asnumpy(), dtype=np.float32)
                if not np.all(np.isfinite(v)):
                    finite = False
                    break
                sq += np.sum(np.square(v))
        gnorm = float(np.sqrt(sq)) if finite else float("inf")
        self._guardian_action = g.observe(finite=finite, gnorm=gnorm)
        return self._guardian_action

    def _telemetry_step_end(self):
        """Close the step: batch size, wall time, and — on the first build
        of a fused-step key — one cost count for MFU."""
        mon = self._telemetry_monitor()
        ex = self._exec_group.execs[0] if self._exec_group.execs else None
        if ex is not None and getattr(ex, "_fused_new_compile", False):
            ex._fused_new_compile = False
            mon.note_compile(ex)
        mon.step_end(getattr(self._exec_group, "batch_size", 0))

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
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def install_monitor(self, mon):
        """Hand every tensor of each forward to ``mon``
        (``Monitor.stat_helper``); the fused step is off from now on."""
        assert self.binded
        self._fused_ok = False
        self._flush_fused_pending()
        self._exec_group.install_monitor(mon)
