"""BaseModule — the abstract training interface and the fit loop;
counterpart of ``mxnet_tpu/module/base_module.py`` (``fit``, ``score``,
``predict``, ``forward_backward``).

``fit`` draws each epoch and each step as a profiler span
(``Module.fit:epoch<N>``, ``Module.fit:step``), measures the time it
blocks on the iterator while telemetry is on (the step monitor's data
wait), and under the training guardian (``guardian.enabled()``) offers a
last-good snapshot at the guardian's cadence and at each epoch start
(parameters, aux states, the updater's states, the random state and the
iterator's position captured before the batch's fetch) and answers a
``rollback`` by restoring the newest snapshot of the epoch and replaying
from its batch."""
from __future__ import annotations

import logging
import time

from .. import metric as _metric
from .. import ndarray as nd
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


def _check_input_names(symbol, names, typename, throw):
    """Check that input names are arguments of the symbol."""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). Did "
               "you mean one of:\n\t%s" % (typename, str(names), name,
                                           "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    """The base class of every module."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------------------
    # high-level interface
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """``forward`` then ``backward``."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run prediction on ``eval_data`` and evaluate."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            for callback in _as_list(batch_end_callback):
                callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals()))
            actual_num_batch += 1
        for callback in _as_list(score_end_callback):
            callback(BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Run prediction, collecting the outputs (padding rows dropped)."""
        import torch

        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].copy()
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [nd.NDArray(torch.cat([out[i]._data
                                            for out in output_list]),
                                 output_list[0][i].context)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Train the module: bind, initialize, then per batch
        ``forward_backward`` + ``update`` + metric (inside ``monitor``'s
        ``tic``/``toc_print`` when one is given), per epoch the callbacks
        and an optional evaluation."""
        from ..initializer import Uniform

        assert num_epoch is not None, "please specify number of epochs"
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)

        from .. import guardian as _guardian_mod
        from .. import profiler as _prof
        from .. import telemetry as _telemetry

        guardian = _guardian_mod.Guardian() if _guardian_mod.enabled() \
            else None
        self._guardian = guardian

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            data_iter = iter(train_data)
            nbatch = 0
            with _prof.Frame("Module.fit:epoch%d" % epoch, "fit"):
                while True:
                    # the iterator's cursor is captured BEFORE the fetch
                    # (a rollback replays the batch about to run) but the
                    # snapshot is committed only after the fetch succeeds;
                    # forced at each epoch start, since replaying across an
                    # epoch boundary would re-apply the prior epoch's tail
                    snap_force = guardian is not None and nbatch == 0
                    snap_due = guardian is not None and \
                        (snap_force or guardian.snapshot_due())
                    snap_iter = None
                    if snap_due:
                        try:
                            snap_iter = train_data.state_dict()
                        except (NotImplementedError, ValueError,
                                AttributeError):
                            pass  # the replay reads on from the live cursor
                    # data wait: time blocked on the iterator, measured only
                    # while telemetry is on
                    t_fetch = time.monotonic() if _telemetry.enabled() \
                        else None
                    try:
                        data_batch = next(data_iter)
                    except StopIteration:
                        break
                    mon = getattr(self, "_telemetry_monitor", None)
                    if t_fetch is not None and mon is not None:
                        mon().note_data_wait(time.monotonic() - t_fetch)
                    if snap_due:
                        self._guardian_snapshot(guardian, snap_iter, epoch,
                                                nbatch, force=snap_force)
                    if monitor is not None:
                        monitor.tic()
                    with _prof.Frame("Module.fit:step", "fit"):
                        self.forward_backward(data_batch)
                        self.update()
                    if guardian is not None and \
                            getattr(self, "_guardian_action", "ok") == \
                            "rollback":
                        # parameters, updater, random state and iterator
                        # all rolled back: the replayed steps are those of
                        # an uncorrupted run
                        nbatch = self._guardian_rollback(guardian,
                                                         train_data, epoch)
                        continue
                    self.update_metric(eval_metric, data_batch.label)
                    if monitor is not None:
                        monitor.toc_print()
                    for callback in _as_list(batch_end_callback):
                        callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                               eval_metric=eval_metric,
                                               locals=locals()))
                    nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            for callback in _as_list(epoch_end_callback):
                callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # ------------------------------------------------------------------
    # guardian: last-good retention ring + rollback-and-replay
    # ------------------------------------------------------------------
    def _guardian_snapshot(self, guardian, iter_state, epoch, nbatch,
                           force=False):
        """Offer a last-good ring snapshot before this batch runs
        (``iter_state`` was captured before the fetch, so it replays this
        very batch).  The capture runs only on the batches the guardian
        elects (every MXNET_GUARDIAN_SNAPSHOT_EVERY applied steps plus each
        epoch start, never while anomalies are live): it copies every
        parameter."""

        def capture():
            from .. import random as _random

            arg_params, aux_params = self.get_params()
            snap = {"arg": {k: v.copy() for k, v in arg_params.items()},
                    "aux": {k: v.copy() for k, v in aux_params.items()},
                    "rng": _random.get_state(),
                    "epoch": epoch, "nbatch": nbatch,
                    "updater": None, "iter": iter_state}
            upd = getattr(self, "_updater", None)
            if upd is not None:
                snap["updater"] = upd.get_states()
            return snap

        guardian.offer_snapshot(capture, force=force)

    def _guardian_rollback(self, guardian, train_data, epoch):
        """Restore the newest ring snapshot from the current epoch —
        parameters, updater states, the random state and the iterator's
        position — so fit replays from last-good.  Returns the restored
        nbatch.  Raises GuardianAbort when the rollback budget is spent or
        no snapshot of the epoch was retained."""
        from .. import guardian as _guardian_mod
        from .. import random as _random

        target = guardian.rollback_target(
            lambda snap: snap.get("epoch") == epoch)
        guardian.note_rollback(
            to_step=target[0] if target is not None else None)
        if target is None:
            raise _guardian_mod.GuardianAbort(
                "guardian must roll back but the last-good ring holds no "
                "snapshot from the current epoch")
        snap = target[1]
        self.set_params(snap["arg"], snap["aux"])
        upd = getattr(self, "_updater", None)
        if upd is not None and snap["updater"] is not None:
            upd.set_states(snap["updater"])
        _random.set_state(snap["rng"])
        if snap["iter"] is not None:
            train_data.set_state(snap["iter"])
        self._guardian_action = "ok"
        self.logger.info(
            "guardian: rolled back to last-good snapshot "
            "(epoch %d, batch %d)", snap["epoch"], snap["nbatch"])
        return snap["nbatch"]

    # ------------------------------------------------------------------
    # symbol / params
    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        arg_params, aux_params = {}, {}
        for k, value in nd.load(fname).items():
            arg_type, _, name = k.partition(":")
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    # ------------------------------------------------------------------
    # computation interface (implemented by subclasses)
    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()
