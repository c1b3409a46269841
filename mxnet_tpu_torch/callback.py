"""Training callbacks — counterpart of ``mxnet_tpu/callback.py`` for the
training slice: ``Speedometer`` (samples/s between batch callbacks),
``do_checkpoint``, ``module_checkpoint`` and ``log_train_metric``."""
from __future__ import annotations

import logging
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback checkpointing a Module."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving prefix-symbol.json + prefix-%04d.params."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the metric every ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples/s every ``frequent`` batches, timed with
    ``time.monotonic()`` between callbacks (the batch-end callback runs
    after the metric update, which waits for the step)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.last_speed = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.monotonic()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.monotonic() - self.tic)
        self.last_speed = speed
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            for name, value in name_value:
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t"
                             "Train-%s=%f", param.epoch, count, speed, name,
                             value)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.monotonic()
