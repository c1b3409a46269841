"""Training callbacks — counterpart of ``mxnet_tpu/callback.py``:
``Speedometer`` (samples/s between batch callbacks), ``ProgressBar``,
``do_checkpoint``, ``module_checkpoint`` and ``log_train_metric``."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar"]


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
    after the metric update, which waits for the step).  While telemetry
    is on, the window's data-wait time (from the active StepMonitor) rides
    along, so a starving input pipeline shows in the training log."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.last_speed = None
        self.last_data_wait_ms = None
        self._wait_seen_ms = 0.0

    def _data_wait_window_ms(self):
        """Data wait accumulated since the last report, from the active
        StepMonitor; None while telemetry is off."""
        from . import telemetry as _tm

        if not _tm.enabled():
            return None
        mon = _tm.current_step_monitor()
        if mon is None:
            return None
        total = mon.data_wait_ms_total
        delta = total - self._wait_seen_ms
        self._wait_seen_ms = total
        return max(0.0, delta)

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
        wait_ms = self._data_wait_window_ms()
        self.last_data_wait_ms = wait_ms
        wait_sfx = "" if wait_ms is None else "\tdata-wait=%.1f ms" % wait_ms
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            for name, value in name_value:
                logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t"
                             "Train-%s=%f%s", param.epoch, count, speed, name,
                             value, wait_sfx)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, wait_sfx)
        self.tic = time.monotonic()


class ProgressBar:
    """Log an ASCII bar of ``length`` characters for the batches done out
    of ``total``, at every batch-end callback."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
