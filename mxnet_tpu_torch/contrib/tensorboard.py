"""TensorBoard logging callback; counterpart of
``mxnet_tpu/contrib/tensorboard.py``.

Reference python/mxnet/contrib/tensorboard.py:8 (``LogMetricsCallback``
writing eval metrics as TensorBoard scalars).  Backed by
``torch.utils.tensorboard`` (an event-file writer); where that import is
unavailable (it needs the ``tensorboard`` package) the callback writes a
JSONL scalar log in the same directory, so training never breaks on a
logging dependency.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogMetricsCallback"]


class LogMetricsCallback:
    """Log metrics at batch/epoch end to TensorBoard.

    Use as ``batch_end_callback`` or ``eval_end_callback`` in
    ``Module.fit`` — the callback reads ``param.eval_metric`` like
    ``Speedometer`` does (callback.py).
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        os.makedirs(logging_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.summary_writer = SummaryWriter(logging_dir)
            self._jsonl = None
        except Exception:
            self.summary_writer = None
            self._jsonl = open(
                os.path.join(logging_dir, "scalars.jsonl"), "a")

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self.step += 1
        names, values = self._name_values(param.eval_metric)
        for name, value in zip(names, values):
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            if self.summary_writer is not None:
                # SummaryWriter flushes on its own cadence; no per-batch
                # flush in the training hot path
                self.summary_writer.add_scalar(name, value, self.step)
            else:
                self._jsonl.write(json.dumps(
                    {"tag": name, "value": float(value), "step": self.step,
                     "wall_time": time.time()}) + "\n")
                self._jsonl.flush()

    @staticmethod
    def _name_values(metric):
        pairs = metric.get_name_value()
        return [p[0] for p in pairs], [p[1] for p in pairs]
