"""Training-curve collection/plotting callbacks; counterpart of
``mxnet_tpu/notebook/callback.py``.

Capability parity with the reference's notebook callbacks
(python/mxnet/notebook/callback.py: PandasLogger + LiveLearningCurve).
The reference renders through bokeh; this build collects into plain
Python structures, renders through matplotlib when it is installed, and
always supports CSV export and a terminal sparkline — so the capability
works on headless hosts too.
"""
from __future__ import annotations

import time
from typing import Dict, List

_TICKS = "▁▂▃▄▅▆▇█"


class MetricsLogger:
    """Collects per-batch and per-epoch metric values via the standard
    ``batch_end_callback`` / ``eval_end_callback`` hooks (the reference's
    PandasLogger capability, minus the hard pandas dependency)."""

    def __init__(self, frequent: int = 50):
        self.frequent = frequent
        self.train: Dict[str, List] = {}
        self.eval: Dict[str, List] = {}
        self._t0 = time.time()

    def _append(self, store, name, value, epoch, nbatch):
        store.setdefault(name, []).append(
            (time.time() - self._t0, epoch, nbatch, float(value)))

    def train_cb(self, param):
        """Use as ``batch_end_callback``."""
        if param.nbatch % self.frequent == 0 and param.eval_metric:
            for name, value in param.eval_metric.get_name_value():
                self._append(self.train, name, value, param.epoch,
                             param.nbatch)

    def eval_cb(self, param):
        """Use as ``eval_end_callback``/``eval_batch_end_callback``."""
        if param.eval_metric:
            for name, value in param.eval_metric.get_name_value():
                self._append(self.eval, name, value, param.epoch,
                             getattr(param, "nbatch", 0))

    # -- output ------------------------------------------------------------
    def values(self, name, which="train"):
        store = self.train if which == "train" else self.eval
        return [v[-1] for v in store.get(name, [])]

    def to_csv(self, path):
        with open(path, "w") as f:
            f.write("phase,metric,seconds,epoch,batch,value\n")
            for phase, store in (("train", self.train), ("eval", self.eval)):
                for name, rows in store.items():
                    for sec, epoch, nbatch, value in rows:
                        f.write("%s,%s,%.3f,%d,%d,%.6f\n"
                                % (phase, name, sec, epoch, nbatch, value))

    def sparkline(self, name, which="train", width=60):
        """Terminal rendering of a metric curve (non-finite samples —
        e.g. a metric's nan before any update — are skipped)."""
        import math

        vals = [v for v in self.values(name, which) if math.isfinite(v)]
        if not vals:
            return ""
        if width <= 1:
            vals = vals[-1:]
        elif len(vals) > width:
            stride = (len(vals) - 1) / float(width - 1)
            vals = [vals[round(i * stride)] for i in range(width)]
        lo, hi = min(vals), max(vals)
        span = (hi - lo) or 1.0
        return "".join(
            _TICKS[int((v - lo) / span * (len(_TICKS) - 1))] for v in vals)

    def plot(self, name, which="train", ax=None):
        """Matplotlib curve when matplotlib is installed."""
        try:
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise ImportError(
                "matplotlib is not installed; use sparkline()/to_csv() on "
                "headless hosts") from e
        vals = self.values(name, which)
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(range(len(vals)), vals, label="%s %s" % (which, name))
        ax.set_xlabel("sample")
        ax.set_ylabel(name)
        ax.legend()
        return ax


class LiveLearningCurve(MetricsLogger):
    """Prints a refreshed sparkline as training proceeds (the reference's
    bokeh live plot, terminal edition)."""

    def __init__(self, metric_name: str = "accuracy", frequent: int = 50):
        super().__init__(frequent=frequent)
        self.metric_name = metric_name

    def train_cb(self, param):
        super().train_cb(param)
        if param.nbatch % self.frequent:  # render at collection cadence
            return
        line = self.sparkline(self.metric_name)
        if line:
            vals = self.values(self.metric_name)
            print("\r%s %s %.4f" % (self.metric_name, line, vals[-1]),
                  end="", flush=True)
