"""Monitor — statistics of every tensor of a batch; counterpart of
``mxnet_tpu/monitor.py``.

``install`` hooks an executor's monitor callback: its ``forward`` hands
every node output, by output name, to the monitor, which keeps a statistic
of those matching ``pattern`` while active.  ``tic`` activates it every
``interval`` batches; ``toc`` adds the statistics of the bound arguments
(parameters and inputs after the update), reads everything to the host and
returns ``(step, name, statistic string)`` rows, sorted by name with
``sort``; ``toc_print`` logs them.  The default statistic is mean(|x|).
"""
from __future__ import annotations

import logging
import re

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """|x| / size(x), as a (1,) array on x's device."""
                return NDArray(x._data.abs().mean().reshape((1,)),
                               x.context)

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            """The executor's callback."""
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))

        self.stat_helper = stat_helper

    def install(self, exe):
        """Install the monitor on an executor."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for the current batch; call before forward."""
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End collection; the (step, name, statistic string) rows."""
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ""
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,):
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """End collection and log the rows."""
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
