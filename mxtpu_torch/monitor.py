"""Monitor: per-op output statistics during execution (counterpart of
``mxtpu/monitor.py``; ref: python/mxnet/monitor.py over
MXExecutorSetMonitorCallback, src/executor/graph_executor.cc:104).

An executor with a monitor installed runs its forwards uncaptured, node
by node, so the callback sees every node's output.
``TrainingHealthMonitor`` reads the guarded updater's health scalars and
the resilience sentinels, which are not ported yet (ROADMAP A9): it
raises.
"""
from __future__ import annotations

import logging
import re

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Monitor", "TrainingHealthMonitor"]


class Monitor:
    """Install on executors to record a statistic of every op output each
    `interval` batches (ref: monitor.py:Monitor)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return x.norm() / (x.size ** 0.5)
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        exe.set_monitor_callback(self._stat_helper)
        self.exes.append(exe)

    def _stat_helper(self, name, value):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(value)))

    def tic(self):
        if self.step % self.interval == 0:
            for exe in self.exes:
                exe._monitor_active = True
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        self.activated = False
        for exe in self.exes:
            exe._monitor_active = False
            for name, array in getattr(exe, "output_dict", {}).items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            v = ", ".join("%f" % float(v.asnumpy().reshape(-1)[0])
                          for v in v_list)
            res.append((n, k, v))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)


class TrainingHealthMonitor:
    """Not ported yet: it reads the guarded fused updater's health scalars
    and the poison-batch and divergence sentinels of the numerics guard
    (ROADMAP A9)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("TrainingHealthMonitor is not ported yet: it reads "
                         "the numerics guard's health scalars and sentinels "
                         "(ROADMAP A9)")
