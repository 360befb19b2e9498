"""Monitor: per-op output statistics during execution (counterpart of
``mxtpu/monitor.py``; ref: python/mxnet/monitor.py over
MXExecutorSetMonitorCallback, src/executor/graph_executor.cc:104).

An executor with a monitor installed runs its forwards uncaptured, node
by node, so the callback sees every node's output.

``TrainingHealthMonitor`` reads the numerics guard's verdicts off the
guarded updater's ``health`` ring (one fetch every ``interval`` steps),
logs each skipped step, counts ``resilience.steps_ok``/``steps_skipped``
and gauges the last grad norm and the loss scale; ``poison_streak``
consecutive skips quarantine the steps (``flight_record("poison_batch")``,
then ``PoisonBatchError`` or, with ``on_poison="continue"``, a log line);
every ``divergence_every`` steps it compares the update's fingerprint
(``resilience.DivergenceSentinel``; on a mesh Trainer over its data
axis).
"""
from __future__ import annotations

import collections
import logging
import re

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
    """The numerics guard's verdicts, off the step path (ref:
    monitor.py:TrainingHealthMonitor; module docstring). ``poison_streak``
    and ``divergence_every`` default to ``resilience.poison_streak()`` and
    ``resilience.divergence_every()``."""

    def __init__(self, interval=100, logger=None, poison_streak=None,
                 on_poison="raise", divergence_every=None):
        from . import resilience
        self.interval = int(interval)
        self.logger = logger or logging.getLogger("mxtpu_torch.resilience")
        self.poison_streak = resilience.poison_streak() \
            if poison_streak is None else int(poison_streak)
        if on_poison not in ("raise", "continue"):
            raise ValueError("on_poison must be 'raise' or 'continue', "
                             "got %r" % (on_poison,))
        self.on_poison = on_poison
        self.divergence_every = resilience.divergence_every() \
            if divergence_every is None else int(divergence_every)
        self._sentinel = resilience.DivergenceSentinel(logger=self.logger)
        self._owner = None
        self._count = 0
        self._skip_streak = 0
        self._streak = []
        self.skipped = []
        self.quarantined = collections.deque(maxlen=64)

    def install(self, owner):
        """Attach to a gluon Trainer, a Module or an updater; the active
        updater is looked up at each flush."""
        self._owner = owner
        return self

    def _updater_of(self):
        owner = self._owner
        active = getattr(owner, "_active_updater", None)   # gluon Trainer
        if callable(active):
            upd = active()
            if upd is not None:
                return upd
            upds = getattr(owner, "_updaters", None)
            return upds[0] if upds else None
        if getattr(owner, "_update_on_kvstore", False) and \
                getattr(owner, "_kvstore", None) is not None:   # Module
            return owner._kvstore._updater
        upds = getattr(owner, "_updaters", None)
        if upds:
            return upds[0]
        return getattr(owner, "_updater", owner)

    def _axis(self, updater):
        plan = getattr(updater, "_plan", None)
        return None if plan is None else plan.data()

    def after_step(self):
        self._count += 1
        records = []
        if self._count % self.interval == 0:
            records = self.flush()
        if self.divergence_every > 0 and \
                self._count % self.divergence_every == 0:
            self.check_divergence()
        return records

    def check_divergence(self):
        """One compare of the replicas' fingerprints (syncs on two
        scalars); raises ``DivergenceError`` after the artifact."""
        updater = self._updater_of()
        fp = getattr(updater, "last_fingerprint", None)
        traces = getattr(updater, "_step_traces", None) or {}
        last_trace = next(reversed(traces.values())) \
            if hasattr(traces, "values") and traces else None
        return self._sentinel.check(
            fp, step=self._count,
            trace_ids=[last_trace] if last_trace else [],
            axis=self._axis(updater))

    def flush(self):
        """Fetch the buffered verdicts (one sync); returns [(step, ok,
        grad_norm)] and logs the skipped steps."""
        from . import telemetry
        updater = self._updater_of()
        health = getattr(updater, "health", None)
        if health is None or len(health) == 0:
            return []
        records = health.drain()
        for step, ok, gnorm in records:
            if not ok:
                self.logger.warning(
                    "step %d skipped: non-finite gradients (global grad "
                    "norm %s); params and optimizer state untouched, loss "
                    "scale backed off", step, gnorm)
        n_skipped = sum(1 for _, ok, _ in records if not ok)
        telemetry.inc("resilience.steps_ok", len(records) - n_skipped)
        telemetry.inc("resilience.steps_skipped", n_skipped)
        telemetry.gauge("resilience.grad_norm", records[-1][2])
        scaler = getattr(updater, "scaler", None)
        if scaler is not None:
            telemetry.gauge("resilience.loss_scale", scaler.scale_value())
        self.skipped.extend((s, g) for s, ok, g in records if not ok)
        self._escalate_poison(updater, records)
        return records

    def _escalate_poison(self, updater, records):
        """``poison_streak`` consecutive skips (across flushes) quarantine
        the streak's steps and trace ids, flight-record them and raise or
        continue per ``on_poison``; a good step resets the streak."""
        if self.poison_streak <= 0:
            return
        from . import resilience, telemetry
        traces = getattr(updater, "_step_traces", None) or {}
        for step, ok, gnorm in records:
            if ok:
                self._skip_streak = 0
                self._streak = []
                continue
            self._streak.append((step, gnorm, traces.get(step)))
            self._skip_streak += 1
            if self._skip_streak < self.poison_streak:
                continue
            steps = [s for s, _, _ in self._streak]
            trace_ids = [t for _, _, t in self._streak if t]
            entry = {"steps": steps, "trace_ids": trace_ids,
                     "grad_norms": [g for _, g, _ in self._streak]}
            self.quarantined.append(entry)
            telemetry.inc("resilience.poison_quarantines")
            telemetry.flight_record("poison_batch", trace_ids=trace_ids,
                                    extra=entry)
            msg = ("poison-batch quarantine: %d CONSECUTIVE sentinel-"
                   "skipped steps (%s); poisoned data or a corrupt shard, "
                   "not overflow noise; the steps' trace ids are in the "
                   "flight artifact (reason=poison_batch)"
                   % (self._skip_streak, steps))
            self._skip_streak = 0
            self._streak = []
            if self.on_poison == "raise":
                raise resilience.PoisonBatchError(msg)
            self.logger.error("%s; continuing per on_poison='continue'",
                              msg)
