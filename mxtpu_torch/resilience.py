"""Resilient training runtime: numerics guard, loss scaling, watchdogs,
sentinels, preemption-safe checkpoints and fault injection (counterpart
of ``mxtpu/resilience.py``).

* **Numerics guard** -- the fused optimizer step
  (``optimizer_fused.FusedUpdater``) computes one all-parameter finite
  flag and the global gradient norm inside the same captured graph as
  the update, and applies the update under ``torch.where``: a non-finite
  step leaves the parameters, every optimizer state and the
  bias-correction count bit-equal. The verdict ``last_step_ok`` and the
  norm are device tensors that ``StepHealth`` fetches later, in one
  transfer. On with ``set_guard(True)`` (the reference's
  ``MXTPU_NUMERICS_GUARD=1``) or by attaching a ``DynamicLossScaler``.
* **Dynamic loss scaling** -- ``DynamicLossScaler``'s scale and good-step
  streak are device scalars of fixed storage that the captured update
  reads and writes in place: backoff on a skipped step, growth after
  ``growth_interval`` good ones, clamped. A change of scale never
  re-captures; ``config()``, the static tuple, is part of the graph's key.
* **Watchdog and sentinels** -- ``TrainStepWatchdog`` brackets each
  ``Trainer.step`` with a deadline off a rolling median of step times and
  dumps ``flight_record("train_wedge")`` on a trip;
  ``DivergenceSentinel`` compares the replicas' copies of the update's
  fingerprint (one float32 sum and one int32 fold of the post-update
  parameters and states) at check cadence.
* **Checkpoints** -- ``ResilientLoop`` + ``CheckpointPolicy`` save through
  ``contrib.async_checkpoint.save_trainer`` on an interval and on SIGTERM
  (``flight_record("sigterm")``), with bounded retries
  (``with_retries``, decorrelated jitter), an atomic ``latest.json`` and a
  tiered, bit-exact resume. ``TrainSupervisor`` respawns a crashed child
  under a crash-loop budget and refuses a poison crash.
* **Fault injection** -- ``set_faults(spec)`` takes the spec string the
  JAX package reads from ``MXTPU_FAULT_INJECT``: ``kind@idx[,idx...]``
  entries separated by ``;``. ``inject(kind, index)`` is True exactly
  once per scheduled (kind, index), so a retry loop converges by
  construction; with ``index=None`` a per-kind call counter supplies the
  index; each firing dumps ``flight_record("fault")``. The training kinds:
  ``nan_grad`` (optimizer-step index: one gradient becomes NaN),
  ``ckpt_io`` (save attempt: the save raises ``OSError``),
  ``ckpt_corrupt`` (save attempt: the saved updater blob's bytes flip
  after the checksum manifest), ``sigterm`` (loop step: the process
  signals itself), ``train_wedge`` (``Trainer.step`` index: that step's
  watchdog entry never disarms), ``divergence`` (check index: a fetched
  fingerprint copy disagrees) and ``supervisor_crash`` (attempt: a clean
  exit counts as a crash). The serving plane's: ``serve_overload``,
  ``serve_timeout``, ``replica_fail``, ``replica_wedge``,
  ``decode_wedge``, ``oom`` (``maybe_oom``: ``Trainer.step``, the
  Predictor's dispatch or the decode loop raises ``ResourceExhausted``),
  ``zoo_cold`` and ``canary_rollback``; the input path's
  ``worker_death`` and ``prefetch_death``; the fleet's (``fleet``,
  ``fleet_worker``): ``host_loss`` (fleet step index:
  ``fleet.maybe_host_loss`` exits ``EXIT_HOST_LOSS`` before that step's
  collectives, a sudden host death with no cleanup), ``coordinator_loss``
  (membership-check index: ``FleetMembership.check`` diagnoses host 0
  dead and raises loud with the board), ``rejoin_stall`` (host rank: that
  host stalls in ``fleet.init``, status ``stalled``, so its peers'
  bring-up deadline names it, then exits ``EXIT_REJOIN_STALL``) and
  ``straggler_slow`` (fleet step index: the fleet worker stalls before
  that step, billed to ``data.wait``, a slow host for the straggler
  sentinel to name).

The reference reads ``MXTPU_NUMERICS_GUARD``, ``MXTPU_LOSS_SCALE``,
``MXTPU_CKPT_RETRIES``, ``MXTPU_CKPT_KEEP``, ``MXTPU_DIVERGENCE_EVERY``,
``MXTPU_TRAIN_STEP_TIMEOUT_X``, ``MXTPU_POISON_STREAK``,
``MXTPU_SUPERVISOR_RESTARTS``/``_BACKOFF_S`` and ``MXTPU_FAULT_INJECT``;
the port reads no environment variable: each has a setter here (or a
``TrainSupervisor`` argument) whose default is the reference's.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import random as _pyrandom
import signal
import threading
import time

from . import telemetry
from .base import MXNetError

__all__ = ["guard_enabled", "default_loss_scale", "ckpt_retries",
           "ckpt_keep", "divergence_every", "train_step_timeout_x",
           "poison_streak", "set_guard", "set_loss_scale",
           "set_ckpt_retries", "set_ckpt_keep", "set_divergence_every",
           "set_train_step_timeout_x", "set_poison_streak",
           "DynamicLossScaler", "StepHealth", "CheckpointPolicy",
           "ResilientLoop", "set_faults", "inject", "reset_faults",
           "with_retries", "FAULT_STATS", "ResourceExhausted", "maybe_oom",
           "TrainWedgeError", "TrainStepWatchdog", "DivergenceError",
           "DivergenceSentinel", "PoisonBatchError", "SupervisorRefusal",
           "TrainSupervisor"]

_log = logging.getLogger("mxtpu_torch.resilience")

# ------------------------------------------------------------------ levers
_LEVERS = {"guard": False, "loss_scale": 2.0 ** 15, "ckpt_retries": 3,
           "ckpt_keep": 0, "divergence_every": 0, "timeout_x": 0.0,
           "poison_streak": 0}


def guard_enabled():
    """The numerics guard without a loss scaler (default off). Part of
    the captured update's key: a flip builds one graph."""
    return _LEVERS["guard"]


def set_guard(on):
    """The ``MXTPU_NUMERICS_GUARD=1`` lever."""
    _LEVERS["guard"] = bool(on)


def default_loss_scale():
    """A ``DynamicLossScaler``'s initial scale (default 2**15)."""
    return _LEVERS["loss_scale"]


def set_loss_scale(scale):
    """The ``MXTPU_LOSS_SCALE`` lever."""
    _LEVERS["loss_scale"] = float(scale)


def ckpt_retries():
    """Retries of a failed checkpoint write (default 3)."""
    return _LEVERS["ckpt_retries"]


def set_ckpt_retries(n):
    """The ``MXTPU_CKPT_RETRIES`` lever."""
    _LEVERS["ckpt_retries"] = int(n)


def ckpt_keep():
    """Finalized intact steps that ``save_trainer`` keeps (default 0: all)."""
    return _LEVERS["ckpt_keep"]


def set_ckpt_keep(n):
    """The ``MXTPU_CKPT_KEEP`` lever."""
    _LEVERS["ckpt_keep"] = int(n)


def divergence_every():
    """The divergence sentinel's cadence (default 0: off). Above 0 the
    captured update also writes the fingerprint (part of its key)."""
    return _LEVERS["divergence_every"]


def set_divergence_every(n):
    """The ``MXTPU_DIVERGENCE_EVERY`` lever."""
    _LEVERS["divergence_every"] = int(n)


def train_step_timeout_x():
    """The step watchdog's multiple of the rolling median (default 0:
    no watchdog at Trainer construction)."""
    return _LEVERS["timeout_x"]


def set_train_step_timeout_x(x):
    """The ``MXTPU_TRAIN_STEP_TIMEOUT_X`` lever."""
    _LEVERS["timeout_x"] = float(x)


def poison_streak():
    """Consecutive skipped steps that quarantine a batch (default 0:
    off)."""
    return _LEVERS["poison_streak"]


def set_poison_streak(n):
    """The ``MXTPU_POISON_STREAK`` lever."""
    _LEVERS["poison_streak"] = int(n)


# ---------------------------------------------------------- fault injection
FAULT_STATS = {"fired": []}
_FAULTS = {"spec": "", "faults": {}}
_FAULT_COUNTERS = {}


def _parse_faults(spec):
    """``{kind: {indices}}`` from a spec string (the reference's parser)."""
    faults = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise MXNetError(
                "MXTPU_FAULT_INJECT entry %r: expected kind@idx[,idx...]"
                % part)
        kind, idxs = part.split("@", 1)
        try:
            where = {int(s) for s in idxs.split(",") if s.strip()}
        except ValueError:
            raise MXNetError(
                "MXTPU_FAULT_INJECT entry %r: indices must be ints" % part)
        faults.setdefault(kind.strip(), set()).update(where)
    return faults


def set_faults(spec):
    """Schedule the faults of ``spec`` (empty or None: none) and restart
    the per-kind call counters, as a changed ``MXTPU_FAULT_INJECT`` does in
    the JAX package. A malformed spec raises here."""
    spec = spec or ""
    _FAULTS["faults"] = _parse_faults(spec)
    _FAULTS["spec"] = spec
    _FAULT_COUNTERS.clear()


def inject(kind, index=None):
    """True exactly once per scheduled (``kind``, ``index``); a firing
    dumps ``flight_record("fault")`` tagged with the current trace."""
    faults = _FAULTS["faults"]
    if index is None:
        index = _FAULT_COUNTERS.get(kind, 0)
        _FAULT_COUNTERS[kind] = index + 1
    where = faults.get(kind)
    if not where or index not in where:
        return False
    where.discard(index)
    FAULT_STATS["fired"].append((kind, index))
    telemetry.inc("faults.injected", tag=kind)
    ctx = telemetry.current_trace()
    telemetry.flight_record(
        "fault", trace_ids=[ctx.trace_id] if ctx is not None else [],
        extra={"kind": kind, "index": index})
    _log.warning("fault injected: %s@%d", kind, index)
    return True


def reset_faults():
    """Test hook: forget the schedule, its consumed faults and counters."""
    set_faults("")
    FAULT_STATS["fired"] = []


class ResourceExhausted(RuntimeError):
    """Injected device out-of-memory (fault kind ``oom``); the message
    carries the ``RESOURCE_EXHAUSTED`` prefix of the reference's."""


def maybe_oom(index=None):
    """Raise ``ResourceExhausted`` when the ``oom`` fault names this
    occurrence."""
    if inject("oom", index):
        raise ResourceExhausted(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            "(injected fault kind 'oom')")


# ------------------------------------------------------- step-wedge watchdog
class TrainWedgeError(MXNetError):
    """A ``Trainer.step`` stayed armed past its deadline; the flight
    artifact (``flight_record("train_wedge")``) is on disk by then."""


class TrainStepWatchdog:
    """Per-step wedge watchdog for ``Trainer.step`` (ref:
    resilience.py:TrainStepWatchdog): each step is bracketed by an armed
    entry whose deadline is the rolling median of completed steps times
    ``timeout_x`` (at least ``min_timeout_s``; none until ``min_samples``
    steps). ``start_monitor()`` scans on a thread; a trip dumps the
    artifact, counts ``train.wedges`` and makes the next arm or disarm on
    the training thread raise ``TrainWedgeError``. ``poll()`` scans now
    and raises; with an injected ``clock`` the matrix runs sleep-free.
    Fault kind ``train_wedge@step`` holds that step's entry armed."""

    def __init__(self, timeout_x=None, min_timeout_s=1.0, window=32,
                 min_samples=3, clock=None):
        self.timeout_x = train_step_timeout_x() if timeout_x is None \
            else float(timeout_x)
        self.min_timeout_s = float(min_timeout_s)
        self.min_samples = int(min_samples)
        self._durations = collections.deque(maxlen=int(window))
        self._clock = time.monotonic if clock is None else clock
        self._lock = threading.Lock()
        self._entries = []
        self._tripped = None
        self._monitor = None
        self._monitor_stop = None

    def baseline(self):
        """Rolling median of completed step times (None until
        ``min_samples``)."""
        with self._lock:
            if len(self._durations) < self.min_samples:
                return None
            vals = sorted(self._durations)
        return vals[len(vals) // 2]

    def deadline_s(self):
        base = self.baseline()
        if base is None or self.timeout_x <= 0:
            return None
        return max(base * self.timeout_x, self.min_timeout_s)

    def arm(self, step, trace_id=None):
        """Arm one step's entry (right before the step's work)."""
        self._check_poisoned()
        now = self._clock()
        bound = self.deadline_s()
        entry = {"step": int(step), "trace_id": trace_id, "t0": now,
                 "deadline": None if bound is None else now + bound,
                 "bound_s": bound, "tripped": False,
                 "held": inject("train_wedge", step)}
        with self._lock:
            self._entries.append(entry)
        return entry

    def disarm(self, entry):
        """Close the bracket; records the step's time and raises if this
        entry (or the watchdog) tripped."""
        now = self._clock()
        with self._lock:
            if entry["held"]:
                return   # an injected step that never returns stays armed
            if entry in self._entries:
                self._entries.remove(entry)
                if not entry["tripped"]:
                    self._durations.append(now - entry["t0"])
        self._check_poisoned()

    def poll(self):
        """Scan now; raises ``TrainWedgeError`` on a trip (after the
        artifact is written)."""
        tripped = self._scan()
        if tripped:
            raise TrainWedgeError(self._describe(tripped[0]))

    def _scan(self):
        now = self._clock()
        tripped = []
        with self._lock:
            for e in self._entries:
                if e["deadline"] is not None and not e["tripped"] \
                        and now > e["deadline"]:
                    e["tripped"] = True
                    tripped.append(e)
            for e in tripped:
                self._entries.remove(e)
        for e in tripped:
            self._trip(e, now)
        return tripped

    def _describe(self, e):
        return ("training step %d wedged: no completion within %.3fs "
                "(rolling baseline x %.1f); flight artifact dumped "
                "(reason=train_wedge)"
                % (e["step"], e["bound_s"] or -1.0, self.timeout_x))

    def _trip(self, e, now):
        from . import xprof
        self._tripped = e
        telemetry.inc("train.wedges")
        telemetry.flight_record(
            "train_wedge",
            trace_ids=[e["trace_id"]] if e["trace_id"] else [],
            extra={"step": e["step"], "elapsed_s": now - e["t0"],
                   "bound_s": e["bound_s"], "timeout_x": self.timeout_x,
                   "baseline_s": self.baseline(),
                   "ledger": xprof.ledger_snapshot(),
                   "memory": xprof._card_memory()})
        _log.error("%s", self._describe(e))

    def _check_poisoned(self):
        e = self._tripped
        if e is not None:
            raise TrainWedgeError(self._describe(e))

    def start_monitor(self, interval_s=0.25):
        """Scan on a daemon thread every ``interval_s`` (idempotent); the
        thread holds only a weak reference to the watchdog."""
        import weakref
        if self._monitor is not None and self._monitor.is_alive():
            return self
        stop = threading.Event()
        wref = weakref.ref(self)

        def loop():
            while not stop.wait(interval_s):
                wd = wref()
                if wd is None:
                    return
                try:
                    wd._scan()
                except Exception:  # noqa: BLE001 - the scan must never die
                    _log.exception("train-wedge monitor scan failed")
                del wd
        t = threading.Thread(target=loop, daemon=True,
                             name="mxtpu-torch-train-wedge-monitor")
        self._monitor, self._monitor_stop = t, stop
        t.start()
        return self

    def stop_monitor(self):
        if self._monitor_stop is not None:
            self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        self._monitor = None
        self._monitor_stop = None


# --------------------------------------------------- divergence sentinel
class DivergenceError(MXNetError):
    """The replicas' fingerprints of the replicated parameters and
    optimizer state disagree; the artifact (``flight_record("divergence")``)
    holds every copy."""


class DivergenceSentinel:
    """Compares the replicas' copies of the update's fingerprint (ref:
    resilience.py:DivergenceSentinel). ``check(fingerprint)`` takes the
    fingerprint's components (device scalars); with ``axis`` (a mesh
    axis) each is all-gathered over it first, one copy a rank; on one
    card there is one copy. One bounded fetch, at check cadence. Fault
    kind ``divergence@i`` appends a disagreeing copy."""

    def __init__(self, logger=None):
        self._log = logger or _log
        self.checks = 0

    @staticmethod
    def _copies(comp, axis):
        import numpy as np
        import torch
        t = comp if isinstance(comp, torch.Tensor) else torch.as_tensor(comp)
        if axis is not None and axis.size > 1:
            from .parallel.collectives import all_gather
            t = all_gather(t.reshape(1), axis)
            return list(enumerate(np.asarray(t.cpu()).reshape(-1)))
        return [(0, np.asarray(t.detach().cpu()))]

    def check(self, fingerprint, step=None, trace_ids=(), axis=None):
        """True when every copy agrees (or there is nothing to compare);
        raises ``DivergenceError`` after the artifact otherwise. Syncs on
        the fingerprint: call at check cadence."""
        if fingerprint is None:
            return True
        telemetry.inc("resilience.divergence_checks")
        self.checks += 1
        views = [[(d, v.tobytes()) for d, v in self._copies(c, axis)]
                 for c in fingerprint]
        if inject("divergence"):
            views[-1].append((-1, b"\xde\xad\xbe\xef"))
        if all(len({b for _, b in comp}) <= 1 for comp in views):
            return True
        detail = {"step": step,
                  "fingerprints": [[(d, b.hex()) for d, b in comp]
                                   for comp in views]}
        telemetry.flight_record("divergence", trace_ids=list(trace_ids),
                                extra=detail)
        msg = ("cross-replica divergence: per-device fingerprints of the "
               "replicated params/optimizer state disagree%s; flight "
               "artifact dumped (reason=divergence). Restore from the last "
               "intact checkpoint." % ("" if step is None else
                                       " at check %s" % step))
        self._log.error("%s", msg)
        raise DivergenceError(msg)


class PoisonBatchError(MXNetError):
    """``poison_streak`` consecutive skipped steps: the data is poisoning
    every step; the quarantine ring and artifact hold the steps."""


# ------------------------------------------------------------------ retries
_BACKOFF = {"pid": None, "rng": None}


def _process_rng():
    """A jitter generator per process, seeded from the pid (resolved
    afresh in a forked child)."""
    pid = os.getpid()
    if _BACKOFF["pid"] != pid:
        _BACKOFF["pid"] = pid
        _BACKOFF["rng"] = _pyrandom.Random(pid * 2654435761 + 17)
    return _BACKOFF["rng"]


def _next_backoff(rng, base, prev, cap):
    """Decorrelated jitter: uniform in [base, 3 prev], capped."""
    return min(cap, rng.uniform(base, max(base, prev * 3.0)))


def with_retries(fn, what, retries=None, backoff=0.25, logger=None,
                 exceptions=(Exception,), metric=None, sleeper=None,
                 rng=None, max_backoff=None):
    """Run ``fn`` with bounded retry-with-backoff (ref:
    resilience.py:with_retries): ``retries`` more tries (default
    ``ckpt_retries()``), the first after ``backoff`` s, later ones after
    decorrelated jitter capped at ``max_backoff`` (default 64 backoff);
    the last failure re-raises. Counts ``retry.total`` and ``metric``."""
    retries = ckpt_retries() if retries is None else int(retries)
    retries = max(0, retries)
    sleeper = time.sleep if sleeper is None else sleeper
    rng = _process_rng() if rng is None else rng
    cap = backoff * 64.0 if max_backoff is None else float(max_backoff)
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:
            if attempt == retries:
                raise
            telemetry.inc("retry.total")
            if metric:
                telemetry.inc(metric)
            (logger or _log).warning(
                "%s failed (%s: %s); retry %d/%d in %.2fs", what,
                type(e).__name__, e, attempt + 1, retries, delay)
            sleeper(delay)
            delay = _next_backoff(rng, backoff, delay, cap)


# --------------------------------------------------------------- loss scaler
class DynamicLossScaler:
    """Dynamic loss scaling driven by the numerics guard (ref:
    resilience.py:DynamicLossScaler).

    The scale (float32) and the good-step streak (int32) are device
    scalars made at first use on the loss's (or the update's) device and
    updated in place by the captured update: on a non-finite step the
    scale backs off by ``backoff_factor``; after ``growth_interval``
    consecutive good steps it grows by ``growth_factor``, clamped to
    [min_scale, max_scale]. ``config()`` is the static tuple in the
    graph's key; the scale's value is read by the graph at each replay::

        scaler = resilience.DynamicLossScaler()
        trainer = gluon.Trainer(params, "sgd", {...}, loss_scaler=scaler)
        with autograd.record():
            loss = scaler.scale(loss_fn(net(x), y))
        loss.backward()
        trainer.step(batch)     # unscaled and guarded in the update

    ``state_dict``/``load_state_dict`` ride the optimizer state blob."""

    def __init__(self, init_scale=None, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000,
                 max_scale=2.0 ** 24, min_scale=1.0):
        self._init = (default_loss_scale() if init_scale is None
                      else float(init_scale))
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.max_scale = float(max_scale)
        self.min_scale = float(min_scale)
        self._scale = None
        self._streak = None
        self._loaded = None   # (scale, streak) loaded before the scalars exist

    def config(self):
        """The static policy tuple (part of the captured update's key)."""
        return (self.growth_factor, self.backoff_factor,
                self.growth_interval, self.max_scale, self.min_scale)

    def _ensure(self, device=None):
        """The scalars, made on ``device`` at first use (default: the
        current context's device), moved once if asked for elsewhere."""
        import torch
        if device is None:
            from .context import default_device
            device = default_device() if self._scale is None \
                else self._scale.device
        device = torch.device(device)
        if self._scale is None:
            scale, streak = self._loaded or (self._init, 0)
            self._loaded = None
            self._scale = torch.full((), scale, dtype=torch.float32,
                                     device=device)
            self._streak = torch.full((), streak, dtype=torch.int32,
                                      device=device)
        elif self._scale.device != device:
            self._scale = self._scale.to(device)
            self._streak = self._streak.to(device)
        return self._scale

    def scale_array(self):
        """The live scale as a device scalar (no sync)."""
        return self._ensure()

    def scale_value(self):
        """The live scale as a float (syncs)."""
        return float(self.scale_array())

    def scale(self, loss):
        """``loss * scale`` in float32 (a float16/bfloat16 loss is cast
        first, as the reference's multiply promotes), recorded like any
        op: the gradients come out scale times too large and the guarded
        update divides the scale back out."""
        import torch
        from .ndarray import NDArray
        s = self._ensure(loss._data.device)
        if loss._data.dtype != torch.float32:
            loss = loss.astype("float32")
        return loss * NDArray(s)

    def host_update(self, ok):
        """The same growth/backoff rule driven by a host bool (the guarded
        eager path); device arithmetic, in place."""
        import torch
        self._ensure()
        with torch.no_grad():
            if ok:
                self._streak.add_(1)
                grow = self._streak >= self.growth_interval
                grown = torch.clamp(self._scale * self.growth_factor,
                                    self.min_scale, self.max_scale)
                self._scale.copy_(torch.where(grow, grown, self._scale))
                self._streak.copy_(torch.where(
                    grow, torch.zeros_like(self._streak), self._streak))
            else:
                self._scale.copy_(torch.clamp(
                    self._scale * self.backoff_factor, self.min_scale,
                    self.max_scale))
                self._streak.zero_()

    def state_dict(self):
        import numpy as np
        if self._scale is None:
            scale, streak = self._loaded or (self._init, 0)
            return {"scale": np.float32(scale), "streak": np.int32(streak),
                    "config": (self._init,) + self.config()}
        return {"scale": np.asarray(self._scale.detach().cpu()),
                "streak": np.asarray(self._streak.detach().cpu()),
                "config": (self._init,) + self.config()}

    def load_state_dict(self, state):
        """Take a state dict's scale and streak (in place: a captured
        update keeps reading the same storage; kept for the first use when
        the scalars do not exist yet)."""
        scale, streak = float(state["scale"]), int(state["streak"])
        if self._scale is None:
            self._loaded = (scale, streak)
            return
        self._scale.fill_(scale)
        self._streak.fill_(streak)

    @classmethod
    def from_state_dict(cls, state):
        init, gf, bf, gi, mx, mn = state["config"]
        scaler = cls(init_scale=init, growth_factor=gf, backoff_factor=bf,
                     growth_interval=gi, max_scale=mx, min_scale=mn)
        scaler.load_state_dict(state)
        return scaler


# ------------------------------------------------------------------- health
class StepHealth:
    """Ring of per-step (step, step_ok, grad_norm) device scalars (ref:
    resilience.py:StepHealth): appended by the guarded update, fetched
    only when a reader asks, in one transfer."""

    def __init__(self, maxlen=4096):
        self._buf = collections.deque(maxlen=maxlen)

    def append(self, step, ok, grad_norm):
        self._buf.append((step, ok, grad_norm))

    def __len__(self):
        return len(self._buf)

    def steps(self):
        return [s for s, _, _ in self._buf]

    @staticmethod
    def _fetch(values):
        """Device or host scalars to floats, in one transfer."""
        import torch
        values = list(values)
        if not values:
            return []
        ts = [v.detach().reshape(()).float() if isinstance(v, torch.Tensor)
              else torch.tensor(float(v)) for v in values]
        dev = next((t.device for t in ts if t.device.type != "cpu"), None)
        if dev is not None:
            ts = [t.to(dev) for t in ts]
        return torch.stack(ts).cpu().tolist()

    def ok_history(self):
        """The step_ok flags (one sync)."""
        return [bool(ok) for ok in self._fetch(o for _, o, _ in self._buf)]

    def grad_norm_history(self):
        return [float(g) for g in self._fetch(g for _, _, g in self._buf)]

    def drain(self):
        """Pop everything buffered as [(step, ok, grad_norm)] (one sync)."""
        buf = list(self._buf)
        self._buf.clear()
        vals = self._fetch(x for _, o, g in buf for x in (o, g))
        return [(s, bool(vals[2 * k]), float(vals[2 * k + 1]))
                for k, (s, _, _) in enumerate(buf)]

    def clear(self):
        self._buf.clear()


# -------------------------------------------------------------- checkpoints
class CheckpointPolicy:
    """When and how ``ResilientLoop`` checkpoints: ``every_steps`` and/or
    ``every_secs``; ``retries`` (default ``ckpt_retries()``) and
    ``backoff`` bound the retries; ``async_save`` writes on a thread
    while training continues."""

    def __init__(self, directory, every_steps=None, every_secs=None,
                 async_save=True, retries=None, backoff=0.25):
        self.directory = str(directory)
        self.every_steps = every_steps
        self.every_secs = every_secs
        self.async_save = bool(async_save)
        self.retries = retries
        self.backoff = float(backoff)

    def due(self, step, last_save_step, last_save_time):
        if self.every_steps and step - last_save_step >= self.every_steps:
            return True
        if self.every_secs and \
                time.monotonic() - last_save_time >= self.every_secs:
            return True
        return False


def _sigterm_postmortem():
    """Flight-record the SIGTERM and flush the sink (off the handler)."""
    telemetry.flight_record("sigterm")
    telemetry.flush()


class ResilientLoop:
    """Preemption-safe training loop around a gluon Trainer (ref:
    resilience.py:ResilientLoop): a SIGTERM handler that sets
    ``preempted`` (the step boundary writes a final checkpoint and stops;
    ``flight_record("sigterm")`` is dumped off the handler), interval
    checkpoints with bounded retries, an atomic ``latest.json``, and a
    tiered bit-exact ``resume`` of parameters, optimizer states, the loss
    scaler and the generators::

        loop = resilience.ResilientLoop(trainer, CheckpointPolicy(
            "/ckpt/run1", every_steps=100))
        start = loop.resume()            # 0 on a fresh directory
        loop.run(step_fn, num_steps, start_step=start)
    """

    def __init__(self, trainer, policy, signals=(signal.SIGTERM,),
                 logger=None):
        self._trainer = trainer
        self._policy = policy
        self._signals = tuple(signals)
        self._log = logger or _log
        self._prev_handlers = {}
        self._installed = False
        self.preempted = False
        self.last_saved_step = None
        self._last_save_step = -1
        self._last_save_time = time.monotonic()
        self._last_ckptr = None
        self._step = 0

    def install(self):
        """Install the signal handlers (idempotent; the main thread only,
        elsewhere set ``loop.preempted = True`` by hand)."""
        if self._installed:
            return self
        try:
            for sig in self._signals:
                self._prev_handlers[sig] = signal.signal(sig,
                                                         self._on_signal)
            self._installed = True
        except ValueError:
            self._log.warning(
                "ResilientLoop: cannot install signal handlers off the main "
                "thread; set loop.preempted=True manually to request a stop")
        return self

    def uninstall(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers = {}
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _on_signal(self, signum, frame):
        self.preempted = True
        threading.Thread(target=_sigterm_postmortem, daemon=True,
                         name="mxtpu-torch-flight-sigterm").start()

    def save(self, step, final=False):
        """Checkpoint now with bounded retries. An interval save that
        fails every retry logs and training goes on; ``final=True`` waits
        for the write and re-raises."""
        from .contrib import async_checkpoint as ackpt

        def _save():
            ck = ackpt.save_trainer(
                self._trainer, self._policy.directory, step=step,
                async_save=self._policy.async_save and not final, force=True)
            if final and hasattr(ck, "wait_until_finished"):
                ck.wait_until_finished()
            return ck

        try:
            self._last_ckptr = with_retries(
                _save, "checkpoint save (step %d)" % step,
                retries=(ckpt_retries() if self._policy.retries is None
                         else self._policy.retries),
                backoff=self._policy.backoff, logger=self._log,
                metric="retry.checkpoint_save")
        except Exception as e:
            if final:
                raise
            self._log.error(
                "checkpoint at step %d failed after retries (%s: %s); "
                "training continues, the previous checkpoint stays latest",
                step, type(e).__name__, e)
            self._last_save_step = step
            self._last_save_time = time.monotonic()
            return False
        self._write_latest(step)
        self._last_save_step = step
        self._last_save_time = time.monotonic()
        self.last_saved_step = step
        return True

    def wait_for_pending(self):
        """Block until the last asynchronous write is finalized."""
        if self._last_ckptr is not None and \
                hasattr(self._last_ckptr, "wait_until_finished"):
            self._last_ckptr.wait_until_finished()

    def _write_latest(self, step):
        """``latest.json`` by a pid-unique temporary file and a rename."""
        directory = self._policy.directory
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "latest.json")
        tmp = "%s.%d.tmp" % (path, os.getpid())
        with open(tmp, "w") as f:
            f.write(json.dumps({"step": int(step)}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def latest_step(self):
        """Newest resumable step (None on a fresh directory)."""
        from .contrib import async_checkpoint as ackpt
        return ackpt.latest_step(self._policy.directory)

    def resume(self):
        """Restore the newest intact checkpoint (tiered: a corrupt step is
        tombstoned and the one before it tried) and return the step to
        continue from (0 on a fresh directory)."""
        from .contrib import async_checkpoint as ackpt
        step = ackpt.load_trainer_fallback(self._trainer,
                                           self._policy.directory)
        if step is None:
            return 0
        self._step = step + 1
        self._last_save_step = step
        self._log.info("resumed from checkpoint step %d", step)
        return step + 1

    def after_step(self, step):
        """Once per completed step: fault injection, interval saves and
        the preemption save. True when the loop should stop."""
        self._step = step + 1
        if inject("sigterm", step):
            os.kill(os.getpid(), signal.SIGTERM)
        if self.preempted:
            self._log.warning("preemption signal received: writing final "
                              "checkpoint at step %d", step)
            self.save(step, final=True)
            return True
        if self._policy.due(step, self._last_save_step,
                            self._last_save_time):
            self.save(step)
        return False

    def run(self, step_fn, num_steps, start_step=None):
        """``step_fn(step)`` for ``range(start, num_steps)`` with the
        handlers installed; returns the last step run."""
        start = self._step if start_step is None else int(start_step)
        last = start - 1
        with self:
            for step in range(start, num_steps):
                step_fn(step)
                last = step
                if self.after_step(step):
                    break
        return last


# -------------------------------------------------- crash-resume supervisor
class SupervisorRefusal(MXNetError):
    """The supervisor will not respawn: the same checkpoint step crashed
    twice, or the crash-loop budget is spent; the message is the
    diagnosis and ``flight_record("supervisor_refusal")`` is on disk."""


def _refuse(diagnosis, history, logger=None):
    telemetry.flight_record(
        "supervisor_refusal",
        extra={"diagnosis": diagnosis, "history": list(history)})
    (logger or _log).error("supervisor refusal: %s", diagnosis)
    return SupervisorRefusal(diagnosis)


class TrainSupervisor:
    """Crash-resume supervisor around a training command (ref:
    resilience.py:TrainSupervisor): respawns ``argv`` on a nonzero exit
    with decorrelated-jitter backoff under a crash-loop budget
    (``max_restarts``, default 8; ``backoff_s`` default 2.0: the
    reference's ``MXTPU_SUPERVISOR_RESTARTS``/``_BACKOFF_S``), counting
    ``supervisor.restarts{reason}``; refuses when the newest intact
    checkpoint step is the same at two crashes in a row.
    ``spawn``/``clock``/``sleeper``/``rng`` may be injected."""

    MAX_RESTARTS = 8   # the crash-loop budget (``FleetSupervisor``'s too)
    BACKOFF_S = 2.0    # the first respawn's wait

    def __init__(self, argv, ckpt_dir=None, max_restarts=None,
                 backoff_s=None, max_backoff_s=60.0, spawn=None,
                 clock=None, sleeper=None, rng=None, logger=None):
        self.argv = list(argv)
        if not self.argv:
            raise MXNetError("TrainSupervisor needs a non-empty command")
        self.ckpt_dir = ckpt_dir
        self.max_restarts = self.MAX_RESTARTS if max_restarts is None \
            else int(max_restarts)
        self.backoff_s = self.BACKOFF_S if backoff_s is None \
            else float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._spawn = self._default_spawn if spawn is None else spawn
        self._clock = time.monotonic if clock is None else clock
        self._sleeper = time.sleep if sleeper is None else sleeper
        self._rng = rng
        self._log = logger or _log
        self.restarts = 0
        self.history = []   # [(attempt, exit_code, resume_step, delay_s)]

    @staticmethod
    def _default_spawn(argv):
        import subprocess
        return subprocess.call(argv)

    def _latest(self):
        if self.ckpt_dir is None:
            return None
        from .contrib import async_checkpoint as ackpt
        try:
            return ackpt.latest_step(self.ckpt_dir)
        except Exception:  # noqa: BLE001 - a broken dir reads as fresh
            return None

    def run(self):
        """Drive the child until a clean exit (0) or a refusal."""
        delay = self.backoff_s
        prev_crash_step = ()
        attempt = 0
        while True:
            resume_step = self._latest()
            self._log.info(
                "supervisor: launching attempt %d (resume step %s): %s",
                attempt, resume_step, " ".join(self.argv))
            rc = self._spawn(self.argv)
            reason = "crash"
            if rc == 0:
                if inject("supervisor_crash", attempt):
                    rc, reason = 1, "injected"
                else:
                    self._log.info("supervisor: clean exit after %d "
                                   "restart(s)", self.restarts)
                    return 0
            crash_step = self._latest()
            self.history.append((attempt, rc, crash_step, delay))
            if crash_step is not None and crash_step == prev_crash_step:
                raise _refuse(
                    "the child crashed twice at checkpoint step %s with "
                    "ZERO progress in between (exit code %d): a "
                    "deterministic poison-crash, not a transient fault. "
                    "Refusing to respawn: inspect the flight artifacts and "
                    "quarantine ring for the poisoned step before "
                    "restarting by hand." % (crash_step, rc),
                    self.history, self._log)
            if self.restarts >= self.max_restarts:
                raise _refuse(
                    "crash-loop budget spent: %d restarts with the child "
                    "still dying (last exit code %d, last checkpoint step "
                    "%s); refusing to flap further"
                    % (self.restarts, rc, crash_step),
                    self.history, self._log)
            prev_crash_step = crash_step
            self.restarts += 1
            attempt += 1
            telemetry.inc("supervisor.restarts", tag=reason)
            self._log.warning(
                "supervisor: child exited %d (checkpoint step %s); respawn "
                "%d/%d in %.2fs", rc, crash_step, self.restarts,
                self.max_restarts, delay)
            self._sleeper(delay)
            delay = _next_backoff(self._rng or _process_rng(),
                                  self.backoff_s, delay, self.max_backoff_s)
