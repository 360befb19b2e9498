"""Dynamic micro-batching (counterpart of ``mxtpu/serving/batcher.py``):
coalesce requests into bucketed device batches.

A bounded FIFO queue; a cohort dispatches when ``max_batch_size`` items
wait or when its head has waited ``max_wait_ms``, whichever comes first,
as ONE padded bucket through the Predictor (``predict_flat``).

* **FIFO within bucket**: requests run in arrival order among those that
  share a sequence bucket; a request of another bucket waits for its own
  cohort.
* **Priority classes**: ``interactive`` takes the coalescing slot before
  ``batch``, whose head still dispatches once it has waited
  ``batch_aging_ms``; under queue pressure the newest batch-class entries
  are evicted to admit interactive work.
* **Admission**: ``submit`` validates the request against the Predictor's
  templates (``MXNetError``, a 400 at the HTTP front) and sheds on a full
  queue or while draining (:class:`QueueFull`, a 503).
* **Deadlines**: a request whose deadline passed while it queued completes
  with :class:`DeadlineExceeded` at dispatch (a 504).
* **Faults**: ``serve_timeout`` (batch index: the batch expires) and
  ``serve_overload`` (submit index: the submit sheds), scheduled with
  ``resilience.set_faults``.
* **SLO control plane**: with a
  :class:`~mxtpu_torch.serving.controller.ServingController` attached
  (``attach_controller``), a submit whose predicted completion misses its
  deadline sheds ``predicted_miss``; every shed, eviction and expiry is
  reported to it, and every delivery feeds its latency model with the
  request's stage breakdown and ``meta`` (the zoo's tenant stamp).
* **Testable time**: the clock is injected (``clock=``); a stopped batcher
  (``start=False``) dispatches only through :meth:`poll`.

Only the worker thread touches the device: request threads hand over host
arrays, the worker joins a cohort on the host, runs it, fetches the
outputs once per batch and splits them per request. The defaults of
``max_batch_size`` (8), ``max_wait_ms`` (5), ``max_queue`` (256 items) and
``batch_aging_ms`` (1000) are those of the reference's ``MXTPU_SERVE_*``
levers; the port reads no environment variable. ``admission_gate`` is the
hook a resource ledger sheds through beyond queue depth (the decode
engine's ``KVCacheAccountant.gate``: ``serving.shed{kv_residency}``). A
worker crash dumps ``flight_record("worker_crash")`` with the failed
requests' traces.

Telemetry: ``serving.requests`` / ``serving.batches`` /
``serving.shed{reason}`` / ``serving.deadline_expired`` counters, the
``serving.queue_depth`` gauge, the ``serving.batch_fill`` and
``serving.latency_s`` histograms, and the ``serving.submit``,
``serving.pad``, ``serving.predict``, ``serving.fetch`` and
``serving.deliver`` spans and trace stages.
"""
from __future__ import annotations

import collections
import logging
import threading
import time

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..resilience import inject

__all__ = ["MicroBatcher", "QueueFull", "DeadlineExceeded", "PRIORITIES",
           "MAX_BATCH", "MAX_WAIT_MS", "MAX_QUEUE", "BATCH_AGING_MS"]

_log = logging.getLogger("mxtpu_torch.serving")

# the reference's MXTPU_SERVE_MAX_BATCH, _MAX_WAIT_MS, _QUEUE and
# _BATCH_AGING_MS defaults
MAX_BATCH = 8
MAX_WAIT_MS = 5.0
MAX_QUEUE = 256
BATCH_AGING_MS = 1000.0

# interactive wins the coalescing slot; batch is the first to shed and
# dispatches only when no interactive cohort is ready or it has aged
PRIORITIES = ("interactive", "batch")


class QueueFull(MXNetError):
    """Request shed at admission (queue full, draining, injected overload).
    The HTTP front maps this to 503."""


class DeadlineExceeded(MXNetError):
    """The request's deadline passed before its batch dispatched (or the
    ``serve_timeout`` fault fired). The HTTP front maps this to 504."""


class _Future:
    """Completion handle (an event and a value or an error). Delivery also
    attaches the request's ``trace_id``, its per-stage ``breakdown``
    (``{stage: seconds}``) and ``e2e_s``."""

    __slots__ = ("_event", "_value", "_error", "trace_id", "breakdown",
                 "e2e_s")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None
        self.trace_id = None
        self.breakdown = None
        self.e2e_s = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise DeadlineExceeded("no result within %ss" % timeout)
        if self._error is not None:
            raise self._error
        return self._value


class _Request:
    __slots__ = ("inputs", "n", "bucket_key", "deadline", "t_enq", "future",
                 "redispatched", "trace", "priority", "meta")

    def __init__(self, inputs, n, bucket_key, deadline, t_enq, trace=None,
                 priority="interactive", meta=None):
        self.inputs = inputs
        self.n = n
        self.bucket_key = bucket_key
        self.deadline = deadline
        self.t_enq = t_enq
        self.priority = priority
        # attribution handed to the controller with this request's verdict
        # (the zoo stamps model, tenant and version)
        self.meta = meta
        self.future = _Future()
        # set when a wedge-watchdog trip re-enqueues this request on a
        # healthy replica: re-dispatch happens exactly once (replicas.py)
        self.redispatched = False
        # the request's trace: made at submit on the caller's thread and
        # handed to whichever worker runs its cohort
        self.trace = trace


def _host(a):
    """A request input as a host array or CPU tensor (bfloat16 has no
    numpy type, so a bf16 tensor stays a tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    if hasattr(a, "asnumpy"):
        return _host(a.to_torch())
    return np.asarray(a)


class MicroBatcher:
    """See the module docstring. ``predictor`` is a warmed
    :class:`~mxtpu_torch.serving.engine.Predictor` (or anything with
    ``predict_flat``); ``start=False`` leaves the worker thread off so
    tests drive dispatch through :meth:`poll`."""

    def __init__(self, predictor, max_batch_size=MAX_BATCH,
                 max_wait_ms=MAX_WAIT_MS, max_queue=MAX_QUEUE,
                 clock=time.monotonic, start=True, allow_cold=False,
                 admission_gate=None, batch_aging_ms=BATCH_AGING_MS):
        self._pred = predictor
        # called with the request's item count: a shed reason to refuse,
        # None to admit; the unit is the gate's (the accountant's
        # register() decides worst-case rows or free pages)
        self._gate = admission_gate
        self.max_batch = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.batch_aging_s = float(batch_aging_ms) / 1e3
        self._clock = clock
        self._q = collections.deque()
        self._items = 0
        self._cond = threading.Condition()
        self._draining = False
        self._closed = False
        self._crashed = False  # the worker died on an unexpected exception
        self._batch_index = 0
        self._inflight = 0     # popped, not yet delivered: drain waits
        self._thread = None
        self._controller = None  # the SLO control plane, when attached
        if start:
            if not allow_cold and not getattr(predictor, "warmed", True):
                raise MXNetError(
                    "MicroBatcher(start=True) on a cold Predictor: call "
                    "predictor.warmup() first (or pass allow_cold=True)")
            self.start()

    # ------------------------------------------------------------- admission
    def attach_controller(self, controller):
        """Wire the SLO control plane in (``ServingController.__init__``
        does it): admission consults ``controller.admit``, delivery feeds
        ``controller.observe``, sheds and expiries its pressure signals.
        Returns self."""
        self._controller = controller
        return self

    def submit(self, inputs, deadline_ms=None, priority="interactive",
               meta=None):
        """Enqueue one request: an array or a tuple of arrays sharing batch
        axis 0, kept on the host until dispatch. Returns a future; raises
        :class:`QueueFull` when shed and ``MXNetError`` when malformed.
        ``priority`` is ``interactive`` or ``batch``; ``meta`` is an opaque
        attribution dict handed to the controller with the request's
        verdict. Each admitted request starts a trace here, whose stage
        breakdown comes back on the future."""
        trace = telemetry.new_trace()
        t0 = time.perf_counter()
        with telemetry.trace_handoff(trace), \
                telemetry.span("serving.submit"):
            req = self._admit(inputs, deadline_ms, trace, priority, meta)
        telemetry.add_stage(trace, "serving.submit",
                            time.perf_counter() - t0)
        return req.future

    def _admit(self, inputs, deadline_ms, trace, priority="interactive",
               meta=None):
        if priority not in PRIORITIES:
            raise MXNetError("submit: unknown priority %r (expected one "
                             "of %s)" % (priority, "|".join(PRIORITIES)))
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        if getattr(inputs[0], "ndim", 0) < 1:
            raise MXNetError("submit: request inputs need a batch axis")
        n = int(inputs[0].shape[0])
        if n < 1:
            raise MXNetError("submit: empty request")
        if n > self.max_batch:
            raise MXNetError(
                "submit: request of %d items exceeds max_batch_size=%d — "
                "chunk large offline batches through Predictor.predict"
                % (n, self.max_batch))
        spec = getattr(self._pred, "spec", None)
        self._validate_shapes(inputs, spec)
        bucket_key = None
        if spec is not None and spec.seq_lens is not None:
            bucket_key = spec.seq_bucket(
                int(inputs[0].shape[spec.seq_axis])
                if inputs[0].ndim > spec.seq_axis else 0)
        if inject("serve_overload"):
            self._shed("injected_overload")
        if self._gate is not None:
            reason = self._gate(n)
            if reason:
                self._shed(str(reason))
        if self._controller is not None:
            # predictive admission: shed now when the latency model already
            # predicts a deadline miss, before the depth bound fills
            queued_ahead = sum(r.n for r in list(self._q)
                               if r.bucket_key == bucket_key)
            reason = self._controller.admit(
                n, bucket_key,
                None if deadline_ms is None else deadline_ms / 1e3,
                priority, queued_ahead=queued_ahead)
            if reason:
                telemetry.trace_mark(trace, "serving.controller.shed")
                self._shed(str(reason))
        now = self._clock()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        req = _Request(inputs, n, bucket_key, deadline, now, trace,
                       priority, meta)
        evicted, shed_reason = (), None
        with self._cond:
            if self._crashed:
                shed_reason = "worker_crashed"
            elif self._draining or self._closed:
                shed_reason = "draining"
            else:
                if self._items + n > self.max_queue:
                    # sweep entries whose deadline already passed before
                    # shedding fresh work for an answer nobody awaits
                    self._sweep_expired_locked(now)
                if self._items + n > self.max_queue \
                        and priority == "interactive":
                    evicted = self._evict_batch_locked(n)
                if self._items + n > self.max_queue:
                    shed_reason = "queue_full"
                else:
                    self._q.append(req)
                    self._items += n
                    telemetry.gauge("serving.queue_depth", self._items)
                    self._cond.notify()
        # victims complete before any shed raise: an eviction never
        # strands a future
        for victim in evicted:
            self._fail(victim, QueueFull(
                "request shed: priority_evict (batch-class entry evicted "
                "for interactive admission)"))
        if shed_reason is not None:
            self._shed(shed_reason)
        telemetry.inc("serving.requests")
        return req

    def _sweep_expired_locked(self, now):
        """Drop queued requests whose deadline passed (each completes with
        :class:`DeadlineExceeded`, as at dispatch)."""
        for r in [r for r in self._q
                  if r.deadline is not None and now > r.deadline]:
            self._q.remove(r)
            self._items -= r.n
            self._expire(r)
        telemetry.gauge("serving.queue_depth", self._items)

    def _evict_batch_locked(self, need):
        """Remove the newest batch-class entries until ``need`` more items
        fit; evicts nothing when even evicting all of them would not make
        room. Returns the victims."""
        evictable = sum(r.n for r in self._q if r.priority == "batch")
        if self._items - evictable + need > self.max_queue:
            return []
        victims = []
        for r in [r for r in reversed(self._q) if r.priority == "batch"]:
            if self._items + need <= self.max_queue:
                break
            self._q.remove(r)
            self._items -= r.n
            victims.append(r)
            telemetry.inc("serving.shed", tag="priority_evict")
        if victims:
            telemetry.gauge("serving.queue_depth", self._items)
            if self._controller is not None:
                self._controller.note_shed("priority_evict", self._clock())
        return victims

    def _validate_shapes(self, inputs, spec):
        """Refuse a malformed request at admission (a 400) rather than
        fail its whole cohort or build an off-template bucket."""
        templates = getattr(self._pred, "input_templates", None)
        if templates is None:
            return
        if len(inputs) != len(templates):
            raise MXNetError(
                "submit: model takes %d input(s), request has %d"
                % (len(templates), len(inputs)))
        seq_axis = spec.seq_axis if spec is not None and \
            spec.seq_lens is not None else None
        for i, (a, (trail, _dt)) in enumerate(zip(inputs, templates)):
            if a.ndim != len(trail) + 1:
                raise MXNetError(
                    "submit: input %d has %d dims, model expects %d"
                    % (i, a.ndim, len(trail) + 1))
            for ax in range(1, a.ndim):
                if ax == seq_axis:
                    continue  # the bucketed axis: seq_bucket checks it
                if a.shape[ax] != trail[ax - 1]:
                    raise MXNetError(
                        "submit: input %d axis %d is %d, model expects %d"
                        % (i, ax, a.shape[ax], trail[ax - 1]))

    def _shed(self, reason):
        telemetry.inc("serving.shed", tag=reason)
        if self._controller is not None:
            self._controller.note_shed(reason, self._clock())
        raise QueueFull("request shed: %s" % reason)

    @property
    def queue_depth(self):
        return self._items

    def queue_depths(self):
        """Queued items per priority class (the controller's ``/healthz``
        view)."""
        out = dict.fromkeys(PRIORITIES, 0)
        with self._cond:
            for r in self._q:
                out[r.priority] += r.n
        return out

    @property
    def draining(self):
        return self._draining

    # ------------------------------------------------------------ coalescing
    def _lead_locked(self, now):
        """``(lead, yielded)``: the request whose cohort dispatches next
        (the first interactive one in FIFO order, unless the batch-class
        head has aged past ``batch_aging_s``) and the batch-class head an
        interactive lead jumps, if any."""
        first_inter = first_batch = None
        for r in self._q:
            if r.priority == "batch":
                if first_batch is None:
                    first_batch = r
            elif first_inter is None:
                first_inter = r
            if first_inter is not None and first_batch is not None:
                break
        if first_inter is None:
            return first_batch, None
        if first_batch is None:
            return first_inter, None
        if (now - first_batch.t_enq) >= self.batch_aging_s:
            return first_batch, None
        yielded = first_batch if self._q[0] is first_batch else None
        return first_inter, yielded

    def _gather_locked(self, now):
        """The coalescing rule, under the lock: the lead's bucket cohort in
        FIFO order up to ``max_batch`` items, taken when full, when the
        lead waited ``max_wait_s``, or when draining; None to keep
        waiting."""
        if not self._q:
            return None
        lead, yielded = self._lead_locked(now)
        take, n = [], 0
        for r in self._q:
            if r.bucket_key != lead.bucket_key:
                continue  # FIFO within bucket: other cohorts keep queueing
            if n + r.n > self.max_batch:
                break
            take.append(r)
            n += r.n
            if n == self.max_batch:
                break
        if n >= self.max_batch or self._draining or \
                (now - lead.t_enq) >= self.max_wait_s:
            if yielded is not None and yielded not in take:
                telemetry.inc("serving.controller.decisions", tag="yield")
                telemetry.trace_mark(yielded.trace,
                                     "serving.controller.yield")
            for r in take:
                self._q.remove(r)
            self._items -= n
            telemetry.gauge("serving.queue_depth", self._items)
            return take
        return None

    def poll(self):
        """Dispatch at most one coalesced batch if the rule allows it now
        (non-blocking). Returns the number of requests dispatched."""
        with self._cond:
            batch = self._gather_locked(self._clock())
            if batch:
                self._inflight += len(batch)
        if not batch:
            return 0
        try:
            self._dispatch(batch)
        finally:
            with self._cond:
                self._inflight -= len(batch)
                self._cond.notify_all()
        return len(batch)

    # -------------------------------------------------------------- dispatch
    def _dispatch(self, batch):
        idx = self._batch_index
        self._batch_index += 1
        now = self._clock()
        live = []
        for r in batch:
            # the queue wait is an interval between threads, credited
            # from the injected clock so fake-clock tests see exact waits
            telemetry.add_stage(r.trace, "serving.queue_wait",
                                max(0.0, now - r.t_enq), event=True)
            if r.deadline is not None and now > r.deadline:
                self._expire(r)
            else:
                live.append(r)
        if live and inject("serve_timeout", idx):
            for r in live:
                self._expire(r)
            live = []
        if not live:
            return
        # the worker adopts the cohort lead's trace for the batch-level
        # stages; every member gets their durations in its breakdown
        with telemetry.trace_handoff(live[0].trace):
            for r in live[1:]:
                telemetry.link(r.trace, "serving.cohort")
            t0 = time.perf_counter()
            try:
                with telemetry.span("serving.pad"):
                    joined = self._join(live)
            except Exception as e:  # noqa: BLE001 — bad batch must not kill
                self._fail_batch(live, e, idx)
                return
            self._share_stage(live, "serving.pad",
                              time.perf_counter() - t0)
            self._run_batch(live, joined, idx)

    @staticmethod
    def _share_stage(live, name, dur_s):
        """Credit one batch-level stage to every cohort member."""
        for r in live:
            telemetry.add_stage(r.trace, name, dur_s)

    def _join(self, live):
        """Host-side coalesce: one array per model input, the cohort's
        requests concatenated on the batch axis, each padded on the host
        to the cohort's shared sequence bucket."""
        n_inputs = len(live[0].inputs)
        spec = getattr(self._pred, "spec", None)
        seq = live[0].bucket_key
        joined = []
        for i in range(n_inputs):
            parts = [_host(r.inputs[i]) for r in live]
            if seq is not None and spec is not None:
                ax = spec.seq_axis
                parts = [self._pad_seq(p, ax, seq, spec.pad_value)
                         if p.ndim > ax and p.shape[ax] != seq else p
                         for p in parts]
            if len(parts) == 1:
                joined.append(parts[0])
            elif any(isinstance(p, torch.Tensor) for p in parts):
                joined.append(torch.cat([torch.as_tensor(p) for p in parts]))
            else:
                joined.append(np.concatenate(parts, axis=0))
        return joined

    @staticmethod
    def _pad_seq(p, ax, seq, pad_value):
        pads = [(0, seq - p.shape[ax]) if d == ax else (0, 0)
                for d in range(p.ndim)]
        if isinstance(p, torch.Tensor):
            flat = [w for lo_hi in reversed(pads) for w in lo_hi]
            return torch.nn.functional.pad(p, flat, value=pad_value)
        return np.pad(p, pads, constant_values=pad_value)

    def _run_batch(self, live, joined, idx):
        """Run one joined batch and deliver its results (the single
        predictor path; the ReplicaDispatcher routes instead)."""
        try:
            t0 = time.perf_counter()
            flat, _fmt, _bucket = self._pred.predict_flat(tuple(joined))
            self._share_stage(live, "serving.predict",
                              time.perf_counter() - t0)
            # the one device-to-host fetch of the loop: once per batch,
            # split per request on the host
            t0 = time.perf_counter()
            with telemetry.span("serving.fetch", cat="sync"):
                host = [o.asnumpy() for o in flat]
            self._share_stage(live, "serving.fetch",
                              time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — a bad batch must not kill
            self._fail_batch(live, e, idx)
            return
        self._deliver(live, host)

    def _fail_batch(self, live, error, idx):
        """Every caller of a failed batch gets the error; the worker
        lives on."""
        for r in live:
            self._fail(r, error)
        telemetry.inc("serving.batch_errors")
        _log.exception("serving batch %d failed", idx)

    def _deliver(self, live, host):
        telemetry.inc("serving.batches")
        off = 0
        done = self._clock()
        for r in live:
            t0 = time.perf_counter()
            with telemetry.trace_handoff(r.trace), \
                    telemetry.span("serving.deliver"):
                outs = [h[off:off + r.n] for h in host]
                off += r.n
                r.future._value = outs[0] if len(outs) == 1 else tuple(outs)
            telemetry.add_stage(r.trace, "serving.deliver",
                                time.perf_counter() - t0)
            # the breakdown rides the future before the event wakes the
            # caller
            if r.trace is not None:
                r.future.trace_id = r.trace.trace_id
                r.future.breakdown = telemetry.trace_breakdown(r.trace)
                r.future.e2e_s = done - r.t_enq
            if self._controller is not None:
                # the observe half of the control loop; without tracing
                # there is no breakdown, so the enqueue-to-deliver interval
                # (same injected clock) stands in for the total
                bd = r.future.breakdown
                if not bd:
                    bd = {"serving.queue_wait": max(0.0, done - r.t_enq)}
                self._controller.observe(
                    r.bucket_key, bd,
                    hit=r.deadline is None or done <= r.deadline,
                    now=done, n=r.n, meta=r.meta)
            r.future._event.set()
            telemetry.observe("serving.latency_s", done - r.t_enq)

    def _expire(self, req):
        telemetry.inc("serving.deadline_expired")
        if self._controller is not None:
            self._controller.note_expired(self._clock(), meta=req.meta)
        self._fail(req, DeadlineExceeded(
            "deadline passed before dispatch (queued %.1f ms)"
            % ((self._clock() - req.t_enq) * 1e3)))

    @staticmethod
    def _fail(req, error):
        req.future._error = error
        req.future._event.set()

    # ---------------------------------------------------------------- worker
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-serving-batcher")
        self._thread.start()
        return self

    def _loop(self):
        # crash barrier: an exception outside _dispatch's own handling
        # fails every queued future instead of stranding them
        try:
            self._worker_loop()
        except Exception as e:  # noqa: BLE001 — barrier, not control flow
            self._worker_crashed(e)

    def _worker_loop(self):
        while True:
            with self._cond:
                batch = None
                while batch is None:
                    if self._closed and not self._q:
                        return
                    now = self._clock()
                    batch = self._gather_locked(now)
                    if batch is not None:
                        break
                    if self._draining and not self._q:
                        self._cond.wait(0.05)
                        continue
                    if self._q:
                        head_due = self._q[0].t_enq + self.max_wait_s - now
                        self._cond.wait(max(head_due, 1e-4))
                    else:
                        self._cond.wait()
                self._inflight += len(batch)
            try:
                self._dispatch(batch)
            finally:
                with self._cond:
                    self._inflight -= len(batch)
                    self._cond.notify_all()

    def _worker_crashed(self, exc):
        """Fail every queued future and refuse new submits
        (``serving.shed{worker_crashed}``): a loud 503, not a hang."""
        telemetry.inc("serving.worker_crashes")
        _log.exception("serving dispatch worker crashed — failing queued "
                       "futures and refusing new submits")
        err = MXNetError("serving worker crashed: %s: %s"
                         % (type(exc).__name__, exc))
        with self._cond:
            self._crashed = True
            dead = list(self._q)
            self._q.clear()
            self._items = 0
            dead += self._abort_extra_locked(err)
            telemetry.gauge("serving.queue_depth", 0)
            self._cond.notify_all()
        telemetry.flight_record(
            "worker_crash",
            trace_ids=[r.trace.trace_id for r in dead
                       if r.trace is not None],
            extra={"error": "%s: %s" % (type(exc).__name__, exc)})
        for r in dead:
            self._fail(r, err)

    def _abort_extra_locked(self, err):
        """Requests tracked outside the queue that a crash must also fail
        (the ReplicaDispatcher's watchdog entries); none here."""
        return []

    # ----------------------------------------------------------------- drain
    def _worker_alive(self):
        return self._thread is not None and self._thread.is_alive()

    def _pending_extra(self):
        """True while requests live outside the queue and the in-flight
        count (a ReplicaDispatcher's armed watchdog entries)."""
        return False

    def drain(self, timeout=None):
        """Stop admitting (submits shed with reason ``draining``), finish
        everything queued and in flight; True when empty. ``timeout`` is
        measured on the injected clock. Without a live worker the queue is
        drained through :meth:`poll`; if that makes no progress, False."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            alive = self._worker_alive()
            if not alive:
                while self.poll():
                    pass
            with self._cond:
                if not self._q and self._inflight == 0 \
                        and not self._pending_extra():
                    return True
                if deadline is not None and self._clock() > deadline:
                    return False
                if not alive:
                    return False
                self._cond.wait(0.05)

    def close(self, timeout=5.0):
        """Drain, then stop the worker thread."""
        self.drain(timeout=timeout)
        with self._cond:
            self._closed = True
            self._draining = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        return self
