"""SLO-aware serving control plane (counterpart of
``mxtpu/serving/controller.py``): the observe -> decide -> act loop over a
:class:`~mxtpu_torch.serving.batcher.MicroBatcher` or a
:class:`~mxtpu_torch.serving.replicas.ReplicaDispatcher`, on the same
injected clock as the rest of the serving plane (sleep-free under
``poll()``).

* **Predictive admission** -- a per-bucket latency model (a bounded,
  time-decayed quantile of the delivered requests' ``serving.queue_wait +
  serving.pad + serving.predict`` stage totals) predicts a new request's
  completion; ``submit`` sheds ``serving.shed{predicted_miss}`` when the
  prediction exceeds its deadline, before the queue fills. Below
  ``min_samples`` observations in the horizon the model is cold and the
  depth bound alone governs.
* **Autoscaling** -- :meth:`ServingController.tick` grows or shrinks the
  ReplicaSet between ``min_replicas`` and ``max_replicas`` on queue
  pressure, recent sheds, decayed SLO attainment and, where the
  ReplicaSet carries a KV-cache ``accountant``
  (``ReplicaSet.attach_accountant``), its residency; actions are spaced
  by the cooldown, and scale-down also needs a whole cooldown of
  idleness. A new replica captures its buckets off the serving path and
  joins only then.
* **Self-healing** -- a replica whose breaker has been open continuously
  for ``replace_after_ms`` is replaced: a fresh replica on a free device,
  or on the dead one's own device when none is free (one card), and the
  dead one retires through the drain.

Every decision bumps ``serving.controller.decisions{action}`` (actions
``predicted_shed``, ``scale_up``, ``scale_down``, ``replace``,
``warmup_failed``; the batcher adds ``yield``) and, except the per-request
predicted sheds, leaves a trace mark ``serving.controller.<action>``; the
gauges are ``serving.controller.replica_target`` and
``serving.tenant_attainment{tenant}``. The reference reads
``MXTPU_SERVE_MIN_REPLICAS``, ``_MAX_REPLICAS``, ``_SCALE_COOLDOWN_MS`` and
``_REPLACE_AFTER_MS``; the port takes them as constructor arguments whose
defaults are the reference's (``MIN_REPLICAS``, ``MAX_REPLICAS`` = 0: every
visible device, ``SCALE_COOLDOWN_MS``, ``REPLACE_AFTER_MS``).
"""
from __future__ import annotations

import collections
import logging
import math
import threading

from .. import telemetry
from ..base import MXNetError
from . import replicas

__all__ = ["ServingController", "MIN_REPLICAS", "MAX_REPLICAS",
           "SCALE_COOLDOWN_MS", "REPLACE_AFTER_MS"]

_log = logging.getLogger("mxtpu_torch.serving")

# the reference's MXTPU_SERVE_MIN_REPLICAS, _MAX_REPLICAS (0: every visible
# device), _SCALE_COOLDOWN_MS and _REPLACE_AFTER_MS defaults
MIN_REPLICAS = 1
MAX_REPLICAS = 0
SCALE_COOLDOWN_MS = 5000.0
REPLACE_AFTER_MS = 30000.0


class _DecayedQuantile:
    """Bounded sliding-horizon quantile estimate: the newest ``maxlen``
    samples, further decayed by dropping anything older than
    ``horizon_s`` on the INJECTED clock — old regimes age out both by
    count and by time, so the estimate tracks the live service rate."""

    __slots__ = ("_samples", "_horizon")

    def __init__(self, maxlen=128, horizon_s=60.0):
        self._samples = collections.deque(maxlen=maxlen)
        self._horizon = float(horizon_s)

    def observe(self, v, now):
        self._samples.append((float(now), float(v)))

    def _live(self, now):
        cut = now - self._horizon
        return [v for t, v in self._samples if t >= cut]

    def count(self, now):
        return len(self._live(now))

    def quantile(self, q, now):
        live = sorted(self._live(now))
        if not live:
            return None
        idx = max(0, min(len(live) - 1,
                         int(math.ceil(q * len(live))) - 1))
        return live[idx]


class ServingController:
    """See the module docstring. ``dispatcher`` is the
    :class:`~mxtpu_torch.serving.batcher.MicroBatcher` (normally a
    :class:`~mxtpu_torch.serving.replicas.ReplicaDispatcher`) to control —
    construction attaches the controller: admission consults
    :meth:`admit`, delivery feeds :meth:`observe`, and the dispatcher's
    maintenance path (``poll()`` under a fake clock, the monitor thread
    in threaded mode) drives :meth:`tick`. On a plain MicroBatcher only
    predictive admission is active (there is no ReplicaSet to scale).

    ``quantile`` is the prediction's pessimism (default 0.9: the
    predicted completion is the windowed p90 of observed totals plus a
    backlog term); ``min_samples`` the cold-model threshold below which
    admission falls back to the depth bound."""

    def __init__(self, dispatcher, min_replicas=MIN_REPLICAS,
                 max_replicas=MAX_REPLICAS,
                 scale_cooldown_ms=SCALE_COOLDOWN_MS,
                 replace_after_ms=REPLACE_AFTER_MS,
                 quantile=0.9, min_samples=8, horizon_s=60.0,
                 pressure_high=0.5, pressure_low=0.05,
                 attainment_floor=0.95, kv_pressure_high=0.9):
        self._disp = dispatcher
        self._set = getattr(dispatcher, "replica_set", None)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas) or len(replicas.visible_devices())
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise MXNetError(
                "ServingController: need 1 <= min_replicas <= max_replicas"
                " (got min=%d max=%d)"
                % (self.min_replicas, self.max_replicas))
        self.cooldown_s = float(scale_cooldown_ms) / 1e3
        self.replace_after_s = float(replace_after_ms) / 1e3
        self._q = float(quantile)
        self._min_samples = int(min_samples)
        self._horizon_s = float(horizon_s)
        self._pressure_high = float(pressure_high)
        self._pressure_low = float(pressure_low)
        self._attainment_floor = float(attainment_floor)
        self._kv_pressure_high = float(kv_pressure_high)
        self._lock = threading.Lock()
        self._models = {}          # bucket_key -> {"total","service"}
        self._deliveries = collections.deque(maxlen=512)  # (t, items)
        self._hits = 0.0           # decayed SLO attainment counters
        self._misses = 0.0
        self._sheds = 0.0          # decayed shed-event counter
        self._tenants = {}         # tenant -> [hits, misses], same decay
        self._att_t = None         # last decay timestamp
        self._last_scale = None    # clock of the last scale action
        self._last_activity = None  # last delivery/shed/non-empty queue
        self._busy = False         # one control action in flight at a time
        self.last_decision = None  # {"action","reason","t"} for /healthz
        dispatcher.attach_controller(self)

    # ------------------------------------------------------------ observation
    def _decay_locked(self, now):
        """Exponential decay of the attainment/shed counters with the
        horizon as time constant — recent behavior dominates."""
        if self._att_t is not None and now > self._att_t:
            f = math.exp(-(now - self._att_t) / self._horizon_s)
            self._hits *= f
            self._misses *= f
            self._sheds *= f
            for hm in self._tenants.values():
                hm[0] *= f
                hm[1] *= f
        self._att_t = now

    def observe(self, bucket_key, breakdown, hit, now, n=1, meta=None):
        """One delivered (or expired) request's verdict: feed the
        per-bucket latency model from its stage breakdown, the empirical
        drain-rate window, and the decayed SLO-attainment counters.
        Called by the batcher on delivery. ``meta`` (the request's
        attribution dict, stamped by the zoo) routes the verdict into
        the per-tenant goodput counters too
        (``serving.tenant_attainment{tenant}``)."""
        total = sum(breakdown.get(k, 0.0) for k in
                    ("serving.queue_wait", "serving.pad", "serving.predict"))
        service = sum(breakdown.get(k, 0.0) for k in
                      ("serving.pad", "serving.predict"))
        with self._lock:
            self._deliveries.append((float(now), int(n)))
            if total > 0.0:
                m = self._models.get(bucket_key)
                if m is None:
                    m = {"total": _DecayedQuantile(horizon_s=self._horizon_s),
                         "service": _DecayedQuantile(
                             horizon_s=self._horizon_s)}
                    self._models[bucket_key] = m
                m["total"].observe(total, now)
                m["service"].observe(service, now)
            self._decay_locked(now)
            if hit:
                self._hits += 1.0
            else:
                self._misses += 1.0
            self._tenant_verdict_locked(meta, hit)
            self._last_activity = now

    def _tenant_verdict_locked(self, meta, hit):
        tenant = (meta or {}).get("tenant")
        if tenant is None:
            return
        hm = self._tenants.get(tenant)
        if hm is None:
            hm = self._tenants[tenant] = [0.0, 0.0]
        hm[0 if hit else 1] += 1.0
        telemetry.gauge("serving.tenant_attainment",
                        hm[0] / (hm[0] + hm[1]), tag=tenant)

    def note_expired(self, now, meta=None):
        """A queued request's deadline passed before dispatch — an SLO
        miss the attainment signal (and the request's tenant) must
        see."""
        with self._lock:
            self._decay_locked(now)
            self._misses += 1.0
            self._tenant_verdict_locked(meta, False)
            self._last_activity = now

    def note_shed(self, reason, now):
        """Any admission shed (depth, predictive, eviction): recent sheds
        are the strongest scale-up pressure there is."""
        with self._lock:
            self._decay_locked(now)
            self._sheds += 1.0
            self._last_activity = now

    def attainment(self, now=None):
        """``(attainment, weight)``: the decayed SLO goodput fraction and
        the decayed verdict count backing it (attainment is None below
        one verdict of weight). The zoo's canary auto-rollback gate reads
        this off the canary arm's controller."""
        if now is None:
            now = self._disp._clock()
        with self._lock:
            self._decay_locked(now)
            weight = self._hits + self._misses
            att = self._hits / weight if weight >= 1.0 else None
        return att, weight

    def tenant_attainment(self, now=None):
        """Per-tenant decayed goodput attainment ({tenant: fraction}) —
        the /healthz per-tenant SLO view."""
        if now is None:
            now = self._disp._clock()
        with self._lock:
            self._decay_locked(now)
            return {t: round(hm[0] / (hm[0] + hm[1]), 4)
                    for t, hm in self._tenants.items()
                    if hm[0] + hm[1] >= 1.0}

    # -------------------------------------------------------------- admission
    def predicted_s(self, bucket_key, queued_ahead_items=0, now=None):
        """Predicted completion time (seconds from now) for a request in
        ``bucket_key``. Two estimates, take the smaller:

        * **history** — the windowed ``quantile`` of observed
          queue-wait + pad + predict totals, plus one service quantum
          per full backlog batch already queued ahead in the same
          bucket;
        * **live bound** — what the CURRENT queue can actually cost:
          (total queued batches + 1) x the service quantile + the
          coalescing wait. History alone deadlocks after an overload
          passes (stale queue-wait samples predict misses, everything
          sheds, and with nothing delivered the model never re-learns);
          the live bound collapses the prediction the moment the queue
          empties, and the backlog terms raise it the moment depth
          returns — self-correcting in both directions.

        None while the model is cold (fewer than ``min_samples``
        observations in the horizon)."""
        if now is None:
            now = self._disp._clock()
        with self._lock:
            m = self._models.get(bucket_key)
            if m is None or m["total"].count(now) < self._min_samples:
                return None
            total = m["total"].quantile(self._q, now)
            # MEDIAN service, deliberately: the per-batch execution time
            # is a tight distribution whose tail is host-noise/first-
            # dispatch stragglers — a pessimistic service estimate here
            # would predict misses forever on an idle box. The pessimism
            # quantile lives on the observed TOTALS, where it belongs
            service = m["service"].quantile(0.5, now) or 0.0
            rate = self._drain_rate_locked(now)
        max_batch = max(1, self._disp.max_batch)
        history = total + (queued_ahead_items // max_batch) * service
        if rate is None:
            return history
        live = self._disp.queue_depth / rate + service \
            + self._disp.max_wait_s
        return min(history, live)

    def _drain_rate_locked(self, now):
        """Empirical delivery rate (items/s) over the recent window —
        what the live-queue wait bound divides by. None before enough
        recent deliveries (<= 1 s span or < 2 samples)."""
        cut = now - min(self._horizon_s, 5.0)
        recent = [(t, k) for t, k in self._deliveries if t >= cut]
        if len(recent) < 2:
            return None
        span = max(1e-3, recent[-1][0] - recent[0][0])
        items = sum(k for _t, k in recent)
        return items / span

    def admit(self, n, bucket_key, deadline_s, priority, queued_ahead=0):
        """The predictive-admission verdict for one submit: a shed-reason
        string (``predicted_miss``) when the predicted completion exceeds
        the request's deadline, None to admit. Deadline-less requests and
        cold buckets always pass — the depth bound still governs."""
        if deadline_s is None:
            return None
        now = self._disp._clock()
        predicted = self.predicted_s(bucket_key, queued_ahead, now=now)
        if predicted is None:
            return None  # cold model: fall back to the depth bound
        if predicted > deadline_s:
            self._record("predicted_shed", "predicted %.1f ms > deadline "
                         "%.1f ms" % (predicted * 1e3, deadline_s * 1e3),
                         now, mark=False)
            return "predicted_miss"
        return None

    def estimate_drain_s(self):
        """Predicted time to drain the CURRENT queue — what the 503
        Retry-After header is derived from. The empirical delivery rate
        when recent traffic gives one; else per-bucket backlog batches x
        that bucket's median service (a conservative 50 ms per batch
        where the model is cold)."""
        now = self._disp._clock()
        depth = self._disp.queue_depth
        with self._lock:
            rate = self._drain_rate_locked(now)
        if rate:
            return depth / rate
        by_bucket = {}
        for r in list(self._disp._q):
            by_bucket[r.bucket_key] = by_bucket.get(r.bucket_key, 0) + r.n
        drain = 0.0
        with self._lock:
            for bucket, items in by_bucket.items():
                batches = math.ceil(items / max(1, self._disp.max_batch))
                m = self._models.get(bucket)
                service = m["service"].quantile(0.5, now) \
                    if m is not None else None
                drain += batches * (service if service else 0.05)
        return drain

    def retry_after_s(self):
        """Integer seconds for the 503 ``Retry-After`` header (>= 1)."""
        return int(math.ceil(max(1.0, self.estimate_drain_s())))

    # ------------------------------------------------------------- decisions
    def _record(self, action, reason, now, mark=True):
        """One tagged counter bump + trace mark — every control-plane
        decision is attributable from telemetry alone. ``mark=False`` is
        the per-request fast path (predicted sheds, which can fire
        thousands of times under overload: the REQUEST's own trace gets
        the mark in ``_admit``, the log stays at debug, and the /healthz
        ``last_decision`` keeps showing the last SCALE-class action)."""
        telemetry.inc("serving.controller.decisions", tag=action)
        if mark:
            self.last_decision = {"action": action, "reason": reason,
                                  "t": float(now)}
            telemetry.trace_mark(telemetry.new_trace(),
                                 "serving.controller." + action)
            _log.info("serving controller: %s (%s)", action, reason)
        else:
            _log.debug("serving controller: %s (%s)", action, reason)

    def note_warmup_failed(self, error, now):
        """A replica bring-up that never joined (called by the
        dispatcher's warmup path — including the threaded side thread,
        where the exception would otherwise die on a daemon frame)."""
        self._record("warmup_failed", "%s: %s"
                     % (type(error).__name__, error), now)

    def _counts_locked(self):
        reps = self._set.replicas
        healthy = sum(1 for r in reps if r.state == "healthy")
        warming = sum(1 for r in reps if r.state == "warming")
        live = sum(1 for r in reps if r.state != "retiring")
        return healthy, warming, live

    def tick(self, now):
        """One control-loop iteration (replace check, then the scaling
        ladder) — called from the dispatcher's maintenance path: under a
        fake clock every ``poll()`` ticks; in threaded mode the monitor
        thread does. Decisions run OUTSIDE the controller lock (a warmup
        is seconds of device work); ``_busy`` keeps them one at a time."""
        if self._set is None:
            return
        with self._lock:
            if self._busy:
                return
            if self._disp.queue_depth > 0:
                self._last_activity = now
            action = self._decide_locked(now)
            if action is None:
                telemetry.gauge("serving.controller.replica_target",
                                self._counts_locked()[2])
                return
            self._busy = True
        try:
            self._act(action, now)
        finally:
            with self._lock:
                self._busy = False

    def _decide_locked(self, now):
        if self._disp._draining or self._disp._closed \
                or self._disp._crashed:
            # a draining/closed/crashed dispatcher can never serve the
            # capacity a scale action would add — drain-retry sheds and
            # crash-barrier sheds must not trigger pointless bring-ups
            return None
        healthy, warming, live = self._counts_locked()
        # 1) self-healing: a breaker open continuously past the bound is
        #    a dead chip, not a blip — replace it (repair is not gated by
        #    the scale cooldown; capacity restoration cannot wait)
        for rep in self._set.replicas:
            if rep.state in ("quarantined", "probing") \
                    and rep.down_since is not None \
                    and now - rep.down_since >= self.replace_after_s:
                return ("replace", rep)
        # 2) scaling, cooldown-gated
        if self._last_scale is not None \
                and now - self._last_scale < self.cooldown_s:
            return None
        self._decay_locked(now)
        pressure = self._disp.queue_depth / max(1, self._disp.max_queue)
        shed_hot = self._sheds > 0.5
        att = None
        if self._hits + self._misses >= 4.0:
            att = self._hits / (self._hits + self._misses)
        kvp = 0.0
        acct = getattr(self._set, "accountant", None)
        if acct is not None:
            kvp = acct.pressure()
        if live < self.max_replicas and (
                pressure >= self._pressure_high or shed_hot
                or (att is not None and att < self._attainment_floor)
                or kvp >= self._kv_pressure_high):
            return ("scale_up",
                    "pressure=%.2f sheds=%.1f attainment=%s kv=%.2f"
                    % (pressure, self._sheds,
                       "%.2f" % att if att is not None else "n/a", kvp))
        idle = self._last_activity is None \
            or now - self._last_activity >= self.cooldown_s
        if healthy > self.min_replicas and warming == 0 \
                and self._disp.queue_depth == 0 and idle \
                and not shed_hot \
                and (att is None or att >= self._attainment_floor):
            return ("scale_down", "idle >= %.1f s" % self.cooldown_s)
        return None

    def _act(self, action, now):
        kind = action[0]
        if kind == "replace":
            self._replace(action[1], now)
        elif kind == "scale_up":
            self._record("scale_up", action[1], now)
            self._last_scale = now
            self._add_one(now)
        elif kind == "scale_down":
            victim = None
            for rep in self._set.replicas:
                if rep.state == "healthy" and (
                        victim is None or rep.index > victim.index):
                    victim = rep
            if victim is None:
                return
            self._record("scale_down",
                         "%s retiring (idle)" % victim.tag, now)
            self._last_scale = now
            self._disp.remove_replica(victim.index)

    def _add_one(self, now, device=None):
        """Grow by one replica (its buckets captured off the serving path —
        the dispatcher warms it on a side thread in threaded mode, inline
        under a fake clock). A failed bring-up is recorded, never raised into
        the serving path: warmup failures are caught (and reported back
        here) by the dispatcher's bring-up step in both modes; this
        catch covers allocation-time refusals (e.g. no free device)."""
        try:
            self._disp.add_replica(device=device)
        except Exception as e:  # noqa: BLE001 — decision log, not control
            _log.exception("serving controller: replica bring-up failed")
            self.note_warmup_failed(e, now)

    def _replace(self, dead, now):
        self._record("replace", "%s breaker open %.1f s (>= %.1f s)"
                     % (dead.tag, now - (dead.down_since or now),
                        self.replace_after_s), now)
        free = self._set.free_devices()
        # "on a fresh device": prefer a device no replica is using — a
        # wedged chip stays written off; fall back to the dead replica's
        # own device when the fleet has no spare (a process-level fault
        # may well serve again from freshly captured graphs)
        device = free[0] if free else dead.device
        self._disp.remove_replica(dead.index)
        self._add_one(now, device=device)

    # -------------------------------------------------------------- reporting
    def view(self):
        """The /healthz controller block: replica target vs actual,
        per-class queue depths, SLO attainment, last decision + reason."""
        depths = self._disp.queue_depths()
        drain = self.estimate_drain_s()
        with self._lock:
            att = None
            if self._hits + self._misses >= 1.0:
                att = self._hits / (self._hits + self._misses)
            out = {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "queue_depths": depths,
                "slo_attainment": round(att, 4) if att is not None else None,
                "tenant_attainment": {
                    t: round(hm[0] / (hm[0] + hm[1]), 4)
                    for t, hm in self._tenants.items()
                    if hm[0] + hm[1] >= 1.0},
                "recent_sheds": round(self._sheds, 2),
                "estimated_drain_s": round(drain, 4),
                "last_decision": dict(self.last_decision)
                if self.last_decision else None,
            }
            if self._set is not None:
                healthy, warming, live = self._counts_locked()
                out["replica_target"] = live
                out["replica_actual"] = healthy
                out["replica_warming"] = warming
        return out
