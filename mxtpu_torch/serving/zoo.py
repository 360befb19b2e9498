"""Multi-model zoo (counterpart of ``mxtpu/serving/zoo.py``): one serving
plane for several models over one device pool, with device bytes as the
shared currency and captured-graph replay as the steady state.

* :class:`ModelZoo` -- the registry: named models x immutable versions,
  each a host snapshot of the parameters with the model's
  :class:`~mxtpu_torch.serving.engine.BucketSpec`; with ``manifest_dir`` a
  ``zoo_manifest.json`` lists what is servable.
* :class:`ZooScheduler` -- multiplexes the registry over the pool. A
  resident model's cost is the bytes its Predictors hold
  (:func:`mxtpu_torch.xprof.site_footprint`), its demand a decayed request
  rate. Placement evicts the coldest resident under the count cap
  (``max_resident``) or the byte budget (``hbm_budget``; 0 is the device's
  limit): its queued and in-flight futures complete first, then its graphs
  and their pool are released (``zoo.evictions{model:reason}``). A page-in
  captures one graph per bucket at ``serving.predict.zoo.<model>`` and
  nothing after it; the kernels are already built. A request for a
  non-resident model waits behind a bounded page-in (``cold_policy``
  ``queue``, ``pagein_queue`` requests) or sheds ``zoo_cold`` (``shed``).
* **Tenants** -- a tenant maps to a priority class and a default deadline
  of the batcher's; each verdict feeds the model's
  :class:`~mxtpu_torch.serving.controller.ServingController` per tenant
  (``serving.tenant_attainment{tenant}``).
* **Rollout** -- :meth:`ModelZoo.deploy` with ``0 < canary_frac < 1``
  routes that share of a model's traffic to a canary arm (its own
  Predictor at ``<site>.canary``) by ``crc32(request id)``, the
  reference's hash, so a request id takes the same arm in both packages;
  ``promote`` swaps the version's parameters into the stable Predictor by
  ``refresh_params`` (no capture; the int8 eligibility stays pinned);
  rollback follows the canary's attainment under ``canary_floor`` once
  ``canary_window`` verdicts weigh in, a parity probe past ``parity_tol``
  at deploy, or the injected ``canary_rollback`` fault. Promote and
  rollback drop no request.

Fault kinds (``resilience.set_faults``): ``zoo_cold`` -- the next zoo
submit sheds as if its model were cold and unpageable;
``canary_rollback`` -- the next canary gate rules a regression.
Telemetry: ``zoo.pageins{model}``, ``zoo.evictions{model:reason}``,
``zoo.deploys``, ``zoo.promotes``, ``zoo.rollbacks{reason}`` counters, the
``zoo.pagein_s`` and ``zoo.pagein_wait_s`` histograms, and the
``zoo.resident_models``, ``zoo.hbm_resident_bytes{model}``,
``zoo.active_version{model}`` and ``zoo.canary_frac{model}`` gauges.

The reference reads ``MXTPU_ZOO_*``; the port takes constructor arguments
whose defaults are the reference's values (the constants below) and
``int8=`` for its ``MXTPU_SERVE_INT8``. A version may name a checkpoint
``(prefix, epoch)`` (``model.save_checkpoint`` naming), whose parameters
``model.load_checkpoint`` reads on the version's first page-in. Not
ported: the page-in from the compile service's disk cache and the flight
recorder's ``canary_rollback`` dump (A9). With ``start=False`` and an injected
``clock`` everything runs synchronously through :meth:`ZooScheduler.poll`;
``start=True`` gives each resident arm its batcher worker, page-ins their
own threads and the zoo a monitor thread.
"""
from __future__ import annotations

import collections
import json
import logging
import math
import os
import threading
import time
import zlib

from .. import telemetry, xprof
from ..base import MXNetError
from ..resilience import inject
from .batcher import PRIORITIES, DeadlineExceeded, MicroBatcher, QueueFull
from .controller import ServingController
from .engine import Predictor
from . import replicas

__all__ = ["ModelZoo", "ZooScheduler", "ZooVersion", "MAX_RESIDENT",
           "HBM_BUDGET", "COLD_POLICY", "PAGEIN_QUEUE", "DEMAND_HORIZON_S",
           "CANARY_FLOOR", "CANARY_WINDOW", "PARITY_TOL"]

_log = logging.getLogger("mxtpu_torch.serving")

# the retrace-site family of every zoo Predictor
_SITE_ROOT = "serving.predict.zoo"

# the reference's MXTPU_ZOO_* defaults: no count cap, the device's limit
# as the byte budget, the queue cold policy behind a 64-request page-in
# queue, a 60 s demand horizon, and the canary gate's floor, window and
# parity tolerance
MAX_RESIDENT = 0
HBM_BUDGET = 0
COLD_POLICY = "queue"
PAGEIN_QUEUE = 64
DEMAND_HORIZON_S = 60.0
CANARY_FLOOR = 0.8
CANARY_WINDOW = 8.0
PARITY_TOL = 1e-2


class _DecayedRate:
    """Exponentially decayed event rate on the injected clock: the
    per-model demand that placement ranks by."""

    __slots__ = ("v", "t", "horizon")

    def __init__(self, horizon_s):
        self.v = 0.0
        self.t = None
        self.horizon = float(horizon_s)

    def _decay(self, now):
        if self.t is not None and now > self.t:
            self.v *= math.exp(-(now - self.t) / self.horizon)
        self.t = now

    def observe(self, n, now):
        self._decay(now)
        self.v += float(n)

    def rate(self, now):
        self._decay(now)
        return self.v / self.horizon


# ------------------------------------------------------------------ registry
class ZooVersion:
    """One immutable version of a zoo model: its parameters (a host
    snapshot ``{name: tensor or array}``, or a checkpoint ref ``(prefix,
    epoch)`` loaded on first use) and the BucketSpec it serves under.
    ``ordinal`` is the registration sequence number, which
    ``zoo.active_version{model}`` gauges."""

    __slots__ = ("model", "version", "spec", "params", "checkpoint",
                 "created", "ordinal")

    def __init__(self, model, version, spec, ordinal, params,
                 checkpoint=None):
        self.model = model
        self.version = version
        self.spec = spec
        self.params = params
        self.checkpoint = checkpoint
        self.created = time.time()
        self.ordinal = int(ordinal)

    def describe(self):
        return {"version": self.version, "ordinal": self.ordinal,
                "created": self.created, "spec": repr(self.spec),
                "checkpoint": self.checkpoint,
                "params": sorted(self.params) if self.params else None}


class _ZooModel:
    __slots__ = ("name", "block", "spec", "example", "versions", "active",
                 "next_ordinal")

    def __init__(self, name, block, spec, example):
        self.name = name
        self.block = block
        self.spec = spec
        self.example = example
        self.versions = collections.OrderedDict()
        self.active = None
        self.next_ordinal = 0


def _snapshot_block_params(block):
    """Host copy of every parameter in its own dtype (a version must not
    alias the live block)."""
    return {name: p._tensor().detach().to("cpu", copy=True)
            for name, p in block.collect_params().items()}


def _load_checkpoint_params(ver):
    """A checkpoint-ref version's parameters as a host mapping
    (``model.save_checkpoint`` naming: ``(prefix, epoch)``)."""
    from ..model import load_checkpoint
    prefix, epoch = ver.checkpoint
    _sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
    return {name: arr._data.detach().to("cpu", copy=True)
            for name, arr in list(arg_params.items())
            + list(aux_params.items())}


class ModelZoo:
    """The registry half: named models x immutable versions. Placement and
    serving are :class:`ZooScheduler`'s; :meth:`deploy` goes through the
    attached scheduler, or flips the registry's active version when none
    is attached."""

    def __init__(self, manifest_dir=None):
        self._models = collections.OrderedDict()
        self._lock = threading.RLock()
        self._manifest_dir = manifest_dir
        self._sched = None

    # ------------------------------------------------------------ registration
    def register(self, name, block, spec, example=None, version="v1",
                 checkpoint=None):
        """Register a model under ``name`` with its first version (the
        block's current parameters unless ``checkpoint`` names a
        ``(prefix, epoch)`` ref). Model names join retrace-site and metric
        families, so they are restricted to ``[A-Za-z0-9_-]``."""
        if not name or not all(c.isalnum() or c in "_-" for c in name):
            raise MXNetError("ModelZoo.register: model name %r must be "
                             "non-empty [A-Za-z0-9_-]" % (name,))
        with self._lock:
            if name in self._models:
                raise MXNetError("ModelZoo.register: model %r already "
                                 "registered — use add_version" % name)
            self._models[name] = _ZooModel(name, block, spec, example)
        self.add_version(name, version, checkpoint=checkpoint)
        return self._models[name]

    def add_version(self, name, version, params=None, checkpoint=None):
        """Add one immutable version: ``params`` (``{name: array or
        tensor}`` on the host), a ``checkpoint`` ref ``(prefix, epoch)``
        (loaded on first apply) or, with neither, a snapshot of the block's
        current parameters. The first version becomes active."""
        m = self._get(name)
        with self._lock:
            if version in m.versions:
                raise MXNetError(
                    "ModelZoo.add_version: %s@%s already exists — "
                    "versions are immutable" % (name, version))
            if params is None and checkpoint is None:
                params = _snapshot_block_params(m.block)
            ver = ZooVersion(name, version, m.spec, m.next_ordinal, params,
                             checkpoint=checkpoint)
            m.next_ordinal += 1
            m.versions[version] = ver
            if m.active is None:
                m.active = version
        self._persist_manifest()
        return ver

    def _get(self, name):
        with self._lock:
            m = self._models.get(name)
        if m is None:
            raise MXNetError("ModelZoo: unknown model %r (known: %s)"
                             % (name, ", ".join(self.models()) or "none"))
        return m

    def models(self):
        with self._lock:
            return list(self._models)

    def versions(self, name):
        return list(self._get(name).versions)

    def active_version(self, name):
        return self._get(name).active

    def version(self, name, version):
        m = self._get(name)
        with self._lock:
            ver = m.versions.get(version)
        if ver is None:
            raise MXNetError(
                "ModelZoo: unknown version %r for model %r (known: %s)"
                % (version, name, ", ".join(m.versions)))
        return ver

    def set_active(self, name, version):
        ver = self.version(name, version)
        with self._lock:
            self._get(name).active = version
        self._persist_manifest()
        return ver

    # -------------------------------------------------------------- params
    def apply_version(self, name, version):
        """Load a version's parameters into the model's shared block: the
        step right before a Predictor snapshots them (its build, or
        ``refresh_params``). A checkpoint-ref version loads (and keeps) its
        parameters here, on first use."""
        m = self._get(name)
        ver = self.version(name, version)
        with self._lock:
            if ver.params is None:
                ver.params = _load_checkpoint_params(ver)
            pd = m.block.collect_params()
            for pname, arr in ver.params.items():
                if pname in pd:
                    pd[pname].set_data(arr)
        return ver

    # ------------------------------------------------------------- manifest
    def _manifest_path(self):
        if not self._manifest_dir:
            return None
        return os.path.join(self._manifest_dir, "zoo_manifest.json")

    def _persist_manifest(self):
        """Best-effort manifest write (an index of what is servable)."""
        path = self._manifest_path()
        if path is None:
            return
        with self._lock:
            doc = {"format": 1, "models": {
                m.name: {"active": m.active,
                         "spec": repr(m.spec),
                         "versions": {v: ver.describe()
                                      for v, ver in m.versions.items()}}
                for m in self._models.values()}}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, default=repr)
            os.replace(tmp, path)
        except OSError:  # advisory index only
            _log.debug("zoo manifest write failed", exc_info=True)

    def manifest(self):
        """The persisted manifest dict ({} when absent or unwritable)."""
        path = self._manifest_path()
        if path is None:
            return {}
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    # --------------------------------------------------------------- rollout
    def attach_scheduler(self, sched):
        self._sched = sched
        return self

    def deploy(self, model, version, canary_frac=1.0, parity_example=None,
               parity_tol=None):
        """Roll ``version`` out for ``model``: ``canary_frac >= 1`` promotes
        directly (the resident Predictor adopts the parameters through
        ``refresh_params``); ``0 < canary_frac < 1`` starts a canary arm
        taking that share of traffic behind the rollback gate. Returns a
        status dict."""
        if self._sched is not None:
            return self._sched.deploy(model, version,
                                      canary_frac=canary_frac,
                                      parity_example=parity_example,
                                      parity_tol=parity_tol)
        ver = self.set_active(model, version)
        telemetry.inc("zoo.deploys", tag=model)
        return {"model": model, "version": version, "mode": "registry",
                "ordinal": ver.ordinal}


# ----------------------------------------------------------------- scheduler
class _ZooFuture:
    """Completion handle of a request that queued behind a page-in: it
    binds to the batcher's future once the model is resident (or fails
    with the shed or deadline verdict), so ``result`` waits at most the
    page-in and the service."""

    __slots__ = ("_event", "_inner", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._inner = None
        self._error = None

    def _bind(self, inner):
        self._inner = inner
        self._event.set()

    def _fail(self, error):
        self._error = error
        self._event.set()

    def done(self):
        if not self._event.is_set():
            return False
        return self._error is not None or self._inner.done()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise DeadlineExceeded("no page-in within %ss" % timeout)
        if self._error is not None:
            raise self._error
        return self._inner.result(timeout)

    @property
    def trace_id(self):
        return self._inner.trace_id if self._inner is not None else None

    @property
    def breakdown(self):
        return self._inner.breakdown if self._inner is not None else None

    @property
    def e2e_s(self):
        return self._inner.e2e_s if self._inner is not None else None


class _Pending:
    __slots__ = ("inputs", "n", "deadline_ms", "priority", "meta", "t0",
                 "future")

    def __init__(self, inputs, n, deadline_ms, priority, meta, t0):
        self.inputs = inputs
        self.n = n
        self.deadline_ms = deadline_ms
        self.priority = priority
        self.meta = meta
        self.t0 = t0
        self.future = _ZooFuture()


class _Arm:
    """One serving arm of a resident model (stable or canary): a warmed
    Predictor, its MicroBatcher and its controller."""

    __slots__ = ("version", "predictor", "batcher", "ctrl", "site")

    def __init__(self, version, predictor, batcher, ctrl):
        self.version = version
        self.predictor = predictor
        self.batcher = batcher
        self.ctrl = ctrl
        self.site = predictor.site


class _Resident:
    __slots__ = ("model", "dslot", "device", "stable", "canary",
                 "canary_frac", "footprint", "warm_summary")

    def __init__(self, model, dslot, device, stable, warm_summary):
        self.model = model
        self.dslot = dslot
        self.device = device
        self.stable = stable
        self.canary = None
        self.canary_frac = 0.0
        self.footprint = 0
        self.warm_summary = warm_summary


class ZooScheduler:
    """See the module docstring. ``zoo`` is the :class:`ModelZoo`;
    ``devices`` the pool (default: every visible CUDA device, raising when
    there is none). ``start=False`` with an injected ``clock`` keeps
    everything synchronous (:meth:`poll` runs page-ins and dispatch);
    ``start=True`` starts the batcher workers, runs page-ins on threads of
    their own and the monitor that evaluates the canary gate."""

    def __init__(self, zoo, devices=None, clock=time.monotonic, start=True,
                 max_resident=MAX_RESIDENT, hbm_budget=HBM_BUDGET,
                 cold_policy=COLD_POLICY, pagein_queue=PAGEIN_QUEUE,
                 demand_horizon_s=DEMAND_HORIZON_S, tenants=None,
                 controller=True, batcher_kw=None, canary_floor=CANARY_FLOOR,
                 canary_window=CANARY_WINDOW, int8=False):
        self._zoo = zoo
        self._devices = list(devices) if devices else replicas.visible_devices()
        if not self._devices:
            raise MXNetError("ZooScheduler: no CUDA device is visible and "
                             "no devices were given: pass devices=['cpu'] "
                             "to serve on the host")
        self._clock = clock
        self._threaded = bool(start)
        self.max_resident = int(max_resident)
        self.hbm_budget = int(hbm_budget)
        self.cold_policy = cold_policy
        if self.cold_policy not in ("queue", "shed"):
            raise MXNetError("ZooScheduler: cold_policy must be "
                             "queue|shed, got %r" % (self.cold_policy,))
        self.pagein_queue = int(pagein_queue)
        self._horizon = float(demand_horizon_s)
        self.canary_floor = float(canary_floor)
        self.canary_window = float(canary_window)
        self._int8 = bool(int8)
        self._use_controller = bool(controller)
        self._batcher_kw = dict(batcher_kw or {})
        self._lock = threading.RLock()
        self._residents = {}        # model -> _Resident
        self._pending = {}          # model -> deque[_Pending]
        self._paging = set()        # models with a page-in in flight
        self._footprints = {}       # model -> last measured resident bytes
        self._demand = {}           # model -> _DecayedRate
        self._tenants = {}          # tenant -> {"priority","deadline_ms"}
        for t, cls in (tenants or {}).items():
            self.set_tenant(t, **cls)
        self._rid = 0
        self._draining = False
        self._closed = False
        self._monitor = None
        self._stop = threading.Event()
        zoo.attach_scheduler(self)
        telemetry.gauge("zoo.resident_models", 0)
        if self._threaded:
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="mxtpu-zoo-monitor")
            self._monitor.start()

    @property
    def registry(self):
        """The :class:`ModelZoo` this scheduler serves."""
        return self._zoo

    # --------------------------------------------------------------- tenants
    def set_tenant(self, tenant, priority="interactive", deadline_ms=None):
        """Declare a tenant's SLO class: its default priority class and
        deadline. Unknown tenants serve as ``interactive`` with no default
        deadline."""
        if priority not in PRIORITIES:
            raise MXNetError("set_tenant: unknown priority %r (expected "
                             "one of %s)" % (priority, "|".join(PRIORITIES)))
        with self._lock:
            self._tenants[tenant] = {"priority": priority,
                                     "deadline_ms": deadline_ms}
        return self

    def tenant_class(self, tenant):
        with self._lock:
            return dict(self._tenants.get(tenant)
                        or {"priority": "interactive", "deadline_ms": None})

    # ------------------------------------------------------------ submission
    def submit(self, model, inputs, tenant=None, deadline_ms=None,
               priority=None, request_id=None, version=None):
        """Route one request by model name. The tenant's class fills the
        priority and deadline the caller left unset; ``version=`` pins the
        request to a live arm (stable or canary) instead of the hash
        route; ``request_id`` feeds the canary hash (one is assigned when
        absent). Returns a future."""
        m = self._zoo._get(model)  # an unknown model refuses loudly
        cls = self.tenant_class(tenant)
        if priority is None:
            priority = cls["priority"]
        if deadline_ms is None:
            deadline_ms = cls["deadline_ms"]
        meta = {"model": model, "tenant": tenant or "default"}
        now = self._clock()
        with self._lock:
            rate = self._demand.get(model)
            if rate is None:
                rate = self._demand[model] = _DecayedRate(self._horizon)
            rate.observe(1, now)
            if request_id is None:
                self._rid += 1
                request_id = self._rid
            if self._draining or self._closed:
                self._shed("draining", model)
            if inject("zoo_cold"):
                # this submit behaves as if its model were non-resident
                # and unpageable
                self._shed("zoo_cold", model)
            res = self._residents.get(model)
        if res is None:
            if version is not None:
                self._zoo.version(model, version)  # unknown refuses loudly
                if version != m.active:
                    raise MXNetError(
                        "ModelZoo: version %r of model %r is not live (a "
                        "page-in would serve the active version %r)"
                        % (version, model, m.active))
            return self._cold_submit(model, inputs, deadline_ms, priority,
                                     meta, now)
        arm = self._pick_arm(res, version, request_id)
        meta["version"] = arm.version
        return arm.batcher.submit(inputs, deadline_ms=deadline_ms,
                                  priority=priority, meta=meta)

    def _shed(self, reason, model):
        telemetry.inc("serving.shed", tag=reason)
        raise QueueFull("request shed: %s (model %r)" % (reason, model))

    def _pick_arm(self, res, version, request_id):
        """Stable or canary: ``version=`` pins (refusing a version no arm
        serves); otherwise ``crc32(request id)`` sends ``canary_frac`` of
        the traffic to the canary."""
        canary = res.canary
        if version is not None:
            if version == res.stable.version:
                return res.stable
            if canary is not None and version == canary.version:
                return canary
            live = [res.stable.version] + (
                [canary.version] if canary is not None else [])
            raise MXNetError(
                "ModelZoo: version %r of model %r is not live (live: %s)"
                % (version, res.model, ", ".join(live)))
        if canary is None or res.canary_frac <= 0.0:
            return res.stable
        h = zlib.crc32(str(request_id).encode("utf-8")) % 10**6
        return canary if h < res.canary_frac * 10**6 else res.stable

    def _cold_submit(self, model, inputs, deadline_ms, priority, meta, now):
        if self.cold_policy == "shed":
            self._shed("zoo_cold", model)
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        n = int(getattr(inputs[0], "shape", (1,))[0] or 1)
        p = _Pending(inputs, n, deadline_ms, priority, meta, now)
        with self._lock:
            pend = self._pending.setdefault(model, collections.deque())
            if len(pend) >= self.pagein_queue:
                # a cold burst past the bound sheds instead of building a
                # backlog nobody can serve in time
                self._shed("zoo_cold", model)
            pend.append(p)
            start_pagein = model not in self._paging
            if start_pagein:
                self._paging.add(model)
        if start_pagein and self._threaded:
            threading.Thread(target=self._pagein_safe, args=(model,),
                             daemon=True,
                             name="mxtpu-zoo-pagein-%s" % model).start()
        # without threads the page-in runs at the next poll(): cold submits
        # gather in the bounded queue as during a threaded page-in
        return p.future

    # ------------------------------------------------------------- placement
    def _site(self, model):
        return "%s.%s" % (_SITE_ROOT, model)

    def _dev_budget(self, dslot):
        if self.hbm_budget > 0:
            return self.hbm_budget
        return xprof.device_memory(self._devices[dslot])["bytes_limit"]

    def _slot_load_locked(self, dslot):
        models = [r for r in self._residents.values() if r.dslot == dslot]
        return len(models), sum(r.footprint for r in models)

    def _fits_locked(self, dslot, est_bytes):
        count, resident = self._slot_load_locked(dslot)
        if self.max_resident > 0 and count >= self.max_resident:
            return False
        budget = self._dev_budget(dslot)
        if budget and resident + est_bytes > budget:
            return False
        return True

    def _coldest_locked(self, dslot, now, incoming):
        """The lowest-demand resident on ``dslot``: the eviction victim. A
        model with a live canary is pinned (evicting it would tear the
        rollout down mid-evaluation)."""
        cands = [r for r in self._residents.values()
                 if r.dslot == dslot and r.model != incoming
                 and r.canary is None]
        if not cands:
            return None

        def rate(r):
            d = self._demand.get(r.model)
            return d.rate(now) if d is not None else 0.0
        return min(cands, key=lambda r: (rate(r), r.model))

    def _place(self, model):
        """The pool slot for ``model``, evicting cold residents until it
        fits (resident bytes against the budget, and the count cap). When
        nothing can be evicted the least loaded slot is used anyway: the
        co-residency pre-flight then warns ``memory.overcommit`` instead of
        this path deadlocking a page-in."""
        with self._lock:
            prev = self._residents.get(model)
            if prev is not None:
                return prev.dslot
            # a model never measured is assumed the residents' mean size,
            # so that the byte budget bites on its first page-in too
            est = self._footprints.get(model, 0)
            if not est and self._residents:
                est = sum(r.footprint for r in self._residents.values())
                est //= len(self._residents)
        while True:
            now = self._clock()
            with self._lock:
                slots = sorted(range(len(self._devices)),
                               key=lambda i: self._slot_load_locked(i))
                dslot = slots[0]
                if self._fits_locked(dslot, est):
                    return dslot
                victim = self._coldest_locked(dslot, now, model)
            if victim is None:
                return dslot
            self._evict(victim.model, "capacity")

    def co_resident_bytes(self, model, dslot):
        """The bytes every other zoo model holds on the same device: what
        the Predictor's pre-flight adds, so ``memory.overcommit`` warns
        before a page-in runs out of memory."""
        with self._lock:
            return sum(r.footprint for r in self._residents.values()
                       if r.dslot == dslot and r.model != model)

    def _build_arm(self, model, version, dslot, site):
        """Build and warm one arm: apply the version's parameters to the
        shared block, snapshot them into a new Predictor on the slot's
        device, and capture one graph per bucket at ``site``. Returns the
        arm and ``{"built": captures, "disk": 0}``."""
        m = self._zoo._get(model)
        with self._lock:
            self._zoo.apply_version(model, version)
            pred = Predictor(
                m.block, m.spec, example=m.example, warmup=False,
                name="zoo:%s@%s" % (model, version),
                device=self._devices[dslot], site=site, int8=self._int8,
                co_resident=lambda: self.co_resident_bytes(model, dslot))
        before = (telemetry.retrace_stats(site) or {}).get("compiles", 0)
        pred.warmup()
        pred.param_version = version
        built = telemetry.retrace_stats(site)["compiles"] - before
        kw = dict(self._batcher_kw)
        kw.setdefault("max_batch_size", m.spec.max_batch)
        batcher = MicroBatcher(pred, clock=self._clock,
                               start=self._threaded, **kw)
        ctrl = None
        if self._use_controller:
            # predictive admission and the (per-tenant) attainment the
            # canary gate reads; a plain batcher has nothing to scale
            ctrl = ServingController(batcher, min_replicas=1,
                                     max_replicas=1)
        return _Arm(version, pred, batcher, ctrl), {"built": built,
                                                    "disk": 0}

    @staticmethod
    def _release(arm):
        """Free an arm whose batcher is closed: its graphs, pool and
        snapshot, and its footprint record."""
        arm.predictor.release()
        xprof.drop(arm.site, family=False)

    def _pagein_safe(self, model):
        try:
            self._pagein(model)
        except Exception as e:  # noqa: BLE001 — pending futures must fail
            _log.exception("zoo: page-in of %r failed", model)
            with self._lock:
                self._paging.discard(model)
                pend = self._pending.pop(model, ())
            err = MXNetError("zoo page-in of %r failed: %s: %s"
                             % (model, type(e).__name__, e))
            for p in pend:
                p.future._fail(err)

    def _pagein(self, model):
        """Place (evicting as needed), build and warm the stable arm,
        record its footprint, then flush the page-in queue into its
        batcher."""
        t0 = time.perf_counter()
        m = self._zoo._get(model)
        dslot = self._place(model)
        version = m.active
        arm, summary = self._build_arm(model, version, dslot,
                                       self._site(model))
        res = _Resident(model, dslot, self._devices[dslot], arm, summary)
        res.footprint = int(xprof.site_footprint(self._site(model),
                                                 family=True))
        with self._lock:
            self._footprints[model] = res.footprint
            self._residents[model] = res
            self._paging.discard(model)
            count = len(self._residents)
        telemetry.inc("zoo.pageins", tag=model)
        telemetry.observe("zoo.pagein_s", time.perf_counter() - t0)
        telemetry.gauge("zoo.resident_models", count)
        telemetry.gauge("zoo.hbm_resident_bytes", res.footprint, tag=model)
        telemetry.gauge("zoo.active_version",
                        self._zoo.version(model, version).ordinal,
                        tag=model)
        _log.info("zoo: paged in %s@%s on %s (%d graphs, footprint %.1f "
                  "MiB)", model, version, res.device, summary["built"],
                  res.footprint / 2**20)
        self._flush_pending(model, res)
        return res

    def _flush_pending(self, model, res):
        with self._lock:
            pend = self._pending.pop(model, None)
        if not pend:
            return
        now = self._clock()
        for p in pend:
            telemetry.observe("zoo.pagein_wait_s", max(0.0, now - p.t0))
            rem = None
            if p.deadline_ms is not None:
                rem = p.deadline_ms - (now - p.t0) * 1e3
                if rem <= 0:
                    # its deadline passed during the page-in: the verdict
                    # a queued expiry gets, which the attainment sees
                    telemetry.inc("serving.deadline_expired")
                    if res.stable.ctrl is not None:
                        res.stable.ctrl.note_expired(now, meta=p.meta)
                    p.future._fail(DeadlineExceeded(
                        "deadline passed during page-in of %r" % model))
                    continue
            try:
                inner = res.stable.batcher.submit(
                    p.inputs, deadline_ms=rem, priority=p.priority,
                    meta=p.meta)
            except (QueueFull, MXNetError) as e:
                p.future._fail(e)
            else:
                p.future._bind(inner)

    def _evict(self, model, reason):
        """Page a resident model out: its queued and in-flight futures
        complete first, then its graphs, pool and snapshot are released.
        Returns the number of graphs released."""
        with self._lock:
            res = self._residents.pop(model, None)
            if res is None:
                return 0
            count = len(self._residents)
        arms = [res.stable] + ([res.canary] if res.canary else [])
        released = 0
        for arm in arms:
            # close = drain (queued + in-flight complete) + worker stop;
            # new submits for this model already take the cold path
            arm.batcher.close(timeout=30.0)
            released += len(arm.predictor._buckets)
            self._release(arm)
        telemetry.inc("zoo.evictions", tag="%s:%s" % (model, reason))
        telemetry.gauge("zoo.resident_models", count)
        telemetry.gauge("zoo.hbm_resident_bytes", 0, tag=model)
        _log.info("zoo: evicted %s (%s): %d graphs released",
                  model, reason, released)
        return released

    def evict(self, model, reason="manual"):
        """Operational page-out."""
        return self._evict(model, reason)

    def ensure_resident(self, model):
        """Synchronous page-in: the model is routable when this returns."""
        with self._lock:
            res = self._residents.get(model)
            if res is not None:
                return res
            self._paging.add(model)
        try:
            return self._pagein(model)
        finally:
            with self._lock:
                self._paging.discard(model)

    # --------------------------------------------------------------- rollout
    def deploy(self, model, version, canary_frac=1.0, parity_example=None,
               parity_tol=None):
        """See :meth:`ModelZoo.deploy`. A model that is not resident only
        flips the registry's active version (its next page-in serves
        it)."""
        ver = self._zoo.version(model, version)
        telemetry.inc("zoo.deploys", tag=model)
        with self._lock:
            res = self._residents.get(model)
        if res is None:
            self._zoo.set_active(model, version)
            telemetry.gauge("zoo.active_version", ver.ordinal, tag=model)
            return {"model": model, "version": version, "mode": "staged"}
        if version == res.stable.version:
            return {"model": model, "version": version, "mode": "noop"}
        if canary_frac >= 1.0:
            self._swap_stable(res, version)
            return {"model": model, "version": version, "mode": "promoted"}
        if canary_frac <= 0.0:
            raise MXNetError("deploy: canary_frac must be in (0, 1] "
                             "(got %r)" % (canary_frac,))
        if res.canary is not None:
            raise MXNetError(
                "deploy: model %r already has canary %s@%s live — promote "
                "or roll it back first" % (model, model,
                                           res.canary.version))
        arm, _summary = self._build_arm(model, version, res.dslot,
                                        self._site(model) + ".canary")
        # the canary snapshotted its parameters: the shared block goes back
        # to the stable version, which the registry calls active
        self._zoo.apply_version(model, res.stable.version)
        if parity_example is not None:
            diff = self._parity_diff(res.stable.predictor, arm.predictor,
                                     parity_example)
            tol = PARITY_TOL if parity_tol is None else parity_tol
            if diff > tol:
                arm.batcher.close(timeout=5.0)
                self._release(arm)
                self._record_rollback(model, version, "parity")
                return {"model": model, "version": version,
                        "mode": "rolled_back", "reason": "parity",
                        "diff": diff}
        with self._lock:
            res.canary = arm
            res.canary_frac = float(canary_frac)
        telemetry.gauge("zoo.canary_frac", canary_frac, tag=model)
        _log.info("zoo: canary %s@%s live at %.0f%% of traffic",
                  model, version, canary_frac * 100)
        return {"model": model, "version": version, "mode": "canary",
                "canary_frac": canary_frac}

    @staticmethod
    def _parity_diff(stable_pred, canary_pred, example):
        """The largest absolute difference between the two arms' outputs
        on the probe input: the deploy-time parity gate."""
        args = example if isinstance(example, (tuple, list)) else (example,)

        def run(pred):
            flat, _fmt, _b = pred.predict_flat(args)
            return [o.to_torch().float().cpu() for o in flat]
        a, b = run(stable_pred), run(canary_pred)
        return float(max((x - y).abs().max().item() for x, y in zip(a, b)))

    def _swap_stable(self, res, version):
        """The promote path: the stable Predictor adopts ``version``'s
        parameters through ``refresh_params`` (no capture; the int8
        eligibility stays pinned)."""
        ver = self._zoo.version(res.model, version)
        with self._lock:
            self._zoo.apply_version(res.model, version)
            res.stable.predictor.refresh_params(version=version)
            res.stable.version = version
        self._zoo.set_active(res.model, version)
        telemetry.inc("zoo.promotes", tag=res.model)
        telemetry.gauge("zoo.active_version", ver.ordinal, tag=res.model)
        _log.info("zoo: %s now serving version %s (in-place parameter "
                  "swap)", res.model, version)

    def promote(self, model):
        """Promote the live canary: traffic stops routing to its arm, its
        queued and in-flight futures complete, the stable Predictor adopts
        the canary's version by ``refresh_params`` and the arm is
        released. No request drops."""
        with self._lock:
            res = self._residents.get(model)
            if res is None or res.canary is None:
                raise MXNetError("promote: model %r has no live canary"
                                 % (model,))
            arm = res.canary
            res.canary_frac = 0.0   # stop routing before the drain
        arm.batcher.close(timeout=30.0)  # in-flight futures complete
        self._swap_stable(res, arm.version)
        with self._lock:
            res.canary = None
        self._release(arm)
        telemetry.gauge("zoo.canary_frac", 0.0, tag=model)
        return {"model": model, "version": arm.version, "mode": "promoted"}

    def rollback(self, model, reason="manual"):
        """Roll the live canary back: traffic stops routing to it, its
        queued and in-flight futures complete on the canary's weights, the
        arm is released and the stable version serves on untouched."""
        with self._lock:
            res = self._residents.get(model)
            if res is None or res.canary is None:
                raise MXNetError("rollback: model %r has no live canary"
                                 % (model,))
            arm = res.canary
            res.canary_frac = 0.0
        arm.batcher.close(timeout=30.0)
        with self._lock:
            res.canary = None
        self._release(arm)
        self._record_rollback(model, arm.version, reason)
        telemetry.gauge("zoo.canary_frac", 0.0, tag=model)
        return {"model": model, "version": arm.version,
                "mode": "rolled_back", "reason": reason}

    @staticmethod
    def _record_rollback(model, version, reason):
        telemetry.inc("zoo.rollbacks", tag=reason)
        _log.warning("zoo: canary %s@%s rolled back (%s)",
                     model, version, reason)

    # ------------------------------------------------------------ evaluation
    def tick(self, now=None):
        """One control pass over every live canary's rollback gate (the
        injected fault first, then the attainment floor once the verdict
        window is full). :meth:`poll` drives it under a fake clock, the
        monitor thread in threaded mode."""
        if now is None:
            now = self._clock()
        with self._lock:
            live = [(m, r) for m, r in self._residents.items()
                    if r.canary is not None]
        for model, res in live:
            arm = res.canary
            if arm is None:
                continue
            if inject("canary_rollback"):
                self.rollback(model, "injected")
                continue
            if arm.ctrl is None:
                continue
            att, weight = arm.ctrl.attainment(now)
            if weight >= self.canary_window and att is not None \
                    and att < self.canary_floor:
                self.rollback(model, "slo")

    def poll(self):
        """One synchronous pass: run any pending page-in inline, one dispatch
        attempt on every live arm's batcher, then a gate tick. Returns the
        requests dispatched."""
        n = 0
        if not self._threaded:
            with self._lock:
                cold = [m for m in self._paging
                        if m not in self._residents]
            for model in cold:
                self._pagein_safe(model)
        with self._lock:
            residents = list(self._residents.values())
        for res in residents:
            n += res.stable.batcher.poll()
            if res.canary is not None:
                n += res.canary.batcher.poll()
        self.tick(self._clock())
        return n

    def _monitor_loop(self):
        while not self._stop.wait(0.05):
            if self._closed:
                return
            try:
                self.tick(self._clock())
            except Exception:  # noqa: BLE001 — gate errors must not kill
                _log.exception("zoo monitor tick failed")

    # ------------------------------------------------------------- reporting
    @property
    def queue_depth(self):
        with self._lock:
            residents = list(self._residents.values())
            pending = sum(p.n for dq in self._pending.values() for p in dq)
        depth = pending
        for res in residents:
            depth += res.stable.batcher.queue_depth
            if res.canary is not None:
                depth += res.canary.batcher.queue_depth
        return depth

    def input_templates(self, model):
        """The input templates of the model's resident stable arm (None
        while it is not resident: the HTTP front then converts JSON with
        numpy's own dtypes)."""
        with self._lock:
            res = self._residents.get(model)
        return res.stable.predictor.input_templates if res else None

    def view(self):
        """The ``/healthz`` zoo block: per-model residency, live versions,
        canary state, footprints, per-tenant attainment."""
        now = self._clock()
        with self._lock:
            residents = dict(self._residents)
            pending = {m: sum(p.n for p in dq)
                       for m, dq in self._pending.items() if dq}
            demand = {m: round(r.rate(now), 4)
                      for m, r in self._demand.items()}
        out = {"models": {}, "pending": pending, "demand": demand,
               "devices": len(self._devices),
               "resident_models": len(residents)}
        for model in self._zoo.models():
            res = residents.get(model)
            row = {"resident": res is not None,
                   "active_version": self._zoo.active_version(model),
                   "versions": self._zoo.versions(model)}
            if res is not None:
                row.update({
                    "device": str(res.device),
                    "resident_bytes": res.footprint,
                    "stable_version": res.stable.version,
                    "queue_depth": res.stable.batcher.queue_depth,
                    "warm_disk_hits": res.warm_summary["disk"],
                    "warm_compiles": res.warm_summary["built"]})
                if res.stable.ctrl is not None:
                    att, _w = res.stable.ctrl.attainment(now)
                    row["attainment"] = round(att, 4) if att is not None \
                        else None
                    row["tenant_attainment"] = \
                        res.stable.ctrl.tenant_attainment(now)
                if res.canary is not None:
                    c = {"version": res.canary.version,
                         "frac": res.canary_frac,
                         "queue_depth": res.canary.batcher.queue_depth}
                    if res.canary.ctrl is not None:
                        att, w = res.canary.ctrl.attainment(now)
                        c["attainment"] = round(att, 4) \
                            if att is not None else None
                        c["verdict_weight"] = round(w, 2)
                    row["canary"] = c
            out["models"][model] = row
        return out

    # ----------------------------------------------------------- drain/close
    def drain(self, timeout=None):
        """Stop admitting (submits shed ``draining``), fail the page-in
        waiters, finish everything queued and in flight on every arm.
        True when empty: the ModelServer's drain path."""
        with self._lock:
            self._draining = True
            pend = {m: list(dq) for m, dq in self._pending.items()}
            self._pending.clear()
            residents = list(self._residents.values())
        err = QueueFull("request shed: draining")
        for dq in pend.values():
            for p in dq:
                p.future._fail(err)
        ok = True
        for res in residents:
            ok = res.stable.batcher.drain(timeout=timeout) and ok
            if res.canary is not None:
                ok = res.canary.batcher.drain(timeout=timeout) and ok
        return ok

    def close(self, timeout=5.0):
        self.drain(timeout=timeout)
        with self._lock:
            self._closed = True
            residents = list(self._residents.values())
        self._stop.set()
        for res in residents:
            res.stable.batcher.close(timeout=timeout)
            if res.canary is not None:
                res.canary.batcher.close(timeout=timeout)
        if self._monitor is not None:
            self._monitor.join(timeout)
        return self
