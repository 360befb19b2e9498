"""Fault-tolerant replica serving (counterpart of
``mxtpu/serving/replicas.py``): a ReplicaSet router with a wedge watchdog.

* :class:`ReplicaSet` -- one warmed :class:`~mxtpu_torch.serving.engine.
  Predictor` per device, each with its own parameter snapshot on its
  device and its builds counted at retrace site ``serving.predict.r<i>``.
  With no ``devices`` it takes every visible CUDA device (``n`` of them
  when given, from :func:`visible_devices`) and raises when there is none;
  the CPU runs replicas only when asked (``devices=["cpu", "cpu"]``).
* **Elasticity** -- ``add_replica`` grows the set by a replica in state
  ``warming``, never routed until ``warm_replica`` has captured every
  bucket at its own site (indices are never reused);
  ``remove_replica`` retires one, which stops pulling work and leaves the
  set once its in-flight work drained (``finalize_retiring``). The
  :class:`~mxtpu_torch.serving.controller.ServingController` drives both
  through the dispatcher, whose bring-up runs off the serving path.
* :class:`ReplicaDispatcher` -- a :class:`~mxtpu_torch.serving.batcher.
  MicroBatcher` with one dispatch worker per replica, all fed from the
  same FIFO cohorts (a busy or quarantined replica stops pulling work;
  under :meth:`poll` the least-loaded healthy replica takes the batch).
* **Wedge watchdog** -- every dispatch carries a deadline
  (``dispatch_timeout_ms``, default 10000). On a trip the replica is
  quarantined, the batch re-dispatches exactly once on a healthy replica
  (a batch that wedges twice fails its futures), and a late answer from
  the wedged call is dropped as stale.
* **Circuit breaker** -- ``breaker_threshold`` consecutive failures
  (default 3) quarantine a replica; a half-open probe runs the smallest
  bucket on it after ``breaker_backoff_ms`` (default 1000), doubling up to
  ``breaker_backoff_max_ms`` (default 30000) per failed probe. All state
  changes read the injected clock, so the whole matrix runs under a fake
  clock with no sleeps.

Fault kinds (``resilience.set_faults``): ``replica_fail@i`` -- the replica
running serving dispatch *i* raises; ``replica_wedge@i`` -- that dispatch
never answers. The defaults are the reference's ``MXTPU_SERVE_*`` levers;
the port reads no environment variable.

KV residency: ``attach_accountant`` takes a
:class:`~mxtpu_torch.serving.decode.KVCacheAccountant` whose pools are
tagged ``r<i>``; ``states()`` then reports each replica's resident KV
bytes (and a paged pool's pages), ``kv_admissible()`` is True while a
healthy replica's pool admits, the dispatcher sheds ``kv_residency`` when
none does, and the ServingController reads the accountant's pressure.
A wedge dumps ``flight_record("replica_wedge")`` and the failure that
opens a breaker ``flight_record("breaker_open")``, each with the batch's
traces; a wedge's dump is written after the serving lock is released.
"""
from __future__ import annotations

import logging
import threading
import time

import torch

from .. import telemetry
from ..base import MXNetError
from ..context import resolve_device
from ..resilience import inject
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .engine import Predictor

__all__ = ["Replica", "ReplicaSet", "ReplicaDispatcher", "ReplicaFailure",
           "visible_devices", "DISPATCH_TIMEOUT_MS", "BREAKER_THRESHOLD", "BREAKER_BACKOFF_MS",
           "BREAKER_BACKOFF_MAX_MS"]

_log = logging.getLogger("mxtpu_torch.serving")

# the reference's MXTPU_SERVE_DISPATCH_TIMEOUT_MS and _BREAKER_* defaults
DISPATCH_TIMEOUT_MS = 10000.0
BREAKER_THRESHOLD = 3
BREAKER_BACKOFF_MS = 1000.0
BREAKER_BACKOFF_MAX_MS = 30000.0

# "the device call has not returned": the dispatch keeps its watchdog
# entry armed and delivers nothing
_WEDGED = object()


def visible_devices():
    """The CUDA devices this process sees (``cuda:<i>``), where a replica
    goes when no device is named; empty without a card."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ReplicaFailure(MXNetError):
    """A replica-level dispatch failure (a device error or the injected
    ``replica_fail``): it counts toward that replica's breaker."""


class Replica:
    """One serving replica: a warmed Predictor on a device and its health.
    States: ``healthy`` (routable) -> ``quarantined`` (breaker open or
    wedged; a probe is due at ``probe_at``) -> ``probing`` -> back; and the
    elastic ones: ``warming`` (bring-up, never routed) -> ``healthy``, and
    ``retiring`` (drains its in-flight work) -> ``removed``."""

    __slots__ = ("index", "device", "predictor", "state", "consecutive",
                 "inflight", "dispatches", "wedged", "backoff_s", "probe_at",
                 "down_since")

    def __init__(self, index, device, predictor, backoff_s,
                 state="healthy"):
        self.index = index
        self.device = device
        self.predictor = predictor
        self.state = state
        self.consecutive = 0      # consecutive dispatch failures (breaker)
        self.inflight = 0         # batches executing here now
        self.dispatches = 0
        self.wedged = False       # a dispatch never returned
        self.backoff_s = backoff_s
        self.probe_at = None
        # clock of the breaker's opening: the continuous outage the
        # controller's replacement bound reads; a restore clears it
        self.down_since = None

    @property
    def tag(self):
        return "r%d" % self.index


class ReplicaSet:
    """One warmed Predictor per device and the health/routing state.

    ``block`` is shared: each replica's Predictor snapshots the parameters
    onto its own device and builds its own buckets. State changes take the
    clock value from the dispatcher (``now``), so the set never sleeps and
    never reads a clock itself."""

    def __init__(self, block, spec, n=None, devices=None, example=None,
                 warmup=True, name="predictor",
                 breaker_threshold=BREAKER_THRESHOLD,
                 breaker_backoff_ms=BREAKER_BACKOFF_MS,
                 breaker_backoff_max_ms=BREAKER_BACKOFF_MAX_MS, int8=False):
        if devices is None:
            avail = visible_devices()
            if not avail:
                raise MXNetError(
                    "ReplicaSet: no CUDA device is visible and no devices "
                    "were given: pass devices=['cpu', ...] to run replicas "
                    "on the host")
            count = len(avail) if n is None else int(n)
            if count < 1:
                raise MXNetError("ReplicaSet: need at least 1 replica")
            if count > len(avail):
                raise MXNetError(
                    "ReplicaSet: %d replicas requested but only %d device"
                    "(s) visible" % (count, len(avail)))
            devices = avail[:count]
        if not devices:
            raise MXNetError("ReplicaSet: empty device list")
        self.spec = spec
        self.threshold = int(breaker_threshold)
        self.backoff0_s = float(breaker_backoff_ms) / 1e3
        self.backoff_max_s = float(breaker_backoff_max_ms) / 1e3
        self._lock = threading.Lock()
        # what elastic growth builds a new replica from
        self._block, self._example = block, example
        self._name, self._int8 = name, int8
        self._accountant = None
        self.replicas = []
        for i, dev in enumerate(devices):
            self.replicas.append(self._new_replica(i, dev))
        # replica indices are identities, never positions: a retired
        # replica's retrace site and telemetry tags are never reused
        self._next_index = len(self.replicas)
        telemetry.gauge("serving.replicas", len(self.replicas))
        if warmup:
            self.warmup()

    def _new_replica(self, index, device, state="healthy"):
        dev = resolve_device(device)
        pred = Predictor(self._block, self.spec, example=self._example,
                         warmup=False, name="%s.r%d" % (self._name, index),
                         device=dev, site="serving.predict.r%d" % index,
                         int8=self._int8)
        return Replica(index, dev, pred, self.backoff0_s, state=state)

    # --------------------------------------------------- batcher interface
    @property
    def input_templates(self):
        return self.replicas[0].predictor.input_templates

    @property
    def warmed(self):
        """True once every serving replica built its buckets (one still in
        its bring-up is not serving yet)."""
        reps = [r for r in self.replicas if r.state != "warming"]
        return bool(reps) and all(r.predictor.warmed for r in reps)

    def warmup(self):
        """Build every bucket on every replica in one
        ``compile_service.warmup`` call over every member's entries (each
        member pre-flighted first; identical members share a group token,
        so one warm-up per bucket counts its FLOPs), then run each
        member's ``finish_warmup``; returns self."""
        from .. import compile_service
        entries = []
        for r in self.replicas:
            r.predictor.preflight()
            entries.extend(r.predictor.warmup_entries())
        compile_service.warmup(entries)
        for r in self.replicas:
            r.predictor.finish_warmup()
        return self

    def __len__(self):
        return len(self.replicas)

    # ------------------------------------------------------------ elasticity
    def _find_locked(self, index):
        for r in self.replicas:
            if r.index == index:
                return r
        raise MXNetError("ReplicaSet: no replica with index %d (live: %s)"
                         % (index, [r.index for r in self.replicas]))

    def _free_devices_locked(self):
        return [d for d in visible_devices()
                if not any(d == r.device for r in self.replicas)]

    def free_devices(self):
        """Visible devices no current replica (in any state) is on: where
        a replacement or a scale-up replica goes first."""
        with self._lock:
            return self._free_devices_locked()

    def add_replica(self, device=None, warm=True):
        """Grow the set by one replica in state ``warming``: listed in
        ``states()``, never routed until :meth:`warm_replica` has captured
        every bucket at its own new site ``serving.predict.r<i>``. With no
        ``device`` it takes the first free one and raises when every
        visible device hosts a replica. ``warm=False`` leaves the bring-up
        to the caller (the dispatcher runs it off the serving path).
        Returns the new replica."""
        with self._lock:
            idx = self._next_index
            self._next_index += 1
            if device is None:
                free = self._free_devices_locked()
                if not free:
                    raise MXNetError(
                        "ReplicaSet.add_replica: every visible device "
                        "already hosts a replica — pass device= to double "
                        "up explicitly")
                device = free[0]
            rep = self._new_replica(idx, device, state="warming")
            self.replicas.append(rep)
            telemetry.gauge("serving.replicas", len(self.replicas))
        if warm:
            self.warm_replica(rep)
        return rep

    def warm_replica(self, rep):
        """Capture the warming replica's buckets, then make it routable
        (``healthy``). A failed warm-up removes the replica and raises: a
        member that cannot build never joins. Returns the replica."""
        try:
            rep.predictor.warmup()
        except Exception:
            with self._lock:
                if rep in self.replicas:
                    self.replicas.remove(rep)
                telemetry.gauge("serving.replicas", len(self.replicas))
            raise
        with self._lock:
            if rep.state == "warming":
                rep.state = "healthy"
                telemetry.inc("serving.replica.joins", tag=rep.tag)
                _log.info("serving replica %d warmed and joined the "
                          "dispatch pool", rep.index)
        return rep

    def remove_replica(self, index):
        """Start retiring a replica (scale-down, or the dead half of a
        replacement): it turns ``retiring``, is never picked or probed, and
        leaves the set once its in-flight work drained
        (:meth:`finalize_retiring`): its in-flight futures always complete.
        Returns the replica."""
        with self._lock:
            rep = self._find_locked(index)
            if rep.state != "retiring":
                rep.state = "retiring"
                rep.probe_at = None
                telemetry.inc("serving.replica.retirements", tag=rep.tag)
                _log.info("serving replica %d retiring (inflight=%d)",
                          rep.index, rep.inflight)
            return rep

    def finalize_retiring(self):
        """Drop the retiring replicas whose in-flight work drained; their
        dispatch workers exit on state ``removed``. Returns them."""
        done = []
        with self._lock:
            for rep in [r for r in self.replicas
                        if r.state == "retiring" and r.inflight == 0]:
                rep.state = "removed"
                self.replicas.remove(rep)
                done.append(rep)
            if done:
                telemetry.gauge("serving.replicas", len(self.replicas))
        return done

    # ------------------------------------------------------------- routing
    def pick(self, exclude=()):
        """Least-loaded healthy replica (ties to the lowest index); None
        when every replica is down."""
        with self._lock:
            cands = [r for r in self.replicas
                     if r.state == "healthy" and r.index not in exclude]
            if not cands:
                return None
            return min(cands, key=lambda r: (r.inflight, r.index))

    def healthy_count(self):
        with self._lock:
            return sum(1 for r in self.replicas if r.state == "healthy")

    def acquire(self, rep):
        with self._lock:
            rep.inflight += 1
            rep.dispatches += 1

    def release(self, rep):
        with self._lock:
            rep.inflight -= 1

    # ------------------------------------------------------- health events
    def record_success(self, rep):
        with self._lock:
            rep.consecutive = 0

    def record_failure(self, rep, now):
        """One dispatch failure; opens the breaker at ``threshold``
        consecutive ones. True when this call opened it."""
        telemetry.inc("serving.replica.failures", tag=rep.tag)
        with self._lock:
            rep.consecutive += 1
            if rep.state == "healthy" and rep.consecutive >= self.threshold:
                self._open_locked(rep, now)
                return True
        return False

    def mark_wedged(self, rep, now):
        """Wedge-watchdog trip: the replica's dispatch never returned."""
        telemetry.inc("serving.replica.wedges", tag=rep.tag)
        with self._lock:
            rep.wedged = True
            if rep.state == "healthy":
                self._open_locked(rep, now)

    def force_quarantine(self, index, now, backoff_s=None):
        """Quarantine a replica as if its breaker opened; it probes back
        after ``backoff_s``."""
        with self._lock:
            rep = self._find_locked(index)
            if backoff_s is not None:
                rep.backoff_s = float(backoff_s)
            if rep.state == "healthy":
                self._open_locked(rep, now)
            else:
                rep.probe_at = now + rep.backoff_s
            return rep

    def _open_locked(self, rep, now):
        rep.state = "quarantined"
        rep.probe_at = now + rep.backoff_s
        if rep.down_since is None:
            rep.down_since = now
        telemetry.inc("serving.replica.quarantines", tag=rep.tag)
        _log.warning("serving replica %d quarantined (wedged=%s, "
                     "consecutive_failures=%d); half-open probe in %.1f s",
                     rep.index, rep.wedged, rep.consecutive, rep.backoff_s)

    # --------------------------------------------------------------- probes
    def due_probes(self, now):
        """Quarantined replicas whose backoff elapsed, each claimed
        (``probing``) before it is returned."""
        with self._lock:
            due = [r for r in self.replicas
                   if r.state == "quarantined" and r.probe_at is not None
                   and now >= r.probe_at]
            for r in due:
                r.state = "probing"
            return due

    def run_probe(self, rep):
        """The half-open probe: the smallest batch and sequence bucket on
        its padding, waited for. Raises on failure."""
        pred = rep.predictor
        if pred.input_templates is None:
            raise MXNetError("probe before settle: ReplicaSet needs "
                             "example= at construction")
        pred.run_bucket(self.spec.batch_sizes[0],
                        self.spec.seq_lens[0] if self.spec.seq_lens else None)

    def probe_result(self, rep, ok, now):
        """Half-open verdict: success restores the replica, failure doubles
        the backoff and quarantines it again."""
        with self._lock:
            if rep.state in ("retiring", "removed"):
                return  # written off mid-probe: a verdict cannot revive it
            if ok:
                rep.state = "healthy"
                rep.wedged = False
                rep.consecutive = 0
                rep.backoff_s = self.backoff0_s
                rep.probe_at = None
                rep.down_since = None
                telemetry.inc("serving.replica.restores", tag=rep.tag)
                _log.info("serving replica %d restored by half-open probe",
                          rep.index)
            else:
                rep.state = "quarantined"
                rep.backoff_s = min(rep.backoff_s * 2, self.backoff_max_s)
                rep.probe_at = now + rep.backoff_s
                _log.warning("serving replica %d probe failed; next probe "
                             "in %.1f s", rep.index, rep.backoff_s)

    # ----------------------------------------------------- KV accountability
    def attach_accountant(self, accountant):
        """Attach a ``KVCacheAccountant`` whose pools are tagged ``r<i>``
        (a rowed decode engine registers worst-case slots, a paged one its
        page pool): ``states()`` reports resident KV bytes and the
        dispatcher sheds ``kv_residency`` when no healthy replica admits.
        Returns self."""
        self._accountant = accountant
        return self

    @property
    def accountant(self):
        return self._accountant

    def kv_admissible(self):
        """True while at least one healthy replica's KV pool admits
        (always without an accountant)."""
        acct = self._accountant
        if acct is None:
            return True
        with self._lock:
            tags = [r.tag for r in self.replicas if r.state == "healthy"]
        return any(acct.would_admit(t) for t in tags)

    # ------------------------------------------------------------ reporting
    def states(self):
        """Per-replica health for ``/healthz``, with each replica's KV rows
        when an accountant is attached."""
        acct = self._accountant
        with self._lock:
            out = [{"replica": r.index, "device": str(r.device),
                    "state": r.state, "inflight": r.inflight,
                    "dispatches": r.dispatches,
                    "consecutive_failures": r.consecutive,
                    "wedged": r.wedged, "probe_at": r.probe_at}
                   for r in self.replicas]
        if acct is not None:
            snap = acct.snapshot()
            for row in out:
                tag = "r%d" % row["replica"]
                row["kv_resident_bytes"] = acct.resident_bytes(tag)
                pool = snap.get(tag)
                if pool is not None and pool.get("page_tokens"):
                    row["kv_page_tokens"] = pool["page_tokens"]
                    row["kv_pages"] = pool["slots"]
                    row["kv_pages_live"] = pool["live"]
        return out


class ReplicaDispatcher(MicroBatcher):
    """A MicroBatcher routed over a :class:`ReplicaSet`.

    Admission, coalescing, deadlines and shedding are the base class's;
    dispatch changes: one worker per replica (each pulls the next cohort
    only while its replica is healthy), every dispatch under the wedge
    watchdog, failures counted by the replica's breaker, and a monitor
    thread that scans for wedges and runs due probes. With
    ``start=False`` and an injected clock everything is synchronous:
    :meth:`poll` runs the scan and due probes, then dispatches one batch
    on the least-loaded healthy replica."""

    def __init__(self, replica_set, dispatch_timeout_ms=DISPATCH_TIMEOUT_MS,
                 **kwargs):
        if not isinstance(replica_set, ReplicaSet):
            raise MXNetError("ReplicaDispatcher routes a ReplicaSet (got "
                             "%s); plain Predictors take a MicroBatcher"
                             % type(replica_set).__name__)
        self._set = replica_set
        self._timeout_s = float(dispatch_timeout_ms) / 1e3
        self._watch = []          # armed dispatch/probe watchdog entries
        self._flight_pending = []  # wedge dumps, written out of the lock
        self._threads = []
        self._monitor = None
        self._stop = threading.Event()
        self._tls = threading.local()
        super().__init__(replica_set, **kwargs)

    @property
    def replica_set(self):
        return self._set

    def replica_states(self):
        """Per-replica health, for ``ModelServer``'s ``/healthz``."""
        return self._set.states()

    def quarantine_replica(self, index, backoff_s=None):
        """Operational kill switch (:meth:`ReplicaSet.force_quarantine`)."""
        self._set.force_quarantine(index, self._clock(), backoff_s)
        with self._cond:
            self._cond.notify_all()

    def submit(self, inputs, deadline_ms=None, priority="interactive",
               meta=None):
        if self._set.healthy_count() == 0:
            # a due probe may restore a replica before this refuses
            self._maintain()
            if self._set.healthy_count() == 0:
                self._shed("no_healthy_replica")
        if not self._set.kv_admissible():
            # every healthy replica's KV pool is over budget: shed by
            # residency, not queue depth
            self._shed("kv_residency")
        return super().submit(inputs, deadline_ms=deadline_ms,
                              priority=priority, meta=meta)

    # ---------------------------------------------------------- elasticity
    def add_replica(self, device=None):
        """Grow the pool by one replica. Its bring-up (a capture of every
        bucket at its new ``serving.predict.r<i>`` site) runs off the
        serving path: on a thread of its own in threaded mode, inline under
        :meth:`poll`. It joins dispatch once warm, with a worker of its own
        in threaded mode; a failed bring-up is reported to the controller
        as ``warmup_failed``. Returns the (maybe still warming) replica."""
        rep = self._set.add_replica(device=device, warm=False)

        def bringup():
            try:
                self._set.warm_replica(rep)  # a failure removes the replica
            except Exception as e:  # noqa: BLE001 — recorded, not lost
                _log.exception("serving: replica %d bring-up failed",
                               rep.index)
                if self._controller is not None:
                    self._controller.note_warmup_failed(e, self._clock())
                return
            with self._cond:
                self._cond.notify_all()
            if self._threads:
                self._spawn_worker(rep)

        if self._threads:
            threading.Thread(target=bringup, daemon=True,
                             name="mxtpu-serving-warmup-r%d"
                             % rep.index).start()
        else:
            bringup()
        return rep

    def remove_replica(self, index):
        """Retire a replica through the drain: it stops pulling work at
        once, its in-flight futures complete, and the next maintenance pass
        removes it."""
        rep = self._set.remove_replica(index)
        with self._cond:
            self._cond.notify_all()
        return rep

    # --------------------------------------------------------- maintenance
    @staticmethod
    def _probe_entry(rep, deadline):
        return {"kind": "probe", "rep": rep, "live": None, "idx": -1,
                "deadline": deadline, "done": False, "abandoned": False,
                "released": True}

    def _maintain(self):
        """Wedge scan and due half-open probes (from :meth:`poll` and
        admission). Probes run inline here, still under a watchdog entry,
        so a probe that wedges is ruled failed by the next scan."""
        now = self._clock()
        due = []
        with self._cond:
            self._scan_wedges_locked(now)
            for rep in self._set.due_probes(now):
                entry = self._probe_entry(rep, now + self._timeout_s)
                self._watch.append(entry)
                due.append((rep, entry))
        self._flush_flight()
        for rep, entry in due:
            self._probe(rep, entry)
        self._post_maintain()

    def _flush_flight(self):
        """Write the wedge dumps the scan deferred (never under the
        serving lock)."""
        if not self._flight_pending:
            return
        with self._cond:
            pending, self._flight_pending = self._flight_pending, []
        for reason, tids, extra in pending:
            telemetry.flight_record(reason, trace_ids=tids, extra=extra)

    def _post_maintain(self):
        """The elastic tail of every maintenance pass: drop the drained
        retiring replicas, then tick the attached controller (outside every
        lock: a bring-up is device work). Under a fake clock this is how
        :meth:`poll` drives the whole control plane."""
        self._set.finalize_retiring()
        if self._controller is not None:
            self._controller.tick(self._clock())

    def poll(self):
        self._maintain()
        if self._set.healthy_count() == 0:
            return 0  # nothing routable: requests stay queued
        return super().poll()

    def _scan_wedges_locked(self, now):
        """The wedge watchdog: an armed entry past its deadline quarantines
        its replica and re-dispatches its batch exactly once on a healthy
        replica (or sheds it when none is left); the wedged call's late
        answer is dropped."""
        for entry in list(self._watch):
            if entry["done"] or entry["abandoned"] \
                    or now < entry["deadline"]:
                continue
            entry["abandoned"] = True
            self._watch.remove(entry)
            rep = entry["rep"]
            if not entry["released"]:
                entry["released"] = True
                self._set.release(rep)
            if entry["kind"] == "probe":
                self._set.probe_result(rep, False, now)
                continue
            self._set.mark_wedged(rep, now)
            self._flight_pending.append(
                ("replica_wedge",
                 [r.trace.trace_id for r in entry["live"]
                  if r.trace is not None],
                 {"replica": rep.index, "dispatch": entry["idx"],
                  "timeout_ms": self._timeout_s * 1e3}))
            _log.warning(
                "serving: dispatch %d wedged on replica %d (no answer in "
                "%.0f ms) — replica quarantined, batch re-dispatching",
                entry["idx"], rep.index, self._timeout_s * 1e3)
            for r in entry["live"]:
                telemetry.trace_mark(r.trace, "serving.wedged")
            fresh = [r for r in entry["live"] if not r.redispatched]
            burnt = [r for r in entry["live"] if r.redispatched]
            for r in burnt:
                self._fail(r, DeadlineExceeded(
                    "re-dispatched batch wedged again (replica %d)"
                    % rep.index))
                telemetry.inc("serving.deadline_expired")
            if not fresh:
                continue
            if self._set.healthy_count() == 0:
                telemetry.inc("serving.shed", len(fresh),
                              tag="no_healthy_replica")
                err = QueueFull("request shed: no_healthy_replica (wedge "
                                "re-dispatch found no live replica)")
                for r in fresh:
                    self._fail(r, err)
                continue
            for r in reversed(fresh):
                r.redispatched = True
                telemetry.trace_mark(r.trace, "serving.redispatch")
                self._q.appendleft(r)  # head: it already waited its turn
                self._items += r.n
            telemetry.inc("serving.replica.redispatches", tag=rep.tag)
            telemetry.gauge("serving.queue_depth", self._items)
            self._cond.notify_all()

    def _probe(self, rep, entry=None):
        """Run one half-open probe (device work, never under the lock)."""
        ok = True
        try:
            with telemetry.span("serving.probe"):
                self._set.run_probe(rep)
        except Exception as e:  # noqa: BLE001 — verdict, not control flow
            ok = False
            _log.warning("serving replica %d half-open probe failed: %s",
                         rep.index, e)
        with self._cond:
            if entry is not None:
                if entry["abandoned"]:
                    return  # the scan already ruled it a wedged probe
                entry["done"] = True
                if entry in self._watch:
                    self._watch.remove(entry)
            self._set.probe_result(rep, ok, self._clock())
            self._cond.notify_all()

    # -------------------------------------------------------------- dispatch
    def _run_batch(self, live, joined, idx):
        now = self._clock()
        t_route = time.perf_counter()
        rep = getattr(self._tls, "rep", None)  # a worker owns its replica
        if rep is not None and rep.state != "healthy":
            rep = None
        if rep is None:
            rep = self._set.pick()
        if rep is None:
            telemetry.inc("serving.shed", len(live),
                          tag="no_healthy_replica")
            err = QueueFull("request shed: no_healthy_replica")
            for r in live:
                self._fail(r, err)
            return
        self._set.acquire(rep)
        telemetry.inc("serving.replica.dispatches", tag=rep.tag)
        entry = {"kind": "dispatch", "rep": rep, "live": live, "idx": idx,
                 "deadline": now + self._timeout_s,
                 "done": False, "abandoned": False, "released": False}
        with self._cond:
            self._watch.append(entry)
        self._share_stage(live, "serving.dispatch",
                          time.perf_counter() - t_route)
        try:
            host = self._execute(rep, joined, idx, live)
        except Exception as e:  # noqa: BLE001 — the breaker counts it
            with self._cond:
                abandoned = entry["abandoned"]
                entry["done"] = True
                if entry in self._watch:
                    self._watch.remove(entry)
                if not entry["released"]:
                    entry["released"] = True
                    self._set.release(rep)
                opened = self._set.record_failure(rep, self._clock())
                self._cond.notify_all()
            if opened:   # the failure that opened the breaker
                telemetry.flight_record(
                    "breaker_open",
                    trace_ids=[r.trace.trace_id for r in live
                               if r.trace is not None],
                    extra={"replica": rep.index, "dispatch": idx,
                           "error": "%s: %s" % (type(e).__name__, e)})
            if not abandoned:
                self._fail_batch(live, e, idx)
            return
        if host is _WEDGED:
            return  # the entry stays armed: the watchdog takes over
        with self._cond:
            stale = entry["abandoned"]
            entry["done"] = True
            if entry in self._watch:
                self._watch.remove(entry)
            if not entry["released"]:
                entry["released"] = True
                self._set.release(rep)
            self._set.record_success(rep)
            self._cond.notify_all()
        if stale:
            # the watchdog already re-dispatched this batch
            telemetry.inc("serving.replica.stale_results", tag=rep.tag)
            return
        self._deliver(live, host)

    def _execute(self, rep, joined, idx, live=()):
        if inject("replica_fail", idx):
            raise ReplicaFailure(
                "injected replica failure (dispatch %d, replica %d)"
                % (idx, rep.index))
        if inject("replica_wedge", idx):
            return _WEDGED
        t0 = time.perf_counter()
        flat, _fmt, _bucket = rep.predictor.predict_flat(tuple(joined))
        self._share_stage(live, "serving.predict", time.perf_counter() - t0)
        t0 = time.perf_counter()
        with telemetry.span("serving.fetch", cat="sync"):
            host = [o.asnumpy() for o in flat]
        self._share_stage(live, "serving.fetch", time.perf_counter() - t0)
        return host

    # ---------------------------------------------------------------- worker
    def _spawn_worker(self, rep):
        t = threading.Thread(target=self._replica_worker, args=(rep,),
                             daemon=True,
                             name="mxtpu-serving-replica-%d" % rep.index)
        self._threads.append(t)
        t.start()
        return t

    def start(self):
        if self._threads:
            return self
        if not self._set.warmed:
            raise MXNetError(
                "ReplicaDispatcher.start on a cold ReplicaSet: warmup() "
                "every replica first")
        for rep in self._set.replicas:
            self._spawn_worker(rep)
        interval = max(0.005, min(0.25, self._timeout_s / 4))
        self._monitor = threading.Thread(
            target=self._monitor_loop, args=(interval,), daemon=True,
            name="mxtpu-serving-monitor")
        self._monitor.start()
        self._thread = self._threads[0]  # base-class compatibility
        return self

    def _replica_worker(self, rep):
        self._tls.rep = rep
        try:
            self._worker_loop_for(rep)
        except Exception as e:  # noqa: BLE001 — the base class's barrier
            self._worker_crashed(e)

    def _worker_loop_for(self, rep):
        # MicroBatcher._worker_loop with a wedge scan and a routability
        # check per iteration, and bounded waits everywhere
        while True:
            with self._cond:
                batch = None
                while batch is None:
                    if self._closed and not self._q:
                        return
                    if rep.state == "removed":
                        return  # retired and drained
                    now = self._clock()
                    self._scan_wedges_locked(now)
                    if rep.state != "healthy":
                        self._cond.wait(0.05)
                        continue
                    batch = self._gather_locked(now)
                    if batch is not None:
                        break
                    if self._q:
                        head_due = self._q[0].t_enq + self.max_wait_s - now
                        self._cond.wait(min(max(head_due, 1e-4), 0.25))
                    else:
                        self._cond.wait(0.25)
                self._inflight += len(batch)
            self._flush_flight()
            try:
                self._dispatch(batch)
            finally:
                with self._cond:
                    self._inflight -= len(batch)
                    self._cond.notify_all()

    def _monitor_loop(self, interval):
        """Wedge scans and probe scheduling in real time. Probes run on
        threads of their own, each under its watchdog entry."""
        while not self._stop.is_set():
            due = []
            with self._cond:
                if self._closed and not self._q and not self._watch:
                    return
                now = self._clock()
                self._scan_wedges_locked(now)
                for rep in self._set.due_probes(now):
                    entry = self._probe_entry(rep, now + self._timeout_s)
                    self._watch.append(entry)
                    due.append((rep, entry))
            self._flush_flight()
            for rep, entry in due:
                threading.Thread(
                    target=self._probe, args=(rep, entry), daemon=True,
                    name="mxtpu-serving-probe-%d" % rep.index).start()
            self._post_maintain()
            self._stop.wait(interval)

    # ------------------------------------------------------- drain / close
    def _worker_alive(self):
        return any(t.is_alive() for t in self._threads)

    def _pending_extra(self):
        return any(e["kind"] == "dispatch" and not e["done"]
                   for e in self._watch)

    def _abort_extra_locked(self, err):
        dead = []
        for entry in self._watch:
            if entry["kind"] == "dispatch" and not entry["done"] \
                    and not entry["abandoned"]:
                entry["abandoned"] = True
                dead.extend(entry["live"])
        self._watch = [e for e in self._watch if e["kind"] != "dispatch"]
        return dead

    def close(self, timeout=5.0):
        self.drain(timeout=timeout)
        with self._cond:
            self._closed = True
            self._draining = True
            self._cond.notify_all()
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        if self._monitor is not None:
            self._monitor.join(timeout)
        return self
