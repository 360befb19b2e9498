"""Fleet observability plane (counterpart of ``mxtpu/fleet_obs.py``).

The telemetry registry, the trace ring, the xprof ledger, ``perf.mfu``
and Prometheus ``/metrics`` are each one process's; this module federates
them over the fleet's status board (``fleet.FleetMembership``'s
directory), host-side only:

* **Per-host publication** -- :class:`HostObsPublisher` writes a bounded
  snapshot ``obs_<rank>.json`` beside the heartbeat files (atomic): the
  counters, gauges, histogram quantiles, retrace table, the ledger's
  digest and the newest trace events. ``install()`` rides
  ``telemetry.on_flush``, so every flush, the exit's included, refreshes
  it.
* **Coordinator merge** -- :class:`FleetObservatory` folds every blob and
  heartbeat into one snapshot: per-host rows and the fleet's aggregates
  (``fleet.mfu`` weighted by each host's executed ledger FLOPs,
  ``fleet.step_s`` p50/p99 across the hosts' ``trainer.step`` medians,
  each host's heartbeat age), ``refresh()`` into the local registry and a
  ``host="<rank>"``-labelled Prometheus text on
  ``telemetry.register_prometheus_extra``.
* **Sentinels** -- :class:`StragglerSentinel` names a rank persistently
  slower than ``factor`` x the fleet median off the step barrier's
  payloads (``flight_record("straggler")`` with its dominant stage);
  :class:`RegressionSentinel` watches one host's rolling step time for
  drift (``flight_record("step_regression")``). With ``profile_on_trip``
  a trip opens one bounded ``torch.profiler`` window a trip reason
  (``mxtpu_torch.profiler`` with device activity), written beside the
  flight records and closed on the training thread.

The blobs and barrier payloads keep the reference's names and fields, so
either package reads the other's board. The reference reads
``MXTPU_FLEET_OBS_S``, ``MXTPU_STRAGGLER_X`` and
``MXTPU_PROFILE_ON_TRIP`` (all off by default); here they are the
arguments ``interval_s``, ``factor`` and ``profile_on_trip`` with those
defaults.
"""
from __future__ import annotations

import glob as _glob
import json
import logging
import os
import statistics
import threading
import time

from . import telemetry, xprof
from .fleet import _atomic_write

_log = logging.getLogger("mxtpu_torch.fleet_obs")

__all__ = ["host_snapshot", "publish_obs", "HostObsPublisher",
           "FleetObservatory", "StragglerSentinel", "RegressionSentinel",
           "close_profile", "step_traces"]

# Bounds on the published blob: cheap to write at flush cadence and to
# re-read on every scrape.
TRACE_TAIL = 64
LEDGER_TOP = 16

# One bounded profiler window a trip reason a process.
PROFILE_WINDOW_S = 1.0
_PROFILE_DONE = set()
_PROFILE_LOCK = threading.Lock()
_PROFILE_OPEN = {"until": None}   # the open window's end (monotonic)


# ------------------------------------------------- per-host publication
def _ledger_digest():
    """The ledger's bounded view: its summary, the executed FLOPs of the
    training sites and the top sites by executed FLOPs."""
    if not xprof.enabled():
        return None
    digest = {"summary": xprof.summary(),
              "executed_flops": xprof.executed_flops(xprof.TRAIN_SITES)}
    rows = []
    for e in xprof.ledger_snapshot():
        fl = e.get("flops") or 0
        rows.append({"site": e.get("site"), "calls": e.get("calls"),
                     "flops": fl,
                     "executed_flops": fl * (e.get("calls") or 0)})
    rows.sort(key=lambda r: -(r["executed_flops"] or 0))
    digest["sites"] = rows[:LEDGER_TOP]
    return digest


def host_snapshot(rank, step=None):
    """The bounded blob :func:`publish_obs` writes (host bookkeeping
    only; nothing waits on the device)."""
    snap = telemetry.snapshot()
    return {
        "rank": int(rank),
        "pid": os.getpid(),
        "step": None if step is None else int(step),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": snap["histograms"],
        "retrace": snap["retrace"],
        "ledger": _ledger_digest(),
        "trace_tail": telemetry.trace_events()[-TRACE_TAIL:],
    }


def publish_obs(fleet_dir, rank, step=None, t=None):
    """Write this host's ``obs_<rank>.json`` on the board (atomic). An
    error is counted (``fleet.obs.errors``), never raised."""
    path = os.path.join(fleet_dir, "obs_%d.json" % int(rank))
    try:
        blob = host_snapshot(rank, step=step)
        blob["t"] = time.time() if t is None else t
        _atomic_write(path, json.dumps(blob, default=str))
        telemetry.inc("fleet.obs.publishes")
        return path
    except Exception as e:  # noqa: BLE001 - must not kill training
        telemetry.inc("fleet.obs.errors")
        _log.warning("obs publish failed for rank %s: %s", rank, e)
        return None


class HostObsPublisher:
    """One host's blob on a cadence: ``maybe_publish(step)`` writes when
    ``interval_s`` (0, the default: never) has passed since the last;
    ``install()`` also publishes on every telemetry flush."""

    def __init__(self, fleet_dir, rank, interval_s=0.0, clock=None):
        self.fleet_dir = fleet_dir
        self.rank = int(rank)
        self.interval_s = float(interval_s or 0.0)
        self._clock = clock or time.time
        self._last = None
        self._step = None
        self._installed = False

    @property
    def path(self):
        return os.path.join(self.fleet_dir, "obs_%d.json" % self.rank)

    def publish(self, step=None):
        if step is not None:
            self._step = int(step)
        out = publish_obs(self.fleet_dir, self.rank, step=self._step,
                          t=self._clock())
        self._last = self._clock()
        return out

    def maybe_publish(self, step=None):
        """Publish when the cadence window has passed; the path or None."""
        if step is not None:
            self._step = int(step)
        if self.interval_s <= 0:
            return None
        now = self._clock()
        if self._last is not None and now - self._last < self.interval_s:
            return None
        return self.publish()

    def install(self):
        """Publish on every telemetry flush (the exit's too)."""
        if not self._installed:
            telemetry.on_flush(self.publish)
            self._installed = True
        return self


# ------------------------------------------------------ coordinator side
def _median(vals):
    return statistics.median(vals) if vals else None


def _quantile(vals, q):
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(int(q * len(vals)), len(vals) - 1)]


def _read_records(pattern):
    out = {}
    for p in sorted(_glob.glob(pattern)):
        try:
            with open(p) as f:
                rec = json.load(f)
            out[int(rec["rank"])] = rec
        except Exception:  # noqa: BLE001 - absent or torn: not seen
            continue
    return out


class FleetObservatory:
    """The coordinator's merge of every host's blob and heartbeat. Reads
    the board only: a missing or torn blob leaves that host out."""

    def __init__(self, fleet_dir, num_hosts=None, clock=None):
        self.fleet_dir = fleet_dir
        self.num_hosts = num_hosts
        self._clock = clock or time.time

    def blobs(self):
        """``{rank: blob}`` of every readable ``obs_<rank>.json``."""
        return _read_records(os.path.join(self.fleet_dir, "obs_*.json"))

    def heartbeats(self):
        """``{rank: heartbeat record}`` off the board."""
        return _read_records(os.path.join(self.fleet_dir, "host_*.json"))

    def merged(self):
        """Per-host rows and the fleet's aggregates (module docstring):
        ``fleet.mfu`` weights each host's ``perf.mfu`` by its executed
        FLOPs (an idle host must not drag it); ``fleet.step_s`` takes the
        hosts' own ``trainer.step`` medians, so one straggler shows in the
        p99."""
        now = self._clock()
        blobs = self.blobs()
        beats = self.heartbeats()
        hosts = {}
        for rank in sorted(set(blobs) | set(beats)):
            blob = blobs.get(rank) or {}
            beat = beats.get(rank) or {}
            gauges = blob.get("gauges") or {}
            hists = blob.get("histograms") or {}
            ledger = blob.get("ledger") or {}
            mfu = gauges.get("perf.mfu")
            if isinstance(mfu, dict):
                mfu = mfu.get("_untagged")
            step_h = hists.get("trainer.step") or {}
            hosts[rank] = {
                "rank": rank,
                "status": beat.get("status"),
                "step": blob.get("step", beat.get("step")),
                "pid": blob.get("pid", beat.get("pid")),
                "mfu": mfu,
                "executed_flops": ledger.get("executed_flops"),
                "step_s": {k: step_h.get(k)
                           for k in ("count", "p50", "p99", "max")},
                "heartbeat_age_s": (round(now - beat["t"], 3)
                                    if beat.get("t") is not None else None),
                "blob_age_s": (round(now - blob["t"], 3)
                               if blob.get("t") is not None else None),
            }
        fl_pairs = [(h["mfu"], h["executed_flops"])
                    for h in hosts.values() if h["mfu"] is not None]
        fleet_mfu = None
        if fl_pairs:
            wsum = sum(fl or 0 for _, fl in fl_pairs)
            if wsum > 0:
                fleet_mfu = sum(m * (fl or 0) for m, fl in fl_pairs) / wsum
            else:
                fleet_mfu = sum(m for m, _ in fl_pairs) / len(fl_pairs)
        p50s = [h["step_s"]["p50"] for h in hosts.values()
                if h["step_s"].get("p50") is not None]
        up = [r for r, h in hosts.items()
              if h["status"] not in (None, "left", "dead")]
        return {
            "t": now,
            "hosts": hosts,
            "fleet": {
                "mfu": fleet_mfu,
                "step_s": {"p50": _median(p50s),
                           "p99": _quantile(p50s, 0.99)},
                "hosts_up": len(up),
                "hosts_seen": len(hosts),
                "executed_flops": sum(h["executed_flops"] or 0
                                      for h in hosts.values()),
            },
        }

    def refresh(self):
        """Merge and land the aggregates in the local registry
        (``fleet.mfu``, ``fleet.step_s{p50,p99}``,
        ``fleet.heartbeat_age_s{host<r>}``, ``fleet.hosts_up``)."""
        m = self.merged()
        fl = m["fleet"]
        if fl["mfu"] is not None:
            telemetry.gauge("fleet.mfu", fl["mfu"])
        for q in ("p50", "p99"):
            if fl["step_s"].get(q) is not None:
                telemetry.gauge("fleet.step_s", fl["step_s"][q], tag=q)
        telemetry.gauge("fleet.hosts_up", fl["hosts_up"])
        for rank, h in m["hosts"].items():
            if h["heartbeat_age_s"] is not None:
                telemetry.gauge("fleet.heartbeat_age_s",
                                h["heartbeat_age_s"], tag="host%d" % rank)
        return m

    def prometheus(self):
        """Every host's published counters, gauges and histogram summaries
        under the registry's family names with a ``host="<rank>"`` label
        (and ``tag`` for tagged families), after a ``refresh()``."""
        self.refresh()
        pn, pl = telemetry._prom_name, telemetry._prom_label
        lines = []
        for rank, blob in sorted(self.blobs().items()):
            host = 'host="%s"' % pl(str(rank))
            for kind, typ in (("counters", "counter"), ("gauges", "gauge")):
                for name, val in sorted((blob.get(kind) or {}).items()):
                    base = pn(name)
                    lines.append("# TYPE %s %s" % (base, typ))
                    if isinstance(val, dict):
                        for tag, v in sorted(val.items()):
                            if tag == "_untagged":
                                lines.append("%s{%s} %s" % (base, host, v))
                            else:
                                lines.append('%s{%s,tag="%s"} %s'
                                             % (base, host, pl(tag), v))
                    else:
                        lines.append("%s{%s} %s" % (base, host, val))
            for name, h in sorted((blob.get("histograms") or {}).items()):
                base = pn(name)
                lines.append("# TYPE %s summary" % base)
                for q in ("p50", "p99"):
                    if h.get(q) is not None:
                        lines.append('%s{%s,quantile="%s"} %s'
                                     % (base, host, q[1:], h[q]))
                lines.append("%s_sum{%s} %s" % (base, host, h.get("sum", 0)))
                lines.append("%s_count{%s} %s"
                             % (base, host, h.get("count", 0)))
        return "\n".join(lines)

    def install(self):
        """Serve the fleet view from this process's ``/metrics``."""
        telemetry.register_prometheus_extra(self.prometheus)
        return self


# ------------------------------------------------------------- sentinels
def _maybe_profile(reason, enabled):
    """With ``enabled`` and a flight directory, open ONE bounded profiler
    window for ``reason`` in this process (a repeat trip is the same
    pathology): ``mxtpu_torch.profiler`` with device activity, its files
    in ``<flight dir>/profile_<reason>_<pid>/``. torch.profiler must stop
    on the thread that started it, so the window closes at the first
    sentinel observation (or ``close_profile()``) after
    ``PROFILE_WINDOW_S``, not on a timer's thread. Skipped while the
    profiler is already running; never raises."""
    if not enabled:
        return None
    out_dir = telemetry.flight_dir()
    if out_dir is None:
        return None
    from . import profiler
    with _PROFILE_LOCK:
        if reason in _PROFILE_DONE or profiler.is_active():
            return None
        _PROFILE_DONE.add(reason)
    out = os.path.join(out_dir, "profile_%s_%d" % (reason, os.getpid()))
    try:
        os.makedirs(out, exist_ok=True)
        profiler.set_config(filename=os.path.join(out, "profile.json"),
                            profile_device=True,
                            xla_trace_dir=os.path.join(out, "device.json"))
        profiler.start()
        _PROFILE_OPEN["until"] = time.monotonic() + PROFILE_WINDOW_S
        telemetry.inc("fleet.profile_captures", tag=str(reason))
        return out
    except Exception as e:  # noqa: BLE001 - observability must not kill
        _log.warning("profile-on-trip (%s) failed: %s", reason, e)
        return None


def close_profile(force=False):
    """Close the trip's profiler window once ``PROFILE_WINDOW_S`` has
    passed (now, with ``force``): stop and write it. Returns True when a
    window closed."""
    until = _PROFILE_OPEN["until"]
    if until is None or (not force and time.monotonic() < until):
        return False
    _PROFILE_OPEN["until"] = None
    from . import profiler
    try:
        profiler.stop()
        profiler.dump()
    except Exception as e:  # noqa: BLE001 - a stop must never raise
        _log.warning("profile-on-trip stop failed: %s", e)
    return True


def _stage_time(payload):
    """The step seconds a payload claims (a dict's ``stages``; a bare
    fingerprint list claims none)."""
    if not isinstance(payload, dict):
        return None
    stages = payload.get("stages") or {}
    if not stages:
        return None
    return sum(v for v in stages.values() if v is not None)


class StragglerSentinel:
    """Names the slow rank. ``observe(step, payloads)`` takes each step's
    ``Fleet.step_barrier`` map; a rank above ``factor`` (0, the default:
    off) x the fleet median for ``streak`` observations in a row trips
    ``flight_record("straggler")`` with its stages, dominant stage and
    ledger digest, and counts ``fleet.straggler_trips{host<r>}``. A
    recovered rank re-arms. The barrier-arrival skew lands in
    ``fleet.arrival_skew_s{host<r>}``."""

    def __init__(self, factor=0.0, streak=3, profile_on_trip=False):
        self.factor = float(factor or 0.0)
        self.streak = max(int(streak), 1)
        self.profile_on_trip = bool(profile_on_trip)
        self._streaks = {}
        self._tripped = set()
        self.trips = []

    def observe(self, step, payloads):
        """The trip record if this observation tripped, else None."""
        close_profile()
        if self.factor <= 0 or not payloads:
            return None
        arrivals = {r: p["t"] for r, p in payloads.items()
                    if isinstance(p, dict) and p.get("t") is not None}
        if arrivals:
            first = min(arrivals.values())
            for r, t in arrivals.items():
                telemetry.gauge("fleet.arrival_skew_s", round(t - first, 6),
                                tag="host%d" % r)
        times = {r: _stage_time(p) for r, p in payloads.items()}
        valid = [t for t in times.values() if t]
        if len(valid) < 2:
            return None
        med = _median(valid)
        trip = None
        for r, t in sorted(times.items()):
            if t is None:
                continue
            if med > 0 and t > self.factor * med:
                self._streaks[r] = self._streaks.get(r, 0) + 1
                if self._streaks[r] >= self.streak and r not in self._tripped:
                    trip = self._trip(step, r, t, med, payloads[r])
            else:
                self._streaks[r] = 0
                self._tripped.discard(r)
        return trip

    def _trip(self, step, rank, t, med, payload):
        self._tripped.add(rank)
        stages = payload.get("stages") or {}
        dominant = (max(stages.items(), key=lambda kv: kv[1] or 0)[0]
                    if stages else None)
        rec = {"rank": rank, "step": step, "step_s": t,
               "fleet_median_s": med,
               "ratio": round(t / med, 3) if med else None,
               "factor": self.factor, "stages": stages,
               "dominant_stage": dominant,
               "trace": payload.get("trace"),
               "ledger": _ledger_digest()}
        self.trips.append(rec)
        telemetry.inc("fleet.straggler_trips", tag="host%d" % rank)
        trace = payload.get("trace")
        telemetry.flight_record(
            "straggler", trace_ids=(trace,) if trace else (), extra=rec)
        _maybe_profile("straggler", self.profile_on_trip)
        return rec


class RegressionSentinel:
    """One host's slow drift: the rolling RECENT median of step times above
    ``factor`` (0: off) x the rolling BASELINE median trips
    ``flight_record("step_regression")`` and ``fleet.step_regressions``,
    once an excursion (re-armed when the recent window recovers). A step
    twice as slow that still finishes never trips the wedge watchdog; it
    trips here."""

    def __init__(self, factor=0.0, baseline_n=8, recent_n=4,
                 profile_on_trip=False):
        self.factor = float(factor or 0.0)
        self.baseline_n = max(int(baseline_n), 1)
        self.recent_n = max(int(recent_n), 1)
        self.profile_on_trip = bool(profile_on_trip)
        self._hist = []
        self._tripped = False
        self.trips = []

    def observe(self, step, dur_s):
        """Feed one step's seconds; the trip record or None."""
        close_profile()
        if self.factor <= 0 or dur_s is None:
            return None
        self._hist.append(float(dur_s))
        bound = self.baseline_n + self.recent_n
        if len(self._hist) > bound:
            del self._hist[:-bound]
        if len(self._hist) < bound:
            return None
        baseline = _median(self._hist[:-self.recent_n])
        recent = _median(self._hist[-self.recent_n:])
        if baseline and recent > self.factor * baseline:
            if self._tripped:
                return None
            self._tripped = True
            rec = {"step": step, "baseline_s": baseline,
                   "recent_s": recent,
                   "ratio": round(recent / baseline, 3),
                   "factor": self.factor}
            self.trips.append(rec)
            telemetry.inc("fleet.step_regressions")
            telemetry.flight_record("step_regression", extra=rec)
            _maybe_profile("step_regression", self.profile_on_trip)
            return rec
        self._tripped = False
        return None


# ------------------------------------------------- cross-host stitching
def step_traces(fleet_dir, limit=None):
    """Each step's critical path off the board's ``barrier_step_*``
    directories: which rank arrived last, by how much, and the dominant
    stage of its breakdown; rows by step, dict payloads only."""
    rows = []
    for d in _glob.glob(os.path.join(fleet_dir, "barrier_step_*")):
        try:
            step = int(os.path.basename(d)[len("barrier_step_"):])
        except ValueError:
            continue
        payloads = {}
        for p in _glob.glob(os.path.join(d, "host_*")):
            try:
                with open(p) as f:
                    rec = json.load(f)
                payloads[int(rec["rank"])] = rec.get("payload")
            except Exception:  # noqa: BLE001 - absent or torn
                continue
        arrivals = {r: pl["t"] for r, pl in payloads.items()
                    if isinstance(pl, dict) and pl.get("t") is not None}
        times = {r: _stage_time(pl) for r, pl in payloads.items()}
        times = {r: t for r, t in times.items() if t is not None}
        if arrivals:
            last_rank = max(arrivals, key=arrivals.get)
            skew = arrivals[last_rank] - min(arrivals.values())
        elif times:
            last_rank = max(times, key=times.get)
            skew = None
        else:
            continue
        pl = payloads.get(last_rank) or {}
        stages = pl.get("stages") if isinstance(pl, dict) else None
        dominant = (max(stages.items(), key=lambda kv: kv[1] or 0)[0]
                    if stages else None)
        rows.append({
            "step": step, "ranks": len(payloads),
            "last_rank": last_rank,
            "skew_s": None if skew is None else round(skew, 6),
            "step_s": times.get(last_rank),
            "dominant_stage": dominant,
            "trace": pl.get("trace") if isinstance(pl, dict) else None,
            "stages": stages or {},
        })
    rows.sort(key=lambda r: r["step"])
    if limit is not None:
        rows = rows[-int(limit):]
    return rows
