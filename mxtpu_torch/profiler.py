"""mx.profiler: op-level profiling with chrome://tracing output
(counterpart of ``mxtpu/profiler.py``; ref: python/mxnet/profiler.py over
src/profiler/profiler.h).

Eager ops are timed at the dispatch boundary (``ndarray._apply``, one
attribute read when the profiler is off); a captured graph is one event
per call of whatever span brackets it. ``dump()`` writes the reference's
chrome-trace JSON: the op events, the telemetry spans of the profiled
window (``telemetry.events``) and the trace ring's causal edges as flow
events (``telemetry.trace_flows``); ``dumps()`` the aggregate table.

Device time: where the reference starts an XLA trace (``profile_xla=True``)
the port starts ``torch.profiler`` with CUDA activity (``profile_device``
is the same switch) and, at ``stop()``, writes its chrome trace, the
card's kernels with their device times, to ``xla_trace_dir`` (default
``<filename>.device.json``); ``device_summary()`` gives the kernels'
device milliseconds by name. A capture is bounded by ``xla_trace_max_s``
(default 120 s): past it a timer stops it.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump", "dumps",
           "ProfileTask", "ProfileFrame", "ProfileEvent", "ProfileScope",
           "scope", "record_event", "is_active", "device_summary"]


class _Profiler:
    def __init__(self):
        self.active = False
        self.events = []          # (name, cat, ts_us, dur_us, tid)
        self.clear_gen = 0        # bumped whenever events are cleared
        self.lock = threading.Lock()
        self.filename = "profile.json"
        self.aggregate = True
        self.profile_device = False
        self.device_path = None
        self.device_max_s = 120.0
        self.device_prof = None   # the running torch.profiler.profile
        self.device_rows = {}     # kernel name -> [device ms, count]
        self.device_timer = None
        self.window_start_us = None
        self.window_stop_us = None


_PROF = _Profiler()


def set_config(filename="profile.json", profile_all=False,
               profile_symbolic=True, profile_imperative=True,
               profile_memory=False, profile_api=False, aggregate_stats=True,
               profile_xla=False, xla_trace_dir=None, xla_trace_max_s=None,
               profile_device=None, **_kwargs):
    """(ref: profiler.py:set_config; the reference's other switches are
    accepted)"""
    _PROF.filename = filename
    _PROF.aggregate = aggregate_stats
    _PROF.profile_device = bool(profile_xla if profile_device is None
                                else profile_device)
    _PROF.device_path = xla_trace_dir or (filename + ".device.json")
    _PROF.device_max_s = (120.0 if xla_trace_max_s is None
                          else float(xla_trace_max_s))


def _start_device():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    _PROF.device_prof = prof
    t = threading.Timer(_PROF.device_max_s, _stop_device)
    t.daemon = True
    t.start()
    _PROF.device_timer = t


def _stop_device():
    """Idempotent: stop the device capture, keep its kernel rows and
    write its chrome trace."""
    prof, _PROF.device_prof = _PROF.device_prof, None
    if prof is None:
        return
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        rows = {}
        for e in prof.key_averages():
            ms = getattr(e, "device_time_total", 0) / 1e3
            if ms > 0:
                rows[e.key] = [ms, e.count]
        _PROF.device_rows = rows
        prof.export_chrome_trace(_PROF.device_path)
    except Exception:  # noqa: BLE001 - a stop must never raise
        pass


def start():
    """(ref: profiler.py:set_state('run'))"""
    _PROF.active = True
    _PROF.window_start_us = time.perf_counter_ns() // 1000
    _PROF.window_stop_us = None
    if _PROF.profile_device and _PROF.device_prof is None:
        _start_device()


def stop():
    _PROF.active = False
    _PROF.window_stop_us = time.perf_counter_ns() // 1000
    t, _PROF.device_timer = _PROF.device_timer, None
    if t is not None:
        t.cancel()
    _stop_device()


def pause():
    _PROF.active = False


def resume():
    _PROF.active = True


def record_event(name, cat, ts_us, dur_us):
    """One event (the op hook and the scopes call it)."""
    tid = threading.get_ident() & 0xFFFF
    with _PROF.lock:
        _PROF.events.append((name, cat, ts_us, dur_us, tid))


def is_active():
    return _PROF.active


def device_summary():
    """``{kernel name: (device ms, calls)}`` of the last device capture."""
    return {k: tuple(v) for k, v in _PROF.device_rows.items()}


def dumps(reset=False):
    """Aggregate statistics table as a string (ref: profiler.py:dumps)."""
    stats = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    with _PROF.lock:
        events = list(_PROF.events)
        if reset:
            _PROF.events.clear()
            _PROF.clear_gen += 1
    for name, _cat, _ts, dur, _tid in events:
        s = stats[name]
        s[0] += 1
        s[1] += dur
        s[2] = min(s[2], dur)
        s[3] = max(s[3], dur)
    lines = ["%-40s %10s %12s %12s %12s %12s" %
             ("Name", "Calls", "Total(us)", "Avg(us)", "Min(us)", "Max(us)")]
    for name in sorted(stats, key=lambda n: -stats[n][1]):
        cnt, total, mn, mx = stats[name]
        lines.append("%-40s %10d %12.1f %12.1f %12.1f %12.1f" %
                     (name, cnt, total, total / cnt, mn, mx))
    return "\n".join(lines)


def dump(finished=True, profile_process="worker"):
    """Write chrome://tracing JSON (ref: profiler.py:dump): the op events,
    the telemetry spans of the profiled window and the trace ring's flow
    events."""
    from . import telemetry
    with _PROF.lock:
        events = list(_PROF.events)
    lo, hi = _PROF.window_start_us, _PROF.window_stop_us
    tel = telemetry.events()
    if lo is not None:
        tel = [e for e in tel if e[2] >= lo and (hi is None or e[2] <= hi)]
    events = events + tel
    flows = telemetry.trace_flows(lo, hi)
    trace = {"traceEvents": [
        {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
        for name, cat, ts, dur, tid in events] + flows}
    with open(_PROF.filename, "w") as f:
        json.dump(trace, f)


# ------------------------------------------------------------ user scopes
class ProfileScope:
    """Context manager timing a custom region (ref: ProfileTask/Frame/Event,
    profiler.py:287+). A scope opened while the profiler is off records
    nothing; one opened in an active window records even if the profiler
    stops before it closes, but not across ``dumps(reset=True)``."""

    def __init__(self, name, cat="user"):
        self.name = name
        self.cat = cat
        self._t0 = None
        self._gen = None

    def start(self):
        if is_active():
            self._t0 = time.perf_counter_ns()
            self._gen = _PROF.clear_gen
        else:
            self._t0 = None

    def stop(self):
        if self._t0 is None:
            return
        if is_active() or self._gen == _PROF.clear_gen:
            dur = (time.perf_counter_ns() - self._t0) // 1000
            record_event(self.name, self.cat, self._t0 // 1000, dur)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


def _domain_name(domain, name):
    dn = getattr(domain, "name", None)
    return "%s:%s" % (dn, name) if dn else name


class ProfileTask(ProfileScope):
    def __init__(self, name, domain=None):
        super().__init__(_domain_name(domain, name), cat="task")


class ProfileFrame(ProfileScope):
    def __init__(self, name, domain=None):
        super().__init__(_domain_name(domain, name), cat="frame")


class ProfileEvent(ProfileScope):
    def __init__(self, name):
        super().__init__(name, cat="event")


def scope(name, cat="user"):
    return ProfileScope(name, cat)
