"""Runtime telemetry: metrics registry, spans, retrace watchdog, request
traces (counterpart of ``mxtpu/telemetry.py``).

The part of the JAX package's telemetry that the serving plane calls:

* **Registry** -- process-global counters, gauges and histograms
  (``inc``, ``gauge``, ``observe``, ``value``, ``tagged``,
  ``gauge_value``, ``reset_metric``), ``snapshot()`` for a structured
  view, ``report()`` for the aggregate table and ``prometheus()`` for
  the text exposition format. Increments are one short lock, no device
  work and no syncs.
* **Spans** -- ``with telemetry.span("serving.predict"): ...`` times a host
  region into a histogram; ``d2h=True`` attributes the device-to-host
  syncs made on this thread inside the region (``record_d2h``, called by
  ``NDArray.asnumpy``) to ``<name>.d2h``.
* **Retrace watchdog** -- ``record_retrace(site)`` counts one build at a
  site (here a captured CUDA graph, or a bucket's first eager run on the
  CPU); past the budget (``set_retrace_budget``, default 64) it warns
  and counts a trip.
* **Request traces** -- a ``TraceContext`` carried in a ``ContextVar``,
  handed across threads only by ``trace_handoff``; ``add_stage`` credits
  a stage's seconds to a trace and ``trace_breakdown`` folds them into
  the per-request latency breakdown the HTTP front returns.
* **Metric families of the serving plane** -- ``serving.*`` (the
  batcher, replicas and front), ``serving.controller.decisions{action}``,
  ``serving.controller.replica_target`` and
  ``serving.tenant_attainment{tenant}`` (the controller), ``zoo.*`` (the
  model zoo's page-ins, evictions, rollouts and residency) and
  ``memory.*`` (``xprof``'s footprints and pre-flight); each module's
  docstring lists its own.

The JAX package reads ``MXTPU_TELEMETRY``, ``MXTPU_TRACE`` and
``MXTPU_RETRACE_BUDGET``; the port reads no environment variable and takes
the same levers from ``set_enabled``, ``set_tracing`` and
``set_retrace_budget``, whose defaults are the reference's. Not ported yet:
the flight recorder, the JSONL sink with its flush thread, the chrome-trace
event ring and ``trace_flows``.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import logging
import os
import threading
import time

__all__ = ["enabled", "set_enabled", "tracing_enabled", "set_tracing",
           "retrace_budget", "set_retrace_budget", "inc", "gauge",
           "observe", "value", "tagged", "gauge_value", "reset_metric",
           "span", "record_d2h", "d2h_count", "record_retrace",
           "retrace_stats", "snapshot", "report", "reset", "prometheus",
           "TraceContext", "new_trace", "current_trace", "trace_handoff",
           "add_stage", "trace_mark", "link", "trace_breakdown",
           "trace_events"]

_log = logging.getLogger("mxtpu_torch.telemetry")

_LOCK = threading.Lock()
_COUNTERS = {}            # (name, tag-or-None) -> float
_GAUGES = {}              # (name, tag-or-None) -> float
_HISTS = {}               # name -> [count, sum, min, max, reservoir-deque]
_RESERVOIR = 2048         # per-histogram quantile sample bound
_RETRACE = {}             # site -> {"compiles", "trips", "last"}
_D2H_WARNED = set()
_D2H_WARMUP = 2           # first occurrences of a span may legitimately sync
_TRACE_RING = 4096

_LEVERS = {"enabled": True, "tracing": True, "retrace_budget": 64}


class _D2HLocal(threading.local):
    """Per-thread d2h count: a span attributes only its own thread's
    syncs, so a server thread's fetch never lands in another region."""

    def __init__(self):
        self.count = 0


_D2H_LOCAL = _D2HLocal()

_TRACE_CV = contextvars.ContextVar("mxtpu_torch_trace", default=None)
_SPAN_IDS = itertools.count(1)
_TRACE_IDS = itertools.count(1)
_TRACE_PREFIX = "%04x" % (os.getpid() & 0xFFFF)
# (kind, trace_id, span_id, parent, name, ts_us, dur_us, tid)
_TRACE_EVENTS = collections.deque(maxlen=_TRACE_RING)


# ------------------------------------------------------------------ levers
def enabled():
    """Span machinery on (default, as ``MXTPU_TELEMETRY`` unset); counters
    stay on either way."""
    return _LEVERS["enabled"]


def set_enabled(on):
    """The ``MXTPU_TELEMETRY=0`` lever: ``False`` turns spans (and with
    them tracing) off."""
    _LEVERS["enabled"] = bool(on)


def tracing_enabled():
    """Request tracing on (default, as ``MXTPU_TRACE`` unset); needs the
    span machinery."""
    return _LEVERS["tracing"] and _LEVERS["enabled"]


def set_tracing(on):
    """The ``MXTPU_TRACE=0`` lever."""
    _LEVERS["tracing"] = bool(on)


def retrace_budget():
    """Builds one site may make before the retrace watchdog warns."""
    return _LEVERS["retrace_budget"]


def set_retrace_budget(n):
    """The ``MXTPU_RETRACE_BUDGET`` lever (default 64)."""
    _LEVERS["retrace_budget"] = int(n)


# ---------------------------------------------------------------- registry
def inc(name, n=1, tag=None):
    """Add ``n`` to a counter; ``tag`` keys a labeled sub-counter."""
    k = (name, tag)
    with _LOCK:
        _COUNTERS[k] = _COUNTERS.get(k, 0) + n


def gauge(name, v, tag=None):
    """Set a gauge (last write wins)."""
    with _LOCK:
        _GAUGES[(name, tag)] = float(v)


def _observe_locked(name, v):
    h = _HISTS.get(name)
    if h is None:
        h = [0, 0.0, v, v, collections.deque(maxlen=_RESERVOIR)]
        _HISTS[name] = h
    h[0] += 1
    h[1] += v
    h[2] = min(h[2], v)
    h[3] = max(h[3], v)
    h[4].append(v)
    return h[0]


def observe(name, v):
    """Record one histogram observation."""
    with _LOCK:
        _observe_locked(name, float(v))


def value(name, tag=None):
    """A counter's value (0 when never incremented); with no ``tag`` and
    no untagged entry, the sum across tags."""
    with _LOCK:
        v = _COUNTERS.get((name, tag))
        if v is not None or tag is not None:
            return v or 0
        return sum(v for (n, t), v in _COUNTERS.items()
                   if n == name and t is not None) or 0


def tagged(name):
    """``{tag: value}`` over a labeled counter family."""
    with _LOCK:
        return {t: v for (n, t), v in _COUNTERS.items()
                if n == name and t is not None}


def gauge_value(name, tag=None):
    """A gauge's value, or None when never set."""
    with _LOCK:
        return _GAUGES.get((name, tag))


def reset_metric(name):
    """Zero one metric (counter with its tags, gauge, histogram)."""
    with _LOCK:
        for k in [k for k in _COUNTERS if k[0] == name]:
            del _COUNTERS[k]
        for k in [k for k in _GAUGES if k[0] == name]:
            del _GAUGES[k]
        _HISTS.pop(name, None)


def _quantile(sorted_vals, q):
    n = len(sorted_vals)
    if n == 0:
        return None
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _collapse(entries):
    """(name, tag) -> v as {name: scalar} for a purely untagged name and
    {name: {tag: v}} otherwise (the untagged entry under "_untagged")."""
    by_name = {}
    for (name, tag), v in entries.items():
        by_name.setdefault(name, {})[tag] = v
    out = {}
    for name, tags in by_name.items():
        if set(tags) == {None}:
            out[name] = tags[None]
        else:
            out[name] = {("_untagged" if t is None else t): v
                         for t, v in tags.items()}
    return out


def snapshot():
    """Structured view of the registry: counters, gauges, histograms (with
    p50/p99) and the retrace watchdog's sites."""
    with _LOCK:
        counters = _collapse(_COUNTERS)
        gauges = _collapse(_GAUGES)
        hists = {}
        for name, (cnt, total, mn, mx, res) in _HISTS.items():
            vals = sorted(res)
            hists[name] = {"count": cnt, "sum": total, "mean": total / cnt,
                           "min": mn, "max": mx,
                           "p50": _quantile(vals, 0.5),
                           "p99": _quantile(vals, 0.99)}
        retrace = {site: dict(st) for site, st in _RETRACE.items()}
    return {"counters": counters, "gauges": gauges, "histograms": hists,
            "retrace": retrace}


def _family_lines(fmt, family):
    lines = []
    for name in sorted(family):
        v = family[name]
        if isinstance(v, dict):
            for tag in sorted(v):
                lines.append(fmt % ("%s{%s}" % (name, tag), v[tag]))
        else:
            lines.append(fmt % (name, v))
    return lines


def report():
    """The aggregate table: histograms by total time, counters, gauges and
    retrace sites."""
    snap = snapshot()
    lines = []
    if snap["histograms"]:
        lines.append("%-38s %8s %10s %10s %10s %10s" %
                     ("Span/Histogram", "Count", "Mean(ms)", "P50(ms)",
                      "P99(ms)", "Max(ms)"))
        for name in sorted(snap["histograms"],
                           key=lambda n: -snap["histograms"][n]["sum"]):
            h = snap["histograms"][name]
            lines.append("%-38s %8d %10.3f %10.3f %10.3f %10.3f" %
                         (name, h["count"], h["mean"] * 1e3,
                          (h["p50"] or 0) * 1e3, (h["p99"] or 0) * 1e3,
                          h["max"] * 1e3))
    for title, key in (("Counter", "counters"), ("Gauge", "gauges")):
        if snap[key]:
            lines.append("")
            lines.append("%-38s %12s" % (title, "Value"))
            lines.extend(_family_lines("%-38s %12g", snap[key]))
    if snap["retrace"]:
        lines.append("")
        lines.append("%-20s %9s %6s  %s" %
                     ("Retrace site", "Compiles", "Trips", "Last provenance"))
        for site in sorted(snap["retrace"]):
            st = snap["retrace"][site]
            lines.append("%-20s %9d %6d  %s" %
                         (site, st["compiles"], st["trips"], st["last"]))
    return "\n".join(lines) if lines else "(telemetry registry empty)"


def reset():
    """Test hook: clear the registry, the trace ring and watchdog state
    (the levers keep their values)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _RETRACE.clear()
        _D2H_WARNED.clear()
        _TRACE_EVENTS.clear()


# ------------------------------------------------------------------- spans
class span:
    """Context manager timing a host region into histogram ``name``
    (seconds). ``d2h=True`` attributes this thread's device-to-host syncs
    inside the region to ``<name>.d2h`` and warns once when a region that
    has already run ``_D2H_WARMUP`` times syncs at all. Under an active
    trace the span joins its tree: it gets a span id, is the current
    context for its body and records one trace event on exit;
    ``new_trace=True`` starts a trace when none is active."""

    __slots__ = ("name", "cat", "_d2h", "_t0", "_d0", "_new_trace",
                 "_parent", "_tok", "ctx")

    def __init__(self, name, cat="phase", d2h=False, new_trace=False):
        self.name = name
        self.cat = cat
        self._d2h = d2h
        self._new_trace = new_trace
        self._t0 = None
        self._d0 = None
        self._parent = None
        self._tok = None
        self.ctx = None

    def __enter__(self):
        if not _LEVERS["enabled"]:
            return self
        parent = _TRACE_CV.get()
        if parent is None and self._new_trace:
            parent = new_trace()
        if parent is not None:
            self._parent = parent.span_id
            self.ctx = TraceContext(parent.trace_id, next(_SPAN_IDS),
                                    parent._stages)
            self._tok = _TRACE_CV.set(self.ctx)
        self._t0 = time.perf_counter_ns()
        if self._d2h:
            self._d0 = _D2H_LOCAL.count
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        if t0 is None:
            return False
        dur_ns = time.perf_counter_ns() - t0
        if self._tok is not None:
            _TRACE_CV.reset(self._tok)
            self._tok = None
            _TRACE_EVENTS.append(
                ("span", self.ctx.trace_id, self.ctx.span_id, self._parent,
                 self.name, t0 // 1000, dur_ns // 1000,
                 threading.get_ident() & 0xFFFF))
        with _LOCK:
            occurrences = _observe_locked(self.name, dur_ns * 1e-9)
        if self._d0 is not None:
            delta = _D2H_LOCAL.count - self._d0
            if delta:
                inc(self.name + ".d2h", delta)
                self._watchdog(delta, occurrences)
        self._t0 = None
        return False

    def _watchdog(self, delta, occurrences):
        with _LOCK:
            if occurrences <= _D2H_WARMUP or self.name in _D2H_WARNED:
                return
            _D2H_WARNED.add(self.name)
        _log.warning("transfer watchdog: %d device->host sync(s) inside '%s' "
                     "after warmup (occurrence %d); the hot loop should be "
                     "transfer-free", delta, self.name, occurrences)


# ---------------------------------------------------------- request traces
class TraceContext:
    """One position in a trace tree: ``trace_id`` and ``span_id`` (0 = the
    root). ``_stages`` is shared by every context of one trace:
    ``add_stage`` appends (stage, seconds) there."""

    __slots__ = ("trace_id", "span_id", "_stages")

    def __init__(self, trace_id, span_id, stages):
        self.trace_id = trace_id
        self.span_id = span_id
        self._stages = stages

    def __repr__(self):
        return "TraceContext(%s, span=%d)" % (self.trace_id, self.span_id)


def new_trace():
    """Root context of a fresh trace (None when tracing is off)."""
    if not tracing_enabled():
        return None
    return TraceContext("%s-%x" % (_TRACE_PREFIX, next(_TRACE_IDS)), 0, [])


def current_trace():
    """This thread's active context (None outside any trace)."""
    return _TRACE_CV.get()


class trace_handoff:
    """Adopt ``ctx`` as the current trace for a ``with`` body: the one way
    a trace crosses threads. A None ``ctx`` makes it a no-op."""

    __slots__ = ("_ctx", "_tok")

    def __init__(self, ctx):
        self._ctx = ctx
        self._tok = None

    def __enter__(self):
        if self._ctx is not None:
            self._tok = _TRACE_CV.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._tok is not None:
            _TRACE_CV.reset(self._tok)
            self._tok = None
        return False


def add_stage(ctx, name, dur_s, event=False):
    """Credit ``dur_s`` seconds of stage ``name`` to ``ctx``'s breakdown
    (None-safe); ``event=True`` also records a trace event, for stages
    measured outside a span (the queue wait)."""
    if ctx is None:
        return
    ctx._stages.append((name, float(dur_s)))
    if event:
        now_us = time.perf_counter_ns() // 1000
        dur_us = int(dur_s * 1e6)
        _TRACE_EVENTS.append(
            ("span", ctx.trace_id, next(_SPAN_IDS), ctx.span_id, name,
             max(0, now_us - dur_us), dur_us,
             threading.get_ident() & 0xFFFF))


def trace_mark(ctx, name):
    """Zero-duration marker in ``ctx``'s trace (None-safe)."""
    if ctx is None:
        return
    _TRACE_EVENTS.append(
        ("mark", ctx.trace_id, next(_SPAN_IDS), ctx.span_id, name,
         time.perf_counter_ns() // 1000, 0, threading.get_ident() & 0xFFFF))


def link(src, name="link"):
    """Causal edge from ``src`` (a context of another trace) to the current
    context; a no-op when either is absent."""
    dst = _TRACE_CV.get()
    if src is None or dst is None:
        return
    _TRACE_EVENTS.append(
        ("link", dst.trace_id, dst.span_id, (src.trace_id, src.span_id),
         name, time.perf_counter_ns() // 1000, 0,
         threading.get_ident() & 0xFFFF))


def trace_breakdown(ctx):
    """``{stage: seconds}`` of ``ctx``'s trace (empty when untraced)."""
    if ctx is None:
        return {}
    out = {}
    for name, dur in list(ctx._stages):
        out[name] = out.get(name, 0.0) + dur
    return out


def trace_events(trace_id=None):
    """The trace ring as dicts (optionally one trace's); ``parent`` is a
    span id for tree edges and ``{"trace", "span"}`` for links."""
    out = []
    for kind, tr, sp, parent, name, ts, dur, tid in list(_TRACE_EVENTS):
        if trace_id is not None and tr != trace_id:
            continue
        rec = {"kind": kind, "trace": tr, "span": sp, "name": name,
               "ts_us": ts, "dur_us": dur, "tid": tid}
        rec["parent"] = ({"trace": parent[0], "span": parent[1]}
                         if kind == "link" else parent)
        out.append(rec)
    return out


# -------------------------------------------------------------- prometheus
def _prom_name(name):
    return "mxtpu_" + "".join(ch if ch.isalnum() or ch in "_:" else "_"
                              for ch in name)


def _prom_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def prometheus():
    """The registry in Prometheus text exposition format 0.0.4: counters
    (tag families as a ``tag`` label), gauges, and histograms as
    summaries (quantiles 0.5 and 0.99, ``_sum``, ``_count``). The metric
    names are the JAX package's (``mxtpu_`` prefix), so one scraper
    configuration reads both."""
    snap = snapshot()
    lines = []
    for kind, key in (("counter", "counters"), ("gauge", "gauges")):
        for name in sorted(snap[key]):
            v = snap[key][name]
            pn = _prom_name(name)
            lines.append("# TYPE %s %s" % (pn, kind))
            if isinstance(v, dict):
                for tag in sorted(v):
                    if tag == "_untagged":
                        lines.append("%s %g" % (pn, v[tag]))
                    else:
                        lines.append('%s{tag="%s"} %g'
                                     % (pn, _prom_label(tag), v[tag]))
            else:
                lines.append("%s %g" % (pn, v))
    for name in sorted(snap["histograms"]):
        h = snap["histograms"][name]
        pn = _prom_name(name)
        lines.append("# TYPE %s summary" % pn)
        if h["p50"] is not None:
            lines.append('%s{quantile="0.5"} %g' % (pn, h["p50"]))
        if h["p99"] is not None:
            lines.append('%s{quantile="0.99"} %g' % (pn, h["p99"]))
        lines.append("%s_sum %g" % (pn, h["sum"]))
        lines.append("%s_count %d" % (pn, h["count"]))
    return "\n".join(lines) + "\n"


# -------------------------------------------------------- transfer watchdog
def record_d2h(n=1):
    """One device-to-host sync (``NDArray.asnumpy``): the global
    ``transfer.d2h`` counter and this thread's count for span attribution."""
    inc("transfer.d2h", n)
    _D2H_LOCAL.count += n


def d2h_count():
    return value("transfer.d2h")


# --------------------------------------------------------- retrace watchdog
def record_retrace(site, provenance=None):
    """Count one build at ``site`` with its provenance; past the budget the
    watchdog counts a trip and warns (the log is rate-limited, the count is
    exact)."""
    inc("retrace." + site)
    budget = retrace_budget()
    with _LOCK:
        st = _RETRACE.setdefault(site,
                                 {"compiles": 0, "trips": 0, "last": None})
        st["compiles"] += 1
        st["last"] = provenance
        over = st["compiles"] > budget
        if over:
            st["trips"] += 1
        compiles, trips = st["compiles"], st["trips"]
    if over:
        inc("retrace.watchdog_trips")
        if trips == 1 or trips % 100 == 0:
            _log.warning("retrace watchdog: '%s' built %d times, over the "
                         "budget of %d. Last provenance: %s", site,
                         compiles, budget, provenance)


def retrace_stats(site=None):
    """``{site: {compiles, trips, last}}``, or one site's dict (None when
    the site never built)."""
    with _LOCK:
        if site is not None:
            st = _RETRACE.get(site)
            return dict(st) if st else None
        return {s: dict(st) for s, st in _RETRACE.items()}
