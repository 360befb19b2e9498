"""Executable observatory: the per-site FLOP ledger, runtime MFU, device
memory views, the serving footprint ledger and the OOM flight path
(counterpart of ``mxtpu/xprof.py``).

* **Ledger** -- the reference wraps each jitted executable and asks XLA's
  cost analysis for its FLOPs. The port has no executables to wrap: each
  ``graphs.CapturedGraph`` built with a ``site`` (``cached_op``,
  ``executor``, ``fused_optimizer``) counts the FLOPs of its warm-up run
  once, under ``torch.utils.flop_counter.FlopCounterMode``, and records
  them with the capture's wall time (``compile_s``) in a ledger entry
  (``attach``/``watch``); each run of the graph adds one to the entry's
  ``calls``. The counter does not see a hand-written kernel, so each
  kernel wrapper reports its own FLOPs from its shapes (``add_flops``:
  the count ``PERF.md``'s bound column uses). ``ledger``/``resolve``/
  ``ledger_snapshot`` list the entries (nothing is left to resolve),
  ``executed_flops`` sums FLOPs times calls and ``summary`` digests them.
* **MFU** -- ``MFUMeter`` (ticked by ``gluon.Trainer.step``) sets the
  ``perf.mfu`` gauge every ``every`` steps: the executed FLOPs of the
  training sites over the wall time since the last tick, over
  ``perf_model.peak_flops`` of the parameters' type.
* **Memory** -- ``poll_memory`` sets ``memory.hbm_{used,limit,headroom,
  peak}_bytes{d<i>}`` from ``torch.cuda``; a memwatch thread
  (``set_memwatch_interval``, 0 = off, the default) keeps them fresh.
* **OOM** -- ``is_oom`` knows ``torch.cuda.OutOfMemoryError`` and the
  injected ``resilience.ResourceExhausted``; ``oom_flight`` writes the
  flight artifact with the ledger and every card's memory view.

The reference reads ``MXTPU_XPROF`` and ``MXTPU_MEMWATCH_S``; the port
reads no environment variable: ``set_enabled`` and
``set_memwatch_interval``, whose defaults are the reference's (on, 0).

* ``device_memory(device)`` -- ``bytes_in_use``, ``bytes_limit``,
  ``peak_bytes_in_use`` and ``bytes_free`` of a device: the card's from
  ``torch.cuda`` (its total memory is the limit), and ``CPU_BYTES_LIMIT``
  as the host's limit.
* ``record_footprint(site, nbytes)`` / ``site_footprint(site, family)`` --
  the bytes a Predictor holds at its retrace site once it has warmed up:
  its parameter snapshot and static inputs, plus on the card the segments
  of its graphs' private memory pool and on the CPU its buckets' outputs.
  The reference prices a site from its XLA executables' ledger (donated
  arguments, temporaries, outputs), so the two packages' numbers differ by
  design; placement decisions are what the tests compare.
* ``preflight(site, ...)`` -- will-it-fit: the site's footprint (or a
  caller's estimate) plus the bytes its co-residents hold, against the
  device's limit; past it ``memory.overcommit{site}`` counts and a warning
  is logged, before the Predictor captures.
* ``drop(site)`` forgets a site's record (a zoo eviction, as the
  reference's ``compile_service.drop`` releases its executables).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time

import torch

from . import telemetry
from .context import resolve_device

__all__ = ["device_memory", "record_footprint", "site_footprint", "drop",
           "preflight", "CPU_BYTES_LIMIT", "enabled", "set_enabled",
           "memwatch_interval", "set_memwatch_interval", "attach", "watch",
           "measuring", "add_flops", "ledger", "ledger_snapshot", "resolve",
           "executed_flops", "summary", "poll_memory", "ensure_memwatch",
           "stop_memwatch", "is_oom", "oom_flight", "MFUMeter",
           "TRAIN_SITES", "reset"]

_log = logging.getLogger("mxtpu_torch.xprof")

# the limit reported for the host: large enough that the count cap, not
# bytes, decides placement on the CPU unless a budget is given
CPU_BYTES_LIMIT = 1 << 40

_LOCK = threading.Lock()
_FOOTPRINTS = {}   # site -> bytes held after warm-up


def device_memory(device=None):
    """``{bytes_in_use, bytes_limit, peak_bytes_in_use, bytes_free}`` of a
    device (a ``torch.device``, a string or a CUDA index; None is
    ``cuda:0``)."""
    if device is None or isinstance(device, int):
        device = torch.device("cuda", device or 0)
    device = resolve_device(device)
    if device.type != "cuda":
        return {"bytes_in_use": 0, "bytes_limit": CPU_BYTES_LIMIT,
                "peak_bytes_in_use": 0, "bytes_free": CPU_BYTES_LIMIT}
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_free": int(free)}


def record_footprint(site, nbytes):
    """Record the bytes the Predictor at ``site`` holds after warm-up."""
    with _LOCK:
        _FOOTPRINTS[site] = int(nbytes)
    telemetry.gauge("memory.site_footprint_bytes", int(nbytes), tag=site)


def site_footprint(site, family=False):
    """The recorded bytes of ``site`` (0 when none); ``family=True`` adds
    its dotted sub-sites (``serving.predict.zoo.m`` covers its
    ``.canary``)."""
    with _LOCK:
        return sum(b for s, b in _FOOTPRINTS.items()
                   if s == site or (family and s.startswith(site + ".")))


def drop(site, family=True):
    """Forget ``site``'s record (and its sub-sites'); returns how many."""
    with _LOCK:
        gone = [s for s in _FOOTPRINTS
                if s == site or (family and s.startswith(site + "."))]
        for s in gone:
            del _FOOTPRINTS[s]
    return len(gone)


def preflight(site, device=None, limit=None, extra_bytes=0, need=None):
    """Will-it-fit: ``need`` (default: the site's recorded footprint) plus
    ``extra_bytes`` already held by co-residents against ``limit``
    (default: the device's). Past the limit it counts
    ``memory.overcommit{site}`` and warns. Returns ``(need_bytes,
    limit_bytes)``."""
    if limit is None:
        limit = device_memory(device)["bytes_limit"]
    need = (site_footprint(site) if need is None else int(need)) + \
        int(extra_bytes or 0)
    telemetry.gauge("memory.preflight_bytes", need, tag=site)
    if need > limit:
        telemetry.inc("memory.overcommit", tag=site)
        _log.warning(
            "memory pre-flight: site %r needs ~%.0f MiB (co-residents' %.0f "
            "MiB included) against the device's %.0f MiB: evict a "
            "co-resident model, shrink the buckets or store int8 weights",
            site, need / 2**20, (extra_bytes or 0) / 2**20, limit / 2**20)
    return need, limit


# ------------------------------------------------------------------ levers
_LEVERS = {"enabled": True, "memwatch_s": 0.0}


def enabled():
    """The ledger, memwatch and MFU surfaces on (default)."""
    return _LEVERS["enabled"]


def set_enabled(on):
    """The ``MXTPU_XPROF=0`` lever: ``False`` records no ledger entry for
    new captures and turns memwatch and the MFU meter off."""
    _LEVERS["enabled"] = bool(on)


def memwatch_interval():
    """Seconds between the memwatch thread's polls (0: no thread)."""
    return _LEVERS["memwatch_s"]


def set_memwatch_interval(seconds):
    """The ``MXTPU_MEMWATCH_S`` lever."""
    _LEVERS["memwatch_s"] = float(seconds)


# ------------------------------------------------------------------ ledger
_SITES = {}                    # site -> deque of ledger entries
_SEQ = itertools.count(1)
_PER_SITE = 16                 # a retrace storm keeps the newest

# the sites that run on the training step's path: the numerator of the
# Trainer's perf.mfu
TRAIN_SITES = ("fused_optimizer", "cached_op", "executor",
               "executor.backward", "parallel.train_step", "subgraph_exec")

# FLOPs the kernel wrappers report while a measurement runs (one capture
# at a time runs one, under graphs.CAPTURE_LOCK; a global, since the
# backward of a CUDA tensor runs on autograd's device thread)
_MEASURE = {"depth": 0, "extra": 0.0}


def add_flops(n):
    """A kernel wrapper's FLOPs of one launch, counted into the running
    measurement (none running: nothing)."""
    if _MEASURE["depth"]:
        with _LOCK:
            _MEASURE["extra"] += float(n)


@contextlib.contextmanager
def measuring():
    """Count the FLOPs of the block's torch ops (``FlopCounterMode``) and
    of the kernels launched in it (``add_flops``); yields a dict whose
    ``flops`` is set on exit."""
    from torch.utils.flop_counter import FlopCounterMode
    out = {"flops": None}
    with _LOCK:
        _MEASURE["depth"] += 1
        start = _MEASURE["extra"]
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            yield out
    finally:
        with _LOCK:
            extra = _MEASURE["extra"] - start
            _MEASURE["depth"] -= 1
        out["flops"] = float(counter.get_total_flops()) + extra


def _jsonable(v):
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def attach(site, provenance=None, flops=None, compile_s=None):
    """Record one build at ``site``: its FLOPs a run (None: unknown) and
    its build wall time. Returns the entry, whose ``calls`` the graph
    raises by one a run; None when the observatory is off."""
    if not enabled():
        return None
    entry = {"site": site, "seq": next(_SEQ),
             "provenance": _jsonable(provenance), "calls": 0,
             "compile_s": compile_s, "flops": flops,
             "resolved": True, "error": None}
    if compile_s is not None:
        telemetry.observe("compile.wall_s", compile_s)
    with _LOCK:
        dq = _SITES.get(site)
        if dq is None:
            dq = _SITES[site] = collections.deque(maxlen=_PER_SITE)
        dq.append(entry)
    return entry


def watch(site, flops=None, provenance=None, compile_s=None):
    """A companion graph that shares its site's build count (a pair's
    backward): a ledger entry and no ``retrace`` count."""
    return attach(site, provenance, flops, compile_s)


def called(entry, n=1):
    """One more run of ``entry``'s graph (None-safe)."""
    if entry is not None and _LEVERS["enabled"]:
        entry["calls"] += n


def ledger(site=None, resolve=True):
    """The ledger as a list of dicts in build order (every entry's FLOPs
    are known at its build, so ``resolve`` changes nothing)."""
    with _LOCK:
        entries = [dict(e) for s, dq in sorted(_SITES.items())
                   if site is None or s == site for e in list(dq)]
    return sorted(entries, key=lambda e: e["seq"])


def ledger_snapshot():
    """The ledger for scrapes and flight artifacts."""
    return ledger(resolve=False)


def resolve(site=None):
    return ledger(site, resolve=True)


def _matches(site, sites):
    return sites is None or any(site == w or site.startswith(w + ".")
                                for w in sites)


def executed_flops(sites=None):
    """Sum of FLOPs times calls over the entries of ``sites`` (exact names
    or dotted families; None: all)."""
    with _LOCK:
        entries = [e for dq in _SITES.values() for e in list(dq)]
    return sum(e["flops"] * e["calls"] for e in entries
               if e.get("flops") and _matches(e["site"], sites))


def summary():
    """``{compiles, compile_s_total, peak_hbm_bytes}`` of the ledger and
    the cards."""
    with _LOCK:
        entries = [e for dq in _SITES.values() for e in list(dq)]
    comp = [e["compile_s"] for e in entries if e.get("compile_s")]
    peak = 0
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            peak = max(peak, device_memory(i)["peak_bytes_in_use"])
    return {"compiles": len(entries),
            "compile_s_total": round(sum(comp), 3) if comp else 0.0,
            "peak_hbm_bytes": peak or None}


# -------------------------------------------------------------- memwatch
_MEMWATCH = {"thread": None, "stop": None, "lock": threading.Lock()}


def _card_memory():
    """``{"d<i>": device_memory(i)}`` over the cards ({} without one)."""
    if not torch.cuda.is_available():
        return {}
    return {"d%d" % i: device_memory(i)
            for i in range(torch.cuda.device_count())}


def poll_memory(stats=None):
    """One sweep into ``memory.hbm_{used,limit,headroom,peak}_bytes``
    tagged ``d<i>``; ``stats`` (``{tag: device_memory dict}``) may be
    given. Without a card and without ``stats``: nothing."""
    if not enabled():
        return {}
    if stats is None:
        stats = _card_memory()
    for tag, m in stats.items():
        used = int(m.get("bytes_in_use", 0))
        limit = int(m.get("bytes_limit", 0))
        telemetry.gauge("memory.hbm_used_bytes", used, tag=tag)
        telemetry.gauge("memory.hbm_limit_bytes", limit, tag=tag)
        telemetry.gauge("memory.hbm_headroom_bytes", max(limit - used, 0),
                        tag=tag)
        telemetry.gauge("memory.hbm_peak_bytes",
                        int(m.get("peak_bytes_in_use", used)), tag=tag)
    return stats


def ensure_memwatch():
    """Start the memwatch thread when its interval is above 0
    (idempotent); the Trainer calls it at construction."""
    interval = memwatch_interval()
    if interval <= 0 or not enabled():
        return False
    with _MEMWATCH["lock"]:
        t = _MEMWATCH["thread"]
        if t is not None and t.is_alive():
            return True
        stop = threading.Event()
        t = threading.Thread(target=_memwatch_loop, args=(interval, stop),
                             daemon=True, name="mxtpu-torch-memwatch")
        _MEMWATCH["thread"], _MEMWATCH["stop"] = t, stop
        t.start()
    return True


def stop_memwatch():
    with _MEMWATCH["lock"]:
        stop, t = _MEMWATCH["stop"], _MEMWATCH["thread"]
        _MEMWATCH["thread"] = _MEMWATCH["stop"] = None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=1.0)


def _memwatch_loop(interval, stop):
    while not stop.wait(interval):
        try:
            poll_memory()
        except Exception:  # noqa: BLE001 - a poll error must never kill
            pass           # the monitor


# ------------------------------------------------------------- OOM flight
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def is_oom(exc):
    """True for a device allocator failure: ``torch.cuda.OutOfMemoryError``
    or a message with the reference's markers (the injected
    ``resilience.ResourceExhausted`` among them)."""
    if exc is None:
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    s = "%s: %s" % (type(exc).__name__, exc)
    return any(m in s for m in _OOM_MARKERS)


def oom_flight(where, exc, extra=None, trace_ids=()):
    """Flight-record a device OOM (``flight_record("oom")``) with the
    ledger and every card's memory view; counts ``memory.oom{where}``.
    The caller re-raises."""
    telemetry.inc("memory.oom", tag=where)
    ex = {"where": where, "error": str(exc)[:4000],
          "ledger": ledger_snapshot(), "memory": _card_memory()}
    if extra:
        ex.update(_jsonable(extra))
    return telemetry.flight_record("oom", trace_ids=trace_ids, extra=ex)


# ------------------------------------------------------------- MFU meter
class MFUMeter:
    """Runtime MFU from the ledger: every ``every`` steps, the executed
    FLOPs of ``sites`` since the last tick over the wall time since it,
    over ``perf_model.peak_flops(device, dtype)`` times ``n_devices``,
    lands in the ``perf.mfu`` gauge. Host bookkeeping only. Without a
    known peak (the CPU, unless ``peak_tflops`` or ``perf_model.set_peak``
    gives one) the gauge is not set."""

    def __init__(self, sites=TRAIN_SITES, every=32, n_devices=1,
                 device=None, dtype="bfloat16", peak_tflops=None):
        self._sites = tuple(sites)
        self._every = max(int(every), 1)
        self._n_devices = max(int(n_devices), 1)
        self._device = device
        self._dtype = dtype
        self._peak_tflops = peak_tflops
        self._n = 0
        self._t0 = None
        self._fl0 = 0.0
        self.last = None

    def step(self):
        """Count one step; on a window's end update the gauge. Returns
        the latest MFU (None until known)."""
        if not enabled():
            return None
        self._n += 1
        if self._n % self._every:
            return self.last
        from . import perf_model
        now = time.perf_counter()
        fl = executed_flops(self._sites)
        if self._t0 is not None:
            peak = perf_model.peak_flops(self._device, self._dtype,
                                         self._peak_tflops)
            dt = now - self._t0
            dfl = fl - self._fl0
            if peak and dt > 0 and dfl > 0:
                self.last = dfl / dt / (peak * self._n_devices)
                telemetry.gauge("perf.mfu", self.last)
        self._t0, self._fl0 = now, fl
        return self.last


def reset():
    """Test hook: clear the ledger and stop the memwatch thread (the
    footprint records stay; ``drop`` forgets those)."""
    stop_memwatch()
    with _LOCK:
        _SITES.clear()
