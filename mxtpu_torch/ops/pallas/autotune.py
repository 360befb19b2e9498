"""Measured launch-plan autotuner (counterpart of
``mxtpu/ops/pallas/autotune.py``).

The hand-written kernels pick their launch in a pure function
(``conv._launch_args``, ``flash_attention._launch_args``). Each kernel
also registers a ``TunableKernel``: the plans its C entry point has
instances for, the plan ``_launch_args`` picks today (the default), a
feasibility check that mirrors the entry point's own refusals (shared
memory past the block's limit, a tile with no instance), so a plan that
would fail is rejected before any launch, a runner that builds real
buffers for a shape class, and the classes a tuning run sweeps.
Hand-written kernels stay the rule: a plan picks among a kernel's
instances and changes none.

* ``search(kernel_id, shape_class)`` times the default first and then
  every feasible candidate, each forced through ``forced`` around its
  runner: one run discarded as warm-up, then the median of ``rounds``
  runs. On the card a run is timed by CUDA events on the stream the kernel
  launches on; on the CPU (a stand-in runner given by a test; no kernel
  runs there) by ``time.perf_counter``. The sweep stops at the wall
  budget with the best so far. The search holds ``graphs.CAPTURE_LOCK``,
  so it never launches while another thread captures. Only a plan that
  beats the default is installed and persisted.
* Plans persist beside the compile service's blobs, as
  ``<cache dir>/plan_<digest>.mxp``: JSON with a magic, the format and
  the device kind, the key material (kernel, shape class, device kind),
  the plan and the search's timings, committed by a temporary file and a
  rename. ``ensure_loaded`` reads the directory once per process; every
  mismatch drops the blob with a counted reason (``autotune.drops``:
  ``corrupt``, ``version_mismatch``, a blob written on another device
  kind among them, ``key_mismatch`` for a forged or collided name, ``io``
  for a failed write) and the kernel runs its default.
* ``lookup`` is the kernels' consult at launch: a forced plan wins, else
  the table's plan under ``set_enabled(True)``, else None (the default).
  A capture runs the consult once, so the plan is baked into the graph;
  ``policy_token`` is a digest of the installed plans and rides
  ``registry.policy_key``, so a different plan set captures anew.
* Counters: ``autotune.searches``, ``autotune.plan_hits{source}``
  (``forced``, ``search``, ``disk``), ``autotune.plan_misses``,
  ``autotune.drops{reason}``; the gauge ``pallas.plan{kernel}`` holds a
  fingerprint of the last plan served (0: the default); ``hits()`` counts
  each (kernel, class) served from the table.

The reference reads ``MXTPU_AUTOTUNE``, ``MXTPU_AUTOTUNE_BUDGET_S`` and
``MXTPU_AUTOTUNE_ROUNDS``; the port reads no environment variable:
``set_enabled`` (default off), ``set_budget_s`` (30) and ``set_rounds``
(3). The reference's ``interpret_env`` has no counterpart: nothing runs
a kernel off the card.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Callable, NamedTuple

__all__ = ["TunableKernel", "register_kernel", "kernels", "enabled",
           "consulted", "set_enabled", "set_budget_s", "set_rounds", "lookup",
           "active_plan", "plan_id_of", "class_token", "plan_infeasible",
           "forced", "search", "install_plan", "installed", "save_plan",
           "ensure_loaded", "policy_token", "hits", "reset"]

FORMAT_VERSION = 1
_MAGIC = "MXTPU-AT"
_PREFIX = "plan_"
_SUFFIX = ".mxp"

_LOCK = threading.RLock()
_PLANS = {}        # (kernel_id, class token) -> {plan, plan_id, source}
_FORCED = {}       # kernel_id -> [plan, ...] (innermost last)
_HITS = {}         # (kernel_id, class token) -> table plans served
_STATE = {"loaded": False, "digest": None}
_LEVERS = {"enabled": False, "budget_s": 30.0, "rounds": 3}


class TunableKernel(NamedTuple):
    """One kernel's tunable surface: ``space(sc)`` the candidate plan
    dicts of a shape class, ``default(sc)`` the plan the kernel picks
    without a table (timed first, and what every drop falls back to),
    ``feasible(plan, sc)`` -> ``(ok, reason)`` before any launch,
    ``runner(sc)`` -> ``(fn, args)`` running the kernel through its public
    entry on real buffers, and ``classes()`` the shape classes a tuning
    run sweeps."""
    kernel_id: str
    space: Callable
    default: Callable
    feasible: Callable
    runner: Callable
    classes: Callable


_KERNELS = {}


def register_kernel(tk: TunableKernel):
    _KERNELS[tk.kernel_id] = tk
    return tk


def kernels():
    return dict(_KERNELS)


# ------------------------------------------------------------------ levers
def consulted():
    """Whether a launch consults ``lookup`` at all: a plan is forced or
    autotune is on (a launch skips the shape class's token otherwise)."""
    return bool(_FORCED) or _LEVERS["enabled"]


def enabled():
    """Tuned plans served at launch (the ``MXTPU_AUTOTUNE=1`` lever; off
    by default). Part of ``registry.policy_key``."""
    return _LEVERS["enabled"]


def set_enabled(on):
    """The ``MXTPU_AUTOTUNE`` lever; returns the previous setting."""
    prev, _LEVERS["enabled"] = _LEVERS["enabled"], bool(on)
    return prev


def set_budget_s(seconds):
    """The ``MXTPU_AUTOTUNE_BUDGET_S`` lever: a search's wall budget."""
    _LEVERS["budget_s"] = float(seconds)


def set_rounds(n):
    """The ``MXTPU_AUTOTUNE_ROUNDS`` lever: timed runs a candidate."""
    _LEVERS["rounds"] = max(1, int(n))


# ------------------------------------------------------------ key material
def class_token(shape_class):
    """A shape class's token: its ``k=v`` pairs sorted by key (the order
    the dict was built in does not matter). The class carries its dtype."""
    return "|".join("%s=%s" % (k, shape_class[k])
                    for k in sorted(shape_class))


def plan_id_of(plan):
    """A plan's stable id, e.g. ``block_m=64,block_n=128``."""
    return ",".join("%s=%s" % (k, plan[k]) for k in sorted(plan))


def device_kind():
    """What a plan is keyed on: the card's name (``cuda/NVIDIA H100 80GB
    HBM3``), or ``cpu`` without one."""
    try:
        import torch
        if torch.cuda.is_available():
            return "cuda/%s" % torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 - a broken driver still keys
        return "unknown"
    return "cpu"


def _key_material(kernel_id, token, device):
    return "%s|%s|%s|fmt%d" % (kernel_id, token, device, FORMAT_VERSION)


def _digest(kernel_id, token, device):
    return hashlib.sha256(_key_material(kernel_id, token, device)
                          .encode("utf-8")).hexdigest()[:20]


def plan_path(kernel_id, shape_class, root=None):
    """The plan blob's path under the compile service's cache dir (None
    without one)."""
    from ... import compile_service
    root = root or compile_service.cache_dir()
    if not root:
        return None
    return os.path.join(root, _PREFIX + _digest(
        kernel_id, class_token(shape_class), device_kind()) + _SUFFIX)


def _plan_fingerprint(plan_id):
    h = hashlib.sha256(plan_id.encode("utf-8")).hexdigest()[:6]
    return int(h, 16) or 1


# ----------------------------------------------------------------- serving
def _drop(reason, kernel_id=None, path=None):
    from ... import telemetry
    telemetry.inc("autotune.drops", tag=reason)
    return None


def _gauge(kernel_id, plan_id):
    from ... import telemetry
    telemetry.gauge("pallas.plan",
                    0 if plan_id is None else _plan_fingerprint(plan_id),
                    tag=kernel_id)


def lookup(kernel_id, shape_class):
    """The plan dict a kernel launches with for this shape class, or None
    for its default: a forced plan first, then (enabled) the table."""
    from ... import compile_service, telemetry
    stack = _FORCED.get(kernel_id)
    if stack:
        telemetry.inc("autotune.plan_hits", tag="forced")
        return dict(stack[-1])
    if not enabled():
        return None
    ensure_loaded()
    token = class_token(shape_class)
    with _LOCK:
        rec = _PLANS.get((kernel_id, token))
        if rec is not None:
            _HITS[(kernel_id, token)] = _HITS.get((kernel_id, token), 0) + 1
    if rec is None:
        telemetry.inc("autotune.plan_misses")
        _gauge(kernel_id, None)
        return None
    telemetry.inc("autotune.plan_hits", tag=rec["source"])
    _gauge(kernel_id, rec["plan_id"])
    compile_service.note_plan(kernel_id, token, rec["plan_id"])
    return dict(rec["plan"])


def plan_infeasible(kernel_id, reason="infeasible"):
    """A served plan failed the kernel's own check: the kernel runs its
    default and the drop counts."""
    return _drop(reason, kernel_id)


def active_plan(kernel_id, shape_class):
    """``(plan_id, "tuned")`` or ``(None, "default")`` (a table plan equal
    to the default reads ``"default"``)."""
    plan = lookup(kernel_id, shape_class)
    if plan is None:
        return None, "default"
    tk = _KERNELS.get(kernel_id)
    if tk is not None and plan == tk.default(shape_class):
        return plan_id_of(plan), "default"
    return plan_id_of(plan), "tuned"


@contextlib.contextmanager
def forced(kernel_id, plan):
    """Every ``lookup`` of ``kernel_id`` in the block returns ``plan``
    (a stack: the innermost wins)."""
    with _LOCK:
        _FORCED.setdefault(kernel_id, []).append(dict(plan))
    try:
        yield
    finally:
        with _LOCK:
            _FORCED[kernel_id].pop()
            if not _FORCED[kernel_id]:
                del _FORCED[kernel_id]


def hits():
    """``{(kernel_id, class token): n}``: table plans served per class."""
    with _LOCK:
        return dict(_HITS)


# ------------------------------------------------------------- persistence
def save_plan(kernel_id, shape_class, plan, meta=None, root=None):
    """Write the plan blob (temporary file, then rename); returns its path,
    or None without a cache dir or when the write fails (``io``)."""
    path = plan_path(kernel_id, shape_class, root)
    if path is None:
        return None
    token = class_token(shape_class)
    dev = device_kind()
    rec = {"magic": _MAGIC, "env": {"format": FORMAT_VERSION,
                                    "device": dev},
           "kernel": kernel_id, "class": token,
           "key": _key_material(kernel_id, token, dev),
           "plan": dict(plan), "plan_id": plan_id_of(plan),
           "meta": dict(meta or {}), "created": time.time()}
    try:
        root_dir = os.path.dirname(path)
        os.makedirs(root_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=root_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(rec, f, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except Exception:  # noqa: BLE001 - disk full, permissions, races
        return _drop("io", kernel_id, path)
    return path


def _load_blob(path):
    """One plan blob into the table, or a counted drop."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            rec = json.load(f)
    except Exception:  # noqa: BLE001 - truncated or garbage
        return _drop("corrupt", None, path)
    if not isinstance(rec, dict) or rec.get("magic") != _MAGIC:
        return _drop("corrupt", None, path)
    dev = device_kind()
    if rec.get("env") != {"format": FORMAT_VERSION, "device": dev}:
        return _drop("version_mismatch", rec.get("kernel"), path)
    kernel_id, token, plan = rec.get("kernel"), rec.get("class"), \
        rec.get("plan")
    if not (isinstance(kernel_id, str) and isinstance(token, str)
            and isinstance(plan, dict)):
        return _drop("corrupt", kernel_id, path)
    want = _PREFIX + _digest(kernel_id, token, dev) + _SUFFIX
    if rec.get("key") != _key_material(kernel_id, token, dev) \
            or os.path.basename(path) != want:
        return _drop("key_mismatch", kernel_id, path)
    with _LOCK:
        _PLANS[(kernel_id, token)] = {
            "plan": dict(plan),
            "plan_id": rec.get("plan_id") or plan_id_of(plan),
            "source": "disk"}
        _STATE["digest"] = None
    return plan


def ensure_loaded():
    """Read every plan blob of the cache dir into the table, once per
    process (a no-op with autotune off)."""
    if not enabled():
        return
    with _LOCK:
        if _STATE["loaded"]:
            return
        _STATE["loaded"] = True
    from ... import compile_service
    root = compile_service.cache_dir()
    if not root or not os.path.isdir(root):
        return
    for name in sorted(os.listdir(root)):
        if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
            _load_blob(os.path.join(root, name))


def install_plan(kernel_id, shape_class, plan, source="search"):
    """Put ``plan`` in the table (``policy_token`` changes with it)."""
    with _LOCK:
        _PLANS[(kernel_id, class_token(shape_class))] = {
            "plan": dict(plan), "plan_id": plan_id_of(plan),
            "source": source}
        _STATE["digest"] = None


def installed():
    """``{(kernel_id, class token): plan_id}``."""
    with _LOCK:
        return {k: v["plan_id"] for k, v in _PLANS.items()}


def reset():
    """Drop the table, the forced plans, the per-class hits and the loaded
    state (tests; a fresh process is the real reset)."""
    with _LOCK:
        _PLANS.clear()
        _FORCED.clear()
        _HITS.clear()
        _STATE["loaded"] = False
        _STATE["digest"] = None


def policy_token():
    """``registry.policy_key``'s plan component: "0" with autotune off or
    no plan, else a digest of the installed plans."""
    if not enabled():
        return "0"
    ensure_loaded()
    with _LOCK:
        if _STATE["digest"] is None:
            items = sorted((k[0], k[1], v["plan_id"])
                           for k, v in _PLANS.items())
            _STATE["digest"] = "0" if not items else hashlib.sha256(
                repr(items).encode("utf-8")).hexdigest()[:12]
        return _STATE["digest"]


# ------------------------------------------------------------------ search
def _first_tensor(args):
    import torch
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
    return None


def _time_plan(kernel_id, fn, plan, args, rounds):
    """Median seconds of one ``fn(*args)`` under ``plan``, its first run
    discarded: CUDA events on the current stream of the arguments' card,
    else the host's clock."""
    import torch
    t = _first_tensor(args)
    on_card = t is not None and t.device.type == "cuda"
    with forced(kernel_id, plan):
        fn(*args)   # warm-up, discarded
        ts = []
        for _ in range(rounds):
            if on_card:
                stream = torch.cuda.current_stream(t.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                fn(*args)
                end.record(stream)
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def search(kernel_id, shape_class, rounds=None, budget_s=None,
           install=True, persist=True):
    """Time the default and every feasible candidate of one shape class
    (module docstring); returns the record. The best plan is installed and
    persisted (with a cache dir) only when it beats the default."""
    from ... import graphs, telemetry
    tk = _KERNELS[kernel_id]
    telemetry.inc("autotune.searches")
    rounds = max(1, int(rounds)) if rounds is not None \
        else _LEVERS["rounds"]
    budget = float(budget_s) if budget_s is not None \
        else _LEVERS["budget_s"]
    default = dict(tk.default(shape_class))
    default_id = plan_id_of(default)
    cands, pruned, seen = [], [], set()
    for plan in [default] + list(tk.space(shape_class)):
        pid = plan_id_of(plan)
        if pid in seen:
            continue
        seen.add(pid)
        ok, reason = tk.feasible(plan, shape_class)
        if ok:
            cands.append(dict(plan))
        else:
            pruned.append({"plan_id": pid, "reason": reason})
    fn, args = tk.runner(shape_class)
    timings, exhausted = [], False
    deadline = time.monotonic() + budget
    with graphs.CAPTURE_LOCK:   # no launch while another thread captures
        for plan in cands:
            if timings and time.monotonic() > deadline:
                exhausted = True
                break
            timings.append({"plan": plan, "plan_id": plan_id_of(plan),
                            "s": _time_plan(kernel_id, fn, plan, args,
                                            rounds)})
    default_s = timings[0]["s"]
    best = min(timings, key=lambda r: r["s"])
    improved = best["plan_id"] != default_id and best["s"] < default_s
    result = {"kernel": kernel_id, "class": class_token(shape_class),
              "device": device_kind(), "rounds": rounds,
              "candidates": len(cands), "pruned": pruned,
              "timed": len(timings), "budget_exhausted": exhausted,
              "default_plan_id": default_id, "default_s": default_s,
              "best_plan": dict(best["plan"]),
              "best_plan_id": best["plan_id"], "best_s": best["s"],
              "speedup_vs_default": (default_s / best["s"]
                                     if best["s"] > 0 else None),
              "improved": improved, "timings": timings, "persisted": None}
    if improved and install:
        install_plan(kernel_id, shape_class, best["plan"])
        if persist:
            result["persisted"] = save_plan(
                kernel_id, shape_class, best["plan"],
                meta={"default_plan_id": default_id,
                      "default_s": default_s, "best_s": best["s"],
                      "rounds": rounds, "timed": len(timings),
                      "pruned": len(pruned)})
    return result
