"""One compile service under every capture site (counterpart of
``mxtpu/compile_service.py``).

Every cache of built work resolves through ``get_or_build``: the
Predictor's buckets (``serving.predict``), ``CachedOp``'s graphs and pairs
(``cached_op``), the executor's (``executor``), the fused optimizer's
update (``fused_optimizer``, the guarded one too), the decode engine's
(``serving.decode``), parsed subgraphs (``subgraph_exec``) and runtime
CUDA libraries (``rtc``).

* **Key** -- ``canonical_key`` builds ``(site, fn_id, signature, policy,
  sharding, donation, device, nonce)``. ``fn_id`` is a stable identity (a
  block's repr and forward source, a symbol's JSON digest, an optimizer's
  class; never ``id()``), ``policy`` the ``registry.policy_key`` state the
  capture bakes in, ``nonce`` an instance's token. ``digest_material``
  leaves ``site`` and ``nonce`` out, so a fresh process (or a replacement
  replica) finds what an identical earlier one wrote.
* **Store** -- one LRU of at most ``set_cache_entries`` entries (1024; 0
  or less: unbounded); an eviction counts ``compile.evictions{site}``.
  A site looks its entry up through the service on every call (its old
  table is a ``SiteTable`` view over the store), so an evicted graph is
  never replayed. A ``CapturedPair`` whose backward is outstanding
  (``busy``) is never evicted. Graphs that share a memory pool (a
  Predictor's buckets) give their memory back only when the last of them
  goes, so the evictions count entries, not bytes. Concurrent misses of
  one key build once; a thread that holds ``graphs.CAPTURE_LOCK`` never
  waits on another thread's build (that thread may be waiting for the
  lock), it builds its own copy.
* **Groups** -- entries that differ only in device and site (a
  ReplicaSet's members) share a group token: the first member's FLOP
  count seeds the others' ledger entries (``compile.lowering_shares``),
  so one warm-up per group runs under ``FlopCounterMode``.
* **Disk** -- with ``set_cache_dir`` given, each built entry writes a
  JSON blob ``<digest>.mxc`` (temporary file, then rename) indexed by a
  best-effort ``manifest.json``. A CUDA graph cannot be serialized, so
  the blob holds what can be kept: the environment (format, torch, CUDA,
  driver, card name), the full key, the provenance, the ledger's numbers
  (each graph's FLOPs, the build's seconds, the site's footprint), the
  autotune plan ids the build ran under and the kernel libraries it
  launched (whose ``.so`` files ``kernels`` keeps in ``<dir>/kernels/``).
  A miss probes the digest first: a good blob loads the libraries without
  nvcc, seeds the ledger with its FLOPs (the capture runs without a
  ``FlopCounterMode`` pass), gives the site its footprint before the
  capture (``peek``) and counts ``compile.disk.hits{site}``; then
  the build captures as a cold one does, once per bucket and device. A
  blob that does not hold drops with a reason in
  ``compile.disk.drops{reason}`` and the entry builds cold: ``corrupt``
  (truncated, garbage), ``version_mismatch`` (format, torch, CUDA,
  driver, card or a kernel library's source changed), ``key_mismatch``
  (a forged rename or a collision), ``load_error`` (a library that does
  not load; a marker file then stops later processes from trying) and
  ``unloadable`` (that marker). Policy, sharding and donation are part of
  the digest itself.
* **Warm-up** -- ``warmup(entries)`` first overlaps, on a pool of
  ``set_cache_threads`` threads, what can overlap: the plan table's load,
  the blobs' reads and the libraries' loads or builds. Then it resolves
  the entries in their order on the calling thread, since captures are
  serialized under ``graphs.CAPTURE_LOCK`` (one capture at a time, never
  in parallel). The first error re-raises after every entry settled.

``telemetry.record_retrace`` counts every build at its site, a disk hit
included (the capture still runs). The reference reads
``MXTPU_COMPILE_CACHE_DIR``, ``MXTPU_COMPILE_CACHE_ENTRIES`` and
``MXTPU_COMPILE_CACHE_THREADS``; the port reads no environment variable:
``set_cache_dir`` (None: no disk), ``set_cache_entries`` (1024) and
``set_cache_threads`` (0: ``min(4, cpu_count)``).
"""
from __future__ import annotations

import collections
import collections.abc
import contextlib
import hashlib
import inspect
import json
import logging
import os
import re
import tempfile
import threading
import time

from . import telemetry

__all__ = ["Key", "Entry", "WarmupEntry", "SiteTable", "canonical_key",
           "device_token", "source_token", "instance_nonce", "cache_dir",
           "set_cache_dir", "cache_entries", "set_cache_entries",
           "cache_threads", "set_cache_threads", "get", "get_or_build",
           "warmup", "drop", "stats", "reset", "trace_lock", "digest_of",
           "disk_path_of", "concrete_args", "manifest", "peek", "annotate",
           "forward_policy", "update_policy",
           "release_on_collect"]

_log = logging.getLogger("mxtpu_torch.compile_service")

FORMAT_VERSION = 1
_MAGIC = "MXTPU-CC"

_LOCK = threading.Lock()             # store, groups, in-flight markers
_STORE = collections.OrderedDict()   # Key -> Entry (newest last)
_GROUPS = collections.OrderedDict()  # group token -> FLOP rows
_GROUP_BOUND = 64
_INFLIGHT = {}                       # Key -> threading.Event
_DEAD = collections.deque()          # nonces of collected site instances
_BUILD = threading.local()           # the build running on this thread
_LEVERS = {"dir": None, "entries": 1024, "threads": 0}

_HEX_ADDR = re.compile(r"0x[0-9a-fA-F]+")


class Key(collections.namedtuple(
        "Key", ["site", "fn_id", "signature", "policy", "sharding",
                "donation", "device", "nonce"])):
    """The canonical key (module docstring). Every component is hashable
    with a repr that is the same in every process."""

    __slots__ = ()

    def digest_material(self):
        """What the disk digest hashes: all but ``site`` and ``nonce``."""
        return "|".join((
            "fmt%d" % FORMAT_VERSION, self.fn_id or "",
            repr(self.signature), repr(self.policy), repr(self.sharding),
            repr(self.donation), self.device or ""))


# fn: what the site built; meta: the site's own side cell (from a build
# returning (fn, meta)); origin: "built" or "disk"; record: the ledger's
# numbers the blob holds (flops, build_s, plans, libraries, footprint)
Entry = collections.namedtuple("Entry", ["fn", "meta", "origin", "record"],
                               defaults=(None,))

# a warm-up declaration: the key, the build, the example inputs (the
# reference's AOT arguments; a capture's inputs are the site's own static
# buffers, so the port's builds take none), provenance and group token
WarmupEntry = collections.namedtuple(
    "WarmupEntry", ["key", "build", "example_args", "provenance", "group"],
    defaults=(None, None))


# ------------------------------------------------------------------ levers
def cache_dir():
    """The disk cache's directory (None: no disk, the default)."""
    return _LEVERS["dir"]


def set_cache_dir(path):
    """The ``MXTPU_COMPILE_CACHE_DIR`` lever (None turns the disk off)."""
    _LEVERS["dir"] = None if not path else str(path)


def cache_entries():
    """The LRU bound (default 1024; 0 or less: unbounded)."""
    return _LEVERS["entries"]


def set_cache_entries(n):
    """The ``MXTPU_COMPILE_CACHE_ENTRIES`` lever."""
    _LEVERS["entries"] = int(n)


def cache_threads():
    """``warmup``'s pool width (default ``min(4, cpu_count)``)."""
    n = _LEVERS["threads"]
    return n if n > 0 else max(1, min(4, os.cpu_count() or 1))


def set_cache_threads(n):
    """The ``MXTPU_COMPILE_CACHE_THREADS`` lever (0: the default)."""
    _LEVERS["threads"] = int(n)


# -------------------------------------------------------------- key helpers
def canonical_key(site, fn_id, signature, policy=None, sharding=None,
                  donation=None, device=None, nonce=None):
    return Key(site, fn_id, signature, policy, sharding, donation, device,
               nonce)


def device_token(device=None, mesh=None):
    """``<type>:d<index>`` of a device, ``<type>:mesh(<indices>)`` of a
    mesh's devices, or ``<type>:default``."""
    import torch
    if mesh is not None:
        devs = [torch.device(d) for d in getattr(mesh, "devices", ())]
        kind = devs[0].type if devs else "cpu"
        return "%s:mesh%s" % (kind, tuple(d.index or 0 for d in devs))
    if device is not None:
        d = torch.device(device)
        return "%s:d%d" % (d.type, d.index or 0)
    return "%s:default" % ("cuda" if torch.cuda.is_available() else "cpu")


def source_token(obj):
    """sha1 of ``inspect.getsource(obj)`` (else of its repr with hex
    addresses stripped), 16 hex digits: the same in every process, and
    different once the code is edited."""
    try:
        src = inspect.getsource(obj)
    except (OSError, TypeError):
        src = _HEX_ADDR.sub("0x", repr(obj))
    return hashlib.sha1(src.encode("utf-8", "replace")).hexdigest()[:16]


_NONCES = {"next": 0}


def instance_nonce(obj):
    """A process-local token of ``obj``, kept on it (``id()`` would be
    reused after a collection)."""
    tok = getattr(obj, "_csvc_nonce", None)
    if tok is None:
        with _LOCK:
            _NONCES["next"] += 1
            tok = "i%d" % _NONCES["next"]
        try:
            obj._csvc_nonce = tok
        except (AttributeError, TypeError):
            tok = "i%x" % id(obj)
    return tok


def release_on_collect(obj):
    """Drop ``obj``'s entries (by its nonce) once it is garbage collected,
    so its graphs give their memory back then, as they did when the
    instance held them. Returns the nonce."""
    import weakref
    nonce = instance_nonce(obj)
    weakref.finalize(obj, _collected, nonce).atexit = False
    return nonce


def _collected(nonce):
    """A site instance is gone: drop its entries now, unless this thread
    is capturing (a graph's teardown would invalidate the capture) or
    holds the store's lock; then at the store's next miss."""
    _DEAD.append(nonce)
    from .graphs import capturing
    if capturing() or not _LOCK.acquire(blocking=False):
        return
    try:
        _purge_locked()
    finally:
        _LOCK.release()


def _purge_locked():
    """Remove the entries of collected instances (``release_on_collect``)."""
    if not _DEAD:
        return
    dead = set()
    while _DEAD:
        dead.add(_DEAD.popleft())
    for k in [k for k in _STORE if k.nonce in dead]:
        del _STORE[k]


def digest_of(key):
    return hashlib.sha256(
        key.digest_material().encode("utf-8", "replace")).hexdigest()[:32]


def disk_path_of(key, root=None):
    root = root or cache_dir()
    if not root:
        return None
    return os.path.join(root, digest_of(key) + ".mxc")


def concrete_args(args):
    """``args``, or None when a tensor among them is a meta tensor (shape
    inference: nothing there can be built)."""
    import torch
    stack = [args]
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if a.device.type == "meta":
                return None
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, dict):
            stack.extend(a.values())
    return args


def trace_lock():
    """The process's one capture lock, ``graphs.CAPTURE_LOCK``."""
    from .graphs import CAPTURE_LOCK
    return CAPTURE_LOCK


def forward_policy():
    """``policy_key`` with the entries only an optimizer's update graph
    bakes in (``registry.UPDATE_ONLY``: the guard, the divergence
    fingerprint, the fused step) as "-": what a forward's capture keys
    on."""
    from .ops import registry
    pol = list(registry.policy_key())
    for i in registry.UPDATE_ONLY:
        pol[i] = "-"
    return tuple(pol)


def update_policy():
    """The fused update's explicit subset of ``policy_key``: the guard bit
    (the divergence fingerprint rides the guarded graph's own key; tuned
    plans and the forward levers never touch an update)."""
    from .ops import registry
    return (registry.policy_key()[registry.UPDATE_ONLY[0]],)


# ------------------------------------------------------------------- store
def _lookup_locked(key):
    e = _STORE.get(key)
    if e is not None:
        _STORE.move_to_end(key)
    return e


def _store_locked(key, entry):
    _purge_locked()
    _STORE[key] = entry
    _STORE.move_to_end(key)
    bound = cache_entries()
    if bound > 0 and len(_STORE) > bound:
        for old in list(_STORE):
            if len(_STORE) <= bound:
                break
            if old == key or getattr(_STORE[old].fn, "busy", False):
                continue   # a pair still holding a call's activations
            del _STORE[old]
            telemetry.inc("compile.evictions", tag=old.site)
    telemetry.gauge("compile.service.entries", len(_STORE))


def get(key):
    """In-memory lookup only (refreshes the LRU position)."""
    with _LOCK:
        return _lookup_locked(key)


def drop(site=None, fn_id=None, nonce=None):
    """Remove the matching entries (and, given ``fn_id`` or nothing, the
    groups) without counting evictions: an explicit release. Returns how
    many went."""
    with _LOCK:
        _purge_locked()
        victims = [k for k in _STORE
                   if (site is None or k.site == site
                       or k.site.startswith(site + "."))
                   and (fn_id is None or k.fn_id == fn_id)
                   and (nonce is None or k.nonce == nonce)]
        for k in victims:
            del _STORE[k]
        if fn_id is not None or (site is None and nonce is None):
            for g in [g for g in _GROUPS
                      if fn_id is None or (isinstance(g, tuple)
                                           and fn_id in g)]:
                del _GROUPS[g]
        telemetry.gauge("compile.service.entries", len(_STORE))
    return len(victims)


def reset():
    """Drop every entry, group and in-flight marker (tests). The disk is
    untouched."""
    with _LOCK:
        _STORE.clear()
        _GROUPS.clear()
        _INFLIGHT.clear()
        telemetry.gauge("compile.service.entries", 0)


def stats():
    with _LOCK:
        _purge_locked()
        per_site = {}
        for k in _STORE:
            per_site[k.site] = per_site.get(k.site, 0) + 1
    return {"entries": sum(per_site.values()), "per_site": per_site,
            "groups": len(_GROUPS), "disk_dir": cache_dir(),
            "bound": cache_entries()}


class SiteTable(collections.abc.Mapping):
    """A site's table as a view over the store: the entries whose key
    ``select`` admits, by ``name(key)``, each the entry's ``fn`` (with
    ``multi``, lists of them in the store's order). ``key_of(name)``, where
    given, makes a lookup by name one store lookup. ``clear()`` drops
    them. What the LRU evicts leaves the view."""

    def __init__(self, select, name=lambda k: k.signature, multi=False,
                 key_of=None):
        self._select = select
        self._name = name
        self._multi = multi
        self._key_of = key_of   # name -> Key: a lookup without a scan

    def _items(self):
        with _LOCK:
            rows = [(k, e.fn) for k, e in _STORE.items() if self._select(k)]
        if not self._multi:
            return {self._name(k): fn for k, fn in rows}
        out = {}
        for k, fn in rows:
            out.setdefault(self._name(k), []).append(fn)
        return out

    def __getitem__(self, name):
        if self._key_of is not None:
            e = get(self._key_of(name))
            if e is None:
                raise KeyError(name)
            return e.fn
        return self._items()[name]

    def __iter__(self):
        return iter(self._items())

    def __len__(self):
        return len(self._items())

    def __eq__(self, other):
        return dict(self._items()) == other

    __hash__ = None

    def __repr__(self):
        return "SiteTable(%r)" % (self._items(),)

    def keys_of(self):
        """The store's keys in the view."""
        with _LOCK:
            return [k for k in _STORE if self._select(k)]

    def clear(self):
        with _LOCK:
            for k in [k for k in _STORE if self._select(k)]:
                del _STORE[k]
            telemetry.gauge("compile.service.entries", len(_STORE))


# ------------------------------------------------------ the running build
def _state():
    return getattr(_BUILD, "state", None)


def note_flops(site, flops):
    """A graph built in the running build reports its ledger FLOPs."""
    st = _state()
    if st is not None:
        st["flops"].append(flops)


def next_seed():
    """The FLOPs of the next graph of the running build, from its blob or
    its group (None: measure them)."""
    st = _state()
    if st is None or not st["seeds"]:
        return None
    return st["seeds"].pop(0)


def note_plan(kernel_id, token, plan_id):
    st = _state()
    if st is not None:
        st["plans"].add((kernel_id, token, plan_id))


def note_library(name, filename):
    """A kernel library the running build launched (``name`` a csrc
    source, or ``rtc/<digest>``), by its file name."""
    st = _state()
    if st is not None:
        st["libraries"][name] = filename


@contextlib.contextmanager
def _running(seeds):
    prev = _state()
    _BUILD.state = st = {"flops": [], "seeds": list(seeds or ()),
                         "plans": set(), "libraries": {}}
    try:
        yield st
    finally:
        _BUILD.state = prev


# ------------------------------------------------------------- disk cache
def _env_material():
    """What a blob must match to load: the format, torch, CUDA, the
    driver and the card."""
    import torch
    env = {"format": FORMAT_VERSION, "torch": torch.__version__,
           "cuda": torch.version.cuda, "driver": None, "device": "cpu"}
    try:
        if torch.cuda.is_available():
            env["device"] = torch.cuda.get_device_name(0)
            env["driver"] = int(torch._C._cuda_getDriverVersion())
    except Exception:  # noqa: BLE001 - a partial driver still keys
        pass
    return env


def _drop_blob(reason, site, path=None):
    telemetry.inc("compile.disk.drops", tag=reason)
    _log.debug("compile disk cache: dropped %s (%s)", path, reason)
    return None


def _marker_path(path):
    return path + ".unloadable"


def _known_unloadable(path):
    try:
        with open(_marker_path(path), "r", encoding="utf-8") as f:
            return json.load(f) == _env_material()
    except (OSError, ValueError):
        return False


def _mark_unloadable(path):
    try:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(_env_material(), f)
        os.replace(tmp, _marker_path(path))
    except Exception:  # noqa: BLE001 - advisory only
        pass


def _read_blob(path):
    """The parsed blob, or a drop reason string."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            rec = json.load(f)
    except Exception:  # noqa: BLE001 - truncated or garbage
        return "corrupt"
    if not isinstance(rec, dict) or rec.get("magic") != _MAGIC \
            or not isinstance(rec.get("meta"), dict):
        return "corrupt"
    return rec


def _check_blob(rec, key):
    """None when ``rec`` holds for ``key`` here, else the drop reason."""
    if isinstance(rec, str):
        return rec
    if rec.get("env") != _env_material():
        return "version_mismatch"
    if rec.get("key") != key.digest_material():
        return "key_mismatch"
    from . import kernels
    for name, fname in (rec["meta"].get("libraries") or {}).items():
        if not name.startswith("rtc/") and \
                kernels.library_file(name) != fname:
            return "version_mismatch"   # the kernel's source changed
    return None


def _load_libraries(rec):
    """Load the csrc libraries a blob names (from the cache dir, or built
    by nvcc where the cache lacks one). Runtime libraries resolve at
    their own site."""
    from . import kernels
    for name in sorted(rec["meta"].get("libraries") or {}):
        if not name.startswith("rtc/"):
            kernels.library(name)


def _disk_load(key, preread=None):
    """The blob record of ``key`` when it holds (counting the hit), else
    None (counting the miss or the drop)."""
    path = disk_path_of(key)
    if path is None:
        return None
    if not os.path.exists(path):
        telemetry.inc("compile.disk.misses", tag=key.site)
        return None
    if _known_unloadable(path):
        return _drop_blob("unloadable", key.site, path)
    rec = preread.pop(path, None) if preread else None
    if rec is None:
        rec = _read_blob(path)
    reason = _check_blob(rec, key)
    if reason is not None:
        return _drop_blob(reason, key.site, path)
    try:
        _load_libraries(rec)
    except OSError:
        _mark_unloadable(path)
        return _drop_blob("load_error", key.site, path)
    telemetry.inc("compile.disk.hits", tag=key.site)
    return rec


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _write_json(root, path, rec):
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
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


def _disk_write(key, record, provenance):
    """Commit ``key``'s blob (temporary file, then rename); a failure
    counts ``compile.disk.drops{io}`` and the built entry serves on."""
    root = cache_dir()
    if not root:
        return False
    path = disk_path_of(key, root)
    if _known_unloadable(path):
        return False
    rec = {"magic": _MAGIC, "env": _env_material(),
           "key": key.digest_material(), "site": key.site,
           "fn_id": key.fn_id, "meta": record,
           "provenance": _json_safe(provenance), "created": time.time()}
    try:
        os.makedirs(root, exist_ok=True)
        _write_json(root, path, rec)
    except Exception:  # noqa: BLE001 - disk full, permissions, races
        telemetry.inc("compile.disk.drops", tag="io")
        return False
    telemetry.inc("compile.disk.writes", tag=key.site)
    _manifest_note(root, digest_of(key), key, os.path.getsize(path))
    return True


def _manifest_note(root, digest, key, nbytes):
    """A best-effort ``manifest.json`` row (the blobs themselves are what
    a load trusts)."""
    path = os.path.join(root, "manifest.json")
    try:
        try:
            with open(path, "r", encoding="utf-8") as f:
                man = json.load(f)
        except (OSError, ValueError):
            man = {}
        if not isinstance(man, dict) or "entries" not in man:
            man = {"format": FORMAT_VERSION, "entries": {}}
        man["format"] = FORMAT_VERSION
        man["env"] = _env_material()
        man["entries"][digest] = {
            "site": key.site, "fn_id": key.fn_id,
            "key": key.digest_material(), "bytes": nbytes,
            "created": time.time()}
        _write_json(root, path, man)
    except Exception:  # noqa: BLE001 - advisory only
        pass


def manifest(root=None):
    """The manifest dict ({} when absent or unreadable)."""
    root = root or cache_dir()
    if not root:
        return {}
    try:
        with open(os.path.join(root, "manifest.json"), "r",
                  encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def peek(key):
    """The numbers of ``key``'s blob when it holds, counting nothing
    (None without one)."""
    path = disk_path_of(key)
    if path is None or not os.path.exists(path):
        return None
    rec = _read_blob(path)
    return None if _check_blob(rec, key) is not None else rec["meta"]


def annotate(key, **fields):
    """Add ``fields`` to the numbers of ``key``'s blob and in-memory
    record (the Predictor's footprint, known after its warm-up)."""
    with _LOCK:
        e = _STORE.get(key)
        if e is not None and isinstance(e.record, dict):
            e.record.update(fields)
    root = cache_dir()
    path = disk_path_of(key, root)
    if path is None or not os.path.exists(path):
        return False
    rec = _read_blob(path)
    if _check_blob(rec, key) is not None:
        return False
    rec["meta"].update(_json_safe(fields))
    try:
        _write_json(root, path, rec)
    except Exception:  # noqa: BLE001 - the next cold build writes it again
        telemetry.inc("compile.disk.drops", tag="io")
        return False
    return True


# -------------------------------------------------------------- build path
def _split_build(raw):
    if isinstance(raw, tuple) and len(raw) == 2:
        return raw
    return raw, None


def _build_entry(key, build, provenance, companion, group, persist,
                 preread):
    if callable(provenance):
        provenance = provenance()
    disk = _disk_load(key, preread) if persist else None
    seeds = None
    if disk is not None:
        seeds = list(disk["meta"].get("flops") or ())
    elif group is not None:
        with _LOCK:
            shared = _GROUPS.get(group)
            if shared is not None:
                _GROUPS.move_to_end(group)
        if shared is not None:
            seeds = list(shared)
            telemetry.inc("compile.lowering_shares", tag=key.site)
    t0 = time.perf_counter()
    with _running(seeds) as st:
        fn, meta = _split_build(build())
    record = {"flops": st["flops"], "build_s": time.perf_counter() - t0,
              "plans": sorted(list(p) for p in st["plans"]),
              "libraries": dict(st["libraries"])}
    if disk is not None and "footprint" in disk["meta"]:
        record["footprint"] = disk["meta"]["footprint"]
    if not companion:
        telemetry.record_retrace(key.site, provenance)
    if group is not None and seeds is None:
        with _LOCK:
            _GROUPS[group] = list(st["flops"])
            while len(_GROUPS) > _GROUP_BOUND:
                _GROUPS.popitem(last=False)
    if disk is None and persist and cache_dir():
        _disk_write(key, record, provenance)
    return Entry(fn, meta, "disk" if disk is not None else "built", record)


def get_or_build(key, build, provenance=None, example_args=None, aot=None,
                 companion=False, group=None, persist=True, _preread=None):
    """The front door: the in-memory store, else (``persist`` and a cache
    dir) the blob, then ``build()`` -- which returns what the site keeps,
    or ``(fn, meta)``. ``provenance`` (or a thunk of it) goes to the
    retrace count (a ``companion`` counts none) and the blob; ``group``
    shares the first member's FLOP count. The reference's
    ``example_args``/``aot`` are accepted and ignored: a capture needs no
    ahead-of-time lowering, and ``build()`` itself captures."""
    with _LOCK:
        e = _lookup_locked(key)
    if e is not None:
        return e
    registered = False
    while True:
        with _LOCK:
            e = _lookup_locked(key)
            if e is not None:
                return e
            waiter = _INFLIGHT.get(key)
            if waiter is None:
                _INFLIGHT[key] = threading.Event()
                registered = True
                break
        if trace_lock()._is_owned():
            # the building thread may be waiting for the capture lock that
            # this thread holds: build a copy rather than wait for it
            break
        waiter.wait()
    try:
        with _LOCK:
            _purge_locked()   # collected instances' graphs go first
        entry = _build_entry(key, build, provenance, companion, group,
                             persist, _preread)
        with _LOCK:
            _store_locked(key, entry)
        return entry
    finally:
        if registered:
            with _LOCK:
                ev = _INFLIGHT.pop(key, None)
            if ev is not None:
                ev.set()


# ------------------------------------------------------------------ warmup
def _prefetch(path):
    """Read one blob and load the csrc libraries it names (the part of a
    warm-up that overlaps)."""
    rec = _read_blob(path)
    if isinstance(rec, dict):
        try:
            _load_libraries(rec)
        except OSError:
            pass   # the entry's own load counts it
    return rec


def warmup(entries, threads=None):
    """Resolve ``entries`` (``WarmupEntry``s) through ``get_or_build``
    (module docstring: the pool overlaps blob reads and library loads or
    builds, the captures run in order); returns ``{entries, built, disk,
    cached, errors, wall_s}``. The first error re-raises after every
    entry settled."""
    entries = list(entries)
    t0 = time.perf_counter()
    try:   # the traced plans are the ones a serving process runs under
        from .ops.pallas import autotune
        autotune.ensure_loaded()
    except Exception:  # noqa: BLE001 - a plan preload never blocks warmup
        pass
    summary = {"entries": len(entries), "built": 0, "disk": 0, "cached": 0,
               "errors": 0, "wall_s": 0.0}
    if not entries:
        return summary
    n = threads or cache_threads()
    preread = {}
    if cache_dir():
        with _LOCK:
            cold = [e.key for e in entries if e.key not in _STORE]
        paths = [p for p in dict.fromkeys(disk_path_of(k) for k in cold)
                 if os.path.exists(p)]
        if paths and n > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(n, len(paths)),
                    thread_name_prefix="mxtpu-compile") as pool:
                preread = dict(zip(paths, pool.map(_prefetch, paths)))
    first_err = None
    for e in entries:
        try:
            pre = get(e.key)
            entry = get_or_build(e.key, e.build, provenance=e.provenance,
                                 group=e.group, _preread=preread)
            res = "cached" if pre is not None else entry.origin
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            summary["errors"] += 1
            first_err = first_err or exc
            continue
        summary["disk" if res == "disk" else "cached" if res == "cached"
                else "built"] += 1
    summary["wall_s"] = time.perf_counter() - t0
    telemetry.observe("compile.warmup_s", summary["wall_s"])
    if first_err is not None:
        raise first_err
    return summary

