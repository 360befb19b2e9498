"""Continuous-batching autoregressive decode (counterpart of
``mxtpu/serving/decode.py``): a prefill/decode split over KV-cache slots.

* **Prefill/decode split** -- a prompt runs through a seq-bucketed
  :class:`~mxtpu_torch.serving.engine.Predictor` (builds at retrace site
  ``serving.prefill``), which gives its KV cache and its logits; the
  first token is sampled at the slot insert. Decode then runs the step
  loop below.
* **KV-cache slots** -- a cohort of fixed capacity (``BucketSpec
  (decode_slots=...)``): each slot holds one sequence's KV cache, current
  token, position and remaining budget in the engine's *carry*, tensors
  allocated once on the device. A finished sequence frees its slot
  between steps and a queued one joins the running cohort: the slot index
  is a value the executable reads from a device buffer, never part of its
  shape, so joining never builds anything.
* **One executable per bucket** -- ``warmup()`` builds one step per
  cohort capacity bucket and one insert per prefill seq bucket (plus one
  extend per seq bucket with the prefix cache, and a draft and a verify
  per cohort bucket with speculation). On the card each is one captured
  CUDA graph (``graphs.CapturedGraph``) that mutates the carry in place;
  its dynamic arguments (slot, ``n``, ``max_new``, page ids, the page
  table) are copied from the host into static device buffers before the
  replay. On the CPU the same functions run eagerly over the same
  buffers. Each build counts at retrace site ``serving.decode`` (the
  draft's at ``serving.draft``) and traffic adds none. A capture that
  fails raises: nothing runs eagerly on the card.
* **No sync in the step** -- the dispatch runs inside the d2h-armed
  ``serving.decode`` span; the one declared fetch per step (tokens and the
  done mask, packed into one int32 tensor) follows in ``serving.fetch``
  through ``NDArray.asnumpy``, which ``telemetry.record_d2h`` counts. The
  speculative commit is computed on the device.
* **Snapshot, not live parameters** -- the model's ``decode_step`` runs
  under ``Predictor.bound()``: it reads the prefill Predictor's parameter
  snapshot (int8 weights dequantized where read), so a ``set_data`` on
  the block changes no answer until ``refresh_params()``.
* **KV residency** -- a :class:`KVCacheAccountant` ledgers each replica's
  KV bytes and gates admission (``serving.shed{kv_residency}``); it plugs
  into ``MicroBatcher(admission_gate=)`` and
  ``ReplicaSet.attach_accountant``, and a ``ServingController`` reads its
  ``pressure()``.
* **int8 KV** (``int8=True``) -- weights (the Predictor) and the KV cache
  are stored as symmetric int8 with per-row scales through
  ``ops.quantization``: about a quarter of float32's bytes a slot.
* **Paged KV** (``page_tokens`` a power of two) -- the carry's leaves
  are a pool of pages ``[pool_pages + 1, page_tokens, ...]`` (page 0 a
  scratch page) and each slot a row of a page table; a step gathers the
  cohort's dense view ``pool[ptab]`` (``[b, pages * page_tokens, ...]``
  materialised each step, as the reference's traced gather is), and
  admission counts real pages. ``prefix_cache=True`` shares full prompt
  pages between prompts with the same prefix (refcounted, read-only), and
  a hit prefills only the novel suffix. ``spec_k`` > 0 with a
  ``draft_model`` proposes k greedy tokens per step and verifies them in
  one target pass, committing the longest accepted prefix.

Model contract (:class:`DecodeModel`): a ``HybridBlock`` whose forward on
``tokens[b, s]`` returns ``(logits[b, s, V], *kv[b, s, ...])`` and whose
``decode_step(kv, tok, pos)`` (tensors in, tensors out) returns
``(logits[c, V], entries)``, the k/v rows this token appends, which the
engine persists at ``pos`` (quantized under int8).
``serving.decode_bench.TinyCausalLM`` is the executable reference.

Failure semantics: a step with no answer within ``dispatch_timeout_ms``
trips the wedge watchdog; the stuck sequences' futures fail loud
(``serving.decode.wedges``, a warning naming their count) and the carry
is reset in place (``zero_``/``fill_``) before the next dispatch, so every
captured graph keeps writing the memory it was captured over; an injected
``decode_wedge`` fault drives the path under a fake clock. A loop thread
that makes no progress within one more timeout after a trip is taken as
blocked in the device call, and the crash barrier fails the queue. A
wedge dumps ``flight_record("decode_wedge")``, a crash
``flight_record("worker_crash")``, and an OOM in the loop (or in
``poll``) ``xprof.oom_flight`` with the KV-cache accountant's view.

The reference's levers (``MXTPU_DECODE_SLOTS``, ``MXTPU_DECODE_QUEUE``,
``MXTPU_DECODE_MAX_NEW``, ``MXTPU_SERVE_KV_OVERCOMMIT``,
``MXTPU_KV_PAGE_TOKENS``, ``MXTPU_PREFIX_CACHE``, ``MXTPU_SPEC_DECODE_K``,
``MXTPU_SERVE_DISPATCH_TIMEOUT_MS``) are constructor arguments here with
the reference's defaults; the port reads no environment variable.
"""
from __future__ import annotations

import collections
import hashlib
import logging
import threading
import time

import numpy as np
import torch

from .. import telemetry, xprof
from ..base import MXNetError
from ..context import resolve_device
from ..graphs import CapturedGraph
from ..ndarray import NDArray
from ..resilience import inject, maybe_oom
from .batcher import DeadlineExceeded, QueueFull, _Future
from .engine import BucketSpec, Predictor, pool_bytes
from .replicas import DISPATCH_TIMEOUT_MS

__all__ = ["DecodeModel", "DecodeEngine", "DecodeFuture", "KVCacheAccountant",
           "DECODE_SLOTS", "DECODE_QUEUE", "DECODE_MAX_NEW", "KV_OVERCOMMIT"]

_log = logging.getLogger("mxtpu_torch.serving")

# the reference's MXTPU_DECODE_SLOTS, _DECODE_QUEUE, _DECODE_MAX_NEW and
# MXTPU_SERVE_KV_OVERCOMMIT defaults (page_tokens 0, prefix cache off and
# spec_k 0 are the constructor's)
DECODE_SLOTS = 8
DECODE_QUEUE = 256
DECODE_MAX_NEW = 32
KV_OVERCOMMIT = 2.0


class DecodeFuture(_Future):
    """A decode request's handle: ``result()`` is the generated token ids
    (int32 numpy, eos included when hit); ``ttft_s`` the time to the
    first token."""

    __slots__ = ("ttft_s",)

    def __init__(self):
        super().__init__()
        self.ttft_s = None


class _Sequence:
    __slots__ = ("prompt", "max_new", "deadline", "t_enq", "trace", "future",
                 "tokens", "slot", "pages", "reserved", "pos")

    def __init__(self, prompt, max_new, deadline, t_enq, trace):
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline
        self.t_enq = t_enq
        self.trace = trace
        self.future = DecodeFuture()
        self.tokens = []
        self.slot = None
        self.pages = []     # paged: mapped page ids, in chunk order
        self.reserved = 0   # paged: accountant pages still queued
        self.pos = 0        # paged: host mirror of the device position


class DecodeModel:
    """Contract mixin for autoregressive decode (see the module
    docstring). A model subclasses ``gluon.HybridBlock`` and this, returns
    ``(logits, *kv)`` from its forward and implements :meth:`decode_step`,
    reading its parameters with ``gluon.block.read_params(self)``, which
    the engine binds to its Predictor's snapshot."""

    def decode_step(self, kv, tok, pos):
        """One decode step: ``kv`` is the cohort's cache leaves ``[c, L,
        ...]`` in compute dtype WITHOUT this step's token (read only: they
        may be the engine's own storage); ``tok[c]`` int32 current tokens;
        ``pos[c]`` int32 cache lengths, each below ``L``. Returns
        ``(logits[c, V], entries)``, the per-leaf new rows ``[c, ...]``."""
        raise NotImplementedError

    def decode_chunk(self, kv, toks, pos):
        """Optional: score ``t`` chained tokens in one forward (the
        speculative verify's fast path). ``toks[c, t]`` are the pending
        token and t-1 draft proposals at positions ``pos + j``; query j
        attends the cache rows ``< pos`` and the chunk's own rows ``<= j``.
        Returns ``(logits[c, t, V], entries)`` with rows ``[c, t, ...]``;
        rows past ``L`` may be garbage (the engine masks them). Without
        it the verify chains ``decode_step``; int8 engines always chain."""
        raise NotImplementedError


# ----------------------------------------------------------- KV accounting
class KVCacheAccountant:
    """Per-replica KV residency ledger feeding admission control.

    Engines :meth:`register` their pool (bytes a slot x slots, tagged per
    replica like ``serving.predict.r<i>``); admission asks
    :meth:`would_admit` / :meth:`try_admit`: a sequence is admitted while
    (live + queued) slots stay under ``overcommit`` x capacity, past that
    it sheds ``serving.shed{kv_residency}``. Gauges
    ``serving.kv_capacity_bytes`` and ``serving.kv_resident_bytes`` (live
    slots only: a queued sequence holds no device bytes yet);
    :meth:`snapshot` (the ``/healthz`` ``kv`` block) gives per-tag bytes
    and the cohort buckets' byte ladder."""

    def __init__(self, capacity_bytes=None, overcommit=KV_OVERCOMMIT):
        self._lock = threading.Lock()
        self._pools = {}
        self._capacity_bytes = capacity_bytes
        self._overcommit = float(overcommit)

    def register(self, tag, per_slot_bytes, slots, bucket_slots=(),
                 page_tokens=0):
        """Declare (or re-declare) a replica's KV pool; ``bucket_slots`` is
        the cohort capacity ladder. A paged engine registers its page pool:
        ``per_slot_bytes`` one page's bytes, ``slots`` the pool's pages and
        ``page_tokens`` the page size, so the same ledger admits by free
        pages, not worst-case rows."""
        with self._lock:
            cap = self._capacity_bytes
            if cap is None:
                cap = int(per_slot_bytes) * int(slots)
            self._pools[tag] = {
                "per_slot_bytes": int(per_slot_bytes),
                "slots": int(slots),
                "capacity_bytes": int(cap),
                "page_tokens": int(page_tokens),
                "live": 0, "queued": 0,
                "bucket_bytes": {int(b): int(b) * int(per_slot_bytes)
                                 for b in bucket_slots},
            }
            self._gauges_locked()

    def _gauges_locked(self):
        telemetry.gauge("serving.kv_capacity_bytes",
                        sum(p["capacity_bytes"]
                            for p in self._pools.values()))
        telemetry.gauge("serving.kv_resident_bytes",
                        sum(p["live"] * p["per_slot_bytes"]
                            for p in self._pools.values()))

    def _pool(self, tag):
        p = self._pools.get(tag)
        if p is None:
            raise MXNetError("KVCacheAccountant: unregistered pool %r "
                             "(register() at engine warmup)" % (tag,))
        return p

    def would_admit(self, tag, n=1):
        """True while ``n`` more sequences fit the overcommit bound; an
        unregistered tag admits (a Predictor-only replica holds no KV)."""
        with self._lock:
            p = self._pools.get(tag)
            if p is None:
                return True
            have = p["live"] + p["queued"] + n
            return have * p["per_slot_bytes"] <= \
                p["capacity_bytes"] * self._overcommit

    def try_admit(self, tag, n=1):
        """The bound test and the queued increment under one lock hold, so
        concurrent submits cannot overshoot it. True when admitted (the
        caller owes a matching occupy or unqueue), False to shed."""
        with self._lock:
            p = self._pools.get(tag)
            if p is None:
                return True
            have = p["live"] + p["queued"] + n
            if have * p["per_slot_bytes"] > \
                    p["capacity_bytes"] * self._overcommit:
                return False
            p["queued"] += n
            return True

    def unqueue(self, tag, n=1):
        """``n`` admitted slots or pages left the queue without going
        resident (expired, shed, crashed, an unused reservation)."""
        with self._lock:
            p = self._pool(tag)
            p["queued"] = max(0, p["queued"] - n)

    def occupy(self, tag, n=1):
        """``n`` queued slots or pages went resident."""
        with self._lock:
            p = self._pool(tag)
            p["queued"] = max(0, p["queued"] - n)
            p["live"] += n
            self._gauges_locked()

    def release(self, tag, n=1):
        """``n`` resident slots or pages freed."""
        with self._lock:
            p = self._pool(tag)
            p["live"] = max(0, p["live"] - n)
            self._gauges_locked()

    def resident_bytes(self, tag=None):
        """Live KV bytes of one tag (0 when unregistered) or of all."""
        with self._lock:
            pools = [self._pools.get(tag)] if tag is not None \
                else list(self._pools.values())
            return sum(p["live"] * p["per_slot_bytes"] for p in pools
                       if p is not None)

    def pressure(self):
        """KV-residency pressure as a fraction of the admission bound: the
        largest (live + queued) / (overcommit x slots) over the pools, 0.0
        without pools. The ServingController scales up on it before the
        ``kv_residency`` sheds start."""
        with self._lock:
            worst = 0.0
            for p in self._pools.values():
                bound = self._overcommit * p["slots"]
                if bound > 0:
                    worst = max(worst, (p["live"] + p["queued"]) / bound)
            return worst

    def gate(self, tag):
        """An ``admission_gate=`` for a MicroBatcher guarding ``tag``'s
        pool: the shed reason ``kv_residency`` when over budget, else
        None."""
        def _gate(_n_items):
            return None if self.would_admit(tag) else "kv_residency"
        return _gate

    def snapshot(self):
        """JSON-serialisable per-tag view (``/healthz``)."""
        with self._lock:
            return {tag: {"capacity_bytes": p["capacity_bytes"],
                          "per_slot_bytes": p["per_slot_bytes"],
                          "slots": p["slots"],
                          "page_tokens": p["page_tokens"],
                          "live": p["live"], "queued": p["queued"],
                          "resident_bytes": p["live"] * p["per_slot_bytes"],
                          "bucket_bytes": dict(p["bucket_bytes"])}
                    for tag, p in self._pools.items()}


def _bcast(mask, ndim):
    """A [b] mask shaped to broadcast against a [b, ...] value."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def _quantize_rows(x):
    """Per-row symmetric int8 through the quantization op: the range is
    max|x| over each row's trailing axes (an all-zero row quantizes on a
    unit grid and stays zero). Returns ``(q int8, r float32 [rows])``: the
    one KV grid rule of the insert and of the step's write-back."""
    from ..ops.quantization import quantize
    xf = x.to(torch.float32)
    r = xf.abs().amax(dim=tuple(range(1, xf.ndim))) if xf.ndim > 1 \
        else xf.abs()
    r = torch.where(r > 0, r, 1.0)
    q, _lo, _hi = quantize(xf, -_bcast(r, xf.ndim), _bcast(r, xf.ndim))
    return q, r


def _dequantize_rows(q, r, dtype):
    """``q`` back to ``dtype`` on its per-row ranges ``r`` (``r``'s shape
    a prefix of ``q``'s)."""
    from ..ops.quantization import dequantize
    rb = r.reshape(tuple(r.shape) + (1,) * (q.ndim - r.ndim))
    return dequantize(q, -rb, rb).to(dtype)


def _argmax(logits):
    """Greedy token ids of ``logits[..., V]`` as int32 (the first
    maximum, as ``jnp.argmax`` gives it)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


class _PrefixCache:
    """Host index of shared read-only prompt pages (paged mode): a rolling
    chunk hash chains page-aligned token blocks, each entry pinning one
    pool page by refcount. Shared pages are full prompt chunks and are
    never written: a diverging suffix lives in its own pages from the first
    unmatched chunk on. Entries whose page only the cache holds evict LRU
    when the free list runs dry. Every call runs under the engine's lock."""

    def __init__(self):
        self._entries = collections.OrderedDict()  # h -> entry

    def __len__(self):
        return len(self._entries)

    @staticmethod
    def chunk_hash(parent, tokens):
        h = hashlib.sha1()
        h.update(parent.encode("ascii"))
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.hexdigest()

    def lookup(self, prompt, pt):
        """Longest cached page-aligned strict-prefix match: ``(matched
        chunks, [page ids])``; at most n - 1 tokens match, so the extend
        always has a novel token to prefill."""
        n = int(prompt.size)
        pids, h = [], ""
        for j in range((n - 1) // pt):
            chunk = prompt[j * pt:(j + 1) * pt]
            h = self.chunk_hash(h, chunk)
            e = self._entries.get(h)
            if e is None or not np.array_equal(e["tokens"], chunk):
                break
            self._entries.move_to_end(h)
            pids.append(e["pid"])
        return len(pids), pids

    def put(self, h, tokens, pid):
        """Register a full chunk's page (the caller increfs it for the
        cache's pin); False when the hash is already there."""
        if h in self._entries:
            return False
        self._entries[h] = {"tokens": np.array(tokens, np.int32),
                            "pid": int(pid)}
        self._entries.move_to_end(h)
        return True

    def evict_one(self, page_ref):
        """Drop the least recently used entry whose page only the cache
        pins; returns its pid, or None."""
        for h, e in self._entries.items():
            if page_ref[e["pid"]] == 1:
                del self._entries[h]
                return e["pid"]
        return None

    def drain(self):
        """Clear every entry (carry reset, close); returns the pinned
        pids."""
        pids = [e["pid"] for e in self._entries.values()]
        self._entries.clear()
        return pids


class _Exec:
    """One executable of the engine over static buffers (the counterpart
    of one of the reference's jitted functions): on the card a captured
    CUDA graph, on the CPU the function run eagerly. A call copies its
    inputs (host arrays or tensors; None keeps the buffer, as does the
    buffer itself) into the static buffers and runs; the outputs are the
    graph's static outputs, which the next call overwrites."""

    def __init__(self, fn, statics, device, pool):
        self.static_inputs = list(statics)
        self._fn = fn
        self._graph = None
        if device.type == "cuda":
            self._graph = CapturedGraph(fn, self.static_inputs, pool=pool,
                                        device=device)

    def __call__(self, *inputs):
        for static, x in zip(self.static_inputs, inputs):
            if x is None:
                continue
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            elif x.data_ptr() == static.data_ptr():
                continue
            static.copy_(x, non_blocking=True)
        if self._graph is not None:
            return self._graph.replay()
        return self._fn(*self.static_inputs)


# ------------------------------------------------------------------- engine
class DecodeEngine:
    """The continuous-batching decode loop (see the module docstring).

    ``prefill_spec`` is a seq-bucketed :class:`BucketSpec` (prompts pad to
    their seq bucket through the Predictor); ``decode_spec`` the
    ``decode_slots=`` spelling (default ``BucketSpec.pow2(decode_slots=
    8)``). ``start=True`` runs a loop thread and a wedge monitor;
    ``start=False`` (tests, fake clock) drives everything through
    :meth:`poll`. One engine owns one device's cohort; ``replica_tag``
    names its pool in a shared :class:`KVCacheAccountant`. ``device``
    defaults to ``cuda:0``."""

    def __init__(self, model, prefill_spec, decode_spec=None, max_len=None,
                 eos_id=None, example=None, warmup=True, name="decode",
                 device=None, site="serving.decode",
                 prefill_site="serving.prefill", int8=False,
                 accountant=None, replica_tag="r0", max_queue=DECODE_QUEUE,
                 max_new_default=DECODE_MAX_NEW,
                 dispatch_timeout_ms=DISPATCH_TIMEOUT_MS,
                 clock=time.monotonic, start=False, continuous=True,
                 page_tokens=0, pool_pages=None, prefix_cache=False,
                 draft_model=None, spec_k=0, draft_site="serving.draft"):
        if not hasattr(model, "decode_step"):
            raise MXNetError(
                "DecodeEngine serves DecodeModel-family blocks (got %s): "
                "implement decode_step(kv, tok, pos) -> (logits, entries)"
                % type(model).__name__)
        if getattr(prefill_spec, "is_decode", False):
            raise MXNetError(
                "DecodeEngine prefill_spec is a decode-cohort spec %r: "
                "prompts need batch x seq buckets (the Predictor path); "
                "pass the capacity spec as decode_spec=" % (prefill_spec,))
        if prefill_spec.seq_lens is None:
            raise MXNetError(
                "DecodeEngine prefill_spec declares no seq_lens: prompts "
                "are variable-length and must be seq-bucketed (a prompt "
                "past the largest bucket is refused)")
        if decode_spec is None:
            decode_spec = BucketSpec.pow2(decode_slots=DECODE_SLOTS)
        if not getattr(decode_spec, "is_decode", False):
            raise MXNetError(
                "DecodeEngine decode_spec must use the decode_slots= "
                "spelling (got %r): cohort buckets are slot capacities, "
                "not request batches" % (decode_spec,))
        self._model = model
        self._prefill_spec = prefill_spec
        self._decode_spec = decode_spec
        self._capacity = decode_spec.max_slots
        self._max_new_default = int(max_new_default)
        self._max_len = int(max_len if max_len is not None
                            else prefill_spec.seq_lens[-1]
                            + self._max_new_default)
        if self._max_len < prefill_spec.seq_lens[-1] + 1:
            raise MXNetError(
                "DecodeEngine max_len=%d leaves no room to decode past "
                "the largest prompt bucket (%d)"
                % (self._max_len, prefill_spec.seq_lens[-1]))
        self._eos = -1 if eos_id is None else int(eos_id)
        self._name = name
        self._site = site
        self._int8 = bool(int8)
        self._acct = accountant
        self._tag = replica_tag
        self._max_queue = int(max_queue)
        self._timeout_s = float(dispatch_timeout_ms) / 1e3
        self._clock = clock
        self._continuous = bool(continuous)
        pt = int(page_tokens or 0)
        if pt < 0 or (pt and (pt & (pt - 1))):
            raise MXNetError(
                "DecodeEngine page_tokens=%d must be 0 (rowed) or a "
                "power of two" % pt)
        self._pt = pt
        self._maxp = 0 if not pt else -(-self._max_len // pt)
        if pool_pages is not None and not pt:
            raise MXNetError("DecodeEngine pool_pages without "
                             "page_tokens: the rowed layout has no pool")
        self._pool_pages = 0 if not pt else int(
            pool_pages if pool_pages is not None
            else self._capacity * self._maxp)
        if pt and self._pool_pages < self._maxp:
            raise MXNetError(
                "DecodeEngine pool_pages=%d cannot hold even one "
                "max_len=%d sequence (%d pages of %d tokens)"
                % (self._pool_pages, self._max_len, self._maxp, pt))
        self._prefix_on = bool(prefix_cache)
        self._spec_k = int(spec_k or 0)
        if self._prefix_on and not pt:
            raise MXNetError("DecodeEngine prefix_cache needs paged KV "
                             "(page_tokens > 0): shared prompts are shared "
                             "pages")
        if self._spec_k and not pt:
            raise MXNetError("DecodeEngine spec_k needs paged KV "
                             "(page_tokens > 0)")
        if self._spec_k and draft_model is None:
            raise MXNetError("DecodeEngine spec_k=%d without a "
                             "draft_model: speculation needs a proposer"
                             % self._spec_k)
        if self._spec_k and self._prefix_on:
            raise MXNetError(
                "DecodeEngine prefix_cache with spec_k: a prefix hit "
                "skips the prefill the draft cache also needs; run one "
                "lever per engine")
        if draft_model is not None and not self._spec_k:
            draft_model = None
        if draft_model is not None and not hasattr(draft_model,
                                                   "decode_step"):
            raise MXNetError("DecodeEngine draft_model must be a "
                             "DecodeModel (decode_step)")
        self._draft_model = draft_model
        self._draft_site = draft_site
        self._draft_pred = None
        self._dkv_layout = None
        self._device = resolve_device(device)
        # host page-pool state (guarded by self._cond, whose RLock makes
        # the ledger helpers re-entrant)
        self._free_pages = []
        self._page_ref = None
        self._ptab = None
        self._prefix = _PrefixCache() if self._prefix_on else None
        if example is None:
            example = np.zeros((1, prefill_spec.seq_lens[0]), np.int32)
        self._pred = Predictor(model, prefill_spec, example=example,
                               warmup=False, name=name + ".prefill",
                               device=self._device, site=prefill_site,
                               int8=self._int8)
        if self._draft_model is not None:
            # the draft Predictor holds the draft's parameter snapshot;
            # its prefill runs inside the insert executables
            self._draft_pred = Predictor(
                self._draft_model, prefill_spec, example=example,
                warmup=False, name=name + ".draft", device=self._device,
                site=self._draft_site, int8=False)
        self._execs = {}           # (kind, bucket) -> _Exec
        self._pool = None          # the executables' graph memory pool
        self._kv_layout = None     # [(trailing_shape, dtype)] per leaf
        self._vocab = None
        self._logits_dtype = None  # the prefill logits' dtype
        self._carry = None         # {"kv", "scales", "tok", "pos", ...}
        self._carry_gen = 0        # bumped by every reset and teardown
        self._carry_stale = False  # reset the carry before the next dispatch
        self._last_logits = None   # the last step's logits (diagnostics)
        self._cond = threading.Condition()
        self._pending = collections.deque()
        self._slots = [None] * self._capacity
        self._inflight_seq = None  # popped, not yet slotted (mid-prefill)
        self._live = 0
        self._step_index = 0
        self._armed = None         # the in-flight step's watchdog entry
        self._prefill_armed = None  # the in-flight prefill's entry
        self._cycles = 0           # loop/poll progress (probation)
        self._probation = None     # (deadline, cycles at trip)
        self._closed = False
        self._draining = False
        self._crashed = False
        self._thread = None
        self._monitor = None
        self._stop = threading.Event()
        if warmup:
            self.warmup()
        if start:
            self.start()

    # ------------------------------------------------------------ properties
    @property
    def capacity(self):
        return self._capacity

    @property
    def int8(self):
        return self._int8

    @property
    def device(self):
        return self._device

    @property
    def live_slots(self):
        with self._cond:
            return self._live

    @property
    def pending_count(self):
        with self._cond:
            return len(self._pending)

    @property
    def predictor(self):
        """The prefill Predictor (its builds count at
        ``serving.prefill``)."""
        return self._pred

    @property
    def accountant(self):
        return self._acct

    @property
    def page_tokens(self):
        """Tokens per KV page (0: rowed worst-case slots)."""
        return self._pt

    @property
    def pool_pages(self):
        """Page-pool size (0 when rowed); page id 0 is a scratch page on
        top of it, so pool ids are 1..pool_pages."""
        return self._pool_pages

    @property
    def spec_k(self):
        """Speculative draft length (0: one token a step)."""
        return self._spec_k

    def _leaf_bytes(self, rows):
        total = 0
        for trail, dt in self._kv_layout:
            n = rows * int(np.prod(trail, dtype=np.int64) or 1)
            if self._int8:
                total += n + rows * 4    # int8 rows + float32 scales
            else:
                total += n * torch.empty((), dtype=dt).element_size()
        return total

    def per_slot_kv_bytes(self):
        """Bytes one slot's KV cache costs at ``max_len`` tokens (int8:
        quantized leaves and per-position scales); paged engines ledger
        :meth:`page_bytes` x pages mapped instead."""
        if self._kv_layout is None:
            raise MXNetError("per_slot_kv_bytes before warmup()")
        return self._leaf_bytes(self._max_len)

    def page_bytes(self):
        """Bytes one pool page costs (``page_tokens`` rows of every leaf;
        int8: quantized rows and scales)."""
        if self._kv_layout is None:
            raise MXNetError("page_bytes before warmup()")
        if not self._pt:
            raise MXNetError("page_bytes on a rowed engine "
                             "(page_tokens=0)")
        return self._leaf_bytes(self._pt)

    # ---------------------------------------------------------------- warmup
    def warmup(self):
        """Settle the prefill templates, derive the KV layout from one
        probe forward, build every prefill bucket, allocate the carry and
        build every cohort step and every insert (extend, draft, verify
        where on), each run once. After this a build at ``serving.decode``
        would be a stall in service. Idempotent."""
        if self._kv_layout is not None:
            return self
        probe = (np.zeros((1, self._prefill_spec.seq_lens[0]), np.int32),)
        flat, _fmt, _b = self._pred.predict_flat(probe)
        if len(flat) < 2:
            raise MXNetError(
                "DecodeModel forward must return (logits, *kv_leaves); "
                "got %d output(s): the KV cache is the decode state"
                % len(flat))
        logits = flat[0]._data
        if logits.ndim != 3:
            raise MXNetError(
                "DecodeModel prefill logits must be [batch, seq, vocab], "
                "got shape %s" % (tuple(logits.shape),))
        self._vocab = int(logits.shape[-1])
        self._logits_dtype = logits.dtype
        layout = []
        for i, leaf in enumerate(flat[1:]):
            d = leaf._data
            if d.ndim < 2 or d.shape[1] != logits.shape[1]:
                raise MXNetError(
                    "DecodeModel kv leaf %d must be [batch, seq, ...] "
                    "(got shape %s)" % (i, tuple(d.shape)))
            layout.append((tuple(int(x) for x in d.shape[2:]), d.dtype))
        self._kv_layout = layout
        self._pred.warmup()
        if self._draft_pred is not None:
            dflat, _df, _db = self._draft_pred.predict_flat(probe)
            if len(dflat) < 2 or dflat[0]._data.ndim != 3:
                raise MXNetError("draft_model must follow the DecodeModel "
                                 "prefill contract (logits, *kv_leaves)")
            if int(dflat[0]._data.shape[-1]) != self._vocab:
                raise MXNetError(
                    "draft_model vocab %d != target vocab %d: the draft "
                    "proposes target token ids"
                    % (int(dflat[0]._data.shape[-1]), self._vocab))
            self._dkv_layout = [
                (tuple(int(x) for x in leaf._data.shape[2:]),
                 leaf._data.dtype) for leaf in dflat[1:]]
        xprof.preflight(self._site, self._device, need=self._carry_bytes())
        with self._cond:
            if self._pt:
                self._reset_pool_locked()
            self._carry = self._alloc_carry()
        # one executable per cohort bucket (run on the all-inactive
        # cohort: a no-op step), one insert per seq bucket (max_new=0
        # marks the warmed slot done at insert, so warm-up leaves no live
        # slot), largest first so the shared pool fits the rest
        ptab0 = None if not self._pt else np.zeros_like(self._ptab)
        for b in sorted(self._decode_spec.decode_slots, reverse=True):
            if self._spec_k:
                props = self._get_draft_exec(b)()[0]
                self._get_verify_exec(b)(ptab0, props)
            elif self._pt:
                self._get_step_exec(b)(ptab0)
            else:
                self._get_step_exec(b)()
        for s in sorted(self._prefill_spec.seq_lens, reverse=True):
            self._get_insert_exec(s)(*self._insert_warm_args(s))
            if self._prefix is not None:
                self._get_extend_exec(s)(self._extend_args(
                    0, 0, 0, 0, np.zeros(self._maxp, np.int32),
                    np.zeros(s, np.int32)))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        telemetry.gauge("serving.decode.buckets",
                        len(self._decode_spec.decode_slots)
                        + len(self._prefill_spec.seq_lens))
        xprof.record_footprint(self._site, self._carry_bytes()
                               + pool_bytes(self._pool, self._device))
        if self._acct is not None:
            if self._pt:
                # one ledger "slot" is one page: the byte gauges and the
                # bound track pages mapped, not worst-case rows
                self._acct.register(self._tag, self.page_bytes(),
                                    self._pool_pages, page_tokens=self._pt)
            else:
                self._acct.register(
                    self._tag, self.per_slot_kv_bytes(), self._capacity,
                    bucket_slots=self._decode_spec.decode_slots)
        return self

    def _carry_bytes(self):
        rows = (self._pool_pages + 1) * self._pt if self._pt \
            else self._capacity * self._max_len
        total = self._leaf_bytes(rows) + self._capacity * 13
        if self._dkv_layout:
            total += sum(self._capacity * self._max_len
                         * int(np.prod(t, dtype=np.int64) or 1)
                         * torch.empty((), dtype=dt).element_size()
                         for t, dt in self._dkv_layout)
        return total

    def _alloc_carry(self):
        """The carry, allocated once: every executable is built over these
        tensors and mutates them in place."""
        C, L, dev = self._capacity, self._max_len, self._device
        # paged: leaves [pool + 1, page_tokens, ...]; page 0 is the
        # scratch page (inactive-slot writes, unmapped table entries and
        # overflow land there)
        rows = (self._pool_pages + 1, self._pt) if self._pt else (C, L)
        if self._int8:
            kv = [torch.zeros(rows + trail, dtype=torch.int8, device=dev)
                  for trail, _dt in self._kv_layout]
            scales = [torch.ones(rows, dtype=torch.float32, device=dev)
                      for _ in self._kv_layout]
        else:
            kv = [torch.zeros(rows + trail, dtype=dt, device=dev)
                  for trail, dt in self._kv_layout]
            scales = None
        carry = {"kv": kv, "scales": scales,
                 "tok": torch.zeros(C, dtype=torch.int32, device=dev),
                 "pos": torch.zeros(C, dtype=torch.int32, device=dev),
                 "active": torch.zeros(C, dtype=torch.bool, device=dev),
                 "rem": torch.zeros(C, dtype=torch.int32, device=dev),
                 "dkv": None, "ptab": None}
        if self._pt:
            carry["ptab"] = torch.zeros((C, max(1, self._maxp)),
                                        dtype=torch.int32, device=dev)
        if self._spec_k:
            # the draft's KV stays rowed in compute dtype: the draft is
            # small by design and stays off the page pool
            carry["dkv"] = [torch.zeros((C, L) + trail, dtype=dt, device=dev)
                            for trail, dt in self._dkv_layout]
        return carry

    def _reset_carry(self):
        """Zero the carry in place (a wedge reset or a teardown): the
        executables stay captured over the same memory."""
        c = self._carry
        for leaf in c["kv"] + (c["dkv"] or []):
            leaf.zero_()
        for s in c["scales"] or []:
            s.fill_(1.0)
        for key in ("tok", "pos", "rem", "active"):
            c[key].zero_()

    # ------------------------------------------------------ page pool (host)
    def _reset_pool_locked(self):
        P = self._pool_pages
        self._free_pages = list(range(P, 0, -1))   # pop() -> 1, 2, ...
        self._page_ref = np.zeros(P + 1, np.int32)
        self._ptab = np.zeros((self._capacity, max(1, self._maxp)), np.int32)
        self._page_gauges_locked()

    def _page_gauges_locked(self):
        if not self._pt:
            return
        free = len(self._free_pages)
        telemetry.gauge("serving.kv_page_free", free)
        telemetry.gauge("serving.kv_page_resident", self._pool_pages - free)
        telemetry.gauge("serving.kv_page_shared",
                        int(np.sum(self._page_ref[1:] >= 2)))
        telemetry.gauge("serving.kv_resident_tokens",
                        sum(s.pos for s in self._slots if s is not None))

    def _take_page_locked(self, seq):
        """One pool page for ``seq`` (ledger, refcount, map): its pid, or
        None when the pool is dry after evicting cache-only pages, or the
        accountant's headroom is gone and ``seq`` holds no reservation."""
        if seq.reserved <= 0:
            if self._acct is not None \
                    and not self._acct.try_admit(self._tag):
                return None
            seq.reserved += 1
        if not self._free_pages and self._prefix is not None:
            pid = self._prefix.evict_one(self._page_ref)
            if pid is not None:
                self._decref_locked(pid)
        if not self._free_pages:
            if self._acct is not None:
                self._acct.unqueue(self._tag)
            seq.reserved -= 1
            return None
        pid = self._free_pages.pop()
        self._page_ref[pid] = 1
        if self._acct is not None:
            self._acct.occupy(self._tag)
        seq.reserved -= 1
        seq.pages.append(pid)
        return pid

    def _share_page_locked(self, seq, pid):
        """Attach a cache-shared page to ``seq`` (a refcount only: its
        bytes are already ledgered live)."""
        self._page_ref[pid] += 1
        seq.pages.append(pid)

    def _decref_locked(self, pid):
        """Drop one reference; at zero the page returns to the free list
        and leaves the accountant's resident count."""
        self._page_ref[pid] -= 1
        if self._page_ref[pid] <= 0:
            self._page_ref[pid] = 0
            self._free_pages.append(pid)
            if self._acct is not None:
                self._acct.release(self._tag)

    def _free_seq_ledger(self, seq, slotted):
        """The one teardown ledger of a sequence (completion, done at
        insert, expiry, wedge, crash, close): paged, deref every page and
        hand back any reservation; rowed, release a slotted sequence's
        slot or unqueue a queued one."""
        if self._pt:
            with self._cond:
                for pid in seq.pages:
                    self._decref_locked(pid)
                seq.pages = []
                if seq.reserved > 0 and self._acct is not None:
                    self._acct.unqueue(self._tag, n=seq.reserved)
                seq.reserved = 0
                self._page_gauges_locked()
        elif self._acct is not None:
            if slotted:
                self._acct.release(self._tag)
            else:
                self._acct.unqueue(self._tag)

    def _register_prefix_locked(self, seq, m_chunks):
        """Publish the prompt's full chunks to the prefix cache (one extra
        reference each, so a page outlives its first owner). The page that
        holds the first generated token is private by construction, which
        keeps shared pages read-only with no copy-on-write."""
        if self._prefix is None:
            return
        pt = self._pt
        h = ""
        for j in range(int(seq.prompt.size) // pt):
            chunk = seq.prompt[j * pt:(j + 1) * pt]
            h = _PrefixCache.chunk_hash(h, chunk)
            if m_chunks <= j < len(seq.pages):
                if self._prefix.put(h, chunk, seq.pages[j]):
                    self._page_ref[seq.pages[j]] += 1
        self._page_gauges_locked()

    # ---------------------------------------------------- KV reads and writes
    def _kv_read(self, b):
        """The first ``b`` slots' caches in compute dtype (views of the
        carry; int8 dequantized with the per-position scales)."""
        c = self._carry
        if not self._int8:
            return [leaf[:b] for leaf in c["kv"]]
        return [_dequantize_rows(q[:b], s[:b], dt) for (_t, dt), q, s
                in zip(self._kv_layout, c["kv"], c["scales"])]

    def _kv_write_rows(self, entries, pos_b, act_b, b):
        """Persist this step's rows at (slot, pos); inactive slots keep
        their bytes (positions are clamped into the cache: an inactive
        slot may sit at ``max_len``). int8: per-row quantization, scales
        beside the cache."""
        c = self._carry
        idx = torch.arange(b, device=pos_b.device)
        wp = pos_b.clamp(max=self._max_len - 1).long()
        for i, entry in enumerate(entries):
            leaf = c["kv"][i]
            if self._int8:
                q, r = _quantize_rows(entry)
                sc = c["scales"][i]
                leaf[idx, wp] = torch.where(_bcast(act_b, q.ndim), q,
                                            leaf[idx, wp])
                sc[idx, wp] = torch.where(act_b, r, sc[idx, wp])
            else:
                leaf[idx, wp] = torch.where(_bcast(act_b, entry.ndim),
                                            entry.to(leaf.dtype),
                                            leaf[idx, wp])

    def _kv_gather(self, ptab_b, b):
        """Dense ``[b, max_len, ...]`` compute-dtype copies of the pool
        through the slots' page tables (int8 dequantized): what makes
        paging invisible to ``decode_step``. Unmapped entries read the
        scratch page, which the position mask never reaches."""
        c, L, pt, maxp = self._carry, self._max_len, self._pt, self._maxp
        out = []
        for i, (trail, dt) in enumerate(self._kv_layout):
            d = c["kv"][i][ptab_b].reshape((b, maxp * pt) + trail)[:, :L]
            if self._int8:
                r = c["scales"][i][ptab_b].reshape(b, maxp * pt)[:, :L]
                d = _dequantize_rows(d, r, dt)
            out.append(d)
        return out

    def _kv_scatter_rows(self, entries, page_b, off_b, keep_b):
        """Persist one row per lane at (page, offset); lanes with
        ``keep_b`` False write the scratch page. A page quantizes row by
        row as it fills, so the int8 grids equal the rowed engine's."""
        c = self._carry
        pg = torch.where(keep_b, page_b, 0).long()
        off = off_b.long()
        for i, entry in enumerate(entries):
            if self._int8:
                q, r = _quantize_rows(entry)
                c["kv"][i][pg, off] = q
                c["scales"][i][pg, off] = r
            else:
                c["kv"][i][pg, off] = entry.to(c["kv"][i].dtype)

    def _kv_row_update(self, kv_b, entries, idx, wp, upd):
        """Refresh a gathered dense view (the engine's own copy) with one
        chained sub-step's rows, so the next forward sees them; int8 runs
        them through the quantize-dequantize round trip a re-gather would
        apply, keeping the chain bit-identical to step-at-a-time decode."""
        for (_t, dt), leaf, entry in zip(self._kv_layout, kv_b, entries):
            row = entry.to(leaf.dtype)
            if self._int8:
                q, r = _quantize_rows(entry)
                row = _dequantize_rows(q, r, dt)
            leaf[idx, wp] = torch.where(_bcast(upd, row.ndim), row,
                                        leaf[idx, wp])
        return kv_b

    def _finish_insert(self, slot, first, n, max_new):
        """Seed ``slot``'s token, position, activity and budget from the
        first token; returns the fetched ``[first, done]``."""
        c = self._carry
        done0 = (first == self._eos) | (max_new <= 1) | (n >= self._max_len)
        c["tok"][slot] = first.view(1)
        c["pos"][slot] = n.view(1)
        c["active"][slot] = (~done0).view(1)
        c["rem"][slot] = (max_new - 1).view(1)
        return torch.stack([first, done0.to(torch.int32)])

    # ------------------------------------------------------------- building
    def _build(self, kind, bucket, fn, statics, site=None):
        """The one front door for the engine's executables: builds (on the
        card, captures) ``fn`` over ``statics`` and counts one build at
        the engine's retrace site (the draft's at ``serving.draft``)."""
        key = (kind, bucket)
        hit = self._execs.get(key)
        if hit is not None:
            return hit
        if self._device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        ex = _Exec(fn, statics, self._device, self._pool)
        telemetry.record_retrace(site or self._site, {
            "engine": self._name, "kind": kind, "bucket": bucket,
            "int8": self._int8, "capacity": self._capacity,
            "max_len": self._max_len, "device": str(self._device)})
        self._execs[key] = ex
        return ex

    def _get_step_exec(self, b):
        """The decode step of cohort bucket ``b``: greedy next token of
        every live slot, its k/v rows persisted at ``pos``, the eos /
        budget / ``max_len`` stop computed in place; outputs the packed
        ``[2, b]`` tokens and done mask, and the logits."""
        hit = self._execs.get(("step", b))
        if hit is not None:
            return hit
        c, pred, model = self._carry, self._pred, self._model
        eos, L, pt, maxp = self._eos, self._max_len, self._pt, self._maxp

        def fn(*_statics):
            act_b, tok_b, pos_b = c["active"][:b], c["tok"][:b], c["pos"][:b]
            rem0 = c["rem"][:b]
            if pt:
                ptab_b = c["ptab"][:b].long()
                kv_b = self._kv_gather(ptab_b, b)
            else:
                kv_b = self._kv_read(b)
            with pred.bound():
                logits, entries = model.decode_step(
                    kv_b, tok_b, pos_b.clamp(max=L - 1))
            next_tok = torch.where(act_b, _argmax(logits), tok_b)
            new_pos = torch.where(act_b, pos_b + 1, pos_b)
            rem_b = torch.where(act_b, rem0 - 1, rem0)
            done_b = act_b & ((next_tok == eos) | (rem_b <= 0)
                              | (new_pos >= L))
            if pt:
                idx = torch.arange(b, device=pos_b.device)
                page_b = ptab_b[idx, (pos_b // pt).clamp(max=maxp - 1).long()]
                self._kv_scatter_rows(entries, page_b, pos_b % pt,
                                      act_b & (pos_b < L))
            else:
                self._kv_write_rows(entries, pos_b, act_b, b)
            new_active = act_b & ~done_b
            c["tok"][:b] = next_tok
            c["pos"][:b] = new_pos
            c["active"][:b] = new_active
            c["rem"][:b] = rem_b
            return [torch.stack([next_tok, done_b.to(torch.int32)]), logits]

        statics = [c["ptab"]] if pt else []
        return self._build("step", b, fn, statics)

    def _get_draft_exec(self, b):
        """The speculative proposer of cohort bucket ``b``: k greedy draft
        tokens per live slot, chained over the draft's rowed KV (builds at
        ``serving.draft``); outputs ``props[b, k]``."""
        hit = self._execs.get(("draft", b))
        if hit is not None:
            return hit
        c, dmodel, dpred = self._carry, self._draft_model, self._draft_pred
        k, L = self._spec_k, self._max_len

        def fn(*_statics):
            act_b, pos0 = c["active"][:b], c["pos"][:b]
            cur = c["tok"][:b]
            idx = torch.arange(b, device=pos0.device)
            props = []
            # k + 1 feeds for k proposals: the last one only writes d_k's
            # row, which a full accept's bonus token moves past, so the
            # draft cache never keeps a hole there
            for j in range(k + 1):
                p_j = pos0 + j
                wp = p_j.clamp(max=L - 1)
                with dpred.bound():
                    logits, entries = dmodel.decode_step(
                        [leaf[:b] for leaf in c["dkv"]], cur, wp)
                keep = act_b & (p_j < L)
                for leaf, entry in zip(c["dkv"], entries):
                    w = wp.long()
                    leaf[idx, w] = torch.where(_bcast(keep, entry.ndim),
                                               entry.to(leaf.dtype),
                                               leaf[idx, w])
                if j < k:
                    cur = torch.where(act_b, _argmax(logits), cur)
                    props.append(cur)
            return [torch.stack(props, dim=1)]

        return self._build("draft", b, fn, [], site=self._draft_site)

    def _get_verify_exec(self, b):
        """The speculative commit of cohort bucket ``b``: the target scores
        the pending token and the k proposals (one ``decode_chunk`` in
        float32, else k + 1 chained ``decode_step`` s), and commits the
        longest prefix where draft equals target, cut by the plain stop
        rule (eos, budget, ``max_len``), all on the device. Outputs
        ``[b, k + 3]`` int32: the emitted tokens (-1 past the commit),
        their count and done."""
        hit = self._execs.get(("verify", b))
        if hit is not None:
            return hit
        c, model, pred = self._carry, self._model, self._pred
        eos, L, pt, k, maxp = (self._eos, self._max_len, self._pt,
                               self._spec_k, self._maxp)
        base = DecodeModel.decode_chunk
        chunked = (not self._int8) and getattr(
            type(model), "decode_chunk", base) is not base
        dev = self._device
        props_buf = torch.zeros((b, k), dtype=torch.int32, device=dev)

        def fn(ptab, props):
            act_b, tok_b, pos_b = c["active"][:b], c["tok"][:b], c["pos"][:b]
            rem_b = c["rem"][:b]
            ptab_b = ptab[:b].long()
            idx = torch.arange(b, device=dev)
            kv_b = self._kv_gather(ptab_b, b)
            if chunked:
                ctoks = torch.cat([tok_b[:, None], props], dim=1)
                with pred.bound():
                    logits, entries = model.decode_chunk(kv_b, ctoks, pos_b)
                outs = _argmax(logits)                        # [b, k+1]
                stacked = [e.reshape((b * (k + 1),) + tuple(e.shape[2:]))
                           for e in entries]
            else:
                cur, gs, rows = tok_b, [], []
                for j in range(k + 1):
                    p_j = pos_b + j
                    wp = p_j.clamp(max=L - 1)
                    with pred.bound():
                        logits, entries = model.decode_step(kv_b, cur, wp)
                    rows.append(entries)
                    gs.append(_argmax(logits))
                    if j < k:
                        kv_b = self._kv_row_update(kv_b, entries, idx,
                                                   wp.long(),
                                                   act_b & (p_j < L))
                        cur = props[:, j]
                outs = torch.stack(gs, dim=1)                 # [b, k+1]
                stacked = [torch.stack([r[i] for r in rows], dim=1).reshape(
                    (b * (k + 1),) + tuple(rows[0][i].shape[1:]))
                    for i in range(len(rows[0]))]
            ar = torch.arange(k + 1, device=dev, dtype=torch.int32)
            p_all = pos_b[:, None] + ar[None, :]
            keep = (act_b[:, None] & (p_all < L)).reshape(-1)
            chunk = (p_all // pt).clamp(max=maxp - 1).long()
            page = torch.gather(ptab_b, 1, chunk).reshape(-1)
            self._kv_scatter_rows(stacked, page, (p_all % pt).reshape(-1),
                                  keep)
            acc = torch.cumprod((props == outs[:, :k]).to(torch.int32), dim=1)
            a = acc.sum(dim=1)                              # accepted drafts
            i1 = ar[None, :]                                # token index - 1
            stop = (outs == eos) | ((rem_b[:, None] - (i1 + 1)) <= 0) \
                | ((pos_b[:, None] + i1 + 1) >= L)
            within = (i1 <= a[:, None]) & act_b[:, None]
            s_in = (stop & within).to(torch.int32)
            prev = torch.cumsum(s_in, dim=1) - s_in
            emit = within & (prev == 0)
            counts = emit.sum(dim=1).to(torch.int32)
            done_b = (stop & emit).any(dim=1)
            last = (counts - 1).clamp(min=0).long()
            new_tok = torch.where(act_b, outs[idx, last], tok_b)
            c["tok"][:b] = new_tok
            c["pos"][:b] = pos_b + counts
            c["active"][:b] = act_b & ~done_b
            c["rem"][:b] = rem_b - counts
            masked = torch.where(emit, outs, -1)
            # one packed int32 fetch: tokens | count | done
            return [torch.cat([masked, counts[:, None],
                               done_b.to(torch.int32)[:, None]], dim=1)]

        return self._build("verify", b, fn, [c["ptab"], props_buf])

    def _insert_layout(self, s):
        """Offsets in an insert's int32 argument buffer: ``[slot, n,
        max_new, *pages (paged), *prompt (speculative)]``."""
        chunks = -(-s // self._pt) if self._pt else 0
        return chunks, 3 + chunks + (s if self._spec_k else 0)

    def _insert_args(self, s, slot, n, max_new, pages=(), toks=None):
        chunks, size = self._insert_layout(s)
        args = np.zeros(size, np.int32)
        args[:3] = (slot, n, max_new)
        args[3:3 + len(pages)] = pages
        if toks is not None and self._spec_k:
            args[3 + chunks:] = toks
        return args

    def _insert_warm_args(self, s):
        leaves = [torch.zeros((1, s) + trail, dtype=dt, device=self._device)
                  for trail, dt in self._kv_layout]
        row = torch.zeros(self._vocab, dtype=self._logits_dtype,
                          device=self._device)
        return leaves + [row, self._insert_args(s, 0, 1, 0)]

    def _get_insert_exec(self, s):
        """The slot insert of prefill seq bucket ``s``: the prompt's KV
        into the slot (rowed) or into the page ids the host allocated
        (paged), both read from the argument buffer, and the first token
        sampled from the logits row at the prompt's true length; spec mode
        also runs the draft's prefill on the prompt and seeds its rowed
        KV. Outputs ``[first, done]``."""
        hit = self._execs.get(("insert", s))
        if hit is not None:
            return hit
        c, pt, spec = self._carry, self._pt, bool(self._spec_k)
        dmodel, dpred = self._draft_model, self._draft_pred
        nl = len(self._kv_layout)
        chunks, _size = self._insert_layout(s)

        def fn(*statics):
            leaves, lrow, args = statics[:nl], statics[nl], statics[nl + 1]
            slot = args[0:1].long()
            n, max_new = args[1], args[2]
            first = _argmax(lrow)
            pages = args[3:3 + chunks].long()
            for i, leaf in enumerate(leaves):
                row = leaf[0]                                # [s, *trail]
                if pt:
                    pad = chunks * pt - s
                    if pad:
                        row = torch.cat([row, row.new_zeros(
                            (pad,) + tuple(row.shape[1:]))])
                    if self._int8:
                        q, r = _quantize_rows(row)
                        c["kv"][i][pages] = q.reshape(
                            (chunks, pt) + tuple(q.shape[1:]))
                        c["scales"][i][pages] = r.reshape(chunks, pt)
                    else:
                        c["kv"][i][pages] = row.to(c["kv"][i].dtype).reshape(
                            (chunks, pt) + tuple(row.shape[1:]))
                elif self._int8:
                    q, r = _quantize_rows(row)
                    c["kv"][i][:, :s][slot] = q[None]
                    c["scales"][i][:, :s][slot] = r[None]
                else:
                    c["kv"][i][:, :s][slot] = row[None].to(c["kv"][i].dtype)
            if spec:
                toks = args[3 + chunks:3 + chunks + s]
                with dpred.bound():
                    dout = dmodel(toks[None])
                for leaf, d in zip(c["dkv"], dout[1:]):
                    leaf[:, :s][slot] = d[0][None].to(leaf.dtype)
            return [self._finish_insert(slot, first, n, max_new)]

        statics = self._insert_warm_args(s)
        statics[-1] = torch.from_numpy(statics[-1]).to(self._device)
        return self._build("insert", s, fn, statics)

    def _extend_args(self, m, n, slot, max_new, ptab_row, toks):
        return np.concatenate([np.array([m, n, slot, max_new], np.int32),
                               np.asarray(ptab_row, np.int32),
                               np.asarray(toks, np.int32)])

    def _get_extend_exec(self, s):
        """The prefix-hit prefill of seq bucket ``s``: the matched chunks'
        pages are shared, so only the novel suffix runs, as ``s`` chained
        ``decode_step`` s (positions at or past ``n`` masked) writing the
        suffix rows into the slot's own pages, the first token taken from
        the last prompt position. Arguments ``[m, n, slot, max_new,
        *page_table_row, *prompt]``."""
        hit = self._execs.get(("extend", s))
        if hit is not None:
            return hit
        c, model, pred = self._carry, self._model, self._pred
        L, pt, maxp = self._max_len, self._pt, self._maxp

        def fn(args):
            m, n, max_new = args[0], args[1], args[3]
            slot = args[2:3].long()
            ptab_row = args[4:4 + maxp].long()
            toks = args[4 + maxp:4 + maxp + s]
            fl = torch.zeros(self._vocab, dtype=torch.float32,
                             device=args.device)
            for t in range(s):
                p = (m + t).view(1)
                kv_b = self._kv_gather(ptab_row[None], 1)
                cur = toks[p.clamp(max=s - 1).long()]
                with pred.bound():
                    logits, entries = model.decode_step(
                        kv_b, cur, p.clamp(max=L - 1))
                page = ptab_row[(p // pt).clamp(max=maxp - 1).long()]
                self._kv_scatter_rows(entries, page, p % pt,
                                      (p < n) & (p < L))
                fl = torch.where(p == n - 1, logits[0].to(torch.float32), fl)
            return [self._finish_insert(slot, _argmax(fl), n, max_new)]

        buf = torch.from_numpy(self._extend_args(
            0, 0, 0, 0, np.zeros(maxp, np.int32),
            np.zeros(s, np.int32))).to(self._device)
        return self._build("extend", s, fn, [buf])

    def compile_stats(self):
        """The retrace watchdog's view of this engine's builds."""
        return telemetry.retrace_stats(self._site)

    # ------------------------------------------------------------- admission
    def submit(self, prompt, max_new=None, deadline_ms=None):
        """Admit one prompt (1-d int token ids). Returns a
        :class:`DecodeFuture` whose ``result()`` is the generated int32
        tokens; sheds :class:`QueueFull` past the queue bound or the
        accountant's KV-residency budget."""
        trace = telemetry.new_trace()
        t0 = time.perf_counter()
        with telemetry.trace_handoff(trace), \
                telemetry.span("serving.submit"):
            seq = self._admit(prompt, max_new, deadline_ms, trace)
        telemetry.add_stage(trace, "serving.submit",
                            time.perf_counter() - t0)
        return seq.future

    def _admit(self, prompt, max_new, deadline_ms, trace):
        if self._kv_layout is None:
            raise MXNetError("submit on a cold DecodeEngine: warmup() "
                             "first (replay needs its executables before "
                             "traffic)")
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise MXNetError("submit: prompt must be a non-empty 1-d "
                             "token-id array, got shape %s"
                             % (tuple(prompt.shape),))
        if not np.issubdtype(prompt.dtype, np.integer):
            raise MXNetError("submit: prompt dtype %s is not integer "
                             "token ids" % prompt.dtype)
        prompt = prompt.astype(np.int32)
        self._prefill_spec.seq_bucket(prompt.size)  # loud past the largest
        if prompt.size >= self._max_len:
            raise MXNetError(
                "submit: prompt of %d tokens leaves no room to decode "
                "within max_len=%d" % (prompt.size, self._max_len))
        max_new = int(max_new if max_new is not None
                      else self._max_new_default)
        if max_new < 1:
            raise MXNetError("submit: max_new must be >= 1, got %d"
                             % max_new)
        now = self._clock()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        seq = _Sequence(prompt, max_new, deadline, now, trace)
        if trace is not None:
            # the trace rides the future from admission, so a sequence a
            # wedge fails is correlatable
            seq.future.trace_id = trace.trace_id
        with self._cond:
            if self._crashed:
                self._shed("worker_crashed")
            if self._draining or self._closed:
                self._shed("draining")
            if len(self._pending) >= self._max_queue:
                self._shed("queue_full")
            if self._acct is not None:
                # check and ledger under the admission lock, before the
                # loop thread can pop the sequence; paged engines reserve
                # the prompt's pages (exact), decode draws page by page
                need = 1 if not self._pt \
                    else -(-min(prompt.size + 1, self._max_len) // self._pt)
                if not self._acct.try_admit(self._tag, n=need):
                    self._shed("kv_residency")
                seq.reserved = need if self._pt else 0
            self._pending.append(seq)
            telemetry.gauge("serving.queue_depth", len(self._pending))
            self._cond.notify_all()
        telemetry.inc("serving.requests")
        return seq

    def _shed(self, reason):
        telemetry.inc("serving.shed", tag=reason)
        raise QueueFull("request shed: %s" % reason)

    # --------------------------------------------------------------- serving
    def poll(self):
        """One engine cycle now (wedge scan, slot admission, one decode
        step): the fake-clock hook and the no-thread drive. Returns the
        decode steps run (0 or 1)."""
        try:
            maybe_oom()  # fault kind 'oom': the decode loop's OOM site
            self._scan_wedges(self._clock())
            self._admit_pending()
            steps = self._step_once()
        except Exception as e:
            self._flight_if_oom(e)   # the raise stays loud either way
            raise
        with self._cond:
            self._cycles += 1
        return steps

    def _flight_if_oom(self, exc):
        """``xprof.oom_flight`` for a device allocator failure, with the
        KV-cache accountant's residency view."""
        from .. import xprof
        if xprof.is_oom(exc):
            xprof.oom_flight(
                "serving.decode", exc,
                extra={"kv": self._acct.snapshot()
                       if self._acct is not None else None})

    def _free_slot_locked(self):
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admit_pending(self):
        """Move queued prompts into free slots between steps (prefill,
        then the insert); ``continuous=False`` refills only once the whole
        cohort drained, the idle-slot steps continuous batching saves."""
        filling = False
        while True:
            with self._cond:
                if not self._pending:
                    return
                if not self._continuous and self._live > 0 and not filling:
                    return
                filling = True
                slot = self._free_slot_locked()
                if slot is None:
                    return
                seq = self._pending.popleft()
                self._inflight_seq = seq
                telemetry.gauge("serving.queue_depth", len(self._pending))
            try:
                now = self._clock()
                if seq.deadline is not None and now > seq.deadline:
                    telemetry.inc("serving.deadline_expired")
                    self._free_seq_ledger(seq, slotted=False)
                    self._fail(seq, DeadlineExceeded(
                        "deadline passed before a KV slot freed (queued "
                        "%.1f ms)" % ((now - seq.t_enq) * 1e3)))
                    continue
                telemetry.add_stage(seq.trace, "serving.queue_wait",
                                    max(0.0, now - seq.t_enq), event=True)
                try:
                    self._prefill_into(seq, slot)
                except Exception as e:  # noqa: BLE001 — complete, re-raise
                    # the popped sequence is in neither the queue nor a
                    # slot: fail it here or the crash barrier strands it
                    if seq.slot is None and not seq.future.done():
                        self._free_seq_ledger(seq, slotted=False)
                        self._fail(seq, MXNetError(
                            "prefill failed: %s: %s"
                            % (type(e).__name__, e)))
                    raise
            finally:
                with self._cond:
                    self._inflight_seq = None

    def _map_prompt_pages(self, seq, slot):
        """Paged: map the prompt's pages before any device work (shared
        prefix chunks by refcount, the rest off the free list against the
        admission reservation). Returns ``(matched chunks, ok)``."""
        m_chunks = 0
        chunks = -(-int(seq.prompt.size) // self._pt)
        with self._cond:
            if self._prefix is not None:
                m_chunks, pids = self._prefix.lookup(seq.prompt, self._pt)
                for pid in pids:
                    self._share_page_locked(seq, pid)
            ok = True
            while len(seq.pages) < chunks:
                if self._take_page_locked(seq) is None:
                    ok = False
                    break
            if ok:
                self._ptab[slot, :] = 0
                self._ptab[slot, :len(seq.pages)] = seq.pages
            self._page_gauges_locked()
        if self._prefix is not None:
            telemetry.inc("serving.prefix.hits" if m_chunks
                          else "serving.prefix.misses")
        return m_chunks, ok

    def _prefill_into(self, seq, slot):
        """Prefill one prompt and insert its KV into ``slot``. The
        ``serving.prefill`` stage covers the prompt forward and the insert;
        the fetch of the first token (``serving.fetch``) makes TTFT a
        delivered fact."""
        n = int(seq.prompt.size)
        s_bucket = self._prefill_spec.seq_bucket(n)
        # pad on the host to the seq bucket
        prompt = seq.prompt if n == s_bucket else np.pad(
            seq.prompt, (0, s_bucket - n),
            constant_values=self._prefill_spec.pad_value)
        m_chunks = 0
        if self._pt:
            m_chunks, ok = self._map_prompt_pages(seq, slot)
            if not ok:
                # pool exhausted at prefill: shed loud
                telemetry.inc("serving.shed", tag="kv_residency")
                self._free_seq_ledger(seq, slotted=False)
                self._fail(seq, QueueFull(
                    "request shed: kv_residency (KV page pool exhausted "
                    "at prefill)"))
                return
        # the prefill and insert run on the same possibly wedged device as
        # the steps: they get their own watchdog entry
        p_entry = {"seq": seq, "deadline": self._clock() + self._timeout_s,
                   "done": False, "abandoned": False}
        with self._cond:
            self._prefill_armed = p_entry
        try:
            with telemetry.trace_handoff(seq.trace):
                t0 = time.perf_counter()
                if m_chunks:
                    # prefix hit: the matched chunks hold their KV; skip the
                    # Predictor and extend from the first novel token
                    with self._cond:
                        ptab_row = self._ptab[slot].copy()
                    out, gen, superseded = self._dispatch_carry(
                        self._get_extend_exec(s_bucket), self._extend_args(
                            m_chunks * self._pt, n, slot, seq.max_new,
                            ptab_row, prompt))
                else:
                    flat, _fmt, _b = self._pred.predict_flat(
                        (prompt[None, :],))
                    pages = seq.pages if self._pt else ()
                    out, gen, superseded = self._dispatch_carry(
                        self._get_insert_exec(s_bucket),
                        *[leaf._data for leaf in flat[1:]],
                        flat[0]._data[0, n - 1],
                        self._insert_args(s_bucket, slot, n, seq.max_new,
                                          pages, prompt))
                if superseded:
                    # a reset landed mid-insert: this prompt went into the
                    # superseded carry
                    self._fail_wedge_casualty(seq)
                    return
                telemetry.add_stage(seq.trace, "serving.prefill",
                                    time.perf_counter() - t0)
                t0 = time.perf_counter()
                with telemetry.span("serving.fetch", cat="sync"):
                    first_done = _fetch(out[0])
                telemetry.add_stage(seq.trace, "serving.fetch",
                                    time.perf_counter() - t0)
        finally:
            with self._cond:
                p_entry["done"] = True
                if self._prefill_armed is p_entry:
                    self._prefill_armed = None
        if seq.future.done():
            # a teardown settled this sequence while the device answered
            # late: touching the ledger again would count it twice
            return
        seq.tokens.append(int(first_done[0]))
        ttft = self._clock() - seq.t_enq
        seq.future.ttft_s = ttft
        telemetry.observe("serving.ttft_s", ttft)
        telemetry.inc("serving.decode.tokens")
        if int(first_done[1]):
            # done at insert (eos, max_new == 1): deliver without a step;
            # the prompt's full chunks still publish to the prefix cache
            if self._pt:
                with self._cond:
                    self._register_prefix_locked(seq, m_chunks)
            self._free_seq_ledger(seq, slotted=False)
            self._deliver(seq)
            return
        with self._cond:
            register = not (self._carry_gen != gen or self._closed
                            or self._crashed or seq.future.done())
            if register:
                seq.slot = slot
                seq.pos = n
                self._slots[slot] = seq
                self._live += 1
                telemetry.gauge("serving.decode.slots", self._live)
                if self._pt:
                    self._register_prefix_locked(seq, m_chunks)
                elif self._acct is not None:
                    # inside the lock: a reset right after must find the
                    # ledger already live
                    self._acct.occupy(self._tag)
        if not register:
            self._fail_wedge_casualty(seq)

    def _dispatch_carry(self, ex, *args):
        """The one carry dispatch protocol (steps and inserts): read the
        generation and any pending reset under the lock, run outside it (a
        dispatch into a wedged device can block, and holding the lock
        would stall every submit and the wedge scan), and report whether a
        reset superseded the carry meanwhile. The reset itself runs here,
        on the dispatching thread, so it is ordered after any late work of
        the call it replaces. Returns ``(outputs, gen, superseded)``."""
        with self._cond:
            gen, stale = self._carry_gen, self._carry_stale
            self._carry_stale = False
        if stale:
            self._reset_carry()
        out = ex(*args)
        with self._cond:
            superseded = self._carry_gen != gen
        return out, gen, superseded

    def _dispatch_step(self, b, ptab):
        """One cohort step's dispatch (inside the ``serving.decode``
        span): the step of bucket ``b``, or the draft and verify pair."""
        if self._spec_k:
            draft = self._get_draft_exec(b)
            verify = self._get_verify_exec(b)

            def composed(ptab_np):
                return verify(ptab_np, draft()[0])

            return self._dispatch_carry(composed, ptab)
        if self._pt:
            return self._dispatch_carry(self._get_step_exec(b), ptab)
        return self._dispatch_carry(self._get_step_exec(b))

    def _step_once(self):
        """One decode step of the live cohort at its smallest covering
        capacity bucket: a replay inside the armed ``serving.decode``
        span, then the one declared fetch in ``serving.fetch``; finished
        sequences free their slots before the next admission."""
        with self._cond:
            if self._live == 0:
                return 0
            prev = self._armed
            if prev is not None and not prev["done"] \
                    and not prev["abandoned"]:
                # a step still in flight (a wedge in the making): a new
                # dispatch must not discard its watchdog entry
                return 0
            casualties = []
            if self._pt:
                # every live sequence gets a page for each position this
                # step writes before the dispatch; on exhaustion one sheds
                # loud and its table row goes to the scratch page
                t_step = 1 + self._spec_k
                for s in [x for x in self._slots if x is not None]:
                    hi_chunk = min(s.pos + t_step - 1,
                                   self._max_len - 1) // self._pt
                    ok = True
                    while len(s.pages) <= hi_chunk:
                        if self._take_page_locked(s) is None:
                            ok = False
                            break
                    if ok:
                        self._ptab[s.slot, :len(s.pages)] = s.pages
                    else:
                        self._ptab[s.slot, :] = 0
                        self._slots[s.slot] = None
                        s.slot = None
                        self._live -= 1
                        casualties.append(s)
                        # give the casualty's pages back inside the pass:
                        # the next lane may need only one of them
                        self._free_seq_ledger(s, slotted=True)
                if casualties:
                    telemetry.gauge("serving.decode.slots", self._live)
                    self._page_gauges_locked()
            alive = self._live > 0
            if alive:
                hi = max(i for i, s in enumerate(self._slots)
                         if s is not None) + 1
                b = self._decode_spec.slot_bucket(hi)
                live = [s for s in self._slots[:b] if s is not None]
                idx = self._step_index
                self._step_index += 1
                entry = {"live": live, "idx": idx, "done": False,
                         "abandoned": False,
                         "deadline": self._clock() + self._timeout_s}
                self._armed = entry
                ptab_snap = self._ptab.copy() if self._pt else None
        for s in casualties:
            telemetry.inc("serving.shed", tag="kv_residency")
            self._fail(s, QueueFull(
                "request shed: kv_residency (KV page pool exhausted "
                "mid-decode)"))
        if not alive:
            return 0
        with telemetry.trace_handoff(live[0].trace):
            t0 = time.perf_counter()
            wedged = inject("decode_wedge", idx)
            if not wedged:
                with telemetry.span("serving.decode", d2h=True):
                    out, _gen, _sup = self._dispatch_step(b, ptab_snap)
            dt = time.perf_counter() - t0
            for s in live:
                telemetry.add_stage(s.trace, "serving.decode", dt)
            if wedged:
                # the device "never answers": the entry stays armed and the
                # watchdog scan trips it
                return 1
            t0 = time.perf_counter()
            with telemetry.span("serving.fetch", cat="sync"):
                packed = _fetch(out[0])
            if self._spec_k:
                toks = packed[:, :self._spec_k + 1]
                counts = packed[:, self._spec_k + 1]
                done = packed[:, self._spec_k + 2]
            else:
                toks, done, counts = packed[0], packed[1], None
            dt = time.perf_counter() - t0
            for s in live:
                telemetry.add_stage(s.trace, "serving.fetch", dt)
        with self._cond:
            stale = entry["abandoned"]
            entry["done"] = True
            if self._armed is entry:
                self._armed = None
        if stale:
            # the watchdog already failed this cohort and reset the carry:
            # a late answer must not resurrect freed slots
            return 1
        if self._spec_k:
            # each live lane verified k proposals and committed counts - 1
            # of them (the + 1 is the verify pass's own token)
            telemetry.inc("serving.decode.spec_proposed",
                          self._spec_k * len(live))
            telemetry.inc("serving.decode.spec_accepted",
                          int(sum(max(0, int(counts[s.slot]) - 1)
                                  for s in live)))
            self._last_logits = None
        else:
            self._last_logits = out[1]
        telemetry.inc("serving.decode.steps")
        self._harvest(live, toks, done, counts)
        return 1

    def _harvest(self, live, toks, done, counts=None):
        finished = []
        with self._cond:
            for seq in live:
                slot = seq.slot
                if counts is None:
                    seq.tokens.append(int(toks[slot]))
                    telemetry.inc("serving.decode.tokens")
                    seq.pos += 1
                else:
                    n = int(counts[slot])
                    seq.tokens.extend(int(t) for t in toks[slot][:n])
                    telemetry.inc("serving.decode.tokens", n)
                    seq.pos += n
                if done[slot]:
                    finished.append(seq)
                    self._slots[slot] = None
                    if self._pt:
                        self._ptab[slot, :] = 0
                    seq.slot = None
                    self._live -= 1
            telemetry.gauge("serving.decode.slots", self._live)
            if self._pt:
                self._page_gauges_locked()
            if finished:
                self._cond.notify_all()
        for seq in finished:
            self._free_seq_ledger(seq, slotted=True)
            self._deliver(seq)

    def _deliver(self, seq):
        done = self._clock()
        t0 = time.perf_counter()
        with telemetry.trace_handoff(seq.trace), \
                telemetry.span("serving.deliver"):
            seq.future._value = np.asarray(seq.tokens, np.int32)
        telemetry.add_stage(seq.trace, "serving.deliver",
                            time.perf_counter() - t0)
        if seq.trace is not None:
            seq.future.trace_id = seq.trace.trace_id
            seq.future.breakdown = telemetry.trace_breakdown(seq.trace)
        seq.future.e2e_s = done - seq.t_enq
        seq.future._event.set()
        telemetry.observe("serving.latency_s", done - seq.t_enq)

    @staticmethod
    def _fail(seq, error):
        seq.future._error = error
        seq.future._event.set()

    def _fail_wedge_casualty(self, seq):
        """Fail a mid-insert sequence whose carry was reset under it."""
        if seq.future.done():
            return
        self._free_seq_ledger(seq, slotted=False)
        self._fail(seq, DeadlineExceeded(
            "cohort reset by the wedge watchdog during this prompt's "
            "slot insert"))

    def _collect_teardown_locked(self):
        """Under ``self._cond``: collect every unfinished sequence (queued,
        slotted, the in-flight one), clear the slot table and the armed
        entries, schedule the carry reset and return ``(seqs, slotted
        ids)``: the one sweep of the crash barrier and of close()."""
        dead = list(self._pending) + [s for s in self._slots
                                      if s is not None]
        slotted = {id(s) for s in self._slots if s is not None}
        if self._inflight_seq is not None:
            dead.append(self._inflight_seq)
            self._inflight_seq = None
        self._pending.clear()
        for s in dead:
            s.slot = None
        self._slots = [None] * self._capacity
        self._live = 0
        for entry in (self._armed, self._prefill_armed):
            if entry is not None:
                entry["abandoned"] = True
        self._armed = self._prefill_armed = None
        # a late insert or registration on a thread resuming after this
        # sees the carry as superseded
        self._carry_gen += 1
        self._carry_stale = True
        if self._pt:
            # the cache's pins die with the cohort's device pages
            if self._prefix is not None:
                for pid in self._prefix.drain():
                    self._decref_locked(pid)
            self._ptab[:, :] = 0
            self._page_gauges_locked()
        self._cond.notify_all()
        return dead, slotted

    def _fail_collected(self, dead, slotted, err):
        for seq in dead:
            if seq.future.done():
                continue
            self._free_seq_ledger(seq, id(seq) in slotted)
            self._fail(seq, err)

    # ------------------------------------------------------- wedge watchdog
    def _check_probation(self, now):
        """After a trip in threaded mode the loop thread may be blocked
        inside the wedged device call; it gets one timeout window to make
        progress, else the crash barrier fails the queue."""
        with self._cond:
            prob = self._probation
            if prob is None:
                return
            deadline, cycles0 = prob
            if self._cycles != cycles0:
                self._probation = None
                return
            if now < deadline:
                return
            self._probation = None
        self._worker_crashed(RuntimeError(
            "decode loop made no progress for %.0f ms after a wedge "
            "trip: blocked inside the wedged device call"
            % (self._timeout_s * 1e3)))

    @staticmethod
    def _entry_due(entry, now):
        return entry is not None and not entry["done"] \
            and not entry["abandoned"] and now >= entry["deadline"]

    def _scan_wedges(self, now):
        """A dispatch with no answer past the timeout is a wedged device:
        a step wedge fails its cohort, a prefill wedge the prompt in
        flight (and the slotted cohort, which the same device carries);
        then the carry is scheduled for an in-place reset."""
        self._check_probation(now)
        with self._cond:
            entry = self._armed
            if self._entry_due(entry, now):
                entry["abandoned"] = True
                self._armed = None
                kind, idx = "step", entry["idx"]
                stuck = list(entry["live"])
                queued_stuck = []
            else:
                entry = self._prefill_armed
                if not self._entry_due(entry, now):
                    return
                entry["abandoned"] = True
                self._prefill_armed = None
                kind, idx = "prefill", -1
                stuck = []
                queued_stuck = [entry["seq"]]
                # settle the casualty with the abandonment, under the lock
                # a late prefill checks future.done() under
                seq = entry["seq"]
                if not seq.future.done():
                    self._free_seq_ledger(seq, slotted=False)
                    self._fail(seq, DeadlineExceeded(
                        "decode prefill dispatch wedged: no device "
                        "answer within %.0f ms" % (self._timeout_s * 1e3)))
            for seq in stuck:
                if seq.slot is not None:
                    self._slots[seq.slot] = None
                    seq.slot = None
                    self._live -= 1
            telemetry.gauge("serving.decode.slots", self._live)
        telemetry.inc("serving.decode.wedges")
        _log.warning(
            "serving: decode %s dispatch %d wedged (no answer in %.0f ms)"
            " — failing %d stuck sequence(s), resetting the cohort carry",
            kind, idx, self._timeout_s * 1e3,
            len(stuck) + len(queued_stuck))
        telemetry.flight_record(
            "decode_wedge",
            trace_ids=[s.trace.trace_id for s in stuck + queued_stuck
                       if s.trace is not None],
            extra={"kind": kind, "step": idx, "engine": self._name,
                   "stuck": len(stuck) + len(queued_stuck),
                   "timeout_ms": self._timeout_s * 1e3})
        err = DeadlineExceeded(
            "decode %s dispatch wedged: no device answer within %.0f ms"
            % (kind, self._timeout_s * 1e3))
        for seq in stuck:
            telemetry.trace_mark(seq.trace, "serving.wedged")
            self._free_seq_ledger(seq, slotted=True)
            self._fail(seq, err)
        for seq in queued_stuck:
            telemetry.trace_mark(seq.trace, "serving.wedged")
            if not seq.future.done():
                self._free_seq_ledger(seq, slotted=False)
                self._fail(seq, err)
        with self._cond:
            # the reset clears the whole cohort's device state: any other
            # live slot loses its KV too and fails
            stragglers = [s for s in self._slots if s is not None]
            self._slots = [None] * self._capacity
            self._live = 0
            telemetry.gauge("serving.decode.slots", 0)
            self._carry_gen += 1
            self._carry_stale = True
            if self._pt:
                if self._prefix is not None:
                    for pid in self._prefix.drain():
                        self._decref_locked(pid)
                self._ptab[:, :] = 0
                self._page_gauges_locked()
            if self._thread is not None and self._thread.is_alive():
                self._probation = (now + self._timeout_s, self._cycles)
            self._cond.notify_all()
        for seq in stragglers:
            self._free_seq_ledger(seq, slotted=True)
            self._fail(seq, err)

    # ---------------------------------------------------------------- worker
    def start(self):
        """Run the engine on a loop thread and a wedge monitor (the
        threaded twin of :meth:`poll`); returns self."""
        if self._thread is not None:
            return self
        if self._kv_layout is None:
            raise MXNetError("DecodeEngine.start on a cold engine: "
                             "warmup() first")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-serving-decode")
        self._thread.start()
        interval = max(0.005, min(0.25, self._timeout_s / 4))
        self._monitor = threading.Thread(
            target=self._monitor_loop, args=(interval,), daemon=True,
            name="mxtpu-serving-decode-monitor")
        self._monitor.start()
        return self

    def _loop(self):
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while True:
                with self._cond:
                    while not self._pending and self._live == 0 \
                            and not self._closed:
                        self._cond.wait(0.25)
                    if self._closed and not self._pending \
                            and self._live == 0:
                        return
                self._admit_pending()
                maybe_oom()  # fault kind 'oom': the decode loop's OOM site
                stepped = self._step_once()
                with self._cond:
                    # the heartbeat probation watches
                    self._cycles += 1
                    if not stepped and self._live > 0:
                        self._cond.wait(0.005)
        except Exception as e:  # noqa: BLE001 — the crash barrier
            self._flight_if_oom(e)
            self._worker_crashed(e)

    def _monitor_loop(self, interval):
        while not self._stop.is_set():
            self._scan_wedges(self._clock())
            with self._cond:
                if self._closed and not self._pending and self._live == 0:
                    return
            self._stop.wait(interval)

    def _worker_crashed(self, exc):
        """The loop died: fail every queued and live future loud and refuse
        new submits (the MicroBatcher's crash barrier)."""
        telemetry.inc("serving.worker_crashes")
        _log.error("serving decode loop crashed (%s: %s) — failing queued "
                   "futures and refusing new submits",
                   type(exc).__name__, exc)
        err = MXNetError("serving decode loop crashed: %s: %s"
                         % (type(exc).__name__, exc))
        with self._cond:
            self._crashed = True
            dead, slotted = self._collect_teardown_locked()
        telemetry.flight_record(
            "worker_crash",
            trace_ids=[s.trace.trace_id for s in dead
                       if s.trace is not None],
            extra={"engine": self._name,
                   "error": "%s: %s" % (type(exc).__name__, exc)})
        self._fail_collected(dead, slotted, err)

    def drain(self, timeout=None):
        """Stop admitting (submits shed ``draining``) and finish queued and
        live sequences; without a loop thread through :meth:`poll`
        (deadline on the injected clock). True when empty."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            alive = self._thread is not None and self._thread.is_alive()
            if not alive:
                while self.poll():
                    pass
                self._admit_pending()
            with self._cond:
                if not self._pending and self._live == 0 \
                        and self._inflight_seq is None:
                    return True
                if deadline is not None and self._clock() > deadline:
                    return False
                if not alive:
                    return False
                self._cond.wait(0.05)

    def close(self, timeout=5.0):
        """Drain, then stop the loop and monitor threads; anything left
        after the drain deadline fails loud."""
        self.drain(timeout=timeout)
        with self._cond:
            self._closed = True
            self._draining = True
            self._cond.notify_all()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._monitor is not None:
            self._monitor.join(timeout)
        # sweep after the joins, so no loop iteration races it
        with self._cond:
            leftovers, slotted = self._collect_teardown_locked()
        self._fail_collected(leftovers, slotted,
                             DeadlineExceeded("engine closed before "
                                              "completion"))
        return self

    # ------------------------------------------------------------ diagnostics
    def prefill_logits(self, prompt):
        """Diagnostic: the prompt's last-position logits as numpy (not a
        serving path: it fetches the device output directly)."""
        prompt = np.asarray(prompt, np.int32)
        flat, _fmt, _b = self._pred.predict_flat((prompt[None, :],))
        return _fetch(flat[0]._data[0, prompt.size - 1])

    def step_logits_probe(self, prompt):
        """Diagnostic: prefill and insert ``prompt``, run one decode step
        through the engine's own executables and return that step's
        logits row (slot 0's, the probe's). Do not call under traffic."""
        fut = self.submit(prompt, max_new=2)
        for _ in range(64):
            if fut.done():
                break
            self.poll()
        if self._last_logits is None:
            raise MXNetError("step_logits_probe: no decode step ran "
                             "(prompt finished at insert?)")
        out = _fetch(self._last_logits[0])
        fut.result(timeout=5.0)
        return out


def _fetch(t):
    """A declared device-to-host read (``NDArray.asnumpy``, which
    ``telemetry.record_d2h`` counts against the enclosing span)."""
    return NDArray(t).asnumpy()
