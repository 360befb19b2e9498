"""Bucketed inference (counterpart of ``mxtpu/serving/engine.py``).

``BucketSpec`` declares the closed set of shapes a ``Predictor`` serves:
batch buckets and, optionally, sequence buckets (``seq_lens``) along
``seq_axis`` of every input that has it. A request of n items runs at the
smallest batch bucket >= n and, with sequence buckets, at the smallest one
>= its length; a request past the largest batch bucket goes through it in
chunks, and a sequence past the largest sequence bucket raises.

The ``Predictor`` keeps its own snapshot of the block's parameters on its
device (``_snapshot_params``) and runs the block functionally over it
(``torch.func.functional_call``): the block stays where it is, a later
``set_data`` on it changes nothing until ``refresh_params()``, and
Predictors over one block on several devices never move each other's
weights. With ``int8=True`` every floating parameter of ndim >= 2 is
stored as symmetric int8 with a per-tensor range (``ops.quantization``)
and dequantized inside the forward where its layer reads it
(``gluon.block.reading_params``): each float copy lives only through that
layer, so a captured graph's pool never holds them all.

On a CUDA device each bucket is one captured CUDA graph
(``graphs.CapturedGraph``), with static input buffers and one memory pool
shared by the Predictor's buckets, captured largest first by ``warmup()``
or at a bucket's first request. A request pads straight into its bucket's
static inputs, replays the graph and gets copies of the outputs sliced to
its batch (the next replay overwrites the static outputs). An input is
cast to its template's dtype on that copy. Nothing on that path syncs the
host. ``refresh_params()`` copies new values into the
captured parameter storage, so it never captures again. A capture that
fails raises: the Predictor never serves eagerly on the card. On the CPU a
bucket runs eagerly over the same static inputs. Either way each bucket
counts one build at the Predictor's retrace site (``compile_stats()``),
and traffic adds none.

``predict_flat`` returns the reference's ``(flat NDArrays, out_fmt,
bucket)``; ``predict`` regroups them into the block's output structure of
NDArrays.

Memory: before ``warmup()`` builds, the pre-flight
(``xprof.preflight``) holds the site's last recorded footprint (else the
snapshot and static inputs) plus the bytes ``co_resident()`` reports held
by other models on the device against the device's limit, and counts
``memory.overcommit`` past it; after warm-up the bytes the Predictor holds
are recorded at its site (``xprof.site_footprint``). ``release()`` drops
the graphs, their pool and the snapshot (a zoo eviction).

The decode engine (``serving.decode``) prefills through a Predictor and
runs its steps under ``bound()``: the block's parameters read as the
snapshot for the body, so decode answers change with ``refresh_params()``
and never with a bare ``set_data``.

``from_checkpoint`` serves a symbol checkpoint and
``from_trainer_checkpoint`` the parameters of a
``contrib.async_checkpoint.save_trainer`` step. A device OOM in a dispatch
(``torch.cuda.OutOfMemoryError``, fault kind ``oom``) writes
``xprof.oom_flight``'s artifact before it fails the dispatch.

Every bucket resolves through the compile service (``compile_service``,
site = the Predictor's retrace site): its key is the block's class and
source with the snapshot's names, shapes and dtypes (``_fn_token``), the
bucket's shapes and dtypes with ``int8``, ``compile_service.
forward_policy()``, the device and this Predictor's nonce; ``_buckets``
is a view over the service's store, so the LRU bound evicts a bucket
from it too (a later request captures it again). ``warmup_entries()``
declares one ``compile_service.WarmupEntry`` per bucket, largest first,
with a group token that a ReplicaSet's identical members share;
``warmup()`` is ``compile_service.warmup(self.warmup_entries())`` after
the pre-flight, then ``finish_warmup()``. With the service's cache dir
set, a bucket whose blob holds takes its FLOPs from it (no
``FlopCounterMode`` pass) and the pre-flight takes the footprint that the
largest bucket's blob recorded; the capture still runs, once per bucket
and device, in a warm process as in a cold one (a CUDA graph cannot be
serialized). ``param_args()`` gives the snapshot a bucket reads.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import numpy as np
import torch

from .. import compile_service, graphs, resilience, telemetry, xprof
from ..base import MXNetError, canonical_dtype
from ..context import resolve_device
from ..graphs import CAPTURE_LOCK, CapturedGraph
from ..ndarray import NDArray

__all__ = ["BucketSpec", "Predictor", "pad_nd"]


def pool_bytes(pool, device):
    """Bytes of the segments of graph memory pool ``pool`` on ``device``
    (0 without a pool)."""
    if pool is None:
        return 0
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == pool)


def pad_nd(arr, batch, seq_len=None, seq_axis=1, pad_value=0):
    """``arr`` padded with ``pad_value`` up to ``batch`` rows on axis 0 and,
    when ``seq_len`` is given and ``arr`` has a ``seq_axis`` dimension, up
    to ``seq_len`` on that axis; ``arr`` itself when nothing is padded."""
    shape = list(arr.shape)
    if shape[0] > batch:
        raise MXNetError("pad_nd: batch %d exceeds bucket %d"
                         % (shape[0], batch))
    shape[0] = batch
    if seq_len is not None and arr.ndim > seq_axis:
        if arr.shape[seq_axis] > seq_len:
            raise MXNetError("pad_nd: axis %d size %d exceeds bucket %d"
                             % (seq_axis, arr.shape[seq_axis], seq_len))
        shape[seq_axis] = seq_len
    if tuple(shape) == tuple(arr.shape):
        return arr
    out = arr.new_full(shape, pad_value)
    out[tuple(slice(0, n) for n in arr.shape)] = arr
    return out


class BucketSpec:
    """The closed set of shapes a Predictor runs: batch sizes (ascending)
    and, optionally, sequence lengths along ``seq_axis`` of every input
    that has it.

    ``decode_slots`` is the third spelling, exclusive of both: the
    capacity buckets of a continuous-batching decode cohort
    (:class:`~mxtpu_torch.serving.decode.DecodeEngine`). A slot carries
    its KV cache across steps, so there is no sequence axis to bucket and
    no request batch to pad: a bucket says how many live slots one step
    covers. A Predictor refuses a decode spec and a DecodeEngine a
    prefill spec as its cohort, both loudly."""

    def __init__(self, batch_sizes=None, seq_lens=None, seq_axis=1,
                 pad_value=0, decode_slots=None):
        if decode_slots is not None:
            if batch_sizes is not None:
                raise MXNetError(
                    "BucketSpec: decode_slots=%r cannot combine with "
                    "batch_sizes=%r: a decode cohort's buckets are its slot "
                    "capacities; prefill batch buckets belong to the "
                    "separate prefill BucketSpec"
                    % (decode_slots, batch_sizes))
            if seq_lens is not None:
                raise MXNetError(
                    "BucketSpec: decode_slots=%r cannot combine with "
                    "seq_lens=%r: decode slots carry KV caches of the "
                    "engine's fixed max_len; there is no seq axis to bucket"
                    % (decode_slots, seq_lens))
            batch_sizes = decode_slots
        elif batch_sizes is None:
            raise MXNetError(
                "BucketSpec: pass batch_sizes (a served shape set) or "
                "decode_slots (a decode-cohort capacity set)")
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise MXNetError("BucketSpec: %s must be >= 1, got %r"
                             % ("decode_slots" if decode_slots is not None
                                else "batch_sizes", batch_sizes))
        self.batch_sizes = tuple(sizes)
        self.decode_slots = (self.batch_sizes if decode_slots is not None
                             else None)
        self.seq_lens = (tuple(sorted({int(s) for s in seq_lens}))
                         if seq_lens else None)
        self.seq_axis = int(seq_axis)
        self.pad_value = pad_value

    @classmethod
    def pow2(cls, max_batch=None, seq_lens=None, seq_axis=1,
             decode_slots=None):
        """1, 2, 4, ... up to and including ``max_batch``; or, with
        ``decode_slots=n`` instead, the same ladder as decode-cohort
        capacities."""
        if (max_batch is None) == (decode_slots is None):
            raise MXNetError(
                "BucketSpec.pow2: pass exactly one of max_batch (a "
                "request-batch ladder) or decode_slots (a decode-cohort "
                "capacity ladder), got max_batch=%r decode_slots=%r"
                % (max_batch, decode_slots))
        if decode_slots is not None and seq_lens is not None:
            raise MXNetError(
                "BucketSpec.pow2: decode_slots=%r cannot combine with "
                "seq_lens=%r: decode slots carry KV caches of the engine's "
                "fixed max_len" % (decode_slots, seq_lens))
        top = int(max_batch if max_batch is not None else decode_slots)
        sizes, b = [], 1
        while b < top:
            sizes.append(b)
            b *= 2
        sizes.append(top)
        if decode_slots is not None:
            return cls(decode_slots=sizes)
        return cls(sizes, seq_lens=seq_lens, seq_axis=seq_axis)

    @property
    def is_decode(self):
        """True for a decode-cohort spec (the ``decode_slots=`` spelling)."""
        return self.decode_slots is not None

    @property
    def max_slots(self):
        """Largest cohort capacity (decode specs only)."""
        if not self.is_decode:
            raise MXNetError("BucketSpec.max_slots on a non-decode spec "
                             "(declare it with decode_slots=)")
        return self.batch_sizes[-1]

    def slot_bucket(self, n_live):
        """Smallest capacity bucket >= ``n_live`` slots (decode specs only;
        None past the largest)."""
        if not self.is_decode:
            raise MXNetError("BucketSpec.slot_bucket on a non-decode spec "
                             "(declare it with decode_slots=)")
        return self.batch_bucket(n_live)

    @property
    def max_batch(self):
        return self.batch_sizes[-1]

    def batch_bucket(self, n):
        """Smallest bucket >= n, or None when n exceeds the largest (the
        caller chunks)."""
        for b in self.batch_sizes:
            if n <= b:
                return b
        return None

    def seq_bucket(self, s):
        """Smallest sequence bucket >= s (None without sequence buckets);
        raises when s exceeds the largest."""
        if self.seq_lens is None:
            return None
        for n in self.seq_lens:
            if s <= n:
                return n
        raise MXNetError(
            "request seq length %d exceeds the largest declared bucket %d "
            "(BucketSpec.seq_lens=%s): sequences cannot be chunked"
            % (s, self.seq_lens[-1], list(self.seq_lens)))

    def buckets(self):
        """Every (batch, seq or None) pair: the set ``warmup()`` builds."""
        seqs = self.seq_lens or (None,)
        return [(b, s) for b in self.batch_sizes for s in seqs]

    def __len__(self):
        return len(self.batch_sizes) * len(self.seq_lens or (None,))

    def __repr__(self):
        if self.is_decode:
            return "BucketSpec(decode_slots=%s)" % (list(self.decode_slots),)
        return "BucketSpec(batch=%s%s)" % (
            list(self.batch_sizes),
            ", seq=%s@axis%d" % (list(self.seq_lens), self.seq_axis)
            if self.seq_lens else "")


def _request_tensor(a):
    """A request input as a tensor where it lies (the copy into the
    bucket's static input moves it), in the JAX package's dtypes."""
    if isinstance(a, NDArray):
        t = a._data
    elif isinstance(a, torch.Tensor):
        t = a
    else:
        t = torch.as_tensor(np.asarray(a))
    dt = canonical_dtype(t.dtype)
    return t if t.dtype == dt else t.to(dt)


class Predictor:
    """Bucketed inference over a HybridBlock, pinned to one device.

    ``example`` (one input, or a tuple of inputs, with a batch axis)
    records each input's trailing shape and dtype, the templates
    ``warmup()`` builds every bucket with, and settles deferred parameter
    shapes; without it the first ``predict`` does both. ``site`` names the
    retrace site the builds count at (``serving.predict.r<i>`` for a
    ReplicaSet member); ``name`` labels the provenance. ``int8=True``
    stores weights as int8 (the ``MXTPU_SERVE_INT8`` lever of the JAX
    package, off by default). ``co_resident`` is a callable returning the
    bytes other models already hold on this device (the zoo's), which the
    pre-flight adds. ``param_version`` names the parameters served (the
    zoo's version, stamped by ``refresh_params``).

    One request runs at a time (a lock around pad, replay and copy-out),
    so a MicroBatcher's worker and direct callers may share a Predictor.
    """

    def __init__(self, block, spec, example=None, warmup=False,
                 name="predictor", device=None, site="serving.predict",
                 int8=False, co_resident=None):
        if not hasattr(block, "collect_params"):
            raise MXNetError("Predictor serves HybridBlock-family models "
                             "(got %s)" % type(block).__name__)
        if getattr(spec, "is_decode", False):
            raise MXNetError(
                "Predictor cannot serve a decode-cohort BucketSpec "
                "(decode_slots=%s): slot-capacity buckets describe a "
                "DecodeEngine cohort, not request shapes; declare "
                "batch_sizes/seq_lens for a Predictor"
                % (list(spec.decode_slots),))
        self._block = block
        self._spec = spec
        self._name = name
        self._device = resolve_device(device)
        self._site = site
        self._int8 = bool(int8)
        self._co_resident = co_resident
        self.param_version = None
        self._params = None      # ordered Parameters, fixed at settle
        self._keys = None        # their functional_call names
        self._stored = None      # per-param storage on the device
        self._ranges = None      # per-param int8 range (None: exact)
        self._qdtypes = None     # per-param original dtype (None: exact)
        self._deq = {}           # id(int8 storage) -> (range, dtype)
        self._templates = None   # [(trailing_shape, dtype)] per input
        self._nonce = compile_service.release_on_collect(self)
        # ((shape, dtype), ...) -> bucket: the service's entries of this
        # Predictor
        self._buckets = compile_service.SiteTable(
            lambda k, n=self._nonce: k.nonce == n,
            name=lambda k: k.signature[0])
        self._fn_tok = None
        self._out_fmt = None
        self._pool = None
        self._lock = threading.Lock()
        if example is not None:
            self._settle(example if isinstance(example, (tuple, list))
                         else (example,))
        if warmup:
            self.warmup()

    # ------------------------------------------------------------ templates
    def _settle(self, args):
        """Record each input's trailing shape and dtype, run one eager
        forward where the block sits if deferred shapes are unsettled, and
        take the parameter snapshot."""
        datas = [_request_tensor(a) for a in args]
        params = list(self._block.collect_params().values())
        if not params or any(not p.initialized for p in params):
            dev = params[0]._get().device if params else torch.device("cpu")
            with CAPTURE_LOCK, torch.no_grad():
                self._block(*[d.to(dev) for d in datas])
            params = list(self._block.collect_params().values())
        if any(not p.initialized for p in params):
            raise MXNetError("Predictor: parameters still uninitialized "
                             "after the example forward")
        paths = {id(m): path for path, m in self._block.named_modules()}
        keys = []
        for p in params:
            module, attr = p._owner
            path = paths[id(module)]
            keys.append(path + "." + attr if path else attr)
        self._params, self._keys = params, keys
        self._snapshot_params()
        self._templates = [(tuple(d.shape[1:]), d.dtype) for d in datas]

    def _snapshot_params(self):
        """Copy the block's parameters into this Predictor's storage on its
        device (int8-quantized under ``int8``). The first snapshot
        allocates; a refresh writes in place, so captured graphs read the
        new values at the addresses they were captured with."""
        datas = [p._tensor().detach() for p in self._params]
        stored, ranges, qdts = self._quantize_params(
            datas, sticky=self._qdtypes)
        if self._stored is None:
            self._stored = [d.to(self._device, copy=True) for d in stored]
            self._ranges = [None if r is None else r.to(self._device)
                            for r in ranges]
        else:
            for p, dst, src in zip(self._params, self._stored, stored):
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise MXNetError(
                        "refresh_params: %s is now %s %s, the snapshot holds "
                        "%s %s (a new shape or dtype needs a new Predictor)"
                        % (p.name, tuple(src.shape), src.dtype,
                           tuple(dst.shape), dst.dtype))
                dst.copy_(src)
            for dst, src in zip(self._ranges, ranges):
                if dst is not None:
                    dst.copy_(src)
        self._qdtypes = qdts
        self._deq = {id(t): (r, qdt) for t, r, qdt in
                     zip(self._stored, self._ranges, qdts) if qdt is not None}

    def _quantize_params(self, datas, sticky=None):
        """int8 storage: eligible parameters (floating, ndim >= 2) become
        symmetric int8 with a per-tensor range ``r = max|w|``. ``sticky``
        (the previous per-parameter dtypes) pins eligibility after the
        first snapshot: a weight that turns all-zero keeps its int8 slot
        on a unit grid, where zeros stay exact. The range is read on the
        host here, at snapshot time, never on the served path."""
        n = len(datas)
        if not self._int8:
            return datas, [None] * n, [None] * n
        from ..ops.quantization import quantize
        out, ranges, qdts = [], [], []
        for i, d in enumerate(datas):
            if sticky is not None:
                eligible = sticky[i] is not None
            else:
                eligible = d.ndim >= 2 and d.is_floating_point()
            r = float(d.abs().max()) if eligible else 0.0
            if eligible and not 0.0 < r < float("inf"):
                if sticky is None:
                    eligible = False
                else:
                    r = 1.0
            if not eligible:
                out.append(d)
                ranges.append(None)
                qdts.append(None)
                continue
            q, _lo, _hi = quantize(d, -r, r)
            out.append(q)
            ranges.append(torch.tensor(r, dtype=torch.float32))
            qdts.append(d.dtype)
        return out, ranges, qdts

    def _read_param(self, t):
        """A parameter as its layer reads it: int8 storage dequantized to
        its original dtype, anything else as it is."""
        q = self._deq.get(id(t))
        if q is None:
            return t
        from ..ops.quantization import dequantize
        r, qdt = q
        return dequantize(t, -r, r).to(qdt)

    def _forward(self, *datas):
        """The block over this Predictor's snapshot (each int8 weight
        dequantized where its layer reads it); what each bucket runs or
        captures."""
        from ..gluon.block import _flatten, reading_params
        params = dict(zip(self._keys, self._stored))
        with torch.no_grad(), \
                reading_params(self._read_param if self._deq else None):
            out = torch.func.functional_call(self._block, params, datas)
        fmt = []
        flat = _flatten(out, fmt)
        self._out_fmt = fmt
        return flat

    @contextlib.contextmanager
    def bound(self):
        """For the body, the block's parameters are this Predictor's
        snapshot, each int8 weight dequantized where its layer reads it
        (``gluon.block.read_params``), as the forward sees them through
        ``functional_call``. Holds ``CAPTURE_LOCK``, as every forward of
        the shared block does."""
        from ..gluon.block import reading_params
        with CAPTURE_LOCK:
            saved = []
            try:
                for p, t in zip(self._params, self._stored):
                    module, attr = p._owner
                    saved.append((module, attr, module._parameters[attr]))
                    module._parameters[attr] = t
                with torch.no_grad(), reading_params(
                        self._read_param if self._deq else None):
                    yield
            finally:
                for module, attr, old in saved:
                    module._parameters[attr] = old

    @property
    def spec(self):
        return self._spec

    @property
    def device(self):
        return self._device

    @property
    def site(self):
        """The retrace site this Predictor's builds count at."""
        return self._site

    @property
    def int8(self):
        """True when weights are stored as int8 with a per-tensor range."""
        return self._int8

    @property
    def input_templates(self):
        """[(trailing_shape, dtype)] per input (None before settle)."""
        return self._templates

    @property
    def warmed(self):
        """True once every bucket of the spec is built."""
        return self._templates is not None and all(
            self._bucket_key(b, s) in self._buckets
            for b, s in self._spec.buckets())

    def param_bytes(self):
        """Bytes of this Predictor's parameter snapshot (int8 storage and
        ranges under ``int8``). The device also holds the buckets' inputs,
        outputs and intermediates (on CUDA, the graphs' memory pool)."""
        return sum(t.numel() * t.element_size() for t in self._stored) + \
            sum(4 for r in self._ranges if r is not None)

    def refresh_params(self, version=None):
        """Copy the block's current parameters into the snapshot in place
        (re-quantizing under int8) without building a bucket again;
        ``version`` stamps ``param_version``."""
        with self._lock:
            self._snapshot_params()
        if version is not None:
            self.param_version = version
        telemetry.inc("serving.param_refreshes", tag=self._site)

    # ------------------------------------------------------------- building
    def _bucket_trailing(self, trailing, seq):
        ax = self._spec.seq_axis - 1   # the trailing shape has no batch axis
        if seq is None or ax >= len(trailing):
            return trailing
        return trailing[:ax] + (seq,) + trailing[ax + 1:]

    def _bucket_key(self, b, s):
        return tuple(((b,) + self._bucket_trailing(t, s), dt)
                     for t, dt in self._templates)

    def param_args(self):
        """The snapshot every bucket reads, ``(stored, ranges)``: each
        parameter's storage on the device (int8 under ``int8``) and its
        int8 range (None where exact). A refresh writes them in place."""
        return self._stored, self._ranges

    def _fn_token(self):
        """The stable identity of what this Predictor runs: the block's
        class and source with the snapshot's names, shapes and dtypes."""
        tok = self._fn_tok
        if tok is None:
            struct = tuple((k, tuple(t.shape), str(t.dtype), str(q))
                           for k, t, q in zip(self._keys, self._stored,
                                              self._qdtypes))
            tok = self._fn_tok = "predictor:%s:%s:%s" % (
                type(self._block).__name__,
                compile_service.source_token(type(self._block)),
                compile_service.source_token(struct)[:12])
        return tok

    def _service_key(self, shape_key, pol):
        return compile_service.canonical_key(
            site=self._site, fn_id=self._fn_token(),
            signature=(shape_key, self._int8), policy=pol,
            device=compile_service.device_token(self._device),
            nonce=self._nonce)

    def _group_token(self, shape_key, pol):
        """Everything in the key but site, device and nonce: what a
        ReplicaSet's identical members share."""
        return ("predict", self._fn_token(), shape_key, self._int8, pol)

    def _prov(self, shape_key):
        return {"predictor": self._name, "block": type(self._block).__name__,
                "device": str(self._device), "int8": self._int8,
                "shapes": [list(s) for s, _ in shape_key]}

    def _build_for(self, shape_key):
        """The build of one bucket: its static inputs, captured on CUDA
        (``graphs.EagerGraph`` on the CPU), at the Predictor's ledger
        site."""
        def build():
            statics = [torch.full(shape, self._spec.pad_value, dtype=dt,
                                  device=self._device)
                       for shape, dt in shape_key]
            with graphs.ledger_site(self._site, self._prov(shape_key)):
                if self._device.type == "cuda":
                    if self._pool is None:
                        self._pool = torch.cuda.graph_pool_handle()
                    return CapturedGraph(self._forward, statics,
                                         pool=self._pool)
                me = weakref.ref(self)   # the store must not keep self

                def run(*datas):
                    # the functional call swaps this Predictor's snapshot
                    # into the shared block: one forward at a time
                    with CAPTURE_LOCK:
                        return me()._forward(*datas)
                return graphs.EagerGraph(run, statics)
        return build

    def _bucket(self, key):
        """The bucket of ``key``, built (captured on CUDA) at first use."""
        pol = compile_service.forward_policy()
        return compile_service.get_or_build(
            self._service_key(key, pol), self._build_for(key),
            provenance=lambda: self._prov(key),
            group=self._group_token(key, pol)).fn

    def warmup_entries(self):
        """One ``compile_service.WarmupEntry`` per bucket, largest first
        (the buckets share one memory pool, which the largest sizes)."""
        if self._templates is None:
            raise MXNetError("Predictor.warmup needs input templates: pass "
                             "example= at construction")
        pol = compile_service.forward_policy()
        entries = []
        for b, s in sorted(self._spec.buckets(),
                           key=lambda bs: (-bs[0], -(bs[1] or 0))):
            key = self._bucket_key(b, s)
            entries.append(compile_service.WarmupEntry(
                key=self._service_key(key, pol), build=self._build_for(key),
                example_args=None, provenance=self._prov(key),
                group=self._group_token(key, pol)))
        return entries

    def _largest_key(self):
        b, s = max(self._spec.buckets(), key=lambda bs: (bs[0], bs[1] or 0))
        return self._service_key(self._bucket_key(b, s),
                                 compile_service.forward_policy())

    def preflight(self):
        """The memory pre-flight before the buckets build: the site's last
        recorded footprint, else the one the largest bucket's blob holds,
        else the snapshot and static inputs, plus the co-residents'
        bytes, against the device's limit."""
        if self._templates is None:
            raise MXNetError("Predictor.warmup needs input templates: pass "
                             "example= at construction")
        disk = compile_service.peek(self._largest_key()) or {}
        return xprof.preflight(
            self._site, self._device,
            extra_bytes=int(self._co_resident()) if self._co_resident else 0,
            need=xprof.site_footprint(self._site)
            or disk.get("footprint") or self._static_bytes())

    def warmup(self):
        """Build every bucket through the compile service, largest first
        (on CUDA each capture runs its bucket once eagerly first, then
        records it), after the memory pre-flight; returns self. Buckets
        already built are kept."""
        self.preflight()
        with self._lock:
            compile_service.warmup(self.warmup_entries())
        return self.finish_warmup()

    def finish_warmup(self):
        """Run each bucket once on its padding (a model that builds but
        cannot run fails here, not on the first request), gauge the bucket
        count and record the bytes held at the site; returns self."""
        out_bytes = sum(self.run_bucket(b, s) for b, s in
                        self._spec.buckets())
        telemetry.gauge("serving.buckets", len(self._spec))
        if self._device.type == "cuda":
            # the outputs live in the pool
            out_bytes = pool_bytes(self._pool, self._device)
        footprint = self._static_bytes() + out_bytes
        xprof.record_footprint(self._site, footprint)
        if compile_service.cache_dir():
            compile_service.annotate(self._largest_key(), footprint=footprint)
        return self

    def run_bucket(self, b, s=None):
        """Run bucket (``b``, ``s``) once on its padding and wait for it
        (the warm-up check and a replica's half-open probe); returns the
        bytes of its outputs."""
        with self._lock:
            entry = self._bucket(self._bucket_key(b, s))
            for static in entry.static_inputs:
                static.fill_(self._spec.pad_value)
            resilience.maybe_oom()
            outs = entry.replay()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return sum(o.numel() * o.element_size() for o in outs)

    def _static_bytes(self):
        """The snapshot's bytes and every bucket's static inputs'."""
        inputs = 0
        for b, s in self._spec.buckets():
            for shape, dt in self._bucket_key(b, s):
                inputs += int(np.prod(shape)) * \
                    torch.empty((), dtype=dt).element_size()
        return self.param_bytes() + inputs

    def release(self):
        """Drop the captured graphs, their memory pool and the parameter
        snapshot, giving the device memory back (a zoo eviction). A later
        request settles and builds again."""
        with self._lock:
            compile_service.drop(nonce=self._nonce)
            self._pool = None
            self._stored = self._ranges = self._templates = None
            self._deq = {}
            self._fn_tok = None

    def compile_stats(self):
        """The retrace watchdog's view of this Predictor's site:
        {compiles, trips, last} (None before any build)."""
        return telemetry.retrace_stats(self._site)

    # ----------------------------------------------------------- predicting
    def _dispatch_one(self, datas, seq, bucket):
        """Pad ``datas`` into the bucket's static inputs, run it, and return
        the outputs sliced to the request's batch (copies on CUDA)."""
        n = int(datas[0].shape[0])
        key = tuple(((bucket,) + self._bucket_trailing(tuple(d.shape[1:]),
                                                       seq), dt)
                    for d, (_, dt) in zip(datas, self._templates))
        with self._lock:
            entry = self._bucket(key)
            for static, d in zip(entry.static_inputs, datas):
                if tuple(d.shape) == tuple(static.shape):
                    static.copy_(d)
                else:
                    static.fill_(self._spec.pad_value)
                    static[tuple(slice(0, k) for k in d.shape)].copy_(d)
            try:
                resilience.maybe_oom()
                outs = entry.replay()
            except Exception as e:
                if xprof.is_oom(e):   # the artifact first, then loud
                    ctx = telemetry.current_trace()
                    xprof.oom_flight(self._site, e,
                                     trace_ids=[ctx.trace_id] if ctx
                                     else [])
                raise
            if self._device.type == "cuda":
                outs = [o[:n].clone() for o in outs]
            elif n != bucket:
                outs = [o[:n] for o in outs]
        telemetry.observe("serving.batch_fill", n / float(bucket))
        return outs

    def predict_flat(self, args):
        """Pad ``args`` (per-input arrays sharing batch axis 0) to their
        bucket, run it, and slice back: ``(flat_outputs, out_fmt,
        bucket_batch)`` with the outputs NDArrays on the device, sliced to
        the request's batch. A request past the largest batch bucket is
        chunked through it and concatenated on the device. No host sync
        happens here: fetching the outputs is the caller's."""
        if self._templates is None:
            self._settle(args)
        datas = [_request_tensor(a) for a in args]
        if len(datas) != len(self._templates):
            raise MXNetError("predict: the model takes %d input(s), got %d"
                             % (len(self._templates), len(datas)))
        n = int(datas[0].shape[0])
        if n == 0:
            raise MXNetError("predict on an empty batch")
        spec = self._spec
        seq = None
        if spec.seq_lens is not None:
            seq = spec.seq_bucket(int(datas[0].shape[spec.seq_axis])
                                  if datas[0].ndim > spec.seq_axis else 0)
        with telemetry.span("serving.predict", d2h=True):
            b = spec.batch_bucket(n)
            if b is None:
                b = spec.max_batch   # the tail pads to it too
                chunks = [self._dispatch_one([d[lo:lo + b] for d in datas],
                                             seq, b)
                          for lo in range(0, n, b)]
                outs = [torch.cat([c[i] for c in chunks])
                        for i in range(len(chunks[0]))]
            else:
                outs = self._dispatch_one(datas, seq, b)
            telemetry.inc("serving.items", n)
        return [NDArray(o) for o in outs], list(self._out_fmt), b

    def predict(self, *args):
        """The user-facing call: NDArrays, tensors or numpy arrays in, the
        block's output structure (one NDArray or a tuple) for the
        request's batch out, on the device."""
        from ..gluon.block import _regroup
        flat, fmt, _ = self.predict_flat(args)
        out, _, _ = _regroup(flat, fmt)
        return out

    # ----------------------------------------------------------- load paths
    @classmethod
    def from_checkpoint(cls, prefix, epoch, spec, input_names=("data",),
                        example=None, warmup=False, name=None, device=None,
                        dtype=None, **kwargs):
        """Serve a (``prefix-symbol.json``, ``prefix-%04d.params``)
        checkpoint (``model.save_checkpoint`` / ``HybridBlock.export``
        naming, either package's) as a SymbolBlock: the c_predict_api
        shape. The block's parameters are staged on the host and cast to
        ``dtype`` where given (BatchNorm's stay float32 under bfloat16, as
        the Gluon layer's); the Predictor snapshots them on ``device``
        (default: the CUDA device, or raise)."""
        from .. import symbol as sym_mod
        from ..context import cpu
        from ..gluon.block import SymbolBlock
        from ..model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        if sym is None:
            raise MXNetError("no symbol file at %s-symbol.json" % prefix)
        if isinstance(input_names, str):
            input_names = [input_names]
        blk = SymbolBlock(sym, [sym_mod.var(n) for n in input_names])
        pd = blk.collect_params()
        pd.reset_ctx(cpu())
        for pname, arr in list(arg_params.items()) + list(aux_params.items()):
            if pname in pd:
                pd[pname].set_data(arr)
        if dtype is not None:
            blk.cast(dtype)
        return cls(blk, spec, example=example, warmup=warmup,
                   name=name or ("ckpt:" + str(prefix)), device=device,
                   **kwargs)

    @classmethod
    def from_trainer_checkpoint(cls, block, directory, spec, step=None,
                                example=None, warmup=False, name=None,
                                device=None, **kwargs):
        """Serve a training run's checkpoint: only the parameters of a
        ``contrib.async_checkpoint.save_trainer`` step (the newest when
        ``step`` is None) are restored into ``block`` (the optimizer
        state and the generators stay on disk), then the Predictor is
        built as ``__init__`` builds it. The block must enumerate the
        trainer's parameters in its order (positional keys); a block
        whose shapes are deferred is settled by one forward on
        ``example`` first."""
        from ..contrib import async_checkpoint as ackpt
        if example is not None and any(
                not p.initialized for p in block.collect_params().values()):
            xs = example if isinstance(example, (tuple, list)) \
                else (example,)
            with torch.no_grad():
                block(*[x._data if hasattr(x, "_data") else torch.as_tensor(
                    np.asarray(x)) for x in xs])
        ackpt.load_trainer_params_into_block(block, directory, step=step)
        return cls(block, spec, example=example, warmup=warmup,
                   name=name or ("trainer:" + str(directory)), device=device,
                   **kwargs)
