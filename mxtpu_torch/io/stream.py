"""Streaming input pipeline with prefetch to the card (counterpart of
``mxtpu/io/stream.py``).

* :func:`shard_keys` -- a deterministic, seedable, epoch-reshuffled,
  remainder-balanced partition of a RecordIO index across replicas (no
  record dropped or duplicated, shard sizes differ by at most one).
* :class:`ShardedRecordReader` -- streams decoded and batchified batches
  from one shard of an ``MXIndexedRecordIO`` file on a small thread pool
  (``num_threads``, 2 by default; 0 decodes inline on the consumer's
  thread). The threads share one file handle through positioned reads
  (``MXIndexedRecordIO.pread_idx``). A worker that dies is restarted
  under the ``max_restarts`` budget (3) with its batch re-enqueued; the
  ``worker_death`` fault point (``resilience.set_faults``) drives it.
* :class:`DevicePrefetcher` -- the prefetch to the card: a producer thread
  pulls host batches, stages each numpy leaf in a ring of ``depth + 1``
  pinned host buffers and copies it to the device on a side CUDA stream
  (``non_blocking``), recording an event; the consumer's stream waits on
  that event before the batch is handed over, and each device tensor is
  marked with ``record_stream`` for the consumer's stream. A pinned buffer
  is written again only after the event of the copy that read it has
  completed. At most ``depth`` (2) batches wait ahead of the consumer.
  The ``prefetch_death`` fault point kills the producer silently; it is
  restarted under ``max_restarts`` on the same source.
* :class:`StreamRecordIter` -- the two composed behind the ``DataIter``
  surface.

Telemetry (``mxtpu_torch.telemetry``): the ``data.prefetch_depth`` gauge,
the ``data.h2d`` span (the producer's staging and enqueue of one batch's
copy), the ``data.wait`` span (the consumer blocked on an empty buffer),
the ``data.starved`` counter (such waits) and the ``data.prefetch_restarts``
and ``stream.worker_restarts`` counters. Each transfer and each wait is a
trace root; the consumer's ``__next__`` pends both
(``telemetry.pend_link``), and the next ``trainer.step`` on its thread
links them into its trace.

The JAX package reads ``MXTPU_PREFETCH_DEPTH``, ``MXTPU_STREAM_THREADS``
and ``MXTPU_DL_WORKER_RESTARTS``; the port takes them as constructor
arguments with the same defaults. ``sharding=`` names one device (a
``torch.device``, a ``Context`` or a string; the current context by
default), or a mesh ``parallel.Sharding`` (a mesh Trainer's
``batch_sharding``): then each leaf's rows of this rank go to its device.
"""
from __future__ import annotations

import collections
import os
import threading

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError, canonical_dtype, numpy_dtype, torch_dtype
from ..context import Context, _scopes, resolve_device
from .io import DataBatch, DataDesc, DataIter

__all__ = ["shard_keys", "ShardedRecordReader", "DevicePrefetcher",
           "StreamRecordIter"]

PREFETCH_DEPTH = 2     # MXTPU_PREFETCH_DEPTH's default
STREAM_THREADS = 2     # MXTPU_STREAM_THREADS's default
WORKER_RESTARTS = 3    # MXTPU_DL_WORKER_RESTARTS's default


def _depth(depth):
    # at least 1: a depth of 0 would keep the producer waiting forever
    return max(1, int(PREFETCH_DEPTH if depth is None else depth))


def _threads(num_threads):
    return max(0, int(STREAM_THREADS if num_threads is None
                      else num_threads))


# ------------------------------------------------------------ index sharding
def shard_keys(keys, num_shards=1, shard_index=0, epoch=0, seed=0,
               shuffle=True):
    """Deterministic per-replica slice of a record index.

    The permutation is a pure function of ``(seed, epoch)``: every replica
    computes the same epoch order and takes its own contiguous slice, so
    shards are disjoint and their union is exactly ``keys``. When
    ``num_shards`` does not divide ``len(keys)`` the first
    ``len(keys) % num_shards`` shards carry one extra record. A new
    ``epoch`` reshuffles; ``shuffle=False`` keeps index order.
    """
    n = len(keys)
    if num_shards < 1:
        raise MXNetError("num_shards must be >= 1, got %d" % num_shards)
    if not 0 <= shard_index < num_shards:
        raise MXNetError("shard_index %d outside [0, %d)"
                         % (shard_index, num_shards))
    if shuffle:
        # a seed sequence: distinct (seed, epoch) pairs never collide
        order = np.random.RandomState([int(seed), int(epoch)]).permutation(n)
    else:
        order = np.arange(n)
    base, rem = divmod(n, num_shards)
    lo = shard_index * base + min(shard_index, rem)
    hi = lo + base + (1 if shard_index < rem else 0)
    return [keys[i] for i in order[lo:hi]]


def _default_batchify(samples):
    """Numpy-only stacking: arrays stack along a new batch dim, tuples
    transpose and recurse, anything else stays a list (raw record bytes)."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_default_batchify(list(col)) for col in zip(*samples))
    if isinstance(first, (np.ndarray, np.generic, float, int)):
        return np.asarray(samples)
    return list(samples)


class _WorkerDied(Exception):
    """Internal marker of the injected silent death (a thread cannot be
    killed: it exits without publishing, as an OOM-killed process worker
    looks to the consumer)."""


class ShardedRecordReader:
    """Streaming batches from one deterministic shard of an indexed
    RecordIO file (ref: ``mxtpu/io/stream.py:ShardedRecordReader``).

    Each ``__iter__`` pass is one epoch: the shard's keys for the current
    epoch (:func:`shard_keys`) split into ``batch_size`` groups, read with
    positioned reads off one shared handle, decoded and batchified on the
    thread pool and delivered in order, so two runs with one seed give
    identical batch streams. The epoch advances when an epoch's iterator
    is exhausted (a mid-epoch abandon replays the same order).

    ``last_batch``: ``'keep'`` emits the short tail batch, ``'discard'``
    drops it. ``num_threads`` 0 decodes inline on the consumer's thread;
    ``max_restarts`` bounds the worker restarts of one epoch.
    """

    def __init__(self, rec_path, idx_path=None, batch_size=1, decode_fn=None,
                 batchify_fn=None, num_shards=1, shard_index=0, seed=0,
                 shuffle=True, num_threads=None, last_batch="keep",
                 max_restarts=WORKER_RESTARTS):
        from ..recordio import MXIndexedRecordIO
        if idx_path is None:
            root = rec_path[:rec_path.rfind(".")] if "." in \
                os.path.basename(rec_path) else rec_path
            idx_path = root + ".idx"
        if last_batch not in ("keep", "discard"):
            raise MXNetError("last_batch must be 'keep' or 'discard', got %r"
                             % (last_batch,))
        self._record = MXIndexedRecordIO(idx_path, rec_path, "r")
        if not self._record.keys:
            raise MXNetError("empty or missing index: %s" % idx_path)
        self.batch_size = int(batch_size)
        self.decode_fn = decode_fn
        self.batchify_fn = batchify_fn or _default_batchify
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed
        self.shuffle = shuffle
        self.last_batch = last_batch
        self.num_threads = _threads(num_threads)
        self.max_restarts = int(max_restarts)
        self._epoch = 0
        self._closed = False

    @property
    def epoch(self):
        return self._epoch

    def set_epoch(self, epoch):
        """Pin the epoch (a resumed loop replays the identical order)."""
        self._epoch = int(epoch)

    def shard_len(self, epoch=None):
        e = self._epoch if epoch is None else epoch
        return len(shard_keys(self._record.keys, self.num_shards,
                              self.shard_index, e, self.seed, self.shuffle))

    def __len__(self):
        n = self.shard_len()
        if self.last_batch == "discard":
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self):
        keys = shard_keys(self._record.keys, self.num_shards,
                          self.shard_index, self._epoch, self.seed,
                          self.shuffle)
        batches = [keys[i:i + self.batch_size]
                   for i in range(0, len(keys), self.batch_size)]
        if batches and self.last_batch == "discard" and \
                len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _load(self, key_batch):
        samples = []
        for k in key_batch:
            raw = self._record.pread_idx(k)
            samples.append(self.decode_fn(raw) if self.decode_fn else raw)
        return self.batchify_fn(samples)

    def __iter__(self):
        if self._closed:
            raise MXNetError("ShardedRecordReader is closed")
        batches = self._epoch_batches()
        if not batches:
            self._epoch += 1
            return
        if self.num_threads == 0:
            for kb in batches:
                yield self._load(kb)
            self._epoch += 1
            return
        yield from self._iter_pool(batches)

    def _iter_pool(self, batches):
        """Thread pool with ordered delivery and worker-death recovery.

        A death is detected (a worker gone without publishing), not
        announced: the consumer's bounded wait rechecks the pool, restarts
        dead workers under the budget and re-enqueues their batches.
        Decode exceptions are not deaths: they travel back as results and
        raise at the consumer with the batch index."""
        from ..resilience import inject
        lock = threading.Lock()
        ready = threading.Condition(lock)
        results = {}
        pending = collections.deque(range(len(batches)))
        # in-flight work keyed by a unique per-worker token (thread idents
        # are reused as soon as a thread exits)
        taken = {}
        workers = {}
        stop = threading.Event()
        state = {"next": 0, "restarts": 0, "token": 0}
        bound = max(2 * self.num_threads, 2)
        max_restarts = self.max_restarts

        def worker(token):
            while not stop.is_set():
                with ready:
                    while not pending and not stop.is_set():
                        ready.wait(0.1)
                    if stop.is_set():
                        return
                    i = pending.popleft()
                    # bounded read-ahead, measured from the consumer, so
                    # the batch the consumer needs next never waits
                    while i > state["next"] + bound and not stop.is_set():
                        ready.wait(0.1)
                    if stop.is_set():
                        return
                    taken[token] = i
                try:
                    if inject("worker_death", i):
                        raise _WorkerDied()
                    out = self._load(batches[i])
                except _WorkerDied:
                    with ready:
                        ready.notify_all()
                    return
                except Exception as e:  # noqa: BLE001 - delivered, not lost
                    out = e
                with ready:
                    taken.pop(token, None)
                    results[i] = out
                    ready.notify_all()

        def spawn(n):
            for _ in range(n):
                token = state["token"]
                state["token"] += 1
                t = threading.Thread(target=worker, args=(token,),
                                     daemon=True, name="mxtpu-stream-reader")
                workers[token] = t
                t.start()

        spawn(self.num_threads)
        try:
            for i in range(len(batches)):
                with ready:
                    while i not in results:
                        dead = [tok for tok, t in workers.items()
                                if not t.is_alive()]
                        if dead:
                            # one restart event per detection sweep
                            state["restarts"] += 1
                            telemetry.inc("stream.worker_restarts")
                            if state["restarts"] > max_restarts:
                                raise RuntimeError(
                                    "stream reader worker(s) died while "
                                    "waiting for batch %d/%d; giving up "
                                    "after %d restart(s) (max_restarts=%d)"
                                    % (i, len(batches),
                                       state["restarts"] - 1, max_restarts))
                            for tok in dead:
                                workers.pop(tok)
                                ix = taken.pop(tok, None)
                                if ix is not None and ix not in results:
                                    pending.appendleft(ix)
                            spawn(self.num_threads - len(workers))
                            ready.notify_all()
                            continue
                        ready.wait(0.1)
                    out = results.pop(i)
                    state["next"] = i + 1
                    ready.notify_all()
                if isinstance(out, Exception):
                    raise RuntimeError(
                        "stream reader failed at batch %d" % i) from out
                yield out
            self._epoch += 1
        finally:
            stop.set()
            with ready:
                ready.notify_all()
            for t in workers.values():
                t.join(timeout=5.0)

    def close(self):
        if not self._closed:
            self._closed = True
            self._record.close()

    def __del__(self):  # pragma: no cover - interpreter-exit timing
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


# -------------------------------------------------------- prefetch-to-device
def _target(spec):
    """``sharding=``/``prefetch_to_device=`` -> (torch.device, the mesh
    ``Sharding`` whose rows each rank takes, or None): None or True the
    current context (``cuda:0`` outside a scope, raising without a card);
    a device, Context or string that device; a ``parallel.Sharding`` its
    device and this rank's block of each leaf; a Trainer its
    ``batch_sharding`` (None without a mesh). Anything else raises."""
    from ..parallel.mesh import Sharding
    if spec is None or spec is True:
        return resolve_device(None), None
    if isinstance(spec, (Context, torch.device, str)):
        return resolve_device(spec), None
    if isinstance(spec, Sharding):
        return resolve_device(spec.device), spec
    if hasattr(type(spec), "batch_sharding"):
        return _target(spec.batch_sharding)
    raise MXNetError(
        "prefetch target %r is neither a device nor a parallel.Sharding of "
        "this package's mesh (ROADMAP A8's port places each rank's rows); "
        "pass one device, Context or Sharding" % (spec,))


def _host_array(x):
    """A leaf as a C-contiguous numpy array in the dtype ``array`` would
    give it (float64 -> float32, int64 -> int32, as with JAX's x64 off)."""
    host = np.asarray(x)
    dt = numpy_dtype(canonical_dtype(host.dtype))
    if host.dtype != dt:
        host = host.astype(dt)
    return np.ascontiguousarray(host)


class _Slot:
    """One ring entry: a pinned byte buffer per leaf position and the
    event of the last copy that read them."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs = []
        self.event = None


class DevicePrefetcher:
    """Double-buffered prefetch to the device over any batch iterator (ref:
    ``mxtpu/io/stream.py:DevicePrefetcher``).

    A producer thread pulls host batches and copies their leaves to the
    device (``sharding``: one device, the current context by default; a
    mesh ``Sharding`` or a mesh Trainer: this rank's rows of each leaf,
    on its device).
    On a CUDA device each numpy leaf is written into a pinned buffer of a
    ring of ``depth + 1`` slots and copied on a side stream with
    ``non_blocking=True``; an event recorded after the batch's copies is
    what the consumer's current stream waits on in ``__next__``, and what
    the producer waits on before it writes that slot again. The device
    tensors are allocated on the side stream and handed to the consumer's
    stream with ``record_stream``. A caller that copies a batch into the
    static inputs of a captured graph does so after ``__next__`` returned,
    on its current stream, which then already waits for the copy. On the
    CPU (a CPU device passed, or a ``with mt.cpu():`` scope) a leaf is
    copied into a CPU tensor.

    Leaves: numpy arrays and scalars (copied), NDArrays and tensors (moved
    only when on another device), ``DataBatch``/list/tuple/dict containers
    (mapped), anything else passes through. At most ``depth`` batches are
    buffered. The producer thread runs in the constructing thread's
    ``with ctx:`` scope.

    Failure discipline: a source or transfer exception is delivered at the
    consumer; the injected silent producer death (``prefetch_death``) is
    detected by the consumer's bounded wait and the producer restarts
    under ``max_restarts`` on the same source (nothing skipped: the death
    comes between batches). ``close()`` is bounded: it drains the buffer,
    joins with a timeout and closes a generator source so its cleanup
    runs. There is no fallback to host batches: without a card the
    constructor raises unless a CPU device is given.

    ``to_device=False`` makes this a host double buffer (no copy, no
    ``<site>.h2d`` span), as the sub-stages of a multi-iterator
    ``PrefetchingIter`` use it.

    ``pinned_bytes`` is the ring's pinned host memory.
    """

    def __init__(self, source, depth=PREFETCH_DEPTH, sharding=None,
                 site="data", to_device=True, max_restarts=WORKER_RESTARTS):
        self._depth = _depth(depth)
        self._put = bool(to_device)
        self._device, self._rows = _target(sharding) if self._put \
            else (None, None)
        self._stream = None
        self._ring = []
        self._slot = 0
        if self._device is not None and self._device.type == "cuda":
            if not torch.cuda.is_available():
                raise MXNetError("DevicePrefetcher: no CUDA device for %s; "
                                 "pass a CPU device to prefetch on the host"
                                 % self._device)
            self._stream = torch.cuda.Stream(self._device)
            self._ring = [_Slot() for _ in range(self._depth + 1)]
        self._source = iter(source)
        self._site = site
        self._scope = _scopes()[-1] if _scopes() else None
        self._max_restarts = int(max_restarts)
        self._buf = collections.deque()
        self._cv = threading.Condition()
        self._finished = False   # producer published end-of-stream
        self._stopped = False    # consumer asked for shutdown
        self._error = None
        self._restarts = 0
        self._thread = None
        self.pinned_bytes = 0
        telemetry.gauge("%s.prefetch_depth" % site, self._depth)
        self._start()

    def _start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-prefetch")
        self._thread.start()

    # producer ------------------------------------------------------------
    def _run(self):
        if self._scope is None:
            self._produce()
            return
        with self._scope:
            self._produce()

    def _produce(self):
        from ..resilience import inject
        try:
            while True:
                with self._cv:
                    while len(self._buf) >= self._depth and \
                            not self._stopped:
                        self._cv.wait(0.1)
                    if self._stopped:
                        return
                # its own fault kind: the reader pool and the loader check
                # worker_death at batch indices, and this counter-indexed
                # point must not race them in composed pipelines
                if inject("prefetch_death"):
                    return  # silent: the consumer detects it
                try:
                    batch = next(self._source)
                except StopIteration:
                    break
                ctx = None
                if self._put:
                    with telemetry.span("%s.h2d" % self._site,
                                        new_trace=True) as sp:
                        item = self._transfer(batch)
                    ctx = sp.ctx
                else:
                    item = (batch, None, ())
                item = item + (ctx,)
                with self._cv:
                    if self._stopped:
                        return
                    self._buf.append(item)
                    self._cv.notify_all()
            with self._cv:
                self._finished = True
                self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 - delivered to consumer
            with self._cv:
                self._error = e
                self._finished = True
                self._cv.notify_all()

    def _transfer(self, batch):
        """(mapped batch, event or None, device tensors to hand over)."""
        from ..ndarray import NDArray
        dev = self._device
        tensors = []
        if self._rows is not None:    # this rank's rows of every leaf
            rows = self._rows

            def mine(x):
                if isinstance(x, NDArray):
                    return NDArray(rows.shard(x._data))
                if isinstance(x, (np.ndarray, torch.Tensor)):
                    return rows.shard(x)
                return x
            batch = self._map(batch, mine)

        def moved(x):
            """An NDArray or tensor on ``dev`` (the same object when it is
            there already), of the type it came as."""
            t = x._data if isinstance(x, NDArray) else x
            if t.device == dev:
                return x
            t = t.to(dev, non_blocking=t.device.type == "cpu"
                     and t.is_pinned())
            tensors.append(t)
            return NDArray(t) if isinstance(x, NDArray) else t

        if self._stream is None:
            def leaf(x):
                if isinstance(x, (np.ndarray, np.generic)):
                    return NDArray(torch.tensor(_host_array(x)))
                return moved(x)
            return self._map(batch, leaf), None, ()
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        if slot.event is not None:
            # the copy that last read this slot's pinned buffers must have
            # finished before the host writes them again
            slot.event.synchronize()
        pos = [0]

        def stage(host, dtype):
            """``host`` written into this slot's next pinned buffer,
            returned as a tensor over that buffer."""
            i = pos[0]
            pos[0] += 1
            if i == len(slot.bufs):
                slot.bufs.append(None)
            buf = slot.bufs[i]
            if buf is None or buf.numel() < host.nbytes:
                old = 0 if buf is None else buf.numel()
                buf = torch.empty(host.nbytes, dtype=torch.uint8,
                                  pin_memory=True)
                self.pinned_bytes += buf.numel() - old
                slot.bufs[i] = buf
            pinned = buf[:host.nbytes].view(dtype).view(host.shape)
            pinned.numpy()[...] = host
            return pinned

        def leaf(x):
            if isinstance(x, (np.ndarray, np.generic)):
                host = _host_array(x)
                dtype = torch_dtype(host.dtype)
                out = torch.empty(host.shape, dtype=dtype, device=dev)
                if host.nbytes:
                    out.copy_(stage(host, dtype), non_blocking=True)
                tensors.append(out)
                return NDArray(out)
            return moved(x)

        with torch.cuda.stream(self._stream):
            mapped = self._map(batch, leaf)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        slot.event = ev
        return mapped, ev, tensors

    @staticmethod
    def _map(obj, leaf):
        from ..ndarray import NDArray

        def rec(x):
            if isinstance(x, DataBatch):
                out = DataBatch.__new__(DataBatch)
                out.__dict__.update(x.__dict__)
                out.data = rec(x.data)
                out.label = rec(x.label)
                return out
            if isinstance(x, (list, tuple)):
                mapped = [rec(v) for v in x]
                return tuple(mapped) if isinstance(x, tuple) else mapped
            if isinstance(x, dict):
                return {k: rec(v) for k, v in x.items()}
            if isinstance(x, (np.ndarray, np.generic, NDArray,
                              torch.Tensor)):
                return leaf(x)
            return x

        return rec(obj)

    # consumer ------------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            if not self._buf and not self._finished and not self._stopped:
                telemetry.inc("%s.starved" % self._site)
            with telemetry.span("%s.wait" % self._site,
                                new_trace=True) as wait_sp:
                while not self._buf and not self._finished and \
                        not self._stopped:
                    if not self._thread.is_alive():
                        # silent producer death (injected prefetch_death):
                        # restart on the same source under the budget
                        self._restarts += 1
                        telemetry.inc("%s.prefetch_restarts" % self._site)
                        if self._restarts > self._max_restarts:
                            raise RuntimeError(
                                "prefetch worker died; giving up after %d "
                                "restart(s) (max_restarts=%d)"
                                % (self._restarts - 1, self._max_restarts))
                        self._start()
                    self._cv.wait(0.1)
            if not self._buf:
                # a concurrent close() ends the stream cleanly
                if self._stopped:
                    raise StopIteration
                # buffered batches first, then a trailing error
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                raise StopIteration
            item, ev, tensors, h2d_ctx = self._buf.popleft()
            self._cv.notify_all()
        # the hand-over: the next trainer.step on this thread links the
        # batch's transfer and wait into its trace (link_pending)
        telemetry.pend_link("%s.h2d" % self._site, h2d_ctx)
        telemetry.pend_link("%s.wait" % self._site, wait_sp.ctx)
        if ev is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ev)
            for t in tensors:
                t.record_stream(cur)
        return item

    def next(self):
        return self.__next__()

    def close(self, timeout=5.0, reraise=False):
        """Bounded shutdown: wake a blocked producer, join with
        ``timeout``, close a generator source so its cleanup runs. With
        ``reraise=True`` a pending producer error raises here, and a join
        that times out raises (the source is still in use); otherwise it
        warns."""
        with self._cv:
            self._stopped = True
            self._buf.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                msg = ("prefetch worker did not exit within %.1fs: it is "
                       "still blocked inside the source iterator; the "
                       "source is not safe to reset or re-consume yet"
                       % timeout)
                if reraise:
                    raise RuntimeError(msg)
                import warnings
                warnings.warn(msg)
                return
        src_close = getattr(self._source, "close", None)
        if src_close is not None:
            try:
                src_close()
            except Exception:  # noqa: BLE001 - teardown must not mask
                pass
        if reraise and self._error is not None:
            err, self._error = self._error, None
            raise err

    def __del__(self):  # pragma: no cover - interpreter-exit timing
        try:
            self.close(timeout=0.5)
        except Exception:  # noqa: BLE001
            pass


# --------------------------------------------------------------- DataIter
class StreamRecordIter(DataIter):
    """``DataIter`` over the streaming pipeline: sharded positioned reads
    -> thread-pool decode/batchify -> double-buffered prefetch to the
    device (ref: ``mxtpu/io/stream.py:StreamRecordIter``).

    ``decode_fn(raw) -> sample`` should return a numpy array or a
    ``(data, label)`` tuple of numpy arrays; batches then arrive as
    ``DataBatch``\\ es of NDArrays on ``sharding`` (one device; the current
    context by default), the overlap the gluon
    ``DataLoader(prefetch_to_device=...)`` path gets too. ``num_threads``
    (2), ``depth`` (2) and ``max_restarts`` (3) are the reference's
    ``MXTPU_STREAM_THREADS``, ``MXTPU_PREFETCH_DEPTH`` and
    ``MXTPU_DL_WORKER_RESTARTS``.

    ``reset()`` closes the in-flight prefetcher (bounded join) and starts
    the next epoch — which reshuffles, per :func:`shard_keys`, only if
    the previous epoch was fully consumed BY THE CONSUMER: the
    prefetcher's read-ahead may exhaust the reader generator a few
    batches early (advancing its epoch producer-side), so reset()
    restores the reader epoch whenever this iterator never delivered the
    epoch's final batch — the replay contract is consumer-driven
    regardless of depth.

    ``prefetch_to_device=False`` disables the device stage entirely:
    batches arrive as HOST numpy (inline pull, no producer thread) —
    for host-side augmentation or keeping device memory free."""

    def __init__(self, rec_path, idx_path=None, batch_size=1, decode_fn=None,
                 batchify_fn=None, num_shards=1, shard_index=0, seed=0,
                 shuffle=True, num_threads=None, last_batch="keep",
                 prefetch_to_device=True, sharding=None,
                 depth=PREFETCH_DEPTH, data_name="data",
                 label_name="softmax_label", max_restarts=WORKER_RESTARTS):
        super().__init__(batch_size)
        if decode_fn is None and batchify_fn is None:
            # without either, batches are raw record BYTES — no
            # shape/dtype to form a DataBatch/DataDesc from; fail here
            # with the fix named instead of an AttributeError from the
            # producer thread at the first next()
            raise MXNetError(
                "StreamRecordIter needs a decode_fn(raw_bytes) -> numpy "
                "sample (or (data, label) tuple), or a batchify_fn that "
                "turns raw records into arrays — e.g. decode via "
                "recordio.unpack/unpack_img. For "
                "raw-bytes streaming use ShardedRecordReader directly.")
        self._reader = ShardedRecordReader(
            rec_path, idx_path, batch_size=batch_size, decode_fn=decode_fn,
            batchify_fn=batchify_fn, num_shards=num_shards,
            shard_index=shard_index, seed=seed, shuffle=shuffle,
            num_threads=num_threads, last_batch=last_batch,
            max_restarts=max_restarts)
        self._max_restarts = max_restarts
        self._prefetch = prefetch_to_device not in (None, False)
        self._sharding = sharding if self._prefetch else None
        self._depth = depth
        self._data_name = data_name
        self._label_name = label_name
        self._prefetcher = None
        self._pending = None
        self._descs = None
        self._start()

    def _start(self):
        self._pending = None
        self._exhausted = False
        self._delivered = 0
        self._epoch0 = self._reader.epoch
        self._len0 = len(self._reader)
        src = self._wrap(iter(self._reader))
        self._prefetcher = DevicePrefetcher(
            src, depth=self._depth, sharding=self._sharding,
            max_restarts=self._max_restarts) \
            if self._prefetch else src

    def _wrap(self, it):
        try:
            for batch in it:
                if isinstance(batch, tuple) and len(batch) == 2:
                    data, label = batch
                else:
                    data, label = batch, None
                n = data[0].shape[0] if isinstance(data, (list, tuple)) \
                    else data.shape[0]
                yield DataBatch(data=data, label=label,
                                pad=self.batch_size - n)
        finally:
            # a GeneratorExit here (prefetcher close) must reach the
            # reader generator's finally too, or its pool threads outlive
            # the epoch
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _fill(self):
        if self._pending is None:
            try:
                self._pending = next(self._prefetcher)
            except StopIteration:
                self._exhausted = True
                return False
            if self._descs is None:
                b = self._pending
                self._descs = (
                    [DataDesc("%s%s" % (self._data_name,
                                        "" if i == 0 else "_%d" % i),
                              d.shape, d.dtype)
                     for i, d in enumerate(b.data)],
                    [DataDesc("%s%s" % (self._label_name,
                                        "" if i == 0 else "_%d" % i),
                              l.shape, l.dtype)
                     for i, l in enumerate(b.label or [])])
        return True

    @property
    def provide_data(self):
        self._fill()
        return self._descs[0] if self._descs else None

    @property
    def provide_label(self):
        self._fill()
        return self._descs[1] if self._descs else None

    def iter_next(self):
        return self._fill()

    def next(self):
        if not self._fill():
            raise StopIteration
        batch, self._pending = self._pending, None
        self._delivered += 1
        return batch

    def _close_pipe(self, reraise=False):
        if isinstance(self._prefetcher, DevicePrefetcher):
            self._prefetcher.close(reraise=reraise)
        elif self._prefetcher is not None:
            self._prefetcher.close()  # host generator: runs _wrap's finally

    def reset(self):
        self._close_pipe(reraise=True)
        # full consumption is judged by DELIVERED batches, not by whether
        # an extra next() observed StopIteration: a step-counted loop
        # (`for _ in range(len(it)): it.next()`) consumed the whole epoch
        # and must progress the shuffle, while a genuine mid-epoch
        # abandon replays — and neither the prefetcher's read-ahead nor
        # the host generator's suspended epoch increment can be trusted
        # to have left the reader's counter right for either case
        if self._exhausted or self._delivered >= self._len0:
            if self._reader.epoch == self._epoch0:
                self._reader.set_epoch(self._epoch0 + 1)
        else:
            self._reader.set_epoch(self._epoch0)
        self._start()

    def close(self):
        self._close_pipe()
        self._reader.close()

    def __del__(self):  # pragma: no cover - interpreter-exit timing
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
