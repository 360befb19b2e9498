"""DataLoader (counterpart of ``mxtpu/gluon/data/dataloader.py``; ref:
python/mxnet/gluon/data/dataloader.py).

* ``num_workers>0`` runs worker PROCESSES, started with the spawn method;
  each runs dataset[i] and a numpy-only batchify and writes the batch into
  POSIX shared memory (`multiprocessing.shared_memory`), sending only
  (name, shape, dtype) descriptors through the result queue, as the
  reference's cpu_shared NDArray hand-off does. Workers are persistent per
  DataLoader (made on the first iteration, reused across epochs) and never
  create a CUDA context: they import only the package (see
  ``_mp_worker``) and work in numpy.
* the parent maps each segment, copies it off, unlinks it, and wraps it
  as an NDArray on the consumer's current context (``cuda:0`` outside a
  scope) -- or, with ``prefetch_to_device``, hands the numpy leaves to
  ``io.stream.DevicePrefetcher``, whose pinned copy on a side CUDA stream
  is the one host-to-device copy.
* ``thread_pool=True`` selects the thread-based pipeline instead (same
  surface, no spawn or pickling constraint on the dataset); its threads
  run in the iterating thread's ``with ctx:`` scope.
* ``worker_restarts`` (3) is the reference's ``MXTPU_DL_WORKER_RESTARTS``;
  ``pin_memory`` is accepted, as the reference's is: the prefetcher's
  staging is always pinned.
"""
from __future__ import annotations

import multiprocessing as _mp
import os
import queue as _queue
import threading
import time
import warnings

import numpy as np

from ...context import _scopes
from ...ndarray import NDArray, array
from . import _mp_worker
from ._mp_worker import default_mp_batchify_fn  # noqa: F401 (public re-export)
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def _prefetch_batchify_fn(data):
    """Stacking without the device placement: numpy samples stay numpy
    so the DevicePrefetcher's pinned copy to the target device is the one
    host-to-device copy; NDArray samples (already on a device) stack the
    normal way (the process pool rejects them, in the worker).
    `default_batchify_fn` is this plus the leaf wrap."""
    if isinstance(data[0], NDArray):
        from ...ndarray import stack
        return stack(*data)
    if isinstance(data[0], tuple):
        transposed = list(zip(*data))
        return [_prefetch_batchify_fn(list(x)) for x in transposed]
    return np.asarray(data)


def default_batchify_fn(data):
    """Stack samples into a batch (ref: dataloader.py:default_batchify_fn)."""
    def wrap(x):
        if isinstance(x, list):
            return [wrap(v) for v in x]
        return array(x) if isinstance(x, np.ndarray) else x
    return wrap(_prefetch_batchify_fn(data))


# worker-process internals (numpy only) live in _mp_worker.py: see that
# module's docstring for the shared-memory protocol


class DataLoader:
    """Iterate a Dataset in mini-batches (ref: dataloader.py:DataLoader)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, prefetch_to_device=None,
                 worker_restarts=3):
        self._dataset = dataset
        self._thread_pool = thread_pool
        self._pool = None  # lazy persistent spawn-worker pool
        # prefetch_to_device: None/False = batches wrapped on the current
        # context; True (the current context), a device or a Context = the
        # copy of batch N+1 overlaps the consumer's work on batch N
        # (io.stream.DevicePrefetcher, depth 2); `data.wait` then measures
        # only true starvation and `data.h2d` the copies' staging and enqueue
        self._prefetch_spec = prefetch_to_device \
            if prefetch_to_device not in (None, False) else None
        self._prefetcher = None   # the current epoch's DevicePrefetcher
        self._worker_restarts = int(worker_restarts)
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size is required when batch_sampler "
                                 "is not specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with a sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch must not be set "
                "when batch_sampler is specified")
        self._batch_sampler = batch_sampler
        self._user_batchify = batchify_fn is not None
        # with the device prefetcher on, default batchify keeps numpy
        # leaves in numpy: the one host-to-device copy is the prefetcher's
        # (default_batchify_fn would place batches on the current context
        # first, a wasted hop); NDArray-sample datasets still stack fine
        self._batchify_fn = batchify_fn or (
            _prefetch_batchify_fn if self._prefetch_spec is not None
            else default_batchify_fn)
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _load(self, batch_idx):
        return self._batchify_fn([self._dataset[i] for i in batch_idx])

    def __iter__(self):
        from ... import telemetry
        if self._prefetch_spec is not None:
            # the prefetcher owns the data.wait / data.starved / data.h2d
            # telemetry: data.wait then measures only true starvation
            from ...io.stream import DevicePrefetcher
            pf = self._prefetcher = DevicePrefetcher(
                self._iter_impl(), sharding=self._prefetch_spec,
                max_restarts=self._worker_restarts)
            try:
                yield from pf
            finally:
                pf.close()
            return
        it = self._iter_impl()
        while True:
            # how long the consumer blocked on the input pipeline before
            # each batch
            with telemetry.span("data.wait"):
                try:
                    batch = next(it)
                except StopIteration:
                    return
            yield batch

    def _iter_impl(self):
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._load(batch_idx)
            return
        if not self._thread_pool:
            yield from self._iter_multiprocess()
            return
        yield from self._iter_threads(_scopes()[-1] if _scopes() else None)

    # ------------------------------------------------- multiprocess workers
    def _ensure_pool(self):
        if self._pool is not None:
            return self._pool
        ctx = _mp.get_context("spawn")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        batchify = self._batchify_fn if self._user_batchify \
            else default_mp_batchify_fn
        workers = []
        try:
            for _ in range(self._num_workers):
                w = ctx.Process(target=_mp_worker.worker_loop,
                                args=(self._dataset, batchify, task_q,
                                      result_q), daemon=True)
                w.start()
                workers.append(w)
        except Exception as e:  # dataset/batchify not picklable for spawn
            for w in workers:  # don't orphan the ones that DID start
                w.terminate()
                w.join(timeout=5)
            warnings.warn("DataLoader cannot spawn workers (%s): falling "
                          "back to thread workers" % e)
            self._thread_pool = True
            return None
        self._pool = (task_q, result_q, workers)
        self._seq = 0  # monotone task ids: stale results from an aborted
        # epoch must never satisfy the next epoch's wait
        return self._pool

    def _teardown_pool(self, task_q, result_q, workers, join_timeout,
                       drain_timeout):
        """ONE copy of the pool teardown shared by close() and the
        worker-death rebuild: bounded joins (terminate stragglers), drain
        published results reclaiming their shm segments, then close +
        ``cancel_join_thread()`` both queues so a feeder thread can never
        hang interpreter exit."""
        # join BEFORE draining: a worker's queue feeder thread may still be
        # flushing a result; draining first would miss it and leak its
        # shared-memory segments (mp.Queue is unbounded, so joining here
        # cannot deadlock on a full queue)
        for w in workers:
            w.join(timeout=join_timeout)
            if w.is_alive():  # pragma: no cover - stuck worker
                w.terminate()
                w.join(timeout=1.0)
        while True:
            try:
                _j, desc, err = result_q.get(timeout=drain_timeout)
            except Exception:  # Empty, or a torn frame from a dead writer
                break
            if err is None:
                self._discard_segments(desc)
        for q in (task_q, result_q):  # pragma: no branch
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:  # pragma: no cover - queue already torn down
                pass

    def close(self, timeout=5.0):
        """Shut the persistent worker pool down (idempotent). Workers are
        joined with a bounded ``timeout`` and terminated if still alive, and
        both queues get ``cancel_join_thread()`` — a wedged worker or a
        queue feeder thread must never hang interpreter exit (this runs
        from ``__del__`` at teardown)."""
        if self._pool is None:
            return
        task_q, result_q, workers = self._pool
        self._pool = None
        for _ in workers:
            task_q.put(None)
        self._teardown_pool(task_q, result_q, workers, join_timeout=timeout,
                            drain_timeout=0.2)

    def __del__(self):  # pragma: no cover - interpreter-exit timing
        try:
            self.close()
        except Exception:
            pass

    def _rebuild_pool(self):
        """Tear the WHOLE pool down and spawn a fresh one after a worker
        death. A fresh pool (not an in-place replacement) is load-bearing:
        a worker SIGKILLed inside ``task_q.get()`` dies HOLDING the queue's
        shared reader lock — every surviving worker then blocks forever
        acquiring it, so the old queues are poisoned and must be abandoned.
        Already-published results are drained off the old result queue
        (their shm segments reclaimed) before it is dropped."""
        task_q, result_q, workers = self._pool
        self._pool = None
        for w in workers:
            if w.is_alive():  # no sentinels: the queues may be poisoned
                w.terminate()
        self._teardown_pool(task_q, result_q, workers, join_timeout=1.0,
                            drain_timeout=0.1)
        seq = self._seq  # task ids must stay monotone across the rebuild
        pool = self._ensure_pool()
        self._seq = seq
        return pool

    def _iter_multiprocess(self):
        """Spawned worker processes + shared-memory batch handoff (the
        reference's _MultiWorkerIter, dataloader.py:157-231).

        Worker DEATH (OOM-kill, segfault — distinct from a dataset
        exception, which travels back as an error result) is survivable:
        dead workers are restarted with backoff and their lost in-flight
        tasks re-enqueued (duplicate deliveries are discarded), up to
        ``worker_restarts`` (default 3) restarts per epoch; past that
        the raise reports every exit code and the batch index so the
        failure is attributable. A worker killed mid-publish can leak its
        shared-memory segment — the price of surviving, noted here."""
        pool = self._ensure_pool()
        if pool is None:  # spawn failed: picklability fallback
            yield from self._iter_threads(_scopes()[-1] if _scopes()
                                          else None)
            return
        task_q, result_q, _workers = pool
        batches = list(self._batch_sampler)
        base = self._seq
        self._seq += len(batches)
        bound = max(self._prefetch, self._num_workers, 1)
        max_restarts = self._worker_restarts
        sent = 0
        restarts = 0
        results = {}
        probe = False   # look at the workers now, before the next result
        from ...resilience import inject
        try:
            for i in range(len(batches)):
                # keep at most `bound` batches in flight past the consumer
                while sent < len(batches) and sent < i + bound:
                    task_q.put((base + sent, batches[sent]))
                    sent += 1
                if inject("worker_death", i):
                    import signal as _signal
                    victim = next(
                        (w for w in _workers if w.is_alive()), None)
                    if victim is not None:
                        os.kill(victim.pid, _signal.SIGKILL)
                        # a victim that held no task loses no batch, and
                        # the others keep the results coming: without a
                        # look now its death would go unseen
                        victim.join(timeout=5.0)
                        probe = True
                while base + i not in results:
                    got = None
                    if not probe:
                        try:
                            got = result_q.get(timeout=1.0)
                        except _queue.Empty:
                            pass
                    probe = False
                    if got is None:
                        dead = [w for w in _workers
                                if not w.is_alive()
                                and w.exitcode not in (0, None)]
                        if not dead:
                            continue
                        # ONE event per detection, however many workers an
                        # OOM-killer sweep took — the budget counts pool
                        # rebuild attempts, not corpses
                        restarts += 1
                        from ... import telemetry
                        telemetry.inc("dataloader.worker_restarts")
                        if restarts > max_restarts:
                            raise RuntimeError(
                                "DataLoader worker(s) died (exit codes %s) "
                                "while waiting for batch %d/%d; giving up "
                                "after %d restart(s) "
                                "(worker_restarts=%d). Repeated "
                                "deaths usually mean the OOM killer — "
                                "shrink the batch or worker count."
                                % ([w.exitcode for w in dead], i,
                                   len(batches), restarts - 1,
                                   max_restarts))
                        warnings.warn(
                            "DataLoader worker died (exit codes %s) at "
                            "batch %d; restarting the pool (%d/%d)"
                            % ([w.exitcode for w in dead], i, restarts,
                               max_restarts))
                        time.sleep(0.05 * restarts)  # backoff
                        pool = self._rebuild_pool()
                        if pool is None:  # spawn broke: cannot recover
                            raise RuntimeError(
                                "DataLoader worker died and the pool could "
                                "not be respawned")
                        task_q, result_q, _workers = pool
                        # in-flight work died with the old pool: re-enqueue
                        # every outstanding id (completed drained results
                        # for pending ids were reclaimed by the rebuild,
                        # so a recompute is the only copy)
                        for j2 in range(base + i, base + sent):
                            if j2 not in results:
                                task_q.put((j2, batches[j2 - base]))
                        continue
                    j, desc, err = got
                    if j < base + i or j in results:
                        # stale epoch, already-yielded, or a post-restart
                        # duplicate: discard — including stale ERRORS,
                        # which belong to work the consumer moved past
                        if err is None:
                            self._discard_segments(desc)
                        continue
                    if err is not None:
                        raise RuntimeError(
                            "DataLoader worker failed at batch %d:\n%s"
                            % (j - base, err))
                    results[j] = desc
                # device-prefetch path: leave leaves in numpy, the
                # prefetcher's copy is the one host-to-device copy
                wrap = (lambda x: x) if self._prefetch_spec is not None \
                    else array
                yield _mp_worker.from_shm(results.pop(base + i), wrap)
        finally:
            # unlink any segments the consumer never mapped (early exit);
            # in-flight stale results are discarded by the next epoch/close
            for desc in results.values():
                self._discard_segments(desc)

    @staticmethod
    def _discard_segments(desc):
        _mp_worker.discard_segments(desc)

    # ------------------------------------------------------- thread workers
    def _iter_threads(self, scope=None):
        # thread-pool pipeline with ordered delivery; the threads run in
        # the iterating thread's `with ctx:` scope (``scope``), where the
        # default batchify places its arrays
        batches = list(self._batch_sampler)
        results = {}
        results_lock = threading.Lock()
        results_ready = threading.Condition(results_lock)
        work = _queue.Queue()
        for i, b in enumerate(batches):
            work.put((i, b))
        stop = threading.Event()

        bound = max(self._prefetch, self._num_workers, 1)
        state = {"next": 0}  # next batch index the consumer will take

        def worker():
            if scope is not None:
                with scope:
                    run()
            else:
                run()

        def run():
            while not stop.is_set():
                try:
                    i, b = work.get_nowait()
                except _queue.Empty:
                    return
                # bounded prefetch: never decode more than `bound` batches
                # ahead of the consumer (reference: dataloader prefetch).
                # Throttling on distance-from-consumer (not on len(results))
                # cannot block the batch the consumer needs next.
                with results_ready:
                    while i > state["next"] + bound and not stop.is_set():
                        results_ready.wait(0.1)
                if stop.is_set():
                    return
                try:
                    out = self._load(b)
                except Exception as e:  # surfaced at delivery
                    out = e
                with results_ready:
                    results[i] = out
                    results_ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with results_ready:
                    while i not in results:
                        results_ready.wait()
                    out = results.pop(i)
                    state["next"] = i + 1
                    results_ready.notify_all()  # release throttled workers
                if isinstance(out, Exception):
                    raise out
                yield out
        finally:
            stop.set()
