"""DataLoader worker-process internals (counterpart of
``mxtpu/gluon/data/_mp_worker.py``).

Spawned workers import this module, and through it the package's
``__init__``; nothing on that path calls into ``torch.cuda``, builds a
kernel or picks the default device, so a worker never creates a CUDA
context. The worker side is numpy only: its batchify rejects device arrays
and tensors, and batches travel to the parent through POSIX shared memory
as (name, shape, dtype) descriptors. The parent-side ``DataLoader`` in
dataloader.py wraps these primitives.

Reference analog: python/mxnet/gluon/data/dataloader.py:26-120 -- worker
processes hand decoded batches to the trainer through shared memory.
"""
from __future__ import annotations

import itertools
import os
import traceback
from multiprocessing import shared_memory as _shm

import numpy as np

_SEGMENT_IDS = itertools.count()


def segment_prefix(pid):
    """The name stem of every segment worker ``pid`` creates
    (``psm_mxt_<pid>_<n>``; ``/dev/shm/<name>`` on Linux), so a loader can
    tell its own pool's segments from any other process's."""
    return "psm_mxt_%d_" % pid


def _new_segment(size):
    """A fresh segment named for this process; a name left behind by an
    earlier process with the same pid is skipped."""
    while True:
        name = "%s%d" % (segment_prefix(os.getpid()), next(_SEGMENT_IDS))
        try:
            return _shm.SharedMemory(name=name, create=True, size=size)
        except FileExistsError:
            continue


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy in, numpy out (ref:
    default_mp_batchify_fn, which batched into cpu_shared NDArrays).
    Runs inside a spawned worker, so it never touches the device: device
    arrays and tensors are rejected loudly."""
    first = data[0]
    if hasattr(first, "asnumpy") or hasattr(first, "_data") or \
            type(first).__module__.startswith("torch"):
        raise TypeError(
            "multiprocess DataLoader workers require numpy samples "
            "(device arrays cannot cross process boundaries); return numpy "
            "from the dataset/transform or use thread_pool=True")
    if isinstance(first, tuple):
        transposed = list(zip(*data))
        return [default_mp_batchify_fn(list(x)) for x in transposed]
    return np.asarray(data)


def to_shm(obj, segments):
    """numpy payload -> picklable descriptor tree; arrays move into fresh
    shared-memory segments recorded in ``segments``."""
    if isinstance(obj, np.ndarray):
        if obj.nbytes == 0:
            return ("npy0", obj.shape, obj.dtype.str)
        seg = _new_segment(obj.nbytes)
        np.ndarray(obj.shape, obj.dtype, buffer=seg.buf)[...] = obj
        # ownership transfers to the consumer (parent unlinks after
        # mapping); unregister from THIS process's resource tracker or it
        # warns about "leaked" segments the parent already removed
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker API private-ish
            pass
        segments.append(seg)
        return ("npy", seg.name, obj.shape, obj.dtype.str)
    if isinstance(obj, (list, tuple)):
        return ("seq", type(obj) is tuple, [to_shm(o, segments) for o in obj])
    if obj is None or isinstance(obj, (str, bytes, int, float, bool,
                                       np.generic)):
        return ("raw", obj)
    # anything else (device arrays, custom objects) must fail HERE, as a
    # catchable worker error — letting it reach mp.Queue's feeder thread
    # turns a pickle failure into a silently dropped result and a parent
    # that waits forever
    raise TypeError(
        "multiprocess DataLoader batch contains %r — workers require "
        "numpy samples/batches (device arrays cannot cross process "
        "boundaries); return numpy from the dataset/batchify_fn or use "
        "thread_pool=True" % type(obj).__name__)


def from_shm(desc, wrap):
    """Descriptor tree -> wrapped-array tree (parent side). Each segment is
    mapped, copied off before unmapping (wrap() may device-put
    asynchronously; an async copy racing the munmap reads garbage), then
    closed and unlinked."""
    kind = desc[0]
    if kind == "npy0":
        return wrap(np.empty(desc[1], np.dtype(desc[2])))
    if kind == "npy":
        seg = _shm.SharedMemory(name=desc[1])
        try:
            view = np.ndarray(desc[2], np.dtype(desc[3]), buffer=seg.buf)
            host = np.array(view)
        finally:
            seg.close()
            seg.unlink()
        return wrap(host)
    if kind == "seq":
        items = [from_shm(d, wrap) for d in desc[2]]
        return tuple(items) if desc[1] else items
    return desc[1]


def discard_segments(desc):
    """Unlink every segment in a descriptor tree the consumer never mapped."""
    if desc[0] == "npy":
        try:
            seg = _shm.SharedMemory(name=desc[1])
            seg.close()
            seg.unlink()
        except FileNotFoundError:  # pragma: no cover
            pass
    elif desc[0] == "seq":
        for d in desc[2]:
            discard_segments(d)


def worker_loop(dataset, batchify_fn, task_q, result_q):
    """Spawned worker: pull (batch_index, sample_indices), build the batch
    with numpy, publish via shared memory. Exceptions travel back as
    formatted tracebacks (the reference's worker does the same re-raise
    dance through the ForkingPickler)."""
    while True:
        job = task_q.get()
        if job is None:
            return
        i, idxs = job
        try:
            batch = batchify_fn([dataset[j] for j in idxs])
            segments = []
            desc = to_shm(batch, segments)
            for seg in segments:
                seg.close()  # parent unlinks after mapping
            result_q.put((i, desc, None))
        except Exception:  # pragma: no cover - exercised via parent raise
            result_q.put((i, None, traceback.format_exc()))
