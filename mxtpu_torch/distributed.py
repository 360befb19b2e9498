"""The multi-process runtime (counterpart of ``mxtpu/distributed.py``).

The reference joins every process to one JAX runtime, and its mesh then
spans all hosts. The port runs one process per card over
``torch.distributed``: NCCL between cards, and gloo only where the
caller asks for it (``backend="gloo"``: the CPU tests, or several ranks
sharing one card). ``init()`` is the one symmetric join, as the
reference's; a process that asks for NCCL on a machine without a card
raises, and NCCL is never swapped for gloo behind the caller's back.

The reference reads ``MXTPU_COORDINATOR``/``MXTPU_NUM_PROCESSES``/
``MXTPU_PROCESS_ID``; here they are the arguments ``coordinator_address``,
``num_processes`` and ``process_id``. With none given, torch's own
``env://`` rendezvous applies (torch reads ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; the port reads none).
``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a full
``tcp://`` or ``file://`` URL.

Host values (``allgather_host``, ``allreduce_host``) travel as tensors on
the collective's device: the rank's card under NCCL, the host under gloo.
"""
from __future__ import annotations

import datetime
import logging
import threading

import numpy as np
import torch
import torch.distributed as dist

from .base import MXNetError

__all__ = ["init", "is_initialized", "shutdown", "adopt_card", "rank",
           "num_workers", "barrier", "global_compute_supported", "allgather_host",
           "allreduce_host", "backend", "collective_device"]

_OWNED = [False]


def init(coordinator_address=None, num_processes=None, process_id=None,
         local_device_ids=None, backend=None, timeout=None):
    """Join the process group; idempotent. Returns ``(rank, world)``.

    ``backend``: ``"nccl"`` (the default, which needs a card) or
    ``"gloo"``. Under NCCL the process's card is ``local_device_ids[0]``,
    else its rank modulo the visible cards. ``timeout``: seconds for the
    rendezvous and every collective (torch's default when None)."""
    if dist.is_initialized():
        return rank(), num_workers()
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise MXNetError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    if backend == "nccl" and not torch.cuda.is_available():
        raise MXNetError(
            "distributed.init: NCCL needs a CUDA device and this process "
            "has none; pass backend='gloo' to run the ranks on the host")
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = "tcp://" + coordinator_address
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    if url != "env://":
        if num_processes is None or process_id is None:
            raise MXNetError("coordinator_address needs num_processes and "
                             "process_id")
        kw.update(world_size=int(num_processes), rank=int(process_id))
    if backend == "nccl":
        ids = local_device_ids
        if ids is None:
            ids = [(process_id or 0) % torch.cuda.device_count()] \
                if url != "env://" else None
        if ids is not None:
            torch.cuda.set_device(int(ids[0]))
            kw["device_id"] = torch.device("cuda", int(ids[0]))
    dist.init_process_group(backend, init_method=url, **kw)
    if backend == "nccl" and local_device_ids is None and url == "env://":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    _OWNED[0] = True
    from . import random as _random
    _random.join_group()
    return rank(), num_workers()


def is_initialized():
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def adopt_card(local_device_ids=None):
    """Make this thread's current card the group's (an NCCL rank's
    ``local_device_ids[0]``, else its rank modulo the visible cards): the
    current device is per thread, and a join may run on another one."""
    if is_initialized() and backend() == "nccl":
        ids = local_device_ids
        torch.cuda.set_device(int(ids[0]) if ids else
                              dist.get_rank() % torch.cuda.device_count())


def shutdown(timeout_s=None):
    """Leave the process group this module joined. With ``timeout_s`` the
    teardown runs on a daemon thread and is given up past it: a group
    whose peer died may block there, and a leaving host must not."""
    if _OWNED[0] and dist.is_initialized():
        if timeout_s is None:
            dist.destroy_process_group()
        else:
            t = threading.Thread(target=dist.destroy_process_group,
                                 daemon=True,
                                 name="mxtpu-torch-group-teardown")
            t.start()
            t.join(float(timeout_s))
            if t.is_alive():
                logging.getLogger("mxtpu_torch.distributed").warning(
                    "process group teardown still blocked after %.1fs "
                    "(a peer died?); leaving it behind", float(timeout_s))
    _OWNED[0] = False


def rank():
    """This process's rank (ref: KVStore::get_rank); 0 outside a group."""
    return dist.get_rank() if is_initialized() else 0


def num_workers():
    """The world size (ref: KVStore::get_group_size); 1 outside a group."""
    return dist.get_world_size() if is_initialized() else 1


def backend(group=None):
    """The backend of ``group`` (the world by default): "nccl" or
    "gloo"."""
    return str(dist.get_backend(group)).lower()


def collective_device(group=None):
    """Where a host value travels for ``group``: the current card under
    NCCL, the host under gloo."""
    if backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_compute_supported():
    """Whether one computation can span every process: always, since
    torch.distributed runs collectives on the host (gloo) as on the card
    (NCCL); the reference's XLA:CPU could not."""
    return True


def barrier(name="mxtpu_barrier"):
    """Block until every process reaches the barrier (ref:
    KVStore::Barrier); a no-op for one process. ``name`` is accepted for
    the reference's signature."""
    if num_workers() > 1:
        dist.barrier()


def allgather_host(x):
    """Gather a host array of the same shape from every process; returns
    ``[world, ...]`` (``x[None]`` for one process)."""
    arr = np.asarray(x)
    if num_workers() <= 1:
        return arr[None]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(collective_device())
    out = [torch.empty_like(t) for _ in range(num_workers())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def allreduce_host(x):
    """The sum of a host array over every process (the identity for
    one)."""
    if num_workers() <= 1:
        return x
    arr = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()
