"""KVStore: parameter synchronization (counterpart of ``mxtpu/kvstore.py``;
ref: include/mxnet/kvstore.h).

``local``/``device``/``nccl`` (and the ``local_*`` spellings) are one
process's store: a push of several values for a key is their sum (one
stacked sum, the reference's tree-sum), a pull copies the stored value
out, and an updater set on the store runs on the merged value
(``update_on_kvstore``). ``dist_sync``/``dist_device_sync`` additionally
sum every push over the processes of ``mxtpu_torch.distributed`` (one
flat all-reduce per dtype for the keys of one push, or, with 2-bit
compression, one all-gather of the packed codes, each worker's
dequantized and summed); ``init`` broadcasts the first rank's value, as
MXNet's rank 0 does. ``dist_async`` raises, as the reference's does.
``attach_mesh`` records the Trainer's mesh (the store stays the control
plane: a mesh Trainer never pushes). ``row_sparse_pull`` copies only the
given rows of the stored value out: into a ``RowSparseNDArray`` (its
values and row ids replaced) or, in place, into those rows of a dense
array.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "local_update_cpu", "local_allreduce_cpu",
          "local_allreduce_device", "device", "nccl")


class KVStore:
    """Key-value store for parameter synchronization (ref: kvstore.h:59)."""

    def __init__(self, kind="local", mesh=None):
        self._kind = kind
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._mesh = mesh

    @property
    def type(self):
        return self._kind

    def attach_mesh(self, mesh):
        """Record the mesh a Trainer trains on."""
        self._mesh = mesh

    def _dist(self):
        return self._kind.startswith("dist")

    def init(self, key, value):
        """Store a copy of each value (the first rank's under ``dist_*``);
        a key already stored keeps its value."""
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            t = v._data.detach().clone()
            if self._dist():
                from .parallel.collectives import broadcast_
                from .parallel.mesh import world_axis
                broadcast_(t, world_axis())
            self._store[k] = NDArray(t)

    def push(self, key, value, priority=0):
        """Sum the values pushed for each key (over the processes too
        under ``dist_*``) into the store, or run the updater on the sum."""
        keys, values = _normalize_grouped(key, value)
        merged = []
        with torch.no_grad():
            for k, vs in zip(keys, values):
                if k not in self._store:
                    raise MXNetError("key %s has not been initialized" % k)
                merged.append(vs[0]._data.clone() if len(vs) == 1 else
                              torch.stack([v._data for v in vs]).sum(0))
            if self._dist():
                merged = self._dist_reduce(keys, merged)
        if self._updater is None:
            for k, m in zip(keys, merged):
                self._store[k]._set_data(m)
            return
        if hasattr(self._updater, "update_batch"):
            self._updater.update_batch([_int_key(k) for k in keys],
                                       [NDArray(m) for m in merged],
                                       [self._store[k] for k in keys])
        else:
            for k, m in zip(keys, merged):
                self._updater(_int_key(k), NDArray(m), self._store[k])

    def _dist_reduce(self, keys, merged):
        """Each merged value summed over the processes: one flat
        all-reduce per dtype, or the 2-bit codes all-gathered."""
        from . import distributed
        from .parallel.collectives import all_reduce_
        from .parallel.mesh import world_axis
        if self._compression is not None:
            wire, meta = [], []
            for k, m in zip(keys, merged):
                packed, n = self._compression.quantize(k, m.cpu().numpy())
                meta.append((packed.shape[0], n, m))
                wire.append(packed)
            gathered = distributed.allgather_host(
                np.concatenate(wire) if wire else np.zeros(0, np.uint8))
            out, off = [], 0
            for plen, n, m in meta:
                total = np.zeros(tuple(m.shape), np.float32)
                for row in gathered:
                    total += self._compression.dequantize(
                        row[off:off + plen], n, tuple(m.shape))
                out.append(torch.from_numpy(total).to(m.device, m.dtype))
                off += plen
            return out
        from .optimizer_fused import _by_dtype
        axis = world_axis()
        for ks in _by_dtype(merged):
            flat = torch.cat([merged[k].reshape(-1) for k in ks])
            all_reduce_(flat, axis)
            for k, piece in zip(ks, flat.split([merged[k].numel()
                                                for k in ks])):
                merged[k] = piece.view_as(merged[k]).clone()
        return merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each stored value into its outputs."""
        keys, outs = _normalize_grouped(key, out)
        with torch.no_grad():
            for k, os_ in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("key %s has not been initialized" % k)
                for o in os_:
                    o._data.copy_(self._store[k]._data)
                    o._version += 1

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (ref: KVStore::PullRowSparse): a
        row_sparse ``out`` becomes those rows; a dense ``out`` takes them
        in place and keeps every other row."""
        from .ndarray.sparse import RowSparseNDArray
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys, outs = _normalize_grouped(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        with torch.no_grad():
            for k, os_ in zip(keys, outs):
                if k not in self._store:
                    raise MXNetError("key %s has not been initialized" % k)
                src = self._store[k]._data
                for o, rid in zip(os_, rids * len(os_)):
                    dev = o._data.device
                    rows = rid._data.to(device=src.device, dtype=torch.int64)
                    vals = src.index_select(0, rows).to(dev)
                    if isinstance(o, RowSparseNDArray):
                        shape = o.shape
                        o._set_data(vals)
                        o._aux = {"indices": rows.to(device=dev,
                                                     dtype=torch.int32),
                                  "shape": tuple(shape)}
                    else:
                        o._data.index_copy_(0, rows.to(dev),
                                            vals.to(o._data.dtype))
                        o._version += 1

    def set_updater(self, updater):
        """Run ``updater`` on the merged values (ref: set_updater)."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        from . import optimizer as opt_mod
        self._optimizer = optimizer
        self.set_updater(opt_mod.get_updater(optimizer))

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on the ``dist_*`` push."""
        from .gradient_compression import GradientCompression
        self._compression = GradientCompression(**dict(compression_params))

    @property
    def rank(self):
        from . import distributed
        return distributed.rank()

    @property
    def num_workers(self):
        from . import distributed
        return distributed.num_workers()

    def barrier(self):
        """Every process waits for the others (a no-op for one)."""
        from . import distributed
        distributed.barrier("mxtpu_kvstore_barrier")

    def _send_command_to_servers(self, head, body):
        raise MXNetError(
            "no parameter-server processes exist in this runtime (symmetric "
            "workers): set_optimizer() on each worker instead")

    def get_num_dead_node(self, node_id=0, timeout=60):
        """0: a failed collective raises at once, as the reference's."""
        return 0

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no optimizer set, cannot save states")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("there is no optimizer set, cannot load states")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


def _key_str(key):
    return str(key)


def _int_key(k):
    try:
        return int(k)
    except ValueError:
        return k


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        return [_key_str(k) for k in key], list(value)
    return [_key_str(key)], [value]


def _normalize_grouped(key, value):
    """Group values per key (a key may take a list of values)."""
    if isinstance(key, (list, tuple)):
        keys = [_key_str(k) for k in key]
        if len(value) == len(keys) and all(
                isinstance(v, (list, tuple)) for v in value):
            return keys, [list(v) for v in value]
        if len(value) == len(keys):
            return keys, [[v] for v in value]
        per = len(value) // len(keys)
        return keys, [list(value[i * per:(i + 1) * per])
                      for i in range(len(keys))]
    vs = value if isinstance(value, (list, tuple)) else [value]
    return [_key_str(key)], [list(vs)]


def create(name="local", mesh=None):
    """A store (ref: src/kvstore/kvstore.cc:40-72): the local kinds, or
    ``dist_sync``/``dist_device_sync`` over the process group, which must
    be joined first (``mxtpu_torch.fleet.init`` or
    ``mxtpu_torch.distributed.init``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _LOCAL:
        return KVStore(name, mesh=mesh)
    if name in ("dist_sync", "dist_device_sync"):
        if mesh is not None:
            raise MXNetError(
                "kvstore %r cannot pre-attach a mesh: a mesh of ranks is the "
                "distributed path; use a device kind with the mesh" % name)
        from . import distributed
        if not distributed.is_initialized():
            raise MXNetError(
                "kvstore %r needs the process group: call "
                "mxtpu_torch.fleet.init() (coordinated bring-up: a retried "
                "join and a barrier under one deadline, heartbeat "
                "membership) or the bare mxtpu_torch.distributed.init() "
                "first (refusing to fall back to the single-process store)"
                % name)
        return KVStore(name)
    if name in ("dist_async", "dist"):
        raise MXNetError(
            "dist_async is deliberately unsupported (synchronous lockstep "
            "collectives; no stragglers to hide). Use dist_sync after "
            "mxtpu_torch.fleet.init() (the elastic bring-up) or "
            "mxtpu_torch.distributed.init(), or a mesh Trainer.")
    raise MXNetError("unknown KVStore type %s" % name)
