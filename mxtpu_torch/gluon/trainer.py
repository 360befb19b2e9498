"""Trainer: applies an Optimizer to a set of Parameters (counterpart of
``mxtpu/gluon/trainer.py``).

``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients and updates every parameter whose ``grad_req`` is not
'null' in one ``update_batch`` call of the ``FusedUpdater``: on a CUDA
device one captured graph per parameter group, its lr, wd and
``rescale_grad`` read from static device tensors, so neither an lr
schedule nor a new batch size builds a graph again. On one device the
reduction is the identity that the JAX package's local store computes
there (``push`` of one copy, ``pull`` of the same copy): ``kvstore``
None, ``'device'``, ``'local'`` or ``'nccl'`` run with no store.

Several processes (``mxtpu_torch.distributed.init``), two ways:

* ``mesh=`` (a ``parallel.Mesh`` with a ``data_axis``): each rank trains
  on its shard of the batch (``shard_batch``, or a prefetcher given
  ``batch_sharding``); ``step(batch_size)`` takes the rank's own batch
  size, sums the gradients over the mesh and divides them by
  ``batch_size`` times the number of ranks, so that the update is the
  global batch's; ``zero1`` (default on) shards the optimizer state and
  the update over the data axis (``FusedUpdater.set_mesh``). The
  parameters are broadcast from the first rank at the first step. The
  reference's ``MXTPU_MESH``/``MXTPU_ZERO1`` are not read: pass
  ``mesh=``/``zero1=``.
* a ``dist_sync``/``dist_device_sync`` store (``kvstore.create``): the
  gradients are pushed and pulled through it, summed over the world as
  the reference's store sums them (``rescale_grad = scale /
  batch_size``), with ``compression_params`` (2-bit) on that push; by
  default the store runs the update (``update_on_kvstore``), as the
  reference's.

``update_on_kvstore=True`` with a mesh raises, as the reference's does;
``loss_scaler`` needs the numerics guard (ROADMAP A9) and raises.

``save_states``/``load_states`` write and read the updater's states and
this package's optimizer (``Updater.get_states(dump_optimizer=True)``);
``convert.load_mxtpu_optimizer_states`` reads the JAX package's states.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local", "nccl")


class Trainer:
    """Gluon's Trainer (ref: gluon/trainer.py): one device, a mesh of
    ranks (``mesh=``) or a distributed store (module docstring)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, loss_scaler=None, mesh=None,
                 zero1=None, data_axis="data"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        if loss_scaler is not None:
            raise MXNetError("loss_scaler needs the numerics guard, which "
                             "is not ported yet (ROADMAP A9)")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise MXNetError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(param))
            param._trainer = self
            self._params.append(param)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        if mesh is not None and not (hasattr(mesh, "shape")
                                     and hasattr(mesh, "axis")):
            raise MXNetError("mesh= takes a parallel.Mesh (make_mesh, "
                             "data_parallel_mesh), got %s"
                             % type(mesh).__name__)
        if mesh is not None and data_axis not in mesh.shape:
            raise MXNetError("mesh has no %r axis (axes: %s)"
                             % (data_axis, tuple(mesh.shape)))
        self._mesh = mesh
        self._data_axis = data_axis
        self._zero1 = (True if zero1 is None else bool(zero1)) \
            and mesh is not None
        if mesh is not None:
            if update_on_kvstore:
                raise MXNetError(
                    "update_on_kvstore=True is incompatible with mesh=: the "
                    "mesh step sums the gradients and updates in the "
                    "Trainer's own FusedUpdater")
            self._updaters[0].set_mesh(mesh, data_axis, self._zero1)
        self._kvstore_kind = kvstore
        self._compression_params = compression_params
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False

    def _init_kvstore(self):
        """Bind the store (a ``dist_*`` kind, or a store object) and, on a
        mesh, broadcast the parameters from the first rank; runs at the
        first step, where the reference binds its store."""
        kind = self._kvstore_kind
        if self._mesh is not None:
            from ..parallel.collectives import broadcast_
            with torch.no_grad():
                for name, size in self._mesh.shape.items():
                    if size > 1:
                        axis = self._mesh.axis(name)
                        for p in self._params:
                            if p.initialized:
                                broadcast_(p.data()._data, axis)
        if kind in _LOCAL_STORES and not self._compression_params \
                and not self._update_on_kvstore:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            from .. import kvstore as kv_mod
            kv = kv_mod.create(kind if kind is not None else "local") \
                if isinstance(kind, (str, type(None))) else kind
            if self._mesh is not None:
                if "dist" in kv.type:
                    raise MXNetError(
                        "mesh= with a dist_* kvstore is contradictory: the "
                        "mesh is the distributed path; use a device kvstore "
                        "kind with the mesh")
                kv.attach_mesh(self._mesh)
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            update_on_kvstore = self._update_on_kvstore
            if update_on_kvstore is None:
                update_on_kvstore = self._mesh is None and "dist" in kv.type
            for i, param in enumerate(self._params):
                if param.initialized:
                    kv.init(i, param.data())
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            self._kvstore = kv
            self._update_on_kvstore = bool(update_on_kvstore)
        self._kv_initialized = True

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def batch_sharding(self):
        """The batch's layout on the mesh: a ``parallel.Sharding`` of dim 0
        over the data axis on the parameters' device, or None without a
        mesh. A prefetcher given it (``io.DevicePrefetcher(sharding=
        trainer)``, ``DataLoader(prefetch_to_device=trainer)``) copies
        this rank's rows of each whole host batch to the card."""
        if self._mesh is None:
            return None
        from ..parallel.mesh import Sharding
        device = next((p.data()._data.device for p in self._params
                       if p.initialized), None)
        return Sharding(self._mesh, (self._data_axis,), device)

    def shard_batch(self, *arrays):
        """This rank's rows of each whole batch array (dim 0 over the
        data axis; the same host batch on every rank), as NDArrays on the
        parameters' device; the identity without a mesh. One input
        returns one NDArray."""
        from ..ndarray import NDArray
        if self._mesh is None:
            return arrays[0] if len(arrays) == 1 else tuple(arrays)
        sh = self.batch_sharding
        n = self._mesh.shape[self._data_axis]
        out = []
        for a in arrays:
            t = a._data if isinstance(a, NDArray) else torch.as_tensor(
                np.asarray(a))
            if not t.shape or t.shape[0] % n:
                raise MXNetError(
                    "batch dim %s does not divide the %r mesh axis (%d)"
                    % ((t.shape[0],) if t.shape else "<scalar>",
                       self._data_axis, n))
            t = sh.shard(t)
            out.append(NDArray(t.to(sh.device) if sh.device is not None
                               else t))
        return out[0] if len(out) == 1 else tuple(out)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step: the gradients reduced and every
        parameter updated, ``rescale_grad = scale / batch_size`` (over
        the ranks too on a mesh, module docstring)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._rescale(batch_size)
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def _rescale(self, batch_size):
        ranks = self._mesh.size if self._mesh is not None else 1
        return self._scale / (batch_size * ranks)

    def allreduce_grads(self):
        """Reduce the gradients across processes through the store (the
        identity on one device; on a mesh the update sums them)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() when parameters are updated "
                             "on kvstore is not supported")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None or self._mesh is not None:
            return   # a mesh's update sums the gradients itself
        keys = [i for i, p in enumerate(self._params)
                if p.grad_req != "null" and p.initialized]
        if not keys:
            return
        grads = [self._params[i].grad() for i in keys]
        self._kvstore.push(keys, grads)
        if self._update_on_kvstore:
            self._kvstore.pull(keys, [self._params[i].data() for i in keys])
        else:
            self._kvstore.pull(keys, grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step`` (after ``allreduce_grads``)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and self._update_on_kvstore:
            raise MXNetError("update() when parameters are updated on "
                             "kvstore is not supported")
        self._optimizer.rescale_grad = self._rescale(batch_size)
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            return   # the store updated the weights during push/pull
        indices, grads, weights = [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not ignore_stale_grad and not param.initialized:
                raise MXNetError("Parameter %s was not initialized"
                                 % param.name)
            if not param.initialized:
                continue
            indices.append(i)
            grads.append(param.grad())
            weights.append(param.data())
        if indices:
            self._updaters[0].update_batch(indices, grads, weights)

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer to ``fname``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read the states ``save_states`` wrote; the Trainer keeps its own
        optimizer (and its update counts), as the JAX package's does."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._optimizer  # as the JAX package
        self._optimizer.param_dict = dict(enumerate(self._params))
