"""Trainer: applies an Optimizer to a set of Parameters (counterpart of
``mxtpu/gluon/trainer.py``, on one device).

``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients and updates every parameter whose ``grad_req`` is not
'null' in one ``update_batch`` call of the ``FusedUpdater``: on a CUDA
device one captured graph per parameter group, its lr, wd and
``rescale_grad`` read from static device tensors, so neither an lr
schedule nor a new batch size builds a graph again. The
parameters live on one device, so the reduction is the identity that the
JAX package's local store computes there (``push`` of one copy, ``pull``
of the same copy): ``kvstore`` None, ``'device'`` or ``'local'`` all run
with no store. Distributed stores (``dist_*``), ``mesh=``,
``update_on_kvstore=True`` and ``compression_params`` need the
multi-device port (ROADMAP A8), and ``loss_scaler`` the numerics guard
(A9): each raises.

``save_states``/``load_states`` write and read the updater's states and
this package's optimizer (``Updater.get_states(dump_optimizer=True)``);
``convert.load_mxtpu_optimizer_states`` reads the JAX package's states.
"""
from __future__ import annotations

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")


class Trainer:
    """Gluon's Trainer (ref: gluon/trainer.py) for parameters on one
    device."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, loss_scaler=None, mesh=None,
                 zero1=None, data_axis="data"):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        if kvstore not in _LOCAL_STORES:
            raise MXNetError(
                "kvstore %r: only one device is ported (None, 'device' or "
                "'local'); distributed and multi-device stores come with "
                "ROADMAP A8" % (kvstore,))
        for what, given in (("mesh=", mesh is not None),
                            ("compression_params", bool(compression_params)),
                            ("update_on_kvstore=True", bool(update_on_kvstore))):
            if given:
                raise MXNetError("%s needs the multi-device port (ROADMAP "
                                 "A8)" % what)
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
        self._kvstore = None
        self._update_on_kvstore = False

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
        """The mesh Trainer's batch layout: the multi-device port (ROADMAP
        A8) raises here, also when a Trainer is given as a prefetch target
        (``io.DevicePrefetcher(sharding=trainer)``)."""
        raise MXNetError("Trainer.batch_sharding needs the multi-device port "
                         "(ROADMAP A8): prefetch to one device instead")

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step: ``rescale_grad = scale / batch_size``,
        the gradients reduced (the identity on one device), every
        parameter updated."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reduce the gradients across devices: the identity on one."""
        self._allreduce_grads()

    def _allreduce_grads(self):
        return None

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step`` (after ``allreduce_grads``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
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
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read the states ``save_states`` wrote; the Trainer keeps its own
        optimizer (and its update counts), as the JAX package's does."""
        with open(fname, "rb") as f:
            states = f.read()
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._optimizer   # as the JAX package does
        self._optimizer.param_dict = dict(enumerate(self._params))
