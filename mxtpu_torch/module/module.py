"""Module: bind a Symbol to data shapes and train it (counterpart of
``mxtpu/module/module.py``).

Reference: ``python/mxnet/module/module.py:40-642`` — binds a
DataParallelExecutorGroup (per-device executors + batch slicing,
executor_group.py:281) and reduces gradients through KVStore.

The port binds ONE executor. ``context`` is one device (default the
CUDA device, or raise); a list of contexts runs on its first, as the
reference's executor keeps the list and runs on one device; a
``parallel.Mesh`` binds on this rank's device, every rank binding the
global shapes and passing the same global batch, and the executor runs
this rank's rows of it with the gradients summed over the mesh's data
axis (``symbol/executor.py``). ``compression_params`` is accepted and
unused, as the reference's is; ``group2ctxs`` raises in the reference's
words. A ``local`` or ``device`` store's push and pull of a gradient is
the identity on one device, so ``kvstore`` None, ``"local"`` and
``"device"`` mean no store; ``"dist_sync"``, ``"dist_device_sync"`` or a
``KVStore`` object is created (``kvstore.create``), holds every parameter,
and, its type naming ``dist``, updates them on the store: ``update``
pushes the grouped gradients and pulls the weights (the reference's
``_update_params_on_kvstore``). Otherwise ``update`` hands the grouped
parameters to one ``FusedUpdater.update_batch`` (on the card the captured
update step), which writes the executor's arrays in place.
"""
from __future__ import annotations

import logging

import torch

from .. import optimizer as opt_mod
from .. import telemetry
from ..base import MXNetError
from ..initializer import InitDesc
from ..model import load_checkpoint, save_checkpoint
from ..ndarray import NDArray
from ..symbol.executor import executor_device
from .base_module import BaseModule

__all__ = ["Module"]

_LOCAL_STORES = (None, "local", "device")


def _create_kvstore(kvstore):
    """None for no store (module docstring), else the store."""
    from .. import kvstore as kv_mod
    if isinstance(kvstore, kv_mod.KVStore):
        return kvstore
    if kvstore in _LOCAL_STORES:
        return None
    if isinstance(kvstore, str):
        return kv_mod.create(kvstore)
    raise MXNetError("kvstore %r is neither a store's name nor a KVStore"
                     % (kvstore,))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if group2ctxs is not None:
            raise MXNetError(
                "group2ctxs manual device placement is not supported: use a "
                "parallel.Mesh context plus ShardedTrainStep param_specs for "
                "model parallelism")
        executor_device(context)   # no card and no CPU context: raise now
        self._context = context
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])

        arg_names = symbol.list_arguments()
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()

        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = "write"
        self._preload_opt_states = None

    # ------------------------------------------------------------- binding
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def output_shapes(self):
        if self._exec is not None and self._exec.outputs:
            return [(n, tuple(o.shape))
                    for n, o in zip(self.output_names, self._exec.outputs)]
        # before the first forward: inferred from the bound input shapes,
        # so chained binding (SequentialModule) can wire shapes ahead
        assert self.binded, "bind first"
        hints = dict(self._data_shapes + (self._label_shapes or []))
        _args, outs, _auxs = self._symbol.infer_shape(**hints)
        return list(zip(self.output_names, [tuple(s) for s in outs]))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """(ref: module.py:bind)"""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self._grad_req = grad_req

        shapes = {}
        for desc in list(data_shapes) + list(label_shapes or []):
            name, shape = (desc.name, desc.shape) if hasattr(desc, "name") \
                else (desc[0], desc[1])
            shapes[name] = tuple(shape)
        self._data_shapes = [(n, shapes[n]) for n in self._data_names]
        self._label_shapes = [(n, shapes[n]) for n in self._label_names
                              if n in shapes]

        req = {}
        for n in self._symbol.list_arguments():
            if n in self._data_names or n in self._label_names \
                    or n in self._fixed_param_names:
                req[n] = "null" if not inputs_need_grad \
                    or n not in self._data_names else grad_req
            else:
                req[n] = grad_req if for_training else "null"
        exe = self._symbol.simple_bind(ctx=self._context, grad_req=req,
                                       **shapes)
        if shared_module is not None and shared_module._exec is not None:
            # share the parameter arrays (BucketingModule's buckets)
            shared = shared_module._exec
            for n in self._param_names:
                if n in shared.arg_dict:
                    exe.arg_dict[n] = shared.arg_dict[n]
                    if n in shared.grad_dict:
                        exe.grad_dict[n] = shared.grad_dict[n]
            for n in self._aux_names:
                if n in shared.aux_dict:
                    exe.aux_dict[n] = shared.aux_dict[n]
        self._exec = exe
        self.binded = True

    # ---------------------------------------------------------- parameters
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Write ``arg_params``/``aux_params`` (or the initializer's draws)
        into the bound arrays in place (ref: module.py:init_params)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        for table, names, given in (
                (self._exec.arg_dict, self._param_names, arg_params),
                (self._exec.aux_dict, self._aux_names, aux_params)):
            for name in names:
                arr = table[name]
                if given is not None and name in given:
                    src = given[name]
                    src = src._data if isinstance(src, NDArray) else \
                        torch.as_tensor(src)
                elif initializer is not None:
                    src = torch.zeros(arr.shape, dtype=torch.float32)
                    initializer(InitDesc(name), src, gen)
                elif not allow_missing and given is not None \
                        and table is self._exec.arg_dict:
                    raise MXNetError("%s not initialized" % name)
                else:
                    continue
                with torch.no_grad():
                    arr._data.copy_(src)
        self.params_initialized = True

    def get_params(self):
        return ({n: self._exec.arg_dict[n].copy() for n in self._param_names},
                {n: self._exec.aux_dict[n].copy() for n in self._aux_names})

    # ----------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False, loss_scaler=None):
        """(ref: module.py:init_optimizer). ``kvstore`` None, ``"local"``
        or ``"device"``: no store; a ``dist_*`` name or a store object: the
        store (module docstring). ``loss_scaler`` (a
        ``resilience.DynamicLossScaler``) attaches the numerics guard to
        the updater (and the store's, where it updates): ``backward``
        scales the head gradients by the live scale."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        kv = _create_kvstore(kvstore)
        _check_scaler(loss_scaler)
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            opt_kw = dict(optimizer_params or {})
            # default rescale_grad = 1/batch (ref: module.py init_optimizer —
            # loss-layer grads like SoftmaxOutput are per-sample sums)
            if "rescale_grad" not in opt_kw and self._data_shapes:
                opt_kw["rescale_grad"] = 1.0 / self._data_shapes[0][1][0]
            optimizer = opt_mod.create(
                optimizer, param_idx2name=idx2name, sym=self._symbol,
                **opt_kw)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self._loss_scaler = loss_scaler
        if loss_scaler is not None:
            self._updater.scaler = loss_scaler
        if self._preload_opt_states is not None:
            with open(self._preload_opt_states, "rb") as f:
                self._updater.set_states(f.read())
            self._updater.optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = kv is not None and "dist" in kv.type
        if kv is not None:
            for i, name in enumerate(self._param_names):
                kv.init(i, self._exec.arg_dict[name])
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
                if loss_scaler is not None and \
                        getattr(kv, "_updater", None) is not None:
                    kv._updater.scaler = loss_scaler
        self.optimizer_initialized = True

    # ------------------------------------------------------------- running
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feed.update(zip(self._label_names, data_batch.label))
        with telemetry.span("module.forward"):
            self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        """(ref: module.py:backward). With a loss scaler the head
        gradients (the default ones, or ``out_grads``) are multiplied by
        the live scale, a device scalar (no sync, no new build)."""
        assert self.binded and self.params_initialized
        scaler = getattr(self, "_loss_scaler", None)
        if scaler is not None:
            outs = self._exec.outputs
            for o in outs:
                dt = o._data.dtype
                if dt.is_floating_point and \
                        scaler.max_scale > torch.finfo(dt).max:
                    raise MXNetError(
                        "loss scaler max_scale=%g exceeds %s's max (%g): "
                        "construct DynamicLossScaler(max_scale=...) within "
                        "the head dtype's range for Module training"
                        % (scaler.max_scale, dt, torch.finfo(dt).max))
            s = scaler._ensure(outs[0]._data.device)
            if out_grads is None:
                out_grads = [NDArray(s.to(o._data.dtype).expand(
                    o._data.shape).clone()) for o in outs]
            else:
                if not isinstance(out_grads, (list, tuple)):
                    out_grads = [out_grads]
                out_grads = [NDArray(g._data * s.to(g._data.dtype))
                             for g in out_grads]
        with telemetry.span("module.backward"):
            self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step on the gradients (ref: module.py:update): the
        grouped keys in ONE ``update_batch`` call, or pushed to the store
        (module docstring)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        keys, grads, weights = [], [], []
        for i, name in enumerate(self._param_names):
            g = self._exec.grad_dict.get(name)
            if g is None:
                continue
            keys.append(i)
            grads.append(g)
            weights.append(self._exec.arg_dict[name])
        if not keys:
            return
        kv = self._kvstore
        with telemetry.span("module.update"):
            if kv is None:
                self._updater.update_batch(keys, grads, weights)
            elif self._update_on_kvstore:
                kv.push(keys, grads)
                kv.pull(keys, weights)
            else:
                kv.push(keys, grads)
                kv.pull(keys, grads)
                self._updater.update_batch(keys, grads, weights)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        mon.install(self._exec)

    # ---------------------------------------------------------- checkpoint
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            with open("%s-%04d.states" % (prefix, epoch), "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint's symbol whose ``init_params`` takes
        the checkpoint's parameters unless given others (ref:
        module.py:load); with ``load_optimizer_states`` its
        ``init_optimizer`` reads the ``.states`` file."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._preloaded = (args, auxs)
        orig_init = mod.init_params

        def init_params(initializer=None, arg_params=None, aux_params=None,
                        allow_missing=False, force_init=False):
            orig_init(initializer=initializer,
                      arg_params=arg_params or args,
                      aux_params=aux_params or auxs,
                      allow_missing=allow_missing, force_init=force_init)
        mod.init_params = init_params
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod


def _check_scaler(loss_scaler):
    from ..resilience import DynamicLossScaler
    if loss_scaler is not None and \
            not isinstance(loss_scaler, DynamicLossScaler):
        raise MXNetError("loss_scaler takes a resilience.DynamicLossScaler, "
                         "got %s" % type(loss_scaler).__name__)
