"""SequentialModule: chain modules so each consumes the previous outputs
(counterpart of ``mxtpu/module/sequential_module.py``).

Reference: ``python/mxnet/module/sequential_module.py:28-441`` — an
imperative container: each inner Module is its own executor, so the chain
costs one replay per stage rather than one graph (the reference's "handy
utility, not the fast path" caveat).
"""
from __future__ import annotations

import copy
import logging

from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """Container chaining multiple modules; data flows module→module, the
    SAME labels from the original batch go to every ``take_labels`` module.
    """

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self.inputs_need_grad = False
        self._meta_keys = {getattr(SequentialModule, x)
                           for x in dir(SequentialModule)
                           if x.startswith("META_")}

    def add(self, module, **kwargs):
        """Append a module; meta kwargs: ``take_labels`` (module receives
        the chain's labels), ``auto_wiring`` (rename incoming data to the
        module's own data_names). Returns self for chaining
        (ref: sequential_module.py:52-94)."""
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, 'Unknown meta "%s", a typo?' % key
        self._metas.append(kwargs)
        # adding resets to raw state: must re-bind / re-init
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ------------------------------------------------------------- shapes
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # --------------------------------------------------------------- params
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init)

        # no duplicated parameter names across layers
        # (ref: sequential_module.py:206-221 _check_name)
        known = {}
        for i_layer, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for name in list(arg) + list(aux):
                assert name not in known, (
                    'Duplicated parameter name "%s": layer %d (%s) and layer '
                    "%d (%s)" % (name, i_layer, type(module).__name__,
                                 known[name][0], known[name][1]))
                known[name] = (i_layer, type(module).__name__)
        self.params_initialized = True

    # ---------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each module in sequence: module i+1's data shapes are
        module i's output shapes; interior modules get inputs_need_grad so
        the backward chain can flow (ref: sequential_module.py:224-296)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._modules, "Attempting to bind an empty SequentialModule"
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, module in enumerate(self._modules):
            meta = self._metas[i_layer]
            if meta.get(SequentialModule.META_TAKE_LABELS, False):
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = bool(inputs_need_grad
                                       or (for_training and i_layer > 0))
            if meta.get(SequentialModule.META_AUTO_WIRING, False):
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                # entries may be DataDesc namedtuples (4 fields) at layer 0
                # or plain (name, shape) pairs from output_shapes after
                my_data_shapes = [
                    (new_name, tuple(d.shape) if hasattr(d, "shape")
                     else tuple(d[1]))
                    for new_name, d in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_ever_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------- running
    def forward(self, data_batch, is_train=None):
        """(ref: sequential_module.py:326-356)"""
        assert self.binded and self.params_initialized
        data_batch = copy.copy(data_batch)
        for i_layer, module in enumerate(self._modules):
            module.forward(data_batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            data_batch.data = module.get_outputs()
            if getattr(data_batch, "provide_data", None) is not None:
                data_names = [x[0] for x in module.output_shapes]
                data_batch.provide_data = [
                    (name, x.shape)
                    for name, x in zip(data_names, data_batch.data)]

    def backward(self, out_grads=None):
        """Reverse chain: each module's input grads feed the previous
        module's out_grads (ref: sequential_module.py:357-367)."""
        assert self.binded and self.params_initialized
        for i_layer in reversed(range(len(self._modules))):
            module = self._modules[i_layer]
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(SequentialModule.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
