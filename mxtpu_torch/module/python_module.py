"""PythonModule / PythonLossModule: host-side modules in a module chain
(counterpart of ``mxtpu/module/python_module.py``).

Reference: ``python/mxnet/module/python_module.py:28-360`` — modules whose
computation is arbitrary Python (typically a custom loss) rather than a
bound symbol: scores and labels arrive as NDArrays on the device; a
grad_func may compute with mx.nd ops (on the device) or numpy (a host
round trip), whose result lands on the scores' device.
"""
from __future__ import annotations

import logging

from ..ndarray import NDArray
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Implements most module APIs as no-ops so subclasses override only
    what they need (ref: python_module.py:28)."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) if label_names is not None \
            else None
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None
        self.inputs_need_grad = False

    # ------------------------------------------------------------- shapes
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # ----------------------------------------------- params (none by default)
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        """By default outputs are scores evaluable against labels
        (ref: python_module.py:141-163)."""
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    # ---------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """(ref: python_module.py:165-214)"""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write", "Python module only supports write gradient"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        norm = [(d.name, tuple(d.shape)) if hasattr(d, "name")
                else (d[0], tuple(d[1])) for d in data_shapes]
        assert len(norm) == len(self._data_names)
        assert [x[0] for x in norm] == self._data_names
        self._data_shapes = norm
        if label_shapes is not None:
            lnorm = [(d.name, tuple(d.shape)) if hasattr(d, "name")
                     else (d[0], tuple(d[1])) for d in label_shapes]
            assert self._label_names is not None
            assert len(self._label_names) == len(lnorm)
            self._label_shapes = lnorm
        else:
            self._label_shapes = None
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        """Subclass computes output shapes from the bound data/label shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """Terminal loss stage: forward passes scores through; backward calls
    ``grad_func(scores, labels) -> d(loss)/d(scores)``
    (ref: python_module.py:243-360)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        assert len(data_names) == 1
        assert len(label_names) == 1
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None:
            assert callable(grad_func)
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "For a loss module, out_grads should be None"
        assert self.for_training
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, NDArray):
                grad = NDArray(grad, ctx=self._scores.context)
            self._scores_grad = grad
        else:
            raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context is True
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
