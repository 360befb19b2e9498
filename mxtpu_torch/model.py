"""Checkpoint helpers, BatchEndParam, and the legacy FeedForward estimator
(counterpart of ``mxtpu/model.py``; ref: python/mxnet/model.py).

Format parity: ``prefix-symbol.json`` (graph) + ``prefix-%04d.params`` holding
``arg:name`` / ``aux:name`` keyed NDArrays, exactly the reference's layout
(model.py:383-413), so either package reads the other's checkpoints.
``load_checkpoint`` stages the arrays on the host; whoever uses them
(``Module.init_params``, ``Executor.copy_params_from``,
``Parameter.set_data``) copies them to its device.

FeedForward (reference model.py:451-1027) predates the Module API; it is
kept for parity as a thin estimator over :class:`module.Module`, whose one
executor takes the place of the reference's `_train_multi_device`
executor loop.
"""
from __future__ import annotations

import logging
import warnings
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .ndarray.utils import load as nd_load, save as nd_save

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Ref: model.py:save_checkpoint."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd_save(param_name, save_dict)


def load_checkpoint(prefix, epoch):
    """Ref: model.py:load_checkpoint. Returns (symbol, arg_params,
    aux_params), the arrays on the host."""
    import os
    from . import symbol as sym_mod
    from .context import cpu
    symbol = None
    if os.path.exists("%s-symbol.json" % prefix):
        symbol = sym_mod.load("%s-symbol.json" % prefix)
    with cpu():
        save_dict = nd_load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("Invalid param file key %s" % k)
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy estimator: fit/predict/score on a symbol (ref: model.py:451).

    Deprecated in the reference in favor of Module — kept for API parity.
    One internal :class:`module.Module` replaces the reference's
    `_train_multi_device` per-GPU executor group (model.py:192-381).
    """

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        warnings.warn("FeedForward is deprecated. Please use Module instead.",
                      DeprecationWarning, stacklevel=2)
        from .initializer import Uniform
        from .symbol import Symbol
        if not isinstance(symbol, Symbol):
            # reference accepts sym_gen callables here; bucketing belongs
            # to BucketingModule in this framework
            raise MXNetError("sym_gen callables are BucketingModule's job; "
                             "FeedForward here takes a Symbol")
        self.symbol = symbol
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        if allow_extra_params:
            if self.arg_params:
                names = set(symbol.list_arguments())
                self.arg_params = {k: v for k, v in self.arg_params.items()
                                   if k in names}
            if self.aux_params:
                names = set(symbol.list_auxiliary_states())
                self.aux_params = {k: v for k, v in self.aux_params.items()
                                   if k in names}
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None
        # bound inference module cached per input-shape signature (the
        # reference's _pred_exec, model.py:610) so a serving loop doesn't
        # re-bind + recompile per predict() call
        self._pred_key = None
        self._pred_module = None

    # ------------------------------------------------------------ plumbing
    def _init_iter(self, X, y, is_train):
        """numpy/NDArray → NDArrayIter (ref: model.py:628-652)."""
        from .io import NDArrayIter
        from .ndarray import NDArray
        if isinstance(X, (np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise MXNetError("y must be specified when X is numpy")
                y = np.zeros(X.shape[0])
            y = y.asnumpy() if isinstance(y, NDArray) else np.asarray(y)
            if X.shape[0] != y.shape[0]:
                raise MXNetError("data and label lengths differ")
            if y.ndim == 2 and y.shape[1] == 1:
                y = y.flatten()
            if y.ndim != 1:
                raise MXNetError("label must be 1D or 2D with 2nd dim 1")
            bs = min(X.shape[0], self.numpy_batch_size)
            if is_train:
                return NDArrayIter(X, y, bs, shuffle=True,
                                   last_batch_handle="roll_over")
            return NDArrayIter(X, y, bs, shuffle=False)
        return X

    def _init_eval_iter(self, eval_data):
        """(ref: model.py:653-672)"""
        if eval_data is None:
            return None
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            d = np.array(eval_data[0]) if isinstance(eval_data[0], list) \
                else eval_data[0]
            lbl = np.array(eval_data[1]) if isinstance(eval_data[1], list) \
                else eval_data[1]
            return self._init_iter(d, lbl, is_train=True)
        return eval_data

    def _build_module(self, data_iter):
        from .module import Module
        data_names = [x[0] for x in data_iter.provide_data]
        label_names = [x[0] for x in (data_iter.provide_label or [])]
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names, context=self.ctx)

    # ------------------------------------------------------------ training
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """(ref: model.py:793-894)"""
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)
        if self.num_epoch is None:
            raise MXNetError("num_epoch must be set to fit")
        if self.epoch_size is not None:
            (logger or logging).warning(
                "epoch_size is ignored: the executor trains full "
                "iterator epochs")
        opt = self.optimizer
        opt_kw = dict(self.kwargs)
        mod = self._build_module(data)
        if logger is not None:
            mod.logger = logger
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=opt, optimizer_params=opt_kw,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    # ----------------------------------------------------------- inference
    def _init_predictor(self, data_iter):
        if self.arg_params is None:
            raise MXNetError("model has no parameters: fit() or load() first")

        def _shape_of(d):
            return (d.name, tuple(d.shape)) if hasattr(d, "name") \
                else (d[0], tuple(d[1]))

        key = tuple(_shape_of(d) for d in data_iter.provide_data)
        if self._pred_key != key:
            mod = self._build_module(data_iter)
            mod.bind(data_shapes=data_iter.provide_data,
                     label_shapes=data_iter.provide_label, for_training=False)
            self._pred_key, self._pred_module = key, mod
        # (re)load params even on cache hit — fit()/load() may have
        # refreshed them since the module was bound
        self._pred_module.init_params(arg_params=self.arg_params,
                                      aux_params=self.aux_params or {},
                                      allow_missing=True, force_init=True)
        return self._pred_module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Forward over X; returns numpy outputs (ref: model.py:673-741)."""
        data = self._init_iter(X, y=None, is_train=False)
        if reset:
            data.reset()
        mod = self._init_predictor(data)
        if not return_data:
            res = mod.predict(data, num_batch=num_batch, reset=False)
            if isinstance(res, list):
                return [o.asnumpy() for o in res]
            return res.asnumpy()
        outputs, datas, labels = [], [], []
        for nbatch, batch in enumerate(data):
            if num_batch is not None and nbatch == num_batch:
                break
            mod.forward(batch, is_train=False)
            n = batch.data[0].shape[0] - batch.pad
            outputs.append([o.asnumpy()[:n] for o in mod.get_outputs()])
            datas.append([d.asnumpy()[:n] for d in batch.data])
            labels.append([l.asnumpy()[:n] for l in (batch.label or [])])
        num_out = len(outputs[0]) if outputs else 0
        merged = [np.concatenate([o[i] for o in outputs])
                  for i in range(num_out)]
        result = merged[0] if num_out == 1 else merged
        md = [np.concatenate([d[i] for d in datas])
              for i in range(len(datas[0]))] if datas else []
        ml = [np.concatenate([l[i] for l in labels])
              for i in range(len(labels[0]))] if labels and labels[0] else []
        return (result, md[0] if len(md) == 1 else md,
                ml[0] if len(ml) == 1 else ml)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Evaluate on X (ref: model.py:742-792)."""
        data = self._init_iter(X, y=None, is_train=False)
        if reset:
            data.reset()
        mod = self._init_predictor(data)
        res = mod.score(data, eval_metric, num_batch=num_batch,
                        batch_end_callback=batch_end_callback, reset=False)
        return res[0][1] if res else None

    # ----------------------------------------------------------- persistence
    def save(self, prefix, epoch=None):
        """(ref: model.py:895-917)"""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """(ref: model.py:918-948)"""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Functional-style fit (ref: model.py:949-1027)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
