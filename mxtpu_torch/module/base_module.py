"""BaseModule: the fit/score/predict training template (counterpart of
``mxtpu/module/base_module.py``).

Reference: ``python/mxnet/module/base_module.py`` — ``fit`` (:410-528) runs
forward_backward + update + metric per batch, eval + checkpoint per epoch.
"""
from __future__ import annotations

import logging

from .. import metric as metric_mod
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ----------------------------------------------------- high-level API
    def forward_backward(self, data_batch):
        """(ref: base_module.py:194)"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate on a data iterator (ref: base_module.py:score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        return eval_metric.get_name_value()

    def _bound_batch_size(self):
        """The batch size this module's executor was bound for (first dim
        of the first bound data shape; None when unbound)."""
        shapes = getattr(self, "data_shapes", None)
        if not shapes:
            return None
        first = shapes[0]
        shape = first.shape if hasattr(first, "shape") else first[1]
        return shape[0] if shape else None

    def _pad_batch_to_bound(self, batch):
        """Ragged batch -> the bound batch size, via the serving
        pad-to-bucket helper: a final batch of n < bound rows pads up to
        bound (``pad`` bumped so output slicing drops the filler) and
        replays the executor's captured graph instead of capturing one per
        ragged size — the builds at retrace site ``executor`` stay flat
        across ragged tails."""
        bound = self._bound_batch_size()
        if bound is None or not getattr(batch, "data", None):
            return batch
        n = batch.data[0].shape[0]
        if n >= bound:
            return batch
        from ..io import DataBatch
        from ..ndarray import NDArray
        from ..serving.engine import pad_nd

        def pad(a):
            return NDArray(pad_nd(a._data if isinstance(a, NDArray) else a,
                                  bound))
        data = [pad(d) for d in batch.data]
        label = [pad(lab) for lab in batch.label] \
            if batch.label else batch.label
        return DataBatch(data=data, label=label,
                         pad=batch.pad + (bound - n), index=batch.index,
                         bucket_key=getattr(batch, "bucket_key", None),
                         provide_data=getattr(batch, "provide_data", None),
                         provide_label=getattr(batch, "provide_label", None))

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Collect outputs over an iterator (ref: base_module.py:predict).
        Ragged batches route through the serving pad-to-bucket helper so
        they reuse the bound batch's graph (see _pad_batch_to_bound)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            eval_batch = self._pad_batch_to_bound(eval_batch)
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outs = [o[0:o.shape[0] - pad] for o in self.get_outputs()]
            output_list.append(outs)
        if not output_list:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            from ..ndarray import concat
            merged = [concat(*[o[i] for o in output_list], dim=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Full training loop (ref: base_module.py:410-528)."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform
        if initializer is None:
            initializer = Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1

            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)

            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                vmetric = _as_metric(validation_metric)
                res = self.score(eval_data, vmetric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                if eval_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=0,
                                          eval_metric=vmetric,
                                          locals=locals())
                    for cb in _as_list(eval_end_callback):
                        cb(param)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

    # --------------------------------------------------------- interfaces
    @property
    def symbol(self):
        return self._symbol

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def install_monitor(self, mon):
        raise NotImplementedError


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]
