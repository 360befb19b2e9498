"""BucketingModule: per-bucket executors sharing parameters (counterpart
of ``mxtpu/module/bucketing_module.py``).

Reference: ``python/mxnet/module/bucketing_module.py`` — the variable-length
RNN answer (docs/faq/bucketing.md): one Module per bucket key, parameters
shared across buckets.

Each bucket key binds one executor (its graphs captured once per
signature); shared parameter arrays make the buckets one logical model.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._init_args = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    @property
    def output_names(self):
        return self._curr_module.output_names

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket (ref: bucketing_module.py:bind)."""
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """(ref: bucketing_module.py:switch_bucket) — compile-on-first-use per
        bucket, parameters shared with the default bucket's module."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self._curr_module.for_training,
                        False, force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key])
            module.params_initialized = True
            module.optimizer_initialized = \
                self._buckets[self._default_bucket_key].optimizer_initialized
            module._optimizer = \
                self._buckets[self._default_bucket_key]._optimizer
            module._updater = self._buckets[self._default_bucket_key]._updater
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self._curr_module.init_params(initializer, arg_params, aux_params,
                                      allow_missing, force_init)
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._buckets[self._default_bucket_key].init_optimizer(
            kvstore, optimizer, optimizer_params, force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        # grads live in the CURRENT bucket's executor; parameters are shared
        self._curr_module._optimizer = \
            self._buckets[self._default_bucket_key]._optimizer
        self._curr_module._updater = \
            self._buckets[self._default_bucket_key]._updater
        self._curr_module.optimizer_initialized = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._buckets.values():
            module.install_monitor(mon)
