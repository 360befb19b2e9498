"""Optimizers (counterpart of ``mxtpu/optimizer.py``): the registry,
``Updater`` and the sixteen update rules of the JAX package (SGD, NAG,
Signum, FTML, DCASGD, SGLD, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl,
Adamax, Nadam, LBSGD, Test and the contrib GroupAdaGrad), with MXNet's
formulas (``ops/optimizer_ops.py``), never ``torch.optim``.

* Update counts are per index (``_update_count``); ``num_update`` is
  their maximum, and the lr scheduler reads it after the index's count
  moves and before its update, as in the reference.
* ``_get_lr``/``_get_wd`` scale by the parameter's ``lr_mult``/``wd_mult``
  (``param_dict[index]``, as MXNet reads it; the JAX package looks the
  index up by name only, so a Trainer's multipliers never reach it) or the
  ``set_lr_mult``/``set_wd_mult`` tables.
* ``multi_precision``: a bfloat16 or float16 weight keeps a float32 master
  copy, updated in float32 and cast back into the weight.
* Every update writes into the weight's and the states' own tensors in
  place, outside autograd, so a Parameter keeps its ``nn.Parameter``.
* ``Updater.get_states`` pickles the states as numpy arrays (bfloat16 as
  float32, exact) and, with ``dump_optimizer``, this package's own
  optimizer beside them; ``set_states`` reads them back, and the first
  update of an index moves its restored states to the weight's device and
  type.

``get_updater`` gives ``optimizer_fused.FusedUpdater``, whose batch path
groups the parameters and updates them with ``torch._foreach_*`` ops.

A ``RowSparseNDArray`` gradient takes the lazy update of SGD (with or
without momentum), Adam, AdaGrad and GroupAdaGrad, as in the JAX package:
only the gradient's rows of the weight and of its states move, read with
``index_select`` and written in place with ``index_copy_``/``index_add_``;
every other row keeps its bits.
"""
from __future__ import annotations

import math
import pickle
import sys as _sys
import types as _types

import numpy as _np
import torch

from . import random as _random
from .base import MXNetError
from .ndarray import NDArray
from .ops import optimizer_ops as _uo
from .ops.optimizer_ops import write as _write

__all__ = ["Optimizer", "Updater", "create", "register", "get_updater",
           "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam",
           "LBSGD", "Test", "GroupAdaGrad"]

_LOW = (torch.float16, torch.bfloat16)


def _t(arr):
    """An NDArray's tensor, outside autograd."""
    return arr._data.detach()


def _sparse_grad(grad):
    """(row ids as int64, the rows' values) of a RowSparseNDArray gradient,
    or None for a dense one."""
    from .ndarray.sparse import RowSparseNDArray
    if not isinstance(grad, RowSparseNDArray):
        return None
    return grad._aux["indices"].long(), _t(grad)


def _set_rows(arr, rows, values):
    """arr[rows] = values, in place, outside autograd."""
    with torch.no_grad():
        arr._data.index_copy_(0, rows, values.to(arr._data.dtype))
    arr._version += 1


def _add_rows(arr, rows, values):
    """arr[rows] += values, in place, outside autograd."""
    with torch.no_grad():
        arr._data.index_add_(0, rows, values.to(arr._data.dtype))
    arr._version += 1


class Optimizer:
    """Base optimizer: lr and wd with their per-parameter multipliers, an
    lr scheduler, update counts for bias correction, multi-precision."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.param_idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.idx2name = dict(self.param_idx2name)
        self.lr_mult = {}
        self.wd_mult = {}

    # -- registry ---------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError("Cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](**kwargs)

    # -- lr/wd ------------------------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, table):
        """The index's lr or wd multiplier: its Parameter's (``param_dict``
        keyed by index, as MXNet's and as the Trainer builds it, or by
        name), else the table's entry by name or index, else 1."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        name = self.idx2name.get(index, index if isinstance(index, str)
                                 else None)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        if name in table:
            return table[name]
        return table.get(index, 1.0)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _mp(self, weight):
        return bool(self.multi_precision) and weight._data.dtype in _LOW

    def create_state_multi_precision(self, index, weight):
        if self._mp(weight):
            master = NDArray(_t(weight).to(torch.float32))
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):  # pragma: no cover
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        with torch.no_grad():
            if self._mp(weight):
                master, base_state = state
                self.update(index, master, NDArray(_t(grad).float()),
                            base_state)
                _write(weight, master._data)
            else:
                self.update(index, weight, grad, state)

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0

    def _common_kwargs(self, index):
        return dict(rescale_grad=self.rescale_grad,
                    clip_gradient=self._clip())

    def _rescaled(self, grad, weight, wd):
        """rescale, clip, + wd * w (the rules written out below)."""
        g = _t(grad) * self.rescale_grad
        if self.clip_gradient:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g + _t(weight) * wd


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros_like_state(weight):
    """A new zeros buffer beside ``weight`` per call (no two state slots
    share one)."""
    return NDArray(torch.zeros_like(_t(weight)))


@register
class SGD(Optimizer):
    """SGD with optional momentum: ``mom = momentum * mom - lr * g;
    w += mom``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        sparse = _sparse_grad(grad)
        if sparse is not None:
            self._sparse_update(weight, sparse, state, lr, wd)
            return
        if state is None:
            _uo.sgd_update(weight, grad, lr, wd=wd,
                           **self._common_kwargs(index))
        else:
            _uo.sgd_mom_update(weight, grad, state, lr,
                               momentum=self.momentum, wd=wd,
                               **self._common_kwargs(index))

    def _sparse_update(self, weight, sparse, state, lr, wd):
        """The lazy update: only the gradient's rows move."""
        rows, g = sparse
        g = g * self.rescale_grad
        if self.clip_gradient:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        g = g + _t(weight).index_select(0, rows) * wd
        if state is None:
            _add_rows(weight, rows, g * -lr)
            return
        m_rows = _t(state).index_select(0, rows) * self.momentum - g * lr
        _set_rows(state, rows, m_rows)
        _add_rows(weight, rows, m_rows)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _uo.sgd_update(weight, grad, lr, wd=wd,
                           **self._common_kwargs(index))
        else:
            _uo.nag_mom_update(weight, grad, state, lr,
                               momentum=self.momentum, wd=wd,
                               **self._common_kwargs(index))


@register
class Signum(Optimizer):
    """SignSGD, with momentum when ``momentum`` is not 0."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _uo.signsgd_update(weight, grad, lr, wd=wd,
                               **self._common_kwargs(index))
        else:
            _uo.signum_update(weight, grad, state, lr,
                              momentum=self.momentum, wd=wd,
                              wd_lh=self.wd_lh, **self._common_kwargs(index))


@register
class FTML(Optimizer):
    """Follow the Moving Leader."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight),
                _zeros_like_state(weight))   # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        new = _uo.ftml_update_fn(
            _t(weight), _t(grad), _t(d), _t(v), _t(z), lr, t,
            beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            rescale_grad=self.rescale_grad, clip_grad=self._clip())
        for arr, value in zip((weight, d, v, z), new):
            _write(arr, value)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros_like_state(weight) if self.momentum else None
        return (mom, NDArray(_t(weight).clone()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, prev = state
        g = self._rescaled(grad, weight, wd)
        w = _t(weight)
        comp = g + g * self.lamda * g * (w - _t(prev))
        if mom is None:
            step = comp * -lr
        else:
            step = _t(mom) * self.momentum - comp * lr
            _write(mom, step)
        _write(prev, w)
        _write(weight, w + step)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half SGD step plus
    N(0, lr) noise from the weight's device generator (``mx.random``)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._rescaled(grad, weight, wd)
        w = _t(weight)
        noise = torch.randn(w.shape, generator=_random.generator(w.device),
                            device=w.device) * math.sqrt(lr)
        _write(weight, w - g * (lr / 2) + noise.to(w.dtype))


@register
class Adam(Optimizer):
    """Adam, its bias correction folded into the step size from the
    index's own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def _lr_t(self, index):
        lr = self._get_lr(index)
        t = self._index_update_count[index]
        return lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        mean, var = state
        sparse = _sparse_grad(grad)
        if sparse is not None:   # the lazy update: only the gradient's rows
            rows, g = sparse
            g = g * self.rescale_grad
            if self.clip_gradient:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            g = g + _t(weight).index_select(0, rows) * wd
            m_new = _t(mean).index_select(0, rows) * self.beta1 \
                + g * (1 - self.beta1)
            v_new = _t(var).index_select(0, rows) * self.beta2 \
                + (g * g) * (1 - self.beta2)
            _set_rows(mean, rows, m_new)
            _set_rows(var, rows, v_new)
            _add_rows(weight, rows, (m_new * -self._lr_t(index))
                      / (torch.sqrt(v_new) + self.epsilon))
            return
        _uo.adam_update(weight, grad, mean, var, self._lr_t(index),
                        beta1=self.beta1, beta2=self.beta2,
                        epsilon=self.epsilon, wd=wd,
                        **self._common_kwargs(index))


@register
class AdaGrad(Optimizer):
    """AdaGrad (``eps`` inside the square root)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        sparse = _sparse_grad(grad)
        if sparse is not None:   # lazy, and (as the JAX package's) no wd
            rows, g = sparse
            g = g * self.rescale_grad
            h_new = _t(state).index_select(0, rows) + g * g
            _set_rows(state, rows, h_new)
            _add_rows(weight, rows, (g * -lr)
                      / torch.sqrt(h_new + self.float_stable_eps))
            return
        _uo.adagrad_update(weight, grad, state, lr,
                           epsilon=self.float_stable_eps, wd=wd,
                           **self._common_kwargs(index))


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered`` is Graves' variant with ``gamma2``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like_state(weight) for _ in range(3))
        return (_zeros_like_state(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(gamma1=self.gamma1, epsilon=self.epsilon, wd=wd,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip(),
                  clip_weights=self.clip_weights if self.clip_weights
                  else -1.0)
        if self.centered:
            n, g, delta = state
            _uo.rmspropalex_update(weight, grad, n, g, delta, lr,
                                   gamma2=self.gamma2, **kw)
        else:
            (n,) = state
            _uo.rmsprop_update(weight, grad, n, lr, **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = state
        g = self._rescaled(grad, weight, wd)
        ag = _t(acc_g) * self.rho + (g * g) * (1 - self.rho)
        delta = torch.sqrt(_t(acc_delta) + self.epsilon) \
            / torch.sqrt(ag + self.epsilon) * g
        ad = _t(acc_delta) * self.rho + (delta * delta) * (1 - self.rho)
        _write(acc_g, ag)
        _write(acc_delta, ad)
        _write(weight, _t(weight) - delta)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (proximal)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        _uo.ftrl_update(weight, grad, z, n, lr, lamda1=self.lamda1,
                        beta=self.beta, wd=wd, **self._common_kwargs(index))


@register
class Adamax(Optimizer):
    """Adam with the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr / (1.0 - self.beta1 ** t)
        m, u = state
        g = self._rescaled(grad, weight, wd)
        m_new = _t(m) * self.beta1 + g * (1 - self.beta1)
        u_new = torch.maximum(_t(u) * self.beta2, torch.abs(g))
        _write(m, m_new)
        _write(u, u_new)
        _write(weight, _t(weight) - (m_new * lr_t) / (u_new + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam; ``m_schedule`` is host state that moves with every
    update, in index order."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like_state(weight), _zeros_like_state(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._rescaled(grad, weight, wd)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        m_new = _t(m) * self.beta1 + g * (1 - self.beta1)
        v_new = _t(v) * self.beta2 + (g * g) * (1 - self.beta2)
        g_prime = g / (1 - self.m_schedule)
        m_prime = m_new / (1 - m_schedule_next)
        v_prime = v_new / (1 - self.beta2 ** t)
        m_bar = g_prime * (1 - momentum_t) + m_prime * momentum_t_1
        _write(m, m_new)
        _write(v, v_new)
        _write(weight, _t(weight) - (m_bar * lr)
               / (torch.sqrt(v_prime) + self.epsilon))


@register
class LBSGD(SGD):
    """Large-batch SGD with the LARS trust ratio (``warmup_strategy=
    'lars'``); reads the weight and gradient norms on the host."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.adaptive = warmup_strategy == "lars"

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        wn = float(torch.linalg.norm(_t(weight).reshape(-1)))
        gn = float(torch.linalg.norm(_t(grad).reshape(-1))) \
            * self.rescale_grad
        if wn > 0 and gn > 0 and self.adaptive:
            lr = lr * min(wn / (gn + wd * wn + 1e-9), 1.0)
        if state is None:
            _uo.sgd_update(weight, grad, lr, wd=wd,
                           **self._common_kwargs(index))
        else:
            _uo.sgd_mom_update(weight, grad, state, lr,
                               momentum=self.momentum, wd=wd,
                               **self._common_kwargs(index))


@register
class Test(Optimizer):
    """Plumbing test: ``w += rescale * g``; the state holds the new w."""

    def create_state(self, index, weight):
        return _zeros_like_state(weight)

    def update(self, index, weight, grad, state):
        _write(weight, _t(weight) + _t(grad) * self.rescale_grad)
        _write(state, _t(weight))


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one history value per row (the mean of the squared
    gradient over the other axes), for large embeddings."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return NDArray(torch.zeros(weight.shape[0], dtype=weight._data.dtype,
                                   device=weight._data.device))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        sparse = _sparse_grad(grad)
        g = _t(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        red = tuple(range(1, g.ndim))
        if sparse is not None:   # the lazy update: only the gradient's rows
            rows = sparse[0]
            h_new = _t(state).index_select(0, rows) + (
                torch.mean(g * g, dim=red) if red else g * g)
            _set_rows(state, rows, h_new)
            div = torch.sqrt(h_new + self.float_stable_eps)
            _add_rows(weight, rows, (g * -lr)
                      / div.reshape((-1,) + (1,) * (g.ndim - 1)))
            return
        h_new = _t(state) + torch.mean(g * g, dim=red) if red \
            else _t(state) + g * g
        _write(state, h_new)
        div = torch.sqrt(h_new + self.float_stable_eps)
        _write(weight, _t(weight) - (g * lr)
               / div.reshape((-1,) + (1,) * (g.ndim - 1)))


class Updater:
    """Per-index optimizer state applying one optimizer."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def _state(self, index, weight):
        """The index's state, created on first use; restored states move to
        the weight's device and type on their first use."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, False):
            dtype = torch.float32 if self.optimizer._mp(weight) \
                else weight._data.dtype
            self.states[index] = _place(self.states[index],
                                        weight._data.device, dtype)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def update_batch(self, indices, grads, weights):
        """One step for many (index, grad, weight) triples, in index order
        (``FusedUpdater`` groups them)."""
        for i, g, w in zip(indices, grads, weights):
            self(i, g, w)

    def get_states(self, dump_optimizer=False):
        state = {k: _state_to_numpy(v) for k, v in self.states.items()}
        if not dump_optimizer:
            return pickle.dumps(state)
        # the live param_dict holds Parameters and their modules; every
        # load path rebinds it to the live parameters
        pd, self.optimizer.param_dict = self.optimizer.param_dict, {}
        try:
            return pickle.dumps((state, self.optimizer))
        finally:
            self.optimizer.param_dict = pd

    def set_states(self, states):
        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            obj, self.optimizer = obj
        self.set_numpy_states(obj)

    def set_numpy_states(self, obj):
        """Take ``{index: numpy state}`` (None, an array, or tuples of
        them) as this updater's states."""
        self.states = {k: _state_from_numpy(v) for k, v in obj.items()}
        self.states_synced = {k: False for k in self.states}


def _state_to_numpy(v):
    if v is None:
        return None
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, (tuple, list)):
        return tuple(_state_to_numpy(x) for x in v)
    return v


def _state_from_numpy(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_state_from_numpy(x) for x in v)
    if isinstance(v, _np.ndarray):
        return NDArray(torch.from_numpy(_np.array(v, copy=True)))
    return v


def _place(v, device, dtype):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_place(x, device, dtype) for x in v)
    t = v._data
    if t.is_floating_point():
        t = t.to(device=device, dtype=dtype)
    return NDArray(t.to(device))


def get_updater(optimizer: Optimizer) -> Updater:
    """A ``FusedUpdater``: its batch path updates the parameters in groups
    with ``torch._foreach_*`` ops; its per-index path is ``Updater``'s."""
    from .optimizer_fused import FusedUpdater
    return FusedUpdater(optimizer)


# mx.optimizer.contrib: the reference's contrib optimizer namespace
contrib = _types.ModuleType(__name__ + ".contrib")
contrib.GroupAdaGrad = GroupAdaGrad
contrib.__all__ = ["GroupAdaGrad"]
_sys.modules[contrib.__name__] = contrib
