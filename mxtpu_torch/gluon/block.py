"""Block / HybridBlock as ``torch.nn.Module`` (counterpart of
``mxtpu/gluon/block.py``).

The reference's auto-naming is kept (``_BlockScope``, ``name_scope()``), so
``collect_params()`` gives the JAX package's names, e.g.
``resnetv10_conv2d0_weight``. Children are ``nn.Module`` submodules and
parameter tensors live in ``nn.Module._parameters`` (see parameter.py).
``HybridBlock.forward`` runs ``hybrid_forward(F, x, **params)`` with ``F``
the port's op namespace, which works on tensors: ``net(tensor)`` returns
tensors (the Predictors feed them), and ``net(ndarray)`` runs the same
forward on the arrays' tensors, taped only under ``autograd.record()``,
and returns NDArrays. ``hybridize()`` does nothing yet: PyTorch runs
eagerly, and CUDA-graph capture comes in a later slice.
"""
from __future__ import annotations

import threading

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Auto-naming of blocks/parameters (ref: gluon/block.py:_BlockScope)."""

    _current = threading.local()

    def __init__(self, block=None):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, hint):
        """(block prefix, its ParameterDict) for a new block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = "%s%d_" % (hint, _NameManager.next(hint))
            return prefix, ParameterDict(prefix)
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        parent = current._block.params
        return (current._block.prefix + prefix,
                ParameterDict(parent.prefix + prefix))

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class _NameManager:
    _lock = threading.Lock()
    _counts = {}

    @classmethod
    def next(cls, hint):
        with cls._lock:
            c = cls._counts.get(hint, 0)
            cls._counts[hint] = c + 1
            return c


class Block(nn.Module):
    """Base container for layers and models (ref: gluon/block.py:Block)."""

    def __init__(self, prefix=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, self._alias())
        self._name = (self._prefix[:-1] if self._prefix.endswith("_")
                      else self._prefix)
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            value._attach(self, name)
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """Name scope for creating children (ref: block.py:name_scope)."""
        return self._scope

    @property
    def params(self):
        return self._params

    def _child_blocks(self):
        return [m for m in self._modules.values() if isinstance(m, Block)]

    def collect_params(self):
        """All Parameters of this block and its children, by full name."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._child_blocks():
            ret.update(child.collect_params())
        return ret

    def register_child(self, block, name=None):
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def initialize(self, init=None, ctx=None, force_reinit=False,
                   generator=None):
        """Initialize every parameter on ``ctx`` (default: the CUDA device,
        or raise), drawing from ``generator`` (default: a new one seeded
        0)."""
        self.collect_params().initialize(init, ctx, force_reinit, generator)

    def hybridize(self, active=True, **kwargs):
        for child in self._child_blocks():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._child_blocks():
            child.cast(dtype)
        for p in self.params.values():
            p.cast(dtype)
        return self

    def forward(self, *args):  # pragma: no cover - abstract
        raise NotImplementedError


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, **params)``
    (ref: block.py:HybridBlock)."""

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from the inputs; leaf layers
        override it."""
        raise MXNetError(
            "Deferred initialization failed: %s cannot infer parameter "
            "shapes from its inputs" % self.__class__.__name__)

    def forward(self, *args):
        for a in args:
            if isinstance(a, NDArray):
                return self._forward_nd(args)
        try:
            params = {k: p._tensor() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            params = {k: p._tensor() for k, p in self._reg_params.items()}
        from .. import ops as F
        return self.hybrid_forward(F, *args, **params)

    def _forward_nd(self, args):
        """NDArrays in and out: the forward on their tensors, taped only
        while recording (as ``ndarray._apply`` runs an op)."""
        args = [a._data if isinstance(a, NDArray) else a for a in args]
        with torch.set_grad_enabled(autograd.is_recording()):
            out = self.forward(*args)
        if isinstance(out, (tuple, list)):
            return type(out)(NDArray(o) for o in out)
        return NDArray(out)

    def hybrid_forward(self, F, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError
