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
and returns NDArrays. ``hybridize()`` turns on a ``CachedOp``: on a
CUDA device, one captured CUDA graph per input signature and train/predict
mode for calls made while autograd is not recording (``graphs.CapturedGraph``,
the helper the serving Predictor's buckets use); a recording call and any
call on the CPU run eagerly, with the same numbers.

``reading_params(fn)`` makes every layer forward on this thread read each
parameter tensor ``t`` as ``fn(t)``: the int8 Predictor dequantizes
there, so each float copy lives only through the layer that uses it.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from .. import autograd, graphs, telemetry
from ..base import MXNetError
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedOp", "reading_params",
           "read_params"]

_PARAM_READ = threading.local()


@contextlib.contextmanager
def reading_params(fn):
    """Within the context a layer forward on this thread passes each of
    its parameter tensors through ``fn`` (``None``: read them as they
    are)."""
    prev = getattr(_PARAM_READ, "fn", None)
    _PARAM_READ.fn = fn
    try:
        yield
    finally:
        _PARAM_READ.fn = prev


def read_params(block):
    """``{attribute: tensor}`` of ``block``'s own parameters as its layer
    forward reads them: each through this thread's ``reading_params``
    function, where one is set."""
    params = {k: p._tensor() for k, p in block._reg_params.items()}
    read = getattr(_PARAM_READ, "fn", None)
    if read is not None:
        params = {k: read(t) for k, t in params.items()}
    return params


def _flatten(out, fmt):
    """Flatten nested tuples/lists of tensors, recording their structure
    in ``fmt`` (the reference's ``_flatten_nd`` codes: 0 a tensor, -1
    None, n a sequence of n, -2 an opaque value)."""
    if isinstance(out, torch.Tensor):
        fmt.append(0)
        return [out]
    if out is None:
        fmt.append(-1)
        return []
    if isinstance(out, (list, tuple)):
        fmt.append(len(out))
        flat = []
        for o in out:
            flat.extend(_flatten(o, fmt))
        return flat
    fmt.append(-2)
    return [out]


def _regroup(flat, fmt, pos=0, idx=0):
    """Inverse of ``_flatten``; returns (value, new_pos, new_idx)."""
    code = fmt[idx]
    if code in (0, -2):
        return flat[pos], pos + 1, idx + 1
    if code == -1:
        return None, pos, idx + 1
    items = []
    idx += 1
    for _ in range(code):
        v, pos, idx = _regroup(flat, fmt, pos, idx)
        items.append(v)
    return tuple(items), pos, idx


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


class CachedOp:
    """Captured forwards of a hybridized block (ref: block.py:CachedOp):
    one CUDA graph per input signature (shapes, dtypes, device) and
    ``autograd.is_training()``, reported at retrace site ``cached_op``.
    The graph reads the block's parameter tensors at the addresses it was
    captured with: an optimizer step writes them in place and is seen,
    and a tensor replaced since (a ``set_data``) is copied into the
    captured storage, which the parameter then shares, before the replay.
    One call at a time holds the static inputs, the replay and the copies
    of its outputs."""

    def __init__(self, block):
        self._block = block
        self._graphs = {}
        self._out_fmt = []
        self._lock = threading.Lock()

    def __call__(self, *args):
        key = (autograd.is_training(),) + tuple(
            (tuple(a.shape), a.dtype, a.device) for a in args)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(key, args)
            graph, params, fmt = entry
            for p, t in params:
                cur = p._tensor()
                if cur.data_ptr() != t.data_ptr():
                    with torch.no_grad():
                        t.copy_(cur)
                    p._put(t)
            for static, a in zip(graph.static_inputs, args):
                static.copy_(a)
            flat = [o.clone() if isinstance(o, torch.Tensor) else o
                    for o in graph.replay()]
        return _regroup(flat, fmt)[0]

    def _forward(self, *args):
        fmt = []
        flat = _flatten(self._block._forward_eager(*args), fmt)
        self._out_fmt = fmt
        return flat

    def _capture(self, key, args):
        block = self._block
        statics = [a.detach().clone() for a in args]
        with torch.no_grad():   # the warm-up run settles deferred shapes
            graph = graphs.CapturedGraph(self._forward, statics)
        params = [(p, p._tensor()) for p in block.collect_params().values()]
        telemetry.record_retrace("cached_op", {
            "block": type(block).__name__, "training": key[0],
            "shapes": [list(k[0]) for k in key[1:]]})
        self._graphs[key] = (graph, params, list(self._out_fmt))
        return self._graphs[key]


class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, **params)``
    (ref: block.py:HybridBlock)."""

    _active = False      # hybridize() sets both on the instance
    _cached_op = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Capture the forward per input signature on CUDA devices (ref:
        block.py:hybridize; ``static_alloc``/``static_shape`` are what a
        captured graph does anyway and are accepted for the reference's
        API). Drops the graphs captured so far."""
        self._active = bool(active)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def cast(self, dtype):
        self._cached_op = None
        return super().cast(dtype)

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
        if self._active and not graphs.capturing() \
                and not autograd.is_recording() and args and all(
                    isinstance(a, torch.Tensor) and a.device.type == "cuda"
                    for a in args):
            if self._cached_op is None:
                self._cached_op = CachedOp(self)
            with torch.no_grad():
                return self._cached_op(*args)
        return self._forward_eager(*args)

    def _forward_eager(self, *args):
        try:
            params = read_params(self)
        except DeferredInitializationError:
            self.infer_shape(*args)
            params = read_params(self)
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
