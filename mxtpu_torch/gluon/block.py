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
the helper the serving Predictor's buckets use), and for a call made under
``autograd.record()`` a captured forward/backward pair
(``graphs.CapturedPair``) taped as one node, as the reference tapes its
jitted forward with a jitted backward. A call on the CPU, and the
deferred-init first call, run eagerly, with the same numbers.

``save_parameters``/``load_parameters`` write and read ``.params`` files
by attribute path (``features.0.weight``), in the reference's byte format
(``ndarray/utils.py``).

``reading_params(fn)`` makes every layer forward on this thread read each
parameter tensor ``t`` as ``fn(t)``: the int8 Predictor dequantizes
there, so each float copy lives only through the layer that uses it.

``HybridBlock.export`` writes the reference's ``-symbol.json`` and
``.params`` files: the forward traced into a Symbol (``symbol.trace_block``
hands ``hybrid_forward`` a recording ``F`` while it runs on a thread;
otherwise the check costs one thread-local read). ``SymbolBlock`` runs a
Symbol as a block, and ``SymbolBlock.imports`` loads such files.
"""
from __future__ import annotations

import contextlib
import functools
import re
import threading
import weakref

import torch
from torch import nn

from .. import autograd, compile_service, graphs
from ..base import MXNetError
from ..ndarray import NDArray
from ..symbol.symbol import _SYM_TAPE, recording_f
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp",
           "reading_params", "read_params"]

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
    function, where one is set, then through the parameter's own
    ``_read`` function, where it has one (``ShardedTrainStep`` gives a
    parameter held as this rank's shard one that reads it whole)."""
    params = {k: p._tensor() for k, p in block._reg_params.items()}
    read = getattr(_PARAM_READ, "fn", None)
    if read is not None:
        params = {k: read(t) for k, t in params.items()}
    for k, p in block._reg_params.items():
        if p._read is not None:
            params[k] = p._read(params[k])
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


def _map_leaves(obj, fn):
    """``obj`` with every leaf of its nested lists and tuples passed
    through ``fn`` (the containers' types kept)."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_leaves(o, fn) for o in obj)
    return fn(obj)


def _tensors_only(flat, fmt):
    """Whether ``_flatten`` found tensors alone: no None, no opaque value
    and no empty sequence (whose code 0 reads back as a tensor)."""
    return bool(flat) and all(isinstance(a, torch.Tensor) for a in flat) \
        and fmt.count(0) == len(flat) and min(fmt) >= 0


class _BlockScope:
    """Auto-naming of blocks/parameters (ref: gluon/block.py:_BlockScope)."""

    _current = threading.local()

    def __init__(self, block=None):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """(block prefix, its ParameterDict) for a new block; ``params``
        (another block's dict) is shared: the new dict takes its prefix
        and hands out its parameters."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = "%s%d_" % (hint, _NameManager.next(hint))
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

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

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = (self._prefix[:-1] if self._prefix.endswith("_")
                      else self._prefix)
        self._scope = _BlockScope(self)
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        children = [(k, b) for k, b in self._modules.items()
                    if isinstance(b, Block)]
        if not children:
            return "%s()" % self.__class__.__name__
        return "%s(\n%s\n)" % (self.__class__.__name__, "\n".join(
            "  (%s): %s" % (k, _indent(repr(b), 2)) for k, b in children))

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

    def collect_params(self, select=None):
        """All Parameters of this block and its children, by full name;
        ``select`` (a regular expression) keeps the names it matches from
        their start (ref: block.py:collect_params)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pattern.match(n)})
        for child in self._child_blocks():
            ret.update(child.collect_params(select=select))
        return ret

    def register_forward_hook(self, hook):
        """``hook(block, inputs, output)`` after every call; returns a
        handle whose ``detach()`` removes it (ref: block.py)."""
        return _HookHandle(super().register_forward_hook(hook))

    def register_forward_pre_hook(self, hook):
        """``hook(block, inputs)`` before every call; returns a handle
        whose ``detach()`` removes it."""
        return _HookHandle(super().register_forward_pre_hook(hook))

    def summary(self, *inputs):
        """Print each block's output shape and parameter count for one
        call on ``inputs``, in the order the calls end, then the total
        (ref: block.py:summary)."""
        rows = []

        def hook(block, inp, out):
            first = out[0] if isinstance(out, (list, tuple)) else out
            shape = getattr(first, "shape", None)
            rows.append((block.__class__.__name__ + "-" + str(len(rows) + 1),
                         None if shape is None else tuple(shape),
                         _count(block.params.values())))

        handles = []
        self.apply(lambda b: handles.append(b.register_forward_hook(hook)))
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        line = "%-30s %-24s %-12s"
        print(line % ("Layer (type)", "Output Shape", "Param #"))
        print("=" * 68)
        for name, shape, n in rows:
            print(line % (name, str(shape), n))
        print("=" * 68)
        print("Total params: %d" % _count(self.collect_params().values()))

    def register_child(self, block, name=None):
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, generator=None):
        """Initialize every parameter on ``ctx`` (default: the CUDA device,
        or raise), drawing from ``generator`` (default: a new one seeded
        0). ``verbose`` is accepted and unused, as the reference's."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator=generator)

    def hybridize(self, active=True, **kwargs):
        for child in self._child_blocks():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._child_blocks():
            child.cast(dtype)
        for p in self.params.values():
            p.cast(dtype)
        return self

    def save_parameters(self, filename):
        """Write every parameter to ``filename`` under its attribute path
        (``features.0.weight``), so the file does not depend on the
        block's prefix (ref: block.py:save_parameters)."""
        from ..ndarray.utils import save as nd_save
        nd_save(filename, {k: v.data() for k, v in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load ``filename`` (either package's file) by attribute path,
        through ``set_data``: the values land on each parameter's device,
        and a hybridized block's graphs and a Trainer's captured update
        read them at the next replay. ``ctx`` is accepted for the
        reference's API."""
        from ..context import cpu
        from ..ndarray.utils import load as nd_load
        with cpu():   # staged on the host; set_data moves each array
            loaded = nd_load(filename)
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("Parameter %s missing in %s"
                                     % (name, filename))
        for name, v in loaded.items():
            if name not in params:
                if ignore_extra:
                    continue
                raise MXNetError("Parameter %s in file not found in Block"
                                 % name)
            params[name].set_data(v)
        return self

    save_params = save_parameters   # the reference's names before 1.3
    load_params = load_parameters

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def forward(self, *args):  # pragma: no cover - abstract
        raise NotImplementedError


class _HookHandle:
    """A forward hook's handle with the reference's ``detach()``."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()


def _count(params):
    """Elements of the initialized parameters among ``params``."""
    return sum(p._tensor().numel() for p in params if p.initialized)


def _indent(s, n):
    return ("\n" + " " * n).join(s.split("\n"))


def _signature(args):
    return tuple((tuple(a.shape), a.dtype, a.device, a.requires_grad)
                 for a in args)


class _Pair:
    """A ``graphs.CapturedPair`` and its bookkeeping: the parameters it
    was captured with, and whether a taped call still holds its
    activations (``busy``: from its forward replay until its backward
    replay or the tape node's release, whichever comes first). ``gen``
    counts forward replays, so a backward for an older one raises."""

    def __init__(self, graphs_pair, params, diff_params, fmt, lock):
        self.graphs = graphs_pair
        self.params = params                        # [(weakref, tensor)]
        self.diff_params = [weakref.ref(p) for p in diff_params]
        self.fmt = fmt
        self.lock = lock
        self.busy = False
        self.gen = 0

    def release(self, gen):
        if self.gen == gen:
            self.busy = False


class _Held:
    """Held by a taped call's autograd context; its finalizer frees the
    pair when the tape node goes away without a backward."""


class _Recorded(torch.autograd.Function):
    """One taped node for a recorded call of a hybridized block (the
    reference's ``record_op(..., name="CachedOp")``): its forward copies
    the inputs into the pair's static inputs and replays the forward
    graph; its backward copies the cotangents into the static ones,
    replays the backward graph and returns copies of the gradients."""

    @staticmethod
    def forward(ctx, pair, n_args, *tensors):
        pair.busy = True
        pair.gen += 1
        ctx.pair, ctx.gen, ctx.n_args = pair, pair.gen, n_args
        ctx.held = _Held()
        weakref.finalize(ctx.held, pair.release, pair.gen)
        fwd = pair.graphs.forward
        for static, a in zip(fwd.static_inputs, tensors[:n_args]):
            static.copy_(a)
        outs = [o.clone() for o in fwd.replay()]
        ctx.mark_non_differentiable(*[
            o for k, o in enumerate(outs)
            if k not in pair.graphs.diff_outputs])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        pair = ctx.pair
        with pair.lock:
            if pair.gen != ctx.gen:
                raise MXNetError(
                    "a hybridized block's recorded call was replayed again "
                    "before this backward (backward twice with "
                    "retain_graph=True across another forward): its "
                    "activations are gone")
            for static, k in zip(pair.graphs.cotangents,
                                 pair.graphs.diff_outputs):
                if grads[k] is None:
                    static.zero_()
                else:
                    static.copy_(grads[k])
            got = [None if g is None else g.clone()
                   for g in pair.graphs.backward.replay()]
            pair.busy = False
        n_in = ctx.n_args
        needs = ctx.needs_input_grad[2:]
        in_grads = []
        it = iter(got)
        for k in range(n_in):
            g = next(it) if pair.graphs.forward.static_inputs[k].requires_grad \
                else None
            in_grads.append(g if needs[k] else None)
        param_grads = list(it)
        return (None, None) + tuple(in_grads) + tuple(param_grads)


class CachedOp:
    """Captured calls of a hybridized block (ref: block.py:CachedOp).

    The inputs may nest lists and tuples of tensors (a recurrent layer's
    ``(inputs, [h, c])``): they are flattened with ``_flatten`` and the
    structure joins the key, as the outputs' is regrouped with
    ``_regroup``. Calls made while autograd is not recording: one CUDA
    graph per input signature (structure, shapes, dtypes, device) and
    ``autograd.is_training()``.
    Recorded calls (``autograd.record()``): a ``graphs.CapturedPair`` per
    signature, with the inputs' ``requires_grad``, and train mode, taped as
    one node (``_Recorded``); a call made while every pair of its
    signature holds another call's activations (two forwards before one
    backward) captures one more. Each capture is one build at retrace
    site ``cached_op`` (a pair counts once). The graphs read the block's
    parameter tensors at the addresses they were captured with: an
    optimizer step writes them in place and is seen, and a tensor replaced
    since (a ``set_data``) is copied into the captured storage, which the
    parameter then shares, before the replay. BatchNorm's running
    statistics move once per call, in the forward graph. A block with a
    layer that draws (``_draws``: a Dropout) has its device's generator
    (``random.generator``) registered with each graph, so every replay
    draws a fresh mask and a pair's backward reuses its forward's. One
    call at a time holds the static inputs, the replay and the copies of
    its outputs.

    Graphs and pairs resolve through the compile service at site
    ``cached_op``: the key is the block's repr and class source
    (``_fn_token``), the signature (``("graph", key)`` or ``("pair", key,
    i)``, the i-th pair of a signature), ``compile_service.
    forward_policy()``, the device and this CachedOp's nonce; ``_graphs``
    and ``_pairs`` are views over the service's store."""

    def __init__(self, block):
        self._block = block
        self._nonce = nonce = compile_service.release_on_collect(self)
        self._graphs = compile_service.SiteTable(
            lambda k: k.nonce == nonce and k.signature[0] == "graph",
            name=lambda k: k.signature[1])
        self._pairs = compile_service.SiteTable(
            lambda k: k.nonce == nonce and k.signature[0] == "pair",
            name=lambda k: k.signature[1], multi=True)
        self._fn_tok = None
        self._out_fmt = []
        self._takes_grad = None
        self._lock = threading.RLock()

    def _fn_token(self):
        tok = self._fn_tok
        if tok is None:
            block = self._block
            tok = self._fn_tok = "cached_op:%s:%s:%s" % (
                type(block).__name__,
                compile_service.source_token(type(block)),
                compile_service.source_token(repr(block))[:12])
        return tok

    def _key(self, signature, device):
        return compile_service.canonical_key(
            site="cached_op", fn_id=self._fn_token(), signature=signature,
            policy=compile_service.forward_policy(),
            device=compile_service.device_token(device), nonce=self._nonce)

    def __call__(self, *args):
        in_fmt = []
        flat = _flatten(args, in_fmt)
        key = (autograd.is_training(),) + tuple(
            (tuple(a.shape), a.dtype, a.device) for a in flat) + (
                tuple(in_fmt),)
        with self._lock:
            graph, params, fmt = compile_service.get_or_build(
                self._key(("graph", key), flat[0].device),
                lambda: self._capture(key, flat, in_fmt),
                provenance=lambda: self._provenance(key, False)).fn
            self._refresh(params)
            for static, a in zip(graph.static_inputs, flat):
                static.copy_(a)
            flat = [o.clone() if isinstance(o, torch.Tensor) else o
                    for o in graph.replay()]
        return _regroup(flat, fmt)[0]

    def record(self, *args):
        """A recorded call: the forward graph's outputs, taped as one node
        whose backward is the backward graph."""
        if self._takes_grad is None:
            self._takes_grad = any(p.grad_req != "null" for p in
                                   self._block.collect_params().values())
        in_fmt = []
        flat_in = _flatten(args, in_fmt)
        if not self._takes_grad and not any(a.requires_grad
                                            for a in flat_in):
            with torch.no_grad():   # nothing to differentiate: no tape
                return self(*args)
        key = (True, autograd.is_training()) + _signature(flat_in) + (
            tuple(in_fmt),)
        with self._lock:
            i = 0
            while True:   # the first pair of the signature not in use
                pair = compile_service.get_or_build(
                    self._key(("pair", key, i), flat_in[0].device),
                    lambda: self._capture_pair(key, flat_in, in_fmt),
                    provenance=lambda: self._provenance(key, True)).fn
                if not pair.busy:
                    break
                i += 1
            self._refresh(pair.params)
            tensors = flat_in + [p()._tensor() for p in pair.diff_params]
            with torch.enable_grad():
                flat = _Recorded.apply(pair, len(flat_in), *tensors)
        return _regroup(list(flat), pair.fmt)[0]

    @staticmethod
    def _refresh(params):
        for ref, t in params:
            p = ref()
            cur = p._tensor()
            if cur.data_ptr() != t.data_ptr():
                with torch.no_grad():
                    t.copy_(cur)
                p._put(t)

    def _forward(self, in_fmt, *flat):
        args = _regroup(list(flat), in_fmt)[0]
        fmt = []
        flat = _flatten(self._block._forward_eager(*args), fmt)
        self._out_fmt = fmt
        return flat

    def _provenance(self, key, recording):
        block = self._block
        return {"block": type(block).__name__, "train": key[int(recording)],
                "recording": recording,
                "shapes": [list(k[0]) for k in key[1 + int(recording):-1]]}

    def _state(self):
        """(every (parameter, tensor) of the block, the tensors a forward
        moves in place: those that take no gradient). The parameters are
        held by weak references: the compile service's store keeps the
        graphs and must not keep the block alive through them."""
        params = [(weakref.ref(p), p._tensor())
                  for p in self._block.collect_params().values()]
        return params, [t for _, t in params if not t.requires_grad]

    def _generators(self, device):
        """The generator of ``device`` where a layer of the block draws."""
        if any(getattr(m, "_draws", False) for m in self._block.modules()):
            from .. import random
            return (random.generator(device),)
        return ()

    def _capture(self, key, args, in_fmt):
        statics = [a.detach().clone() for a in args]
        params, keep = self._state()
        with torch.no_grad(), graphs.keeping(keep), graphs.ledger_site(
                "cached_op", self._provenance(key, False)):
            graph = graphs.CapturedGraph(
                functools.partial(self._forward, in_fmt), statics,
                generators=self._generators(statics[0].device))
        return graph, params, list(self._out_fmt)

    def _capture_pair(self, key, args, in_fmt):
        statics = [a.detach().clone().requires_grad_(a.requires_grad)
                   for a in args]
        params, keep = self._state()
        by_ptr = {t.data_ptr(): t for _, t in params}
        outer = getattr(_PARAM_READ, "fn", None)

        def captured(t):   # the tensors captured, whatever the parameter
            t = by_ptr.get(t.data_ptr(), t)   # holds now (same storage)
            return t if outer is None else outer(t)

        def forward(*xs):
            with reading_params(captured):
                return self._forward(in_fmt, *xs)

        diff = [(r(), t) for r, t in params if t.requires_grad]
        with graphs.ledger_site("cached_op", self._provenance(key, True)):
            captured_pair = graphs.CapturedPair(
                forward, statics, [t for _, t in diff], keep,
                generators=self._generators(statics[0].device))
        pair = _Pair(captured_pair, params, [p for p, _ in diff],
                     list(self._out_fmt), self._lock)
        if any(not isinstance(o, torch.Tensor)
               for o in pair.graphs.forward.outputs):
            raise MXNetError("a recorded call of a hybridized %s returns a "
                             "value that is not a tensor"
                             % type(self._block).__name__)
        return pair


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
        fmt = []
        flat = _flatten(args, fmt)
        if any(isinstance(a, NDArray) for a in flat):
            return self._forward_nd(args)
        if self._active and not graphs.capturing() \
                and _tensors_only(flat, fmt[1:]) \
                and _SYM_TAPE.active is None \
                and graphs.captures(flat[0].device):
            if self._cached_op is None:
                if not self._params_ready():
                    return self._forward_eager(*args)
                self._cached_op = CachedOp(self)
            if autograd.is_recording():
                return self._cached_op.record(*args)
            with torch.no_grad():
                return self._cached_op(*args)
        return self._forward_eager(*args)

    def _params_ready(self):
        """False until every parameter's shape is known: the deferred-init
        first call runs eagerly and settles them (as the reference's)."""
        return all(p.initialized for p in self.collect_params().values())

    def _forward_eager(self, *args):
        try:
            params = read_params(self)
        except DeferredInitializationError:
            self.infer_shape(*args)
            params = read_params(self)
        # the last eager call's input signature, which export traces with
        self.__dict__["_in_specs"] = [(tuple(a.shape), a.dtype) for a in args
                                      if isinstance(a, torch.Tensor)]
        if _SYM_TAPE.active is not None:
            return self.hybrid_forward(recording_f(), *args, **params)
        from .. import ops as F
        return self.hybrid_forward(F, *args, **params)

    def _forward_nd(self, args):
        """NDArrays in and out (also nested in lists and tuples): the
        forward on their tensors, taped only while recording (as
        ``ndarray._apply`` runs an op)."""
        args = _map_leaves(args, lambda a: a._data if isinstance(a, NDArray)
                           else a)
        with torch.set_grad_enabled(autograd.taping()):
            out = self.forward(*args)
        return _map_leaves(out, lambda o: NDArray(o)
                           if isinstance(o, torch.Tensor) else o)

    def hybrid_forward(self, F, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (parameters
        as ``arg:name``, those without a gradient as ``aux:name``), the
        reference's checkpoint layout (ref: block.py:export). The forward
        is traced at the last eager call's input signature, so the block
        must have run at least once. Returns the Symbol."""
        from ..ndarray.utils import save as nd_save
        from ..symbol import trace_block
        sym, _ = trace_block(self)
        sym.save("%s-symbol.json" % path)
        arrays = {("aux:" if p.grad_req == "null" else "arg:") + name:
                  p.data() for name, p in self.collect_params().items()}
        nd_save("%s-%04d.params" % (path, epoch), arrays)
        return sym


_LOW_PRECISION = ("float16", "bfloat16")


class SymbolBlock(HybridBlock):
    """Run a Symbol as a block (ref: gluon/block.py:SymbolBlock:954).

    Every free variable of ``outputs`` that is not one of ``inputs`` becomes
    a Parameter of the variable's name (``grad_req='null'`` for the moving
    statistics), held as an attribute of that name, so a Predictor's
    parameter snapshot and ``reading_params`` cover them. The forward runs
    the symbol on tensors through each op's tensor function, so a
    hybridized SymbolBlock and a Predictor capture it like any block.
    Training-mode BatchNorm normalizes by the batch statistics and does not
    move the moving ones, as the reference's SymbolBlock."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=None)
        # parameter names are the symbol's variable names
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(outputs, (list, tuple)):
            from ..symbol import Group
            outputs = outputs[0] if len(outputs) == 1 else Group(outputs)
        self._output_sym = outputs
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._input_names = [s.name for s in inputs]
        aux = set(outputs.list_auxiliary_states())
        self._names = {}   # attribute -> variable name
        for name in outputs.list_inputs():
            if name in self._input_names:
                continue
            attr = name.replace(".", "_")
            if attr in self._names or hasattr(self, attr):
                raise MXNetError("SymbolBlock: variable %r clashes with an "
                                 "attribute of the block" % name)
            p = self._params.get(name, allow_deferred_init=True,
                                 grad_req="null" if name in aux else "write")
            setattr(self, attr, p)
            self._names[attr] = name
        from ..symbol.symbol import _topo, draws
        nodes = [n for n in _topo(outputs._heads) if not n.is_var()]
        self._draws = draws(outputs)
        # statistics and affine inputs of BatchNorm stay float32 on a cast
        self._float32 = {inp.name for n in nodes if n.op == "BatchNorm"
                         for inp, _ in n.inputs[1:] if inp.is_var()}

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file`` (either package's) with its
        parameters from ``param_file`` on ``ctx`` (default: the CUDA
        device, or raise) (ref: SymbolBlock.imports)."""
        from .. import symbol as sym_mod
        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [sym_mod.var(n) for n in input_names])
        ret.collect_params().reset_ctx(ctx)
        if param_file is not None:
            ret.collect_params().load(param_file, ctx=ctx)
        return ret

    def infer_shape(self, *args):
        shapes = dict(zip(self._input_names, (tuple(a.shape) for a in args)))
        sym = self._output_sym
        arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
        known = dict(zip(sym.list_arguments(), arg_shapes))
        known.update(zip(sym.list_auxiliary_states(), aux_shapes))
        for name, p in self.params.items():
            if known.get(name) is None:
                raise MXNetError("SymbolBlock: cannot infer the shape of %s"
                                 % name)
            p._shape_resolved(known[name])

    def cast(self, dtype):
        """Cast the parameters to ``dtype``, except BatchNorm's, which stay
        float32 under a float16 or bfloat16 cast (as gluon.nn.BatchNorm)."""
        self._cached_op = None
        low = str(dtype).split(".")[-1] in _LOW_PRECISION
        for name, p in self.params.items():
            p.cast("float32" if low and name in self._float32 else dtype)
        return self

    def hybrid_forward(self, F, *args, **params):
        feed = {self._names[k]: v for k, v in params.items()}
        feed.update(zip(self._input_names, args))
        out = self._output_sym._execute(feed)
        return out[0] if len(out) == 1 else out
