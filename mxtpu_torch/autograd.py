"""Imperative autograd for NDArray code (counterpart of ``mxtpu/autograd.py``).

The JAX package keeps a tape of its own; the port rides torch autograd and
keeps MXNet's rules on top of it:

* Taping happens only inside ``record()``. ``ndarray._apply`` runs each op
  under ``torch.set_grad_enabled(is_recording())``, so an array with an
  attached gradient grows no graph outside ``record()`` or inside
  ``pause()``.
* ``attach_grad`` makes the array's tensor a torch leaf that requires grad
  and points back (weakly) at its NDArray. ``backward`` walks the graph
  from the heads to those leaves, computes their gradients with
  ``torch.autograd.grad`` and writes (``grad_req='write'``) or adds
  (``'add'``) them into each NDArray's own grad buffer; ``'null'`` skips.
  Torch's ``.grad`` is never used, so nothing accumulates behind MXNet's
  back.
* ``backward`` without ``retain_graph`` frees the graph and detaches the
  heads, so a second ``backward`` raises, as in the JAX package.
* Integer arrays cannot require grad in torch; they get no gradient, as
  the JAX package skips their float0 cotangents.
* A control-flow op's body (``foreach``, ``while_loop``, ``cond``) runs
  under ``taping_through()``: ``pause()`` as the JAX package's body sees
  it, while torch goes on taping what the body computes when the call is
  recorded (``taping()``), so the call is differentiated as one node.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording",
    "taping", "taping_through",
    "is_training", "set_recording", "set_training", "mark_variables",
    "backward", "grad", "Function",
]


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.through = False   # inside a recorded control-flow body


_STATE = _AGState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def taping() -> bool:
    """Whether torch tapes an op run now: under ``record()``, and inside
    the body of a control-flow op called under it."""
    return _STATE.recording or _STATE.through


@contextlib.contextmanager
def taping_through():
    """The scope of a control-flow op's body: recording and training off
    (``pause()``), torch's taping as the call's (on, where the call is
    recorded; as it was, for a call on tensors)."""
    prev = _STATE.through
    _STATE.through = through = taping()
    try:
        with pause(), torch.set_grad_enabled(through or
                                             torch.is_grad_enabled()):
            yield
    finally:
        _STATE.through = prev


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


class _Scope:
    def __init__(self, recording=None, training=None):
        self._rec, self._train = recording, training

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *a):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True):  # noqa: A002 - mirror reference name
    """Scope enabling taping (ref: python/mxnet/autograd.py:record)."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False):
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to leaves (ref: autograd.py:mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._make_leaf(g, req)


def _as_list(x):
    from .ndarray import NDArray
    return [x] if isinstance(x, NDArray) else list(x)


def _graph_leaves(roots):
    """The tensors of every torch leaf (AccumulateGrad node) that the
    graphs of ``roots`` reach."""
    leaves, seen = [], set()
    stack = [t.grad_fn for t in roots if t.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None:
            leaves.append(var)
        stack.extend(n for n, _ in node.next_functions if n is not None)
    return leaves


def _heads(heads, head_grads):
    """(head tensors with a graph, their seed gradients); a head outside any
    recorded computation raises unless it is itself a leaf."""
    heads = _as_list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    else:
        head_grads = _as_list(head_grads)
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if t.grad_fn is None:
            if not t.requires_grad or h._grad_req == "null":
                raise MXNetError("head array is not part of a recorded "
                                 "computation (run inside autograd.record())")
            continue   # a leaf head seeds nothing, as in the JAX package
        outs.append(t)
        seeds.append(torch.ones_like(t) if hg is None
                     else hg._data.to(dtype=t.dtype, device=t.device))
    return heads, outs, seeds


def _free(heads):
    """Drop the heads' history (the JAX package's AGInfo::Clear)."""
    for h in heads:
        if h._data.grad_fn is not None:
            h._data = h._data.detach()


def _autograd_grad(outs, inputs, seeds, retain_graph, create_graph=False):
    try:
        return torch.autograd.grad(outs, inputs, seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        raise MXNetError("backward failed: %s" % e) from e


def backward(heads, head_grads=None, retain_graph=False,
             train_mode=True):  # noqa: A002
    """Reverse mode from ``heads`` (ref: Imperative::Backward). Gradients
    land in ``x.grad`` of every array with an attached grad buffer
    (``attach_grad``/``mark_variables``) that the heads depend on."""
    heads, outs, seeds = _heads(heads, head_grads)
    targets = []   # (leaf tensor, owning NDArray)
    for leaf in _graph_leaves(outs):
        ref = getattr(leaf, "_mx_owner", None)
        owner = ref() if ref is not None else None
        if owner is not None and owner._grad_req != "null" \
                and owner._grad is not None:
            targets.append((leaf, owner))
    if targets:
        with _Scope(training=train_mode):
            grads = _autograd_grad(outs, [t for t, _ in targets], seeds,
                                   retain_graph)
        for (leaf, owner), g in zip(targets, grads):
            if g is None:
                continue
            buf = owner._grad
            if owner._grad_req == "add":
                buf._set_data(buf._data + g.to(buf._data.dtype))
            else:
                buf._set_data(g.to(buf._data.dtype))
    if not retain_graph:
        _free(heads)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # noqa: A002
    """Gradients of ``heads`` with respect to ``variables``, returned as new
    NDArrays; no grad buffer is touched (ref: autograd.py:grad)."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    variables = _as_list(variables)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("variables passed to grad() must be used in the "
                             "recorded graph")
    heads, outs, seeds = _heads(heads, head_grads)
    retain = bool(retain_graph) or create_graph
    with _Scope(training=train_mode):
        gs = _autograd_grad(outs, [v._data for v in variables], seeds,
                            retain, create_graph)
    out = [NDArray(torch.zeros_like(v._data.detach()) if g is None else g)
           for v, g in zip(variables, gs)]
    if not retain:
        _free(heads)
    return out[0] if single else out


class _FunctionBridge(torch.autograd.Function):
    """Runs a user ``Function``'s NDArray forward and backward as one torch
    autograd node."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray import NDArray
        ctx.func = func
        ctx.differentiable = [t.is_floating_point() for t in tensors]
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        func._single = isinstance(outs, NDArray)
        return tuple(o._data for o in ([outs] if func._single else outs))

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray
        with pause():
            in_gs = ctx.func.backward(*[NDArray(g) for g in grads])
        in_gs = [in_gs] if isinstance(in_gs, NDArray) else list(in_gs)
        if len(in_gs) != len(ctx.differentiable):
            raise MXNetError("Function.backward returned %d gradients for %d "
                             "inputs" % (len(in_gs), len(ctx.differentiable)))
        return (None,) + tuple(
            g._data if ok and g is not None else None
            for g, ok in zip(in_gs, ctx.differentiable))


class Function:
    """Custom differentiable function (ref: python/mxnet/autograd.py:Function).
    Subclass and implement ``forward``/``backward`` on NDArrays; under
    ``record()`` a call becomes one torch autograd node whose backward calls
    ``backward`` with the output gradients."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):  # pragma: no cover - abstract
        raise NotImplementedError

    def backward(self, *out_grads):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        outs = [NDArray(o) for o in outs]
        return outs[0] if self._single else outs
