"""Functional control flow: ``foreach``, ``while_loop``, ``cond``
(counterpart of ``mxtpu/ops/control_flow.py``).

The JAX package lowers these to ``lax.scan``, ``lax.while_loop`` and
``lax.cond``; here they are Python loops, with its semantics: the body
and branch functions take and return NDArrays (tensors, where the call
was given tensors, as a ``hybrid_forward`` gives them) and run under
``autograd.pause()`` (``is_recording()`` and ``is_training()`` are False
inside), while the call as a whole is differentiated with respect to its
inputs when it is made under ``autograd.record()``
(``autograd.taping_through``). ``foreach`` reads nothing on the host, so it
captures into a CUDA graph; ``while_loop`` and ``cond`` read their
predicate on the host each time and raise inside a capture.
"""
from __future__ import annotations

import torch

from .. import autograd, graphs
from ..base import MXNetError
from .registry import register

__all__ = ["foreach", "while_loop", "cond"]


def _nd():
    # late: the ndarray package imports the op modules
    from ..ndarray.ndarray import NDArray
    return NDArray


def _is_array(x):
    return isinstance(x, (_nd(), torch.Tensor))


def _as_list(x):
    return [x] if _is_array(x) else list(x)


def _stack(steps):
    """One step's outputs stacked on a new axis 0, as their kind."""
    nd = _nd()
    raw = torch.stack([o._data if isinstance(o, nd) else o for o in steps])
    return nd(raw) if isinstance(steps[0], nd) else raw


def _host_predicate(what, pred):
    """``pred`` (an NDArray, tensor or number) as a Python bool, read on
    the host; refused inside a capture, where no value can be read."""
    if graphs.capturing():
        raise MXNetError(
            "%s reads its predicate on the host at every step, which a "
            "captured CUDA graph cannot do: call it outside a hybridized "
            "block, or write the loop with foreach" % what)
    if isinstance(pred, _nd()):
        pred = pred._data
    if isinstance(pred, torch.Tensor):
        return bool(pred.reshape(()).item())
    return bool(pred)


@register("foreach", aliases=("_foreach",), wrap=False)
def foreach(body, data, init_states):
    """``body(x_t, states) -> (out_t, new_states)`` over axis 0 of
    ``data`` (one array or a list); returns (the stacked outputs, the
    final states), each an array or a list as ``body`` and
    ``init_states`` give them (ref: control_flow.cc ``_foreach``)."""
    single_data = _is_array(data)
    single_state = _is_array(init_states)
    datas = _as_list(data)
    states = _as_list(init_states)
    outs = []
    with autograd.taping_through():
        for t in range(datas[0].shape[0]):
            x_t = [d[t] for d in datas]
            out, states = body(x_t[0] if single_data else x_t,
                               states[0] if single_state else states)
            states = _as_list(states)
            outs.append(_as_list(out))
        stacked = [_stack([o[k] for o in outs])
                   for k in range(len(outs[0]))]
    out = stacked[0] if len(stacked) == 1 else stacked
    return out, (states[0] if single_state else states)


@register("while_loop", aliases=("_while_loop",), wrap=False)
def while_loop(cond, func, loop_vars, max_iterations=None):
    """``loop_vars = func(*loop_vars)`` while ``cond(*loop_vars)``; returns
    ``([], final loop_vars)``: no per-step outputs, and ``max_iterations``
    unread, as in the JAX package (ref: control_flow.cc
    ``_while_loop``)."""
    single = _is_array(loop_vars)
    cur = _as_list(loop_vars)
    with autograd.taping_through():
        while _host_predicate("while_loop", cond(*cur)):
            cur = _as_list(func(*cur))
    return [], (cur[0] if single else cur)


@register("cond", aliases=("_cond",), wrap=False)
def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs)`` if ``pred`` else ``else_func(*inputs)``: one
    output as an NDArray, several as a list (ref: control_flow.cc
    ``_cond``)."""
    inputs = [] if inputs is None else _as_list(inputs)
    branch = then_func if _host_predicate("cond", pred) else else_func
    with autograd.taping_through():
        out = branch(*inputs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    return list(outs) if len(outs) > 1 else outs[0]
