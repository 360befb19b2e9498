"""External kernels as first-class ops (counterpart of
``mxtpu/contrib/external_kernel.py``; ref analog: the TVM bridge,
src/nnvm/tvm_bridge.cc:54-178).

* ``register_external_kernel(name, fn, vjp=None, aliases=())``: ``fn`` is
  any function on torch tensors — a runtime-compiled kernel's ``launch``
  (``mxtpu_torch.rtc``) is one. It becomes a registry op: ``mx.nd.<name>``
  on NDArrays, taped under ``autograd.record()``. Without ``vjp`` torch
  differentiates ``fn`` itself where it can; with ``vjp(cotangent,
  *arrays, **attrs) -> grads`` the op is one ``torch.autograd.Function``
  whose backward calls it. Attributes are bound before that boundary.
* ``register_host_kernel(name, fn, out_shape_fn=None, vjp=None)``: ``fn``
  runs on the host on numpy arrays; its result returns to the first
  input's device.

A name or alias that is already registered raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError
from ..ops.registry import REGISTRY, get_op, register

__all__ = ["register_external_kernel", "register_host_kernel"]


def _tensor(x):
    from ..ndarray import NDArray
    return x.to_torch() if isinstance(x, NDArray) else x


class _VjpFunction(torch.autograd.Function):
    """``fn`` forward, the user's ``vjp`` backward; non-tensor and integer
    inputs get no gradient."""

    @staticmethod
    def forward(ctx, fn, vjp, attrs, *arrays):
        ctx.vjp, ctx.attrs = vjp, attrs
        ctx.tensor_at = [isinstance(a, torch.Tensor) for a in arrays]
        ctx.others = [None if t else a for a, t in zip(arrays, ctx.tensor_at)]
        ctx.save_for_backward(*[a for a, t in zip(arrays, ctx.tensor_at)
                                if t])
        out = fn(*arrays, **attrs)
        ctx.multi = isinstance(out, (list, tuple))
        return tuple(map(_tensor, out)) if ctx.multi else _tensor(out)

    @staticmethod
    def backward(ctx, *gs):
        saved = iter(ctx.saved_tensors)
        res = [next(saved) if t else o
               for t, o in zip(ctx.tensor_at, ctx.others)]
        grads = ctx.vjp(gs if ctx.multi else gs[0], *res, **ctx.attrs)
        if not isinstance(grads, (list, tuple)):
            grads = (grads,)
        if len(grads) != len(res):
            raise MXNetError("external kernel vjp returned %d gradients for "
                             "%d inputs" % (len(grads), len(res)))
        out = []
        for g, a in zip(grads, res):
            diff = isinstance(a, torch.Tensor) and a.is_floating_point()
            out.append(_tensor(g) if diff and g is not None else None)
        return (None, None, None) + tuple(out)


def _attach_vjp(fn, vjp):
    def kernel(*arrays, **attrs):
        return _VjpFunction.apply(fn, vjp, attrs, *arrays)
    return kernel


def register_external_kernel(name, fn, vjp=None, aliases=()):
    """Register a tensor-level kernel as a framework op; returns its
    NDArray-level callable (also ``mx.nd.<name>``)."""
    for nm in (name,) + tuple(aliases):
        if nm in REGISTRY:
            raise MXNetError("op name %r is already registered" % nm)
    kernel = fn if vjp is None else functools.wraps(fn)(_attach_vjp(fn, vjp))
    register(name, aliases=aliases)(kernel)
    return get_op(name).wrapper


def register_host_kernel(name, fn, out_shape_fn=None, vjp=None, aliases=()):
    """Register a HOST function (numpy/cffi/ctypes) as a framework op.

    The inputs go to the host as numpy arrays, ``fn(*arrays, **attrs)``
    runs there, and its result comes back to the first input's device.
    ``out_shape_fn(*inputs, **attrs)`` receives the inputs as ``meta``
    tensors (shape and dtype, no data) and returns one of the result's
    shape and dtype; by default the result takes the first input's. It is
    checked against what ``fn`` returned.
    """

    def device_side(*arrays, **attrs):
        first = arrays[0]
        if out_shape_fn is None:
            shape, dtype = tuple(first.shape), first.dtype
        else:
            spec = out_shape_fn(*[torch.empty(a.shape, dtype=a.dtype,
                                              device="meta")
                                  for a in arrays], **attrs)
            shape, dtype = tuple(spec.shape), spec.dtype
        host = [a.detach().cpu().float().numpy()
                if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
                for a in arrays]
        out = np.asarray(fn(*host, **attrs))
        if tuple(out.shape) != shape:
            raise MXNetError("host kernel %r returned shape %s, expected %s"
                             % (name, tuple(out.shape), shape))
        return torch.from_numpy(np.ascontiguousarray(out)).to(
            device=first.device, dtype=dtype)

    device_side.__name__ = name
    device_side.__doc__ = fn.__doc__
    return register_external_kernel(name, device_side, vjp=vjp,
                                    aliases=aliases)
