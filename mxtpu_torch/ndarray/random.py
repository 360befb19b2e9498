"""``mx.nd.random`` (counterpart of ``mxtpu/ndarray/random.py`` and the
samplers of ``mxtpu/ops/random_ops.py`` it calls): draws from the device's
generator in ``mxtpu_torch.random``. Samples are fresh leaves: nothing is
taped. Parameters given as NDArrays broadcast together, and ``shape`` is
appended to their shape: one sample set per parameter element."""
from __future__ import annotations

import torch

from .. import random as _rnd
from ..base import canonical_dtype
from ..context import resolve_device
from .ndarray import NDArray

__all__ = ["uniform", "normal", "randn", "exponential"]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _params(shape, ctx, dtype, *params):
    """(sample shape, device, dtype, params as numbers or tensors shaped to
    broadcast against the samples: one sample set of ``shape`` per
    element of the broadcast parameters)."""
    tensors = [p._data for p in params if isinstance(p, NDArray)]
    dev = tensors[0].device if tensors and ctx is None \
        else resolve_device(ctx)
    base = tuple(torch.broadcast_shapes(*[t.shape for t in tensors])) \
        if tensors else ()
    extra = _shape(shape)
    vals = [p._data.reshape(tuple(p.shape) + (1,) * len(extra))
            if isinstance(p, NDArray) else p for p in params]
    dt = torch.float32 if dtype in (None, "None") else canonical_dtype(dtype)
    return base + extra, dev, dt, vals


def _emit(data, dt, out):
    res = NDArray(data.to(dt))
    if out is None:
        return res
    out._set_data(res._data)
    return out


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **_ig):
    """Samples of U[low, high)."""
    shape, dev, dt, (lo, hi) = _params(shape, ctx, dtype, low, high)
    u = torch.rand(shape, generator=_rnd.generator(dev), device=dev)
    return _emit(u * (hi - lo) + lo, dt, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **_ig):
    """Samples of N(loc, scale^2)."""
    shape, dev, dt, (lo, sc) = _params(shape, ctx, dtype, loc, scale)
    z = torch.randn(shape, generator=_rnd.generator(dev), device=dev)
    return _emit(z * sc + lo, dt, out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kwargs):
    """Normal samples of shape ``*shape`` (ref: ndarray/random.py:randn)."""
    return normal(loc=loc, scale=scale, shape=shape or None, dtype=dtype,
                  ctx=ctx, **kwargs)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None,
                **_ig):
    """Samples of an exponential with mean ``scale`` (ref:
    python/mxnet/ndarray/random.py:exponential)."""
    shape, dev, dt, (sc,) = _params(shape, ctx, dtype, scale)
    e = torch.empty(shape, device=dev).exponential_(
        1.0, generator=_rnd.generator(dev))
    return _emit(e * sc, dt, out)
