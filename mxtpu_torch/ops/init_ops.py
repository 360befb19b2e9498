"""Array-creation ops (counterpart of ``mxtpu/ops/init_ops.py``).

Each returns a tensor on ``ctx`` (default: the CUDA device, or raise) in
the JAX package's dtypes (x64 off: "float64" gives float32); their
``mx.nd`` wrappers return NDArrays."""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from ..context import resolve_device
from .registry import register

__all__ = ["zeros", "ones", "full", "empty", "arange", "linspace", "eye",
           "zeros_like", "ones_like", "full_like"]


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _kw(ctx, dtype):
    return dict(dtype=canonical_dtype(dtype), device=resolve_device(ctx))


@register("zeros", aliases=("_zeros",))
def zeros(shape, ctx=None, dtype="float32", stype=None, **_ig):
    return torch.zeros(_shape(shape), **_kw(ctx, dtype))


@register("ones", aliases=("_ones",))
def ones(shape, ctx=None, dtype="float32", **_ig):
    return torch.ones(_shape(shape), **_kw(ctx, dtype))


@register("full", aliases=("_full",))
def full(shape, val=0.0, ctx=None, dtype="float32", **_ig):
    return torch.full(_shape(shape), val, **_kw(ctx, dtype))


@register("empty")
def empty(shape, ctx=None, dtype="float32"):
    """Zeros, as in the JAX package (never uninitialized memory)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


@register("arange", aliases=("_arange",))
def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32",
           **_ig):
    """``start, start + step, ...`` below ``stop`` (``[0, start)`` when
    ``stop`` is None), each value ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, **_kw(ctx, dtype))
    return out.repeat_interleave(repeat) if repeat > 1 else out


@register("linspace")
def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    kw = _kw(ctx, dtype)
    if endpoint:
        return torch.linspace(start, stop, num, **kw)
    return torch.linspace(start, stop, num + 1, **kw)[:num]


@register("eye", aliases=("_eye",))
def eye(N, M=0, k=0, ctx=None, dtype="float32", **_ig):
    """Ones on the ``k``-th diagonal of an N x M (M=0: N x N) matrix."""
    m = M if M else N
    kw = _kw(ctx, dtype)
    rows = torch.arange(N, device=kw["device"])[:, None]
    cols = torch.arange(m, device=kw["device"])[None, :]
    return (cols - rows == k).to(kw["dtype"])


@register("zeros_like", as_method=False)
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like", as_method=False)
def ones_like(x):
    return torch.ones_like(x)


@register("full_like")
def full_like(x, fill_value=0.0):
    return torch.full_like(x, fill_value)
