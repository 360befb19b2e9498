"""Reductions and broadcast-axis ops (counterpart of ``mxtpu/ops/reduce.py``).

MXNet reduce semantics: ``axis`` may be int/tuple/None, ``keepdims`` bool,
and ``exclude=True`` reduces over the axes NOT listed; an empty axis set
reduces nothing. Result types follow the JAX package: integer sums stay
int32 (torch would give int64), means of integers are float32, and the
arg-reductions return float32 indices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import canonical_dtype
from .registry import register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _canon(t):
    dt = canonical_dtype(t.dtype)
    return t if t.dtype == dt else t.to(dt)


def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _prod(x, dims, keepdim):
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dims, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dims,
                 keepdim)


_REDUCERS = {
    "sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "mean": lambda x, d, k: torch.mean(_float(x), dim=d, keepdim=k),
    "prod": _prod,
    "nansum": lambda x, d, k: torch.nansum(x, dim=d, keepdim=k),
    "nanprod": _nanprod,
    "max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
}


def _reduce(name, aliases=()):
    tfn = _REDUCERS[name]

    @register(name, aliases=aliases, as_method=True)
    def fn(x, axis=None, keepdims=False, exclude=False, **_ig):
        ax = _norm_axis(axis, x.ndim, exclude)
        dims = tuple(range(x.ndim)) if ax is None else ax
        if not dims:   # nothing to reduce (a 0-d input or an empty set)
            return _canon(_float(x) if name == "mean" else x)
        return _canon(tfn(x, dims, keepdims))
    fn.__name__ = name
    return fn


sum_ = _reduce("sum", aliases=("sum_axis",))
mean = _reduce("mean")
prod = _reduce("prod")
nansum = _reduce("nansum")
nanprod = _reduce("nanprod")
max_ = _reduce("max", aliases=("max_axis",))
min_ = _reduce("min", aliases=("min_axis",))


@register("norm", as_method=True)
def norm(x, ord=2, axis=None, keepdims=False, **_ig):  # noqa: A002
    """L1/L2 norm (ref: broadcast_reduce_op_value.cc norm)."""
    ax = _norm_axis(axis, x.ndim)
    dims = tuple(range(x.ndim)) if ax is None else ax
    if ord == 1:
        return torch.sum(torch.abs(x), dim=dims, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=keepdims))


def _arg(fn, x, axis, keepdims):
    if axis is None:
        r = fn(x.reshape(-1))
        if keepdims:
            r = r.reshape((1,) * x.ndim)
    else:
        r = fn(x, dim=axis, keepdim=keepdims)
    return r.to(torch.float32)


@register("argmax", as_method=True)
def argmax(x, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin", as_method=True)
def argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argmax_channel")
def argmax_channel(x):
    """argmax over axis 1 (ref: broadcast_reduce_op_index.cc)."""
    return torch.argmax(x, dim=1).to(torch.float32)


@register("broadcast_axis", aliases=("broadcast_axes",), as_method=True)
def broadcast_axis(x, axis=(), size=()):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return x.broadcast_to(tuple(shape))


@register("broadcast_to", as_method=False)
def broadcast_to(x, shape=()):
    # MXNet: 0 in the target shape keeps the source dim
    return x.broadcast_to(tuple(x.shape[i] if s == 0 else s
                                for i, s in enumerate(shape)))


@register("broadcast_like", as_method=False)
def broadcast_like(x, like):
    return x.broadcast_to(like.shape)


@register("pick", as_method=True)
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """Pick one element per row by index (ref: broadcast_reduce_op_index.cc
    pick); ``clip`` clamps the index, any other mode wraps it."""
    idx = index.to(torch.int64)
    n = x.shape[axis]
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    picked = torch.take_along_dim(x, idx.unsqueeze(axis), dim=axis)
    return picked if keepdims else picked.squeeze(axis)


@register("L2Normalization")
def L2Normalization(x, eps=1e-10, mode="instance"):
    """Ref: src/operator/l2_normalization.cc."""
    if mode == "instance":
        ax = tuple(range(1, x.ndim))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, x.ndim))
    else:
        raise ValueError("unknown mode " + mode)
    return x / torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True)
                          + eps)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Fused cross entropy summed over the batch (ref: loss_binary_op.cc)."""
    logp = F.log_softmax(data, dim=-1)
    picked = torch.take_along_dim(logp, label.to(torch.int64)[:, None],
                                  dim=-1)
    return -torch.sum(picked)


@register("_square_sum", wrap=False)
def _square_sum(data, axis=None, keepdims=False, exclude=False, out=None,
                **_ig):
    """The sum of squares over axes (ref: tensor/square_sum.cc): a
    row_sparse input with ``axis=1, keepdims=True`` gives a row_sparse
    output over the input's row ids; every other case is dense, and a
    row_sparse input reduces its stored values alone (a csr input is
    densified first)."""
    from ..ndarray.ndarray import NDArray, _apply
    from ..ndarray.sparse import BaseSparseNDArray, RowSparseNDArray
    if isinstance(data, BaseSparseNDArray) \
            and not isinstance(data, RowSparseNDArray):
        data = data.todense()
    if isinstance(data, RowSparseNDArray):
        ax = _norm_axis(axis, len(data.shape), exclude)
        idx, shape = data._aux["indices"], data.shape
        if ax == (1,) and keepdims:
            vals = _apply(lambda v: torch.sum(v * v, dim=1, keepdim=True),
                          (data,), name="_square_sum")
            res = RowSparseNDArray(vals._data, idx, (shape[0], 1))
        elif ax == (1,):
            res = _apply(lambda v: torch.zeros(
                shape[0], dtype=v.dtype, device=v.device).index_add(
                    0, idx, torch.sum(v * v, dim=1)), (data,),
                name="_square_sum")
        elif ax == (0,):
            res = _apply(lambda v: torch.sum(v * v, dim=0, keepdim=keepdims),
                         (data,), name="_square_sum")
        else:   # a full reduction (axis None, or both axes)
            res = _apply(lambda v: _sum_all(v * v, keepdims), (data,),
                         name="_square_sum")
    else:
        ax = _norm_axis(axis, data.ndim, exclude)
        res = _apply(lambda v: _sum_all(v * v, keepdims) if ax is None
                     else torch.sum(v * v, dim=ax, keepdim=keepdims),
                     (data,), name="_square_sum")
    if out is not None:
        return res.copyto(out)
    return res


def _sum_all(x, keepdims):
    s = torch.sum(x)
    return s.reshape((1,) * x.ndim) if keepdims else s
