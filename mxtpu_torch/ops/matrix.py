"""Shape, indexing and dot ops (counterpart of ``mxtpu/ops/matrix.py``):
``reshape`` with MXNet's special codes, ``Flatten``, ``transpose``, the
``Embedding``
lookup, joins, splits (``SliceChannel``), slices and ``pad``, and ``dot``/``batch_dot`` (float32 in full
float32, bfloat16 accumulated in float32, as the JAX package's
``contract_acc``)."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .precision_util import promote
from .registry import register, register_num_outputs, register_param_shapes

__all__ = ["reshape", "Flatten", "transpose", "Embedding", "expand_dims", "squeeze",
           "Concat", "stack", "SliceChannel", "slice_", "slice_axis", "tile",
           "repeat",
           "reverse", "swapaxes", "pad", "dot", "batch_dot"]


def _reshape_target(src, shape):
    """The target shape of MXNet's special codes, read left to right."""
    tgt, shape = [], list(shape)
    src_i = i = 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            tgt.append(src[src_i])
            src_i += 1
        elif s == -2:
            tgt.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:
            tgt.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:
            a, b = shape[i + 1], shape[i + 2]
            dim = src[src_i]
            if a == -1:
                a = dim // b
            if b == -1:
                b = dim // a
            tgt.extend([a, b])
            src_i += 1
            i += 2
        else:   # a size, or -1
            tgt.append(s)
            src_i += 1
        i += 1
    return tgt


def _resolve(tgt, numel):
    """``tgt`` with its -1 inferred."""
    known = 1
    for s in tgt:
        if s != -1:
            known *= s
    return tuple(numel // known if s == -1 and known else s for s in tgt)


@register("Reshape", aliases=("reshape",), as_method=False)
def reshape(x, shape=None, reverse=False, **_ig):
    """MXNet reshape: 0 copies the input dim, -1 infers one dim, -2 copies
    every remaining dim, -3 merges two dims, -4 splits one dim into the
    next two values (either may be -1) (ref: matrix_op.cc ReshapeParam).
    Other keywords are ignored, as the JAX package does. The JAX package
    also ignores ``reverse``; MXNet reads the codes right to left with it.
    Where the two readings give the same shape that shape is returned, and
    where they differ the call raises rather than pick one."""
    if shape is None:
        raise ValueError("reshape requires target shape")
    src = list(x.shape)
    tgt = _reshape_target(src, shape)
    if reverse:
        if -4 in list(shape) or _resolve(tgt, x.numel()) != _resolve(
                _reshape_target(src[::-1], list(shape)[::-1])[::-1],
                x.numel()):
            raise MXNetError(
                "reshape(shape=%s, reverse=True) of %s: MXNet's right-to-left "
                "reading differs from the JAX package's, which ignores "
                "reverse" % (tuple(shape), tuple(src)))
    return torch.reshape(x, tuple(tgt))


@register("Flatten", aliases=("flatten",), as_method=False)
def Flatten(x):
    """[N, ...] -> [N, prod(...)]."""
    return x.reshape(x.shape[0], -1)


@register("transpose", as_method=False)
def transpose(x, axes=None):
    """Permute the axes (reverse them when ``axes`` is empty)."""
    axes = tuple(axes) if axes else tuple(range(x.ndim - 1, -1, -1))
    return x.permute(axes)


@register("Embedding")
def Embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` for the ids in ``data``, ids cast to int32 and
    clipped to ``[0, input_dim - 1]`` as the JAX package does (an
    out-of-range id reads the first or last row, never raises). The output
    has the weight's type; ``dtype`` and ``sparse_grad`` are accepted and
    ignored, as the JAX package does (the gradient is dense)."""
    idx = data.to(torch.int32).clamp(0, weight.shape[0] - 1)
    return weight.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(weight.shape[1:]))


@register_param_shapes("Embedding")
def _embedding_param_shapes(shapes, attrs):
    """weight = (input_dim, output_dim) whatever the data's shape (ref:
    indexing_op.h EmbeddingOpShape)."""
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


@register("expand_dims", as_method=False)
def expand_dims(x, axis):
    return x.unsqueeze(axis)


@register("squeeze", as_method=False)
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return x.squeeze(tuple(a % x.ndim for a in axes)) if axes else x


@register("Concat", aliases=("concat", "concatenate"), as_method=False)
def Concat(*args, dim=1, axis=None, num_args=None):
    return torch.cat(args, dim=axis if axis is not None else dim)


@register("stack", as_method=False)
def stack(*args, axis=0, num_args=None):
    return torch.stack(args, dim=axis)


@register("SliceChannel", aliases=("split",), as_method=False)
def SliceChannel(x, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts of ``x`` along ``axis`` (a list, or the
    one part), each without that axis when ``squeeze_axis`` (ref:
    slice_channel.cc); an axis that does not divide raises, as
    ``jnp.split`` does."""
    axis = axis % x.ndim
    if x.shape[axis] % num_outputs:
        raise MXNetError("SliceChannel: axis %d of %s does not split into "
                         "%d equal parts" % (axis, tuple(x.shape),
                                             num_outputs))
    outs = list(torch.split(x, x.shape[axis] // num_outputs, dim=axis))
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return outs if num_outputs > 1 else outs[0]


@register_num_outputs("SliceChannel")
def _slice_channel_num_outputs(attrs):
    return int(attrs.get("num_outputs", 1))


def _slice_axis(x, axis, begin, end, step=None):
    """``x[begin:end:step]`` along ``axis``; a negative step (which torch
    slicing refuses) gathers the indices Python's slice would give."""
    if step is None or step > 0:
        return x[(slice(None),) * axis + (slice(begin, end, step),)]
    idx = range(*slice(begin, end, step).indices(x.shape[axis]))
    return x.index_select(axis, torch.tensor(list(idx), dtype=torch.int64,
                                             device=x.device))


@register("slice", aliases=("crop",), as_method=False)
def slice_(x, begin=(), end=(), step=()):
    step = step or [None] * len(begin)
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _slice_axis(x, ax, b, e, s)
    return x


@register("slice_axis", as_method=True)
def slice_axis(x, axis=0, begin=0, end=None):
    return _slice_axis(x, axis % x.ndim, begin, end)


@register("tile", as_method=True)
def tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat", as_method=True)
def repeat(x, repeats=1, axis=None):
    """numpy repeat: each element ``repeats`` times along ``axis``, over
    the flattened array when ``axis`` is None."""
    if axis is None:
        return x.reshape(-1).repeat_interleave(repeats)
    return x.repeat_interleave(repeats, dim=axis)


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("pad", aliases=("Pad",), as_method=True)
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """numpy-style padding of every axis: ``pad_width`` holds (before,
    after) per axis (ref: pad.cc). ``edge`` and ``reflect`` pad the
    trailing 1-3 axes only (leading pairs zero), as torch's and MXNet's
    kernels do; ``constant`` any axis."""
    if mode not in _PAD_MODES:
        raise MXNetError("unknown pad mode %r" % (mode,))
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    pw += [(0, 0)] * (x.ndim - len(pw))
    widths = [v for lo, hi in reversed(pw) for v in (lo, hi)]
    if mode == "constant":
        return torch.nn.functional.pad(x, widths, value=constant_value)
    padded = [i for i, p in enumerate(pw) if p != (0, 0)]
    n = x.ndim - min(padded) if padded else 0
    if n > 3 or x.ndim - n < 1:
        raise MXNetError("pad mode %r pads the trailing 1-3 axes of an "
                         "array with a leading one, got pad_width %s for "
                         "%d axes" % (mode, tuple(pad_width), x.ndim))
    if n == 0:
        return x
    lead = x.shape[:x.ndim - n]
    y = x.reshape((-1,) + tuple(x.shape[x.ndim - n:]))
    out = torch.nn.functional.pad(y, widths[:2 * n], mode=_PAD_MODES[mode])
    return out.reshape(tuple(lead) + tuple(out.shape[1:]))


@register("reverse", aliases=("flip",), as_method=True)
def reverse(x, axis=()):
    if isinstance(axis, int):
        axis = (axis,)
    return torch.flip(x, dims=tuple(axis))


@register("swapaxes", aliases=("SwapAxis",), as_method=False)
def swapaxes(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


def _contract(fn, a, b, **kw):
    dt = promote(a.dtype, b.dtype)
    return fn(a.to(dt), b.to(dt), **kw)


@register("dot", as_method=True)
def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """General dot (ref: dot-inl.h): contracts the last axis of lhs with
    the first of rhs; ``transpose_*`` reverses every axis of an operand
    with more than two (swaps the last two of a 2-D one)."""
    def flip(t, on):
        if not on or t.ndim < 2:
            return t
        return t.permute(tuple(range(t.ndim))[::-1])
    a, b = flip(lhs, transpose_a), flip(rhs, transpose_b)
    if a.ndim == 1 and b.ndim == 1:
        return _contract(torch.dot, a, b)
    return _contract(torch.tensordot, a, b, dims=([-1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return _contract(torch.matmul, a, b)
