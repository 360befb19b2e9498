"""Shape, indexing, ordering and dot ops (counterpart of
``mxtpu/ops/matrix.py``): ``reshape`` with MXNet's special codes,
``Flatten``, ``transpose``, the ``Embedding`` lookup, joins, splits
(``SliceChannel``), slices and ``pad``, and ``dot``/``batch_dot`` (float32
in full float32, bfloat16 accumulated in float32, as the JAX package's
``contract_acc``); ROADMAP A10.1's gathers, scatters, ``one_hot``,
``sort``/``argsort``/``topk`` and ravel ops.

Every index op gives the JAX package's answer for an id out of range
without a device-side assert (which would end the CUDA context) and
without reading anything back to the host: ``take`` clamps, wraps or
fills, ``gather_nd`` clamps, the scatters drop the update, ``one_hot``
gives a row of ``off_value``. Ordering ops sort stably, so ties come out
in the JAX package's order (``topk``: lower index first)."""
from __future__ import annotations

import torch

from ..base import MXNetError, canonical_dtype
from .precision_util import promote
from .registry import register, register_num_outputs, register_param_shapes

__all__ = ["reshape", "Flatten", "transpose", "Embedding", "expand_dims", "squeeze",
           "Concat", "stack", "SliceChannel", "slice_", "slice_axis", "tile",
           "repeat",
           "reverse", "swapaxes", "pad", "dot", "batch_dot", "slice_like",
           "depth_to_space", "space_to_depth", "diag", "shape_array",
           "size_array", "take", "batch_take", "gather_nd", "scatter_nd",
           "_scatter_set_nd", "one_hot", "index_copy", "sort", "argsort",
           "topk", "khatri_rao", "reshape_like", "_ravel_multi_index",
           "_unravel_index"]


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


# ------------------------------------------------- A10.1: shapes and indexing
def _const(values, dtype, device):
    """A small 1-D tensor of Python numbers, filled on the device (no host
    copy, so a graph capture can record it)."""
    out = torch.empty((len(values),), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


@register("slice_like", as_method=True)
def slice_like(x, shape_like, axes=()):
    """``x`` cut to ``shape_like``'s sizes on ``axes`` (every shared axis
    when empty) (ref: matrix_op.cc slice_like)."""
    axes = axes or range(min(x.ndim, shape_like.ndim))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return x[tuple(idx)]


@register("depth_to_space")
def depth_to_space(x, block_size):
    """[N, C, H, W] -> [N, C / b^2, H b, W b], the channel blocks read
    depth-column-row (ref: matrix_op.cc depth_to_space)."""
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(x, block_size):
    """The inverse of ``depth_to_space``."""
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register("diag", as_method=True)
def diag(x, k=0, **_ig):
    """A 1-D input's ``k``-th diagonal matrix; else the ``k``-th diagonal
    of the last two axes (a new array, as ``jnp.diagonal`` gives)."""
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1).clone()


@register("shape_array")
def shape_array(x):
    """``x``'s shape as int32 (the JAX package's int64 with x64 off)."""
    return _const(list(x.shape), torch.int32, x.device)


@register("size_array")
def size_array(x):
    return _const([x.numel()], torch.int32, x.device)


def _fill_value(dtype):
    """``jnp.take``'s fill for an index out of range: NaN for floats, the
    most negative value for signed ints, the largest for unsigned ones."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("take", as_method=True)
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at ``indices`` (ref: indexing_op.cc
    take): ``clip`` clamps an index into range, ``wrap`` takes it modulo
    the size; any other mode is ``jnp.take``'s fill mode, where an index
    in [-size, size) wraps once and any other reads the fill value."""
    axis = axis % a.ndim
    size = a.shape[axis]
    idx = indices.to(torch.int64)
    valid = None
    if mode == "clip":
        idx = idx.clamp(0, size - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, size)
    else:
        valid = (idx >= -size) & (idx < size)
        idx = torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)
    out = a.index_select(axis, idx.reshape(-1))
    shape = tuple(a.shape[:axis]) + tuple(idx.shape) + tuple(
        a.shape[axis + 1:])
    out = out.reshape(shape)
    if valid is not None:
        v = valid.reshape((1,) * axis + tuple(valid.shape)
                          + (1,) * (a.ndim - axis - 1))
        out = torch.where(v, out, torch.full((), _fill_value(a.dtype),
                                              dtype=a.dtype,
                                              device=a.device))
    return out


@register("batch_take")
def batch_take(a, indices):
    """``a[i, indices[i]]`` for each row, ids clamped into range."""
    idx = indices.to(torch.int64).clamp(0, a.shape[1] - 1)
    return a.gather(1, idx.reshape(-1, 1)).reshape(-1)


def _nd_index(indices, shape):
    """The leading ``M`` axes' ids of an (M, ...) index array, each with a
    negative id wrapped once (numpy indexing) and cast to int64."""
    idx = indices.to(torch.int64)
    return [torch.where(idx[i] < 0, idx[i] + shape[i], idx[i])
            for i in range(idx.shape[0])]


@register("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]`` (ref: indexing_op.cc
    gather_nd): a negative id wraps once and an id still out of range is
    clamped, as JAX's gather clamps."""
    ids = [i.clamp(0, data.shape[d] - 1)
           for d, i in enumerate(_nd_index(indices, data.shape))]
    return data[tuple(ids)]


def _scatter(out, indices, values):
    """``out[indices] = values`` over the leading M axes, in place, with
    updates whose ids fall out of range after one wrap dropped (the JAX
    package's ``.at[].set``): they land in a spare row that is cut off, so
    nothing is read back to the host."""
    m = indices.shape[0]
    lead = tuple(out.shape[:m])
    ids = _nd_index(indices, lead)
    flat = torch.zeros_like(ids[0])
    valid = torch.ones_like(ids[0], dtype=torch.bool)
    for d, i in enumerate(ids):
        valid &= (i >= 0) & (i < lead[d])
        flat = flat * lead[d] + i
    rows = 1
    for s in lead:
        rows *= s
    flat = torch.where(valid, flat, torch.full_like(flat, rows))
    tail = tuple(out.shape[m:])
    spare = torch.cat([out.reshape((rows,) + tail),
                       out.new_zeros((1,) + tail)])
    vals = values.to(out.dtype).expand(tuple(ids[0].shape) + tail)
    spare.index_put_((flat.reshape(-1),), vals.reshape((-1,) + tail))
    return spare[:rows].reshape(out.shape)


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (ref:
    indexing_op.cc scatter_nd). Duplicate ids are unspecified, as in the
    JAX package."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return _scatter(out, indices, data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, indices, rhs, shape=()):
    """``lhs`` with ``rhs`` written at ``indices``."""
    return _scatter(lhs, indices, rhs)


@register("one_hot", as_method=True)
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """``on_value`` at each id's position of a ``depth``-wide last axis,
    ``off_value`` elsewhere; an id out of [0, depth) (negative too) gives a
    row of ``off_value``, as ``jax.nn.one_hot`` gives zeros."""
    idx = indices.to(torch.int32)
    hot = (idx.unsqueeze(-1) == torch.arange(
        depth, dtype=torch.int32, device=idx.device)).to(torch.float32)
    return (hot * (on_value - off_value) + off_value).to(
        canonical_dtype(dtype))


@register("_contrib_index_copy", aliases=("index_copy",))
def index_copy(old, index, new):
    """``old`` with its rows at ``index`` replaced by ``new``'s (ref:
    contrib/index_copy.cc); rows out of range are dropped."""
    return _scatter(old, index.reshape(1, -1), new)


# ------------------------------------------------------ A10.1: ordering
def _stable_sort(x, axis):
    return torch.sort(x, dim=axis, stable=True)


@register("sort", as_method=True)
def sort(x, axis=-1, is_ascend=True):
    """Sorted along ``axis``. Descending is the stable ascending order
    reversed, as the JAX package flips it: equal values come out in
    reverse index order."""
    y = _stable_sort(x, axis).values
    return y if is_ascend else torch.flip(y, dims=(axis,))


@register("argsort", as_method=True)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    """The indices ``sort`` would order by, as float32 whatever ``dtype``
    says (the JAX package's cast)."""
    idx = _stable_sort(x, axis).indices
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(torch.float32)


@register("topk", as_method=True)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, ties
    lower index first as ``lax.top_k`` orders them: a stable sort, then
    the first ``k``. ``ret_typ`` is ``indices`` (float32), ``value``,
    ``both`` ([values, indices]) or ``mask`` (float32 ones at the chosen
    positions)."""
    xm = x.movedim(axis, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=not is_ascend,
                           stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros(xm.shape, dtype=torch.float32, device=x.device)
        mask.scatter_(-1, idx, 1.0)
        return mask.movedim(-1, axis)
    vals = vals.movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(torch.float32)
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return [vals, idx]
    raise ValueError("unknown ret_typ " + ret_typ)


@register_num_outputs("topk")
def _topk_num_outputs(attrs):
    return 2 if attrs.get("ret_typ") == "both" else 1


# ------------------------------------------------------ A10.1: the rest
@register("khatri_rao")
def khatri_rao(*args):
    """Column-wise Khatri-Rao product (ref: contrib/krprod.cc)."""
    out = args[0]
    for m in args[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


@register("reshape_like", as_method=True)
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """``lhs`` in ``rhs``'s shape, or with its axes [lhs_begin, lhs_end)
    replaced by ``rhs``'s [rhs_begin, rhs_end); a negative bound means
    ndim + bound (ref: elemwise_unary_op_basic.cc reshape_like)."""
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(tuple(rhs.shape))

    def norm(v, ndim, default):
        if v is None:
            return default
        return v + ndim if v < 0 else v

    lb = norm(lhs_begin, lhs.ndim, 0)
    le = norm(lhs_end, lhs.ndim, lhs.ndim)
    rb = norm(rhs_begin, rhs.ndim, 0)
    re_ = norm(rhs_end, rhs.ndim, rhs.ndim)
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


@register("_ravel_multi_index", aliases=("ravel_multi_index",))
def _ravel_multi_index(data, shape=None):
    """(ndim, N) coordinates -> row-major flat indices, int32 (ref:
    tensor/ravel.cc)."""
    shape = tuple(int(s) for s in shape)
    idx = data.to(torch.int32)
    out = torch.zeros(tuple(idx.shape[1:]), dtype=torch.int32,
                      device=idx.device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        out = out + idx[d] * stride
        stride *= shape[d]
    return out


@register("_unravel_index", aliases=("unravel_index",))
def _unravel_index(data, shape=None):
    """Flat indices -> (ndim, N) coordinates, int32 (floor division and
    modulo, as the JAX package's)."""
    shape = tuple(int(s) for s in shape)
    rem = data.to(torch.int32)
    coords = []
    for size in reversed(shape):
        coords.append(torch.remainder(rem, size))
        rem = torch.div(rem, size, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0)
