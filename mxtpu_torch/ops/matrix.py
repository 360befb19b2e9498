"""Shape and indexing ops of the transformer path (counterpart of
``mxtpu/ops/matrix.py``): ``reshape`` with MXNet's special codes,
``transpose`` and the ``Embedding`` lookup."""
from __future__ import annotations

import torch

__all__ = ["reshape", "transpose", "Embedding"]


def reshape(x, shape=None):
    """MXNet reshape: 0 copies the input dim, -1 infers one dim, -2 copies
    every remaining dim, -3 merges two dims, -4 splits one dim into the
    next two values (either may be -1) (ref: matrix_op.cc ReshapeParam)."""
    if shape is None:
        raise ValueError("reshape requires target shape")
    src, tgt, shape = list(x.shape), [], list(shape)
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
    return torch.reshape(x, tuple(tgt))


def transpose(x, axes=None):
    """Permute the axes (reverse them when ``axes`` is empty)."""
    axes = tuple(axes) if axes else tuple(range(x.ndim - 1, -1, -1))
    return x.permute(axes)


def Embedding(data, weight, input_dim=None, output_dim=None):
    """Rows of ``weight`` for the ids in ``data``, ids cast to int32 and
    clipped to ``[0, input_dim - 1]`` as the JAX package does (an
    out-of-range id reads the first or last row, never raises)."""
    idx = data.to(torch.int32).clamp(0, weight.shape[0] - 1)
    return weight.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(weight.shape[1:]))
