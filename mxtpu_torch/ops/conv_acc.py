"""Convolution dispatch (counterpart of ``mxtpu/ops/conv_acc.py:conv_fast``).

Convs that ``pallas.conv.pallas_applicable`` admits go to the hand-written
fused conv kernel; that is the port's default on the card (the JAX package
stages the same route behind ``MXTPU_PALLAS_CONV``). Every other conv runs
``torch.nn.functional.conv2d`` on NCHW views, the counterpart of the plain
XLA conv: those convs ran outside any Pallas kernel in the JAX package too.
The JAX package's im2col and f32-accumulate custom-vjp branches are off by
default there and are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .precision_util import promote

__all__ = ["conv_fast"]

_TO_NCHW = {"NHWC": (0, 3, 1, 2), "NCHW": None}
_W_TO_OIHW = {"HWIO": (3, 2, 0, 1), "OIHW": None}


def conv_fast(x, w, strides, padding, lhs_dilation, rhs_dilation, dims,
              groups, bias=None):
    """The gated fused kernel, else the plain conv; ``bias`` (a [C_out]
    vector) is applied on every path. ``dims`` is the (lhs, rhs, out)
    layout triple, ``padding`` per-dim (lo, hi) pairs."""
    from .pallas.conv import fused_conv, pallas_applicable
    ok, _reason = pallas_applicable(x, w, strides, padding, lhs_dilation,
                                    rhs_dilation, dims, groups)
    if ok:
        # a bias that would promote the output (f32 bias on bf16 operands)
        # stays an external add: the fused epilogue keeps the conv dtype
        out_dt = promote(x.dtype, w.dtype)
        fuse_bias = bias is not None and promote(out_dt, bias.dtype) == out_dt
        out = fused_conv(x.contiguous(), w.contiguous(),
                         strides=tuple(strides),
                         padding=tuple(map(tuple, padding)),
                         bias=bias if fuse_bias else None)
        return out if fuse_bias else _with_bias(out, bias, dims)
    return _with_bias(_plain_conv(x, w, strides, padding, lhs_dilation,
                                  rhs_dilation, dims, groups), bias, dims)


def _plain_conv(x, w, strides, padding, lhs_dilation, rhs_dilation, dims,
                groups):
    lhs, rhs, out_l = dims
    if x.ndim != 4 or lhs not in _TO_NCHW or rhs not in _W_TO_OIHW \
            or out_l != lhs:
        raise MXNetError("conv_fast: only 2-D NCHW/OIHW and NHWC/HWIO convs "
                         "are ported, got %s" % (dims,))
    if tuple(lhs_dilation) != (1, 1):
        raise MXNetError("conv_fast: transposed convs (lhs dilation) are "
                         "not ported")
    dt = promote(x.dtype, w.dtype)
    xc = x.to(dt) if _TO_NCHW[lhs] is None else x.to(dt).permute(_TO_NCHW[lhs])
    wc = w.to(dt) if _W_TO_OIHW[rhs] is None else \
        w.to(dt).permute(_W_TO_OIHW[rhs])
    (plo, phi), (qlo, qhi) = (tuple(p) for p in padding)
    if plo == phi and qlo == qhi:
        pad = (plo, qlo)
    else:
        xc = F.pad(xc, (qlo, qhi, plo, phi))
        pad = (0, 0)
    out = F.conv2d(xc, wc, stride=tuple(strides), padding=pad,
                   dilation=tuple(rhs_dilation), groups=int(groups))
    if _TO_NCHW[lhs] is not None:
        out = out.permute(0, 2, 3, 1).contiguous()
    return out


def _with_bias(out, bias, dims):
    if bias is None:
        return out
    if dims[2][-1] == "C":
        return out + bias
    return out + bias.reshape((1, -1) + (1,) * (out.ndim - 2))
