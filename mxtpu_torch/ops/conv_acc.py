"""Convolution dispatch (counterpart of ``mxtpu/ops/conv_acc.py:conv_fast``).

Convs that ``pallas.conv.pallas_applicable`` admits go to the hand-written
fused conv kernel; that is the port's default on the card (the JAX package
stages the same route behind ``MXTPU_PALLAS_CONV``). Every other conv
(any 1-, 2- or 3-D conv) runs ``torch.nn.functional.conv{1,2,3}d`` on
channels-first views, the counterpart of the plain XLA conv: those convs
ran outside any Pallas kernel in the JAX package too. A conv the gate
refuses counts in B1's ``DISPATCH_STATS`` with the gate's reason.
The JAX package's im2col and f32-accumulate custom-vjp branches are off by
default there and are not ported.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..base import MXNetError
from .precision_util import promote

__all__ = ["conv_fast"]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_fast(x, w, strides, padding, lhs_dilation, rhs_dilation, dims,
              groups, bias=None):
    """The gated fused kernel, else the plain conv; ``bias`` (a [C_out]
    vector) is applied on every path. ``dims`` is the (lhs, rhs, out)
    layout triple, ``padding`` per-dim (lo, hi) pairs."""
    from .pallas.conv import count_fallback, fused_conv, pallas_applicable
    ok, reason = pallas_applicable(x, w, strides, padding, lhs_dilation,
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
    if x.device.type != "meta":
        count_fallback(reason)
    return _with_bias(_plain_conv(x, w, strides, padding, lhs_dilation,
                                  rhs_dilation, dims, groups), bias, dims)


def _plain_conv(x, w, strides, padding, lhs_dilation, rhs_dilation, dims,
                groups):
    lhs, rhs, out_l = dims
    nd = x.ndim - 2
    if nd not in _CONV or out_l != lhs or len(lhs) != nd + 2:
        raise MXNetError("conv_fast: only 1-3-D convs with matching input "
                         "and output layouts are ported, got %s" % (dims,))
    if tuple(lhs_dilation) != (1,) * nd:
        raise MXNetError("conv_fast: lhs dilation is not ported (the "
                         "Deconvolution op runs conv_transpose)")
    last = lhs[-1] == "C"
    dt = promote(x.dtype, w.dtype)
    xc, wc = x.to(dt), w.to(dt)
    if last:   # NHWC-style input, HWIO-style weight: channels-first views
        xc = xc.permute(0, nd + 1, *range(1, nd + 1))
        wc = wc.permute(nd + 1, nd, *range(nd))
    pads = [tuple(p) for p in padding]
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xc = F.pad(xc, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        pad = (0,) * nd
    out = _CONV[nd](xc, wc, stride=tuple(strides), padding=pad,
                    dilation=tuple(rhs_dilation), groups=int(groups))
    if last:
        out = out.permute(0, *range(2, nd + 2), 1).contiguous()
    return out


def _with_bias(out, bias, dims):
    if bias is None:
        return out
    if dims[2][-1] == "C":
        return out + bias
    return out + bias.reshape((1, -1) + (1,) * (out.ndim - 2))
