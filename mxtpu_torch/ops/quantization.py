"""INT8 quantization ops (counterpart of ``mxtpu/ops/quantization.py``;
ref: src/operator/quantization/*).

The reference's signed-symmetric path (quantize-inl.h:75-78): a real range
``r = max(|min|, |max|)`` maps to 127, ``q = sign(x) * min(|x| * 127/r +
0.5, 127)`` truncated to int8. Ranges are float32 scalars (numbers or
0-d tensors), so the serving Predictor keeps them as device tensors it can
overwrite in place. The int8 products accumulate exactly: the int8 values
are multiplied in float64, where every product and every sum of fewer
than 2^38 of them is an integer held exactly, then taken to int32, which
is the reference's int32 accumulator on any device (PyTorch has no int8
convolution on CUDA).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["quantize", "dequantize", "requantize",
           "quantized_fully_connected", "quantized_conv",
           "quantized_flatten", "quantized_pooling"]

_QMAX = 127.0


def _f32(x, like=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def _real_range(min_range, max_range, like=None):
    return torch.maximum(_f32(min_range, like).abs(),
                         _f32(max_range, like).abs())


def _to_int8(real, r8):
    # clamp by a Python number: a device constant made here would be a
    # host-to-device copy, which a CUDA-graph capture refuses
    q = torch.sign(real) * (real.abs() * (_QMAX / r8) + 0.5).clamp(max=_QMAX)
    return q.to(torch.int8)


@register("_contrib_quantize", aliases=("quantize",), num_outputs=3)
def quantize(data, min_range, max_range, out_type="int8"):
    """float -> int8 with the range carried through (ref: quantize.cc):
    ``[quantized, -r, r]``."""
    r = _real_range(min_range, max_range, data)
    x = data.to(torch.float32)
    return [_to_int8(x, r), -r, r.clone()]


@register("_contrib_dequantize", aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 -> float32 (ref: dequantize.cc), in one multiply: the int8
    operand is promoted to the float32 scale's type inside the kernel, so
    no float32 copy of ``data`` is made first."""
    r = _real_range(min_range, max_range, data)
    return data * (r / _QMAX)


@register("_contrib_requantize", aliases=("requantize",), num_outputs=3)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8 with a narrower calibrated range (ref:
    requantize.cc); ``min_range``/``max_range`` give the int32's real
    range."""
    r32 = _real_range(min_range, max_range, data)
    real = data.to(torch.float32) * (r32 / (2.0 ** 31 - 1))
    if min_calib_range is not None and max_calib_range is not None:
        r8 = _real_range(min_calib_range, max_calib_range, data)
    else:
        r8 = r32
    return [_to_int8(real, r8), -r8, r8.clone()]


def _scales(data, min_data, max_data, min_weight, max_weight):
    sx = _real_range(min_data, max_data, data) / _QMAX
    sw = _real_range(min_weight, max_weight, data) / _QMAX
    return sx * sw


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, bias=None, min_data=None,
                              max_data=None, min_weight=None, max_weight=None,
                              min_bias=None, max_bias=None, num_hidden=None,
                              no_bias=False, flatten=True):
    """int8 x int8 -> float32 fully connected (ref:
    quantized_fully_connected.cc): the int32 product times one dequant
    scale, then the float32 bias (kept in float32, as the JAX package
    does)."""
    x = data.to(torch.int8)
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    acc = torch.matmul(x.to(torch.float64),
                       weight.to(torch.int8).to(torch.float64).t())
    out = acc.to(torch.int32).to(torch.float32) * _scales(
        data, min_data, max_data, min_weight, max_weight)
    if bias is not None and not no_bias:
        out = out + bias.to(torch.float32)
    return out


@register("_contrib_quantized_conv", aliases=("quantized_conv",))
def quantized_conv(data, weight, bias=None, min_data=None, max_data=None,
                   min_weight=None, max_weight=None, min_bias=None,
                   max_bias=None, kernel=None, stride=None, dilate=None,
                   pad=None, num_filter=None, num_group=1, no_bias=False,
                   layout=None):
    """int8 convolution with an int32 accumulator (ref:
    quantized_conv.cc), 2-D, NCHW/OIHW or NHWC/HWIO."""
    from .nn import _conv_dims, _pair
    ndim = data.ndim - 2
    stride = _pair(stride, ndim)
    dilate = _pair(dilate, ndim)
    pad = _pair(pad, ndim) if pad is not None else (0,) * ndim
    channels_last = _conv_dims(ndim, layout)[0][-1] == "C"
    x = data.to(torch.int8).to(torch.float64)
    w = weight.to(torch.int8).to(torch.float64)
    if channels_last:
        x = x.permute(0, 3, 1, 2)
        w = w.permute(3, 2, 0, 1)
    acc = F.conv2d(x, w, stride=stride, padding=pad, dilation=dilate,
                   groups=num_group)
    if channels_last:
        acc = acc.permute(0, 2, 3, 1)
    out = acc.to(torch.int32).to(torch.float32) * _scales(
        data, min_data, max_data, min_weight, max_weight)
    if bias is not None and not no_bias:
        b = bias.to(torch.float32)
        out = out + (b if channels_last else b.reshape((1, -1) + (1,) * ndim))
    return out


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",),
          num_outputs=3)
def quantized_flatten(data, min_data, max_data):
    """Flatten an int8 tensor, ranges unchanged (ref:
    quantized_flatten.cc)."""
    return (data.reshape(data.shape[0], -1), min_data, max_data)


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",),
          num_outputs=3)
def quantized_pooling(data, min_data, max_data, kernel=None, pool_type="max",
                      global_pool=False, stride=None, pad=None,
                      pooling_convention="valid", layout=None):
    """Pooling on int8 data, ranges unchanged (ref: quantized_pooling.cc):
    max is exact, avg accumulates in float and rounds back to int8."""
    from .nn import Pooling
    x = data.to(torch.float32)
    out = Pooling(x, kernel=kernel, pool_type=pool_type,
                  global_pool=global_pool, stride=stride, pad=pad,
                  pooling_convention=pooling_convention, layout=layout)
    if pool_type != "max":
        out = torch.clamp(torch.round(out), -128, 127)
    return (out.to(data.dtype), min_data, max_data)
