"""Neural-network ops of the serving path (counterpart of ``mxtpu/ops/nn.py``).

Plain functions on tensors, with the JAX package's signatures and layout
handling, each registered for ``mx.nd``: ``Convolution`` (through
``conv_acc.conv_fast``), ``Pooling``, ``Activation``, ``FullyConnected``,
``BatchNorm``, ``LayerNorm``, ``softmax`` and ``log_softmax``. Keywords that only tune the reference's
cuDNN calls (``workspace``, ``cudnn_tune``, ``cudnn_off``) are accepted and
ignored, as the JAX package does.
NHWC tensors go to PyTorch's NCHW operators as permuted views, which are
channels-last in memory, so no copy is made to change layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd
from ..base import MXNetError
from .conv_acc import conv_fast
from .precision_util import promote
from .registry import register

__all__ = ["FullyConnected", "Convolution", "Pooling", "Activation",
           "BatchNorm", "LayerNorm", "softmax", "log_softmax"]


def _pair(v, n=2):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


@register("FullyConnected", aliases=("fully_connected",))
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """y = x W^T + b with the reference's (num_hidden, in_units) weight.
    float32 runs in full float32 and bf16 accumulates in float32
    (precision_util.apply_policy); the output has the operands' type."""
    x = data
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    dt = promote(x.dtype, weight.dtype)
    y = torch.matmul(x.to(dt), weight.to(dt).t())
    if bias is not None and not no_bias:
        y = y + bias
    return y


def _conv_dims(ndim, layout):
    if ndim != 2:
        raise MXNetError("only 2-D convolution is ported (got ndim %d)" % ndim)
    if layout in (None, "NCHW"):
        return ("NCHW", "OIHW", "NCHW")
    return ("NHWC", "HWIO", "NHWC")


@register("Convolution", aliases=("convolution",))
def Convolution(data, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None, workspace=None, cudnn_tune=None, cudnn_off=None):
    """2-D convolution; the bias is handed to conv_fast so every dispatch
    path (fused kernel or plain conv) owns it."""
    ndim = data.ndim - 2
    stride = _pair(stride, ndim)
    dilate = _pair(dilate, ndim)
    pad = _pair(pad, ndim) if pad is not None else (0,) * ndim
    return conv_fast(
        data, weight,
        strides=stride,
        padding=[(p, p) for p in pad],
        lhs_dilation=(1,) * ndim,
        rhs_dilation=dilate,
        dims=_conv_dims(ndim, layout),
        groups=num_group,
        bias=bias if (bias is not None and not no_bias) else None,
    )


def _spatial_axes(ndim, layout):
    channels_last = layout is not None and layout.endswith("C")
    return (tuple(range(1, 1 + ndim)) if channels_last
            else tuple(range(2, 2 + ndim))), channels_last


@register("Pooling", aliases=("pooling",))
def Pooling(data, kernel=None, pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True,
            layout=None, cudnn_off=None, p_value=None):
    """2-D max/avg/sum pooling, or global pooling over the spatial axes.
    Padding reads -inf for max and 0 for avg/sum, and ``"full"`` (ceil)
    convention adds the missing right padding, as the JAX package's
    reduce_window does."""
    ndim = data.ndim - 2
    sp, channels_last = _spatial_axes(ndim, layout)
    if global_pool:
        if pool_type == "max":
            return torch.amax(data, dim=sp, keepdim=True)
        if pool_type == "avg":
            return torch.mean(data, dim=sp, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=sp, keepdim=True)
        raise MXNetError("unported pool_type %r" % pool_type)
    if ndim != 2:
        raise MXNetError("only 2-D pooling is ported (got ndim %d)" % ndim)
    kernel = _pair(kernel, ndim)
    stride = _pair(stride, ndim) if stride is not None else (1,) * ndim
    pad = _pair(pad, ndim) if pad is not None else (0,) * ndim
    x = data.permute(0, 3, 1, 2) if channels_last else data
    lohi = []
    for i in range(ndim):
        lo = hi = pad[i]
        if pooling_convention == "full":
            size = x.shape[2 + i]
            out_sz = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            hi = max(hi, (out_sz - 1) * stride[i] + kernel[i] - size - pad[i])
        lohi.append((lo, hi))
    (plo, phi), (qlo, qhi) = lohi
    if pool_type == "max":
        xp = F.pad(x, (qlo, qhi, plo, phi), value=float("-inf"))
        out = F.max_pool2d(xp, kernel, stride)
    elif pool_type in ("avg", "sum"):
        area = kernel[0] * kernel[1]
        out = F.avg_pool2d(F.pad(x, (qlo, qhi, plo, phi)), kernel, stride)
        if pool_type == "sum":
            out = out * area
        elif not count_include_pad:
            ones = F.pad(torch.ones_like(x[:1, :1]), (qlo, qhi, plo, phi))
            out = out / F.avg_pool2d(ones, kernel, stride)
    else:
        raise MXNetError("unported pool_type %r" % pool_type)
    return out.permute(0, 2, 3, 1).contiguous() if channels_last else out


@register("Activation", aliases=("activation",))
def Activation(x, act_type="relu"):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return x / (1 + torch.abs(x))
    raise MXNetError("unknown act_type " + act_type)


@register("BatchNorm", aliases=("batch_norm",))
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False):
    """Batch normalization, computed in float32 and cast back to the
    input's type (ref: mxtpu/ops/nn.py:BatchNorm). In autograd training
    mode, unless ``use_global_stats``, it normalizes by the batch
    statistics in the JAX package's default one-pass form (``mean = E[x]``,
    ``var = max(E[x^2] - mean^2, 0)``; gradients flow through them);
    otherwise by the moving statistics. The moving-stat update belongs to
    the layer (gluon.nn.BatchNorm). ``output_mean_var`` also returns the
    statistics used."""
    shape = [1] * data.ndim
    ax = axis % data.ndim
    shape[ax] = data.shape[ax]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if autograd.is_training() and not use_global_stats:
        x32 = data.float()
        red = [i for i in range(data.ndim) if i != ax]
        mean = x32.mean(dim=red)
        var = torch.clamp_min(x32.square().mean(dim=red) - mean.square(),
                              0.0)
        inv = torch.rsqrt(var + eps)
        out = (x32 - mean.reshape(shape)) * (inv * g.float()).reshape(shape) \
            + beta.float().reshape(shape)
    else:
        mean, var = moving_mean, moving_var
        inv = torch.rsqrt(moving_var.float() + eps)
        out = (data.float() - moving_mean.float().reshape(shape)) \
            * (inv * g.float()).reshape(shape) + beta.float().reshape(shape)
    out = out.to(data.dtype)
    return (out, mean, var) if output_mean_var else out


@register("LayerNorm", aliases=("layer_norm",))
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Layer normalization in the JAX package's order: mean and (biased)
    variance in float32, normalize and cast back to the input's type, and
    only then scale by gamma and shift by beta in that type (in bfloat16
    the order decides the last bit). ``output_mean_var`` also returns the
    float32 mean and variance with ``axis`` squeezed out."""
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype)
    shape = [1] * data.ndim
    ax = axis % data.ndim
    shape[ax] = data.shape[ax]
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    if output_mean_var:
        return [out, mean.squeeze(ax), var.squeeze(ax)]
    return out


@register("softmax", aliases=("Softmax",), as_method=True)
def softmax(x, axis=-1, temperature=None, length=None, **_ig):
    """softmax(x / temperature) over ``axis``; ``length`` (one count per
    row of a 2-D input) masks the positions at and past it to -inf first."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        pos = torch.arange(x.shape[axis], device=x.device)
        x = torch.where(pos < length.to(torch.int32).unsqueeze(-1), x,
                        float("-inf"))
    return torch.softmax(x, dim=axis)


@register("log_softmax", as_method=True)
def log_softmax(x, axis=-1, temperature=None, **_ig):
    """log(softmax(x / temperature)) over ``axis``."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.log_softmax(x, dim=axis)
