"""Neural-network ops of the serving path (counterpart of ``mxtpu/ops/nn.py``).

Plain functions on tensors, with the JAX package's signatures and layout
handling, each registered for ``mx.nd``: ``Convolution`` (1-, 2- and 3-D,
through ``conv_acc.conv_fast``), ``Deconvolution``, ``Pooling`` (1-3-D,
max/avg/sum/lp), ``Activation``, ``LeakyReLU`` (and ``_rrelu_train``),
``Dropout``, ``FullyConnected``, ``BatchNorm``, ``InstanceNorm``,
``LayerNorm``, ``softmax``, ``log_softmax``, ``softmin``,
``SoftmaxActivation``, ``LRN``, ``UpSampling``, ``SoftmaxOutput`` and the
three regression heads (whose fused backwards are autograd Functions), and
the sequence ops ``SequenceMask``, ``SequenceLast`` and
``SequenceReverse``. The
parameter-shape rules at the end fill the weights' shapes that ``Symbol.infer_shape`` does not know. Keywords that only tune
the reference's cuDNN calls (``workspace``, ``cudnn_tune``, ``cudnn_off``)
are accepted and ignored, as the JAX package does.

Random ops (``Dropout`` in training, ``rrelu``) draw from the port's
generator of the tensor's device (``random.generator``), so torch's
streams differ from JAX's keys; the mask is a tensor saved by autograd, so
a backward reuses the forward's draw.
NHWC tensors go to PyTorch's NCHW operators as permuted views, which are
channels-last in memory, so no copy is made to change layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd
from ..base import MXNetError
from .conv_acc import conv_fast
from .precision_util import promote
from .registry import register, register_param_shapes

__all__ = ["FullyConnected", "Convolution", "Deconvolution", "Pooling",
           "Activation", "LeakyReLU", "Dropout", "BatchNorm", "InstanceNorm",
           "LayerNorm", "softmax", "log_softmax", "SoftmaxOutput",
           "SequenceMask", "SequenceLast", "SequenceReverse", "softmin",
           "SoftmaxActivation", "UpSampling", "LRN", "LinearRegressionOutput",
           "LogisticRegressionOutput", "MAERegressionOutput"]


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


_CONV_DIMS = {
    1: {False: ("NCH", "OIH", "NCH"), True: ("NHC", "HIO", "NHC")},
    2: {False: ("NCHW", "OIHW", "NCHW"), True: ("NHWC", "HWIO", "NHWC")},
    3: {False: ("NCDHW", "OIDHW", "NCDHW"),
        True: ("NDHWC", "DHWIO", "NDHWC")},
}


def _conv_dims(ndim, layout):
    """The (lhs, rhs, out) layout triple of the JAX package's
    ``lax.conv_general_dilated`` call; channels-last unless ``layout`` is
    None or channels-first."""
    if ndim not in _CONV_DIMS:
        raise MXNetError("unsupported conv ndim %d" % ndim)
    return _CONV_DIMS[ndim][layout is not None and layout.endswith("C")]


@register("Convolution", aliases=("convolution",))
def Convolution(data, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None, workspace=None, cudnn_tune=None, cudnn_off=None):
    """1-, 2- or 3-D convolution; the bias is handed to conv_fast so every
    dispatch path (fused kernel or plain conv) owns it. Only 2-D NHWC convs
    can take the fused kernel (its gate)."""
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


@register("Deconvolution", aliases=("deconvolution",))
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, layout=None,
                  workspace=None, cudnn_tune=None, cudnn_off=None):
    """Transposed convolution with the reference's weight, ``(in, out/g,
    *k)`` channels-first or ``(*k, out/g, in)`` channels-last; the output
    is ``(in - 1) * stride - 2 * pad + dilate * (k - 1) + adj + 1`` long,
    as the JAX package's lhs-dilated conv gives. It runs
    ``conv_transpose{1,2,3}d`` (the JAX package's lhs-dilated conv never
    takes the fused kernel either); ``target_shape`` is accepted and
    ignored, as there."""
    ndim = data.ndim - 2
    stride = _pair(stride, ndim)
    dilate = _pair(dilate, ndim)
    pad = _pair(pad, ndim) if pad is not None else (0,) * ndim
    adj = _pair(adj, ndim) if adj is not None else (0,) * ndim
    channels_last = _conv_dims(ndim, layout)[0][-1] == "C"
    dt = promote(data.dtype, weight.dtype)
    x, w = data.to(dt), weight.to(dt)
    if channels_last:
        x = x.permute(0, ndim + 1, *range(1, ndim + 1))
        w = w.permute(ndim + 1, ndim, *range(ndim))
    fn = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[ndim - 1]
    out = fn(x, w, stride=stride, padding=pad, output_padding=adj,
             groups=int(num_group), dilation=dilate)
    if channels_last:
        out = out.permute(0, *range(2, ndim + 2), 1).contiguous()
    if bias is not None and not no_bias:
        out = out + (bias if channels_last else
                     bias.reshape((1, -1) + (1,) * ndim))
    return out


def _spatial_axes(ndim, layout):
    channels_last = layout is not None and layout.endswith("C")
    return (tuple(range(1, 1 + ndim)) if channels_last
            else tuple(range(2, 2 + ndim))), channels_last


@register("Pooling", aliases=("pooling",))
def Pooling(data, kernel=None, pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True,
            layout=None, cudnn_off=None, p_value=None):
    """1-, 2- or 3-D max/avg/sum/lp pooling, or global pooling over the
    spatial axes. Padding reads -inf for max and 0 for the others, and
    ``"full"`` (ceil) convention adds the missing right padding, as the JAX
    package's reduce_window does; lp is ``(sum |x|^p)^(1/p)``, p = 2 by
    default."""
    ndim = data.ndim - 2
    sp, channels_last = _spatial_axes(ndim, layout)
    if global_pool:
        if pool_type == "max":
            return torch.amax(data, dim=sp, keepdim=True)
        if pool_type == "avg":
            return torch.mean(data, dim=sp, keepdim=True)
        if pool_type == "sum":
            return torch.sum(data, dim=sp, keepdim=True)
        if pool_type == "lp":
            p = p_value or 2
            return torch.sum(data.abs() ** p, dim=sp,
                             keepdim=True) ** (1.0 / p)
        raise MXNetError("unknown pool_type %r" % pool_type)
    if ndim not in (1, 2, 3):
        raise MXNetError("unsupported pooling ndim %d" % ndim)
    kernel = _pair(kernel, ndim)
    stride = _pair(stride, ndim) if stride is not None else (1,) * ndim
    pad = _pair(pad, ndim) if pad is not None else (0,) * ndim
    x = data.permute(0, ndim + 1, *range(1, ndim + 1)) if channels_last \
        else data
    widths = []   # F.pad's order: the last axis first
    for i in reversed(range(ndim)):
        lo = hi = pad[i]
        if pooling_convention == "full":
            size = x.shape[2 + i]
            out_sz = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            hi = max(hi, (out_sz - 1) * stride[i] + kernel[i] - size - pad[i])
        widths += [lo, hi]
    area = math.prod(kernel)
    avg = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[ndim - 1]
    if pool_type == "max":
        out = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[ndim - 1](
            F.pad(x, widths, value=float("-inf")), kernel, stride)
    elif pool_type in ("avg", "sum"):
        out = avg(F.pad(x, widths), kernel, stride)
        if pool_type == "sum":
            out = out * area
        elif not count_include_pad:
            ones = F.pad(torch.ones_like(x[:1, :1]), widths)
            out = out / avg(ones, kernel, stride)
    elif pool_type == "lp":
        p = p_value or 2
        out = (avg(F.pad(x.abs() ** p, widths), kernel, stride)
               * area) ** (1.0 / p)
    else:
        raise MXNetError("unknown pool_type %r" % pool_type)
    if channels_last:
        return out.permute(0, *range(2, ndim + 2), 1).contiguous()
    return out


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


@register("LeakyReLU")
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    """The leaky/PReLU/ELU/SELU/GELU/RReLU family (ref: leaky_relu.cc);
    ``prelu`` reads the slope from ``gamma`` (a 1-D gamma broadcasts over
    axis 1), ``gelu`` is the tanh form (``jax.nn.gelu``'s default) and
    ``rrelu`` is ``_rrelu_train``."""
    x = data
    if act_type == "rrelu":
        return _rrelu_train(x, lower_bound, upper_bound)
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        g = gamma
        if g.ndim == 1 and g.ndim < x.ndim:
            g = g.reshape((1, -1) + (1,) * (x.ndim - 2))
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x, approximate="tanh")
    raise MXNetError("unknown act_type " + act_type)


@register("_rrelu_train")
def _rrelu_train(data, lower_bound=0.125, upper_bound=0.334):
    """Randomized leaky ReLU: in autograd training mode each negative
    element takes a slope drawn from U(lower, upper) (the port's
    generator), otherwise the mean slope."""
    x = data
    if autograd.is_training():
        from ..random import generator
        s = torch.rand(x.shape, generator=generator(x.device),
                       device=x.device, dtype=torch.float32)
        s = (s * (upper_bound - lower_bound) + lower_bound).to(x.dtype)
        return torch.where(x > 0, x, s * x)
    return torch.where(x > 0, x, (lower_bound + upper_bound) / 2.0 * x)


@register("Dropout", aliases=("dropout",))
def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=None):
    """Inverted dropout (ref: dropout.cc): in autograd training mode, or
    with ``mode="always"``, each element is kept with probability
    ``1 - p`` and scaled by ``1 / (1 - p)``; ``axes`` share one draw along
    them. The mask is drawn from the port's generator of the tensor's
    device (inside a CUDA-graph capture only when the graph registered it)
    and saved by autograd, so the gradient is ``mask * g / (1 - p)``."""
    if p <= 0 or (mode != "always" and not autograd.is_training()):
        return data
    from ..random import generator
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    mask = torch.rand(shape, generator=generator(data.device),
                      device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


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


@register("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Instance normalization of channels-first data over its spatial axes
    (ref: instance_norm.cc), in the data's type as the JAX package's
    (biased variance)."""
    red = tuple(range(2, data.ndim))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


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


class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; the reference's fused backward, which ignores the
    output's cotangent: d(data) = (p - onehot(label)) * grad_scale, with
    ``ignore_label`` masking and batch or valid normalization."""

    @staticmethod
    def forward(ctx, data, label, axis, cfg):
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.axis, ctx.cfg = axis, cfg
        return p

    @staticmethod
    def backward(ctx, _g):
        p, lab = ctx.saved_tensors
        axis = ctx.axis
        grad_scale, ignore_label, use_ignore, normalization, alpha = ctx.cfg
        nclass = p.shape[axis]
        shape = [1] * p.ndim
        shape[axis] = nclass
        classes = torch.arange(nclass, device=p.device).reshape(shape)
        oh = (lab.to(torch.int32).unsqueeze(axis % p.ndim) == classes).to(
            p.dtype)
        if alpha:
            oh = oh * (1.0 - alpha) + alpha / (nclass - 1) * (1.0 - oh)
        grad = p - oh
        if use_ignore:
            valid = (lab != ignore_label).to(p.dtype)
            grad = grad * valid.unsqueeze(axis % p.ndim)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / lab.shape[0]
        elif normalization == "valid" and use_ignore:
            nvalid = torch.clamp_min((lab != ignore_label).sum(), 1)
            grad = grad / nvalid.to(p.dtype)
        return grad * scale, None, None, None


@register("SoftmaxOutput", aliases=("softmax_output",))
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0):
    """softmax(data) over the class axis (1 with ``multi_output``, else
    the last) whose gradient is the implicit cross-entropy's, as the
    reference's fused backward (ref: softmax_output.cc)."""
    axis = 1 if multi_output else -1
    if torch.is_grad_enabled() and data.requires_grad:
        return _SoftmaxOutput.apply(
            data, label, axis, (grad_scale, ignore_label, bool(use_ignore),
                                normalization, smooth_alpha))
    return torch.softmax(data, dim=axis)


@register("softmin")
def softmin(x, axis=-1, **_ig):
    """softmax(-x) over ``axis``."""
    return torch.softmax(-x, dim=axis)


@register("SoftmaxActivation")
def SoftmaxActivation(x, mode="instance"):
    """softmax over the channel axis (``mode="channel"``) or the last one
    (ref: softmax_activation.cc, deprecated there)."""
    return torch.softmax(x, dim=1 if mode == "channel" else -1)


@register("UpSampling")
def UpSampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=None):
    """[N, C, H, W] -> [N, C, H scale, W scale] (ref: upsampling.cc):
    ``nearest`` repeats each pixel, ``bilinear`` interpolates with
    half-pixel centres and clamped edges (``jax.image.resize``). Only the
    first input is read, as in the JAX package."""
    x = data[0]
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    n, c, h, w = x.shape
    return F.interpolate(x, size=(h * scale, w * scale), mode="bilinear",
                         align_corners=False)


@register("LRN")
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels (ref: lrn.cc):
    ``data / (knorm + alpha / nsize * window_sum(data^2))^beta``, the
    window ``nsize`` channels centred on each, zero-padded."""
    sq = data * data
    half = nsize // 2
    pad = [0, 0] * (data.ndim - 2) + [half, half]
    sq = F.pad(sq, pad)
    c = data.shape[1]
    s = sq[:, 0:c]
    for i in range(1, nsize):
        s = s + sq[:, i:i + c]
    return data / torch.pow(knorm + alpha / nsize * s, beta)


# ------------------------------------------------------------ regression heads
_LINKS = {"linear": lambda d: d, "logistic": torch.sigmoid}


class _Regression(torch.autograd.Function):
    """``link(data)`` forward; the reference's backward, which ignores the
    output's cotangent: ``(link(data) - label) * grad_scale / (size /
    batch)`` (its sign for MAE), the label reshaped to the prediction's
    shape (a (N,) label against an (N, 1) prediction must not broadcast to
    (N, N)) and given a zero gradient (ref: regression_output-inl.h)."""

    @staticmethod
    def forward(ctx, data, label, link, grad_scale, mae):
        p = _LINKS[link](data)
        ctx.save_for_backward(p, label)
        ctx.grad_scale, ctx.mae = grad_scale, mae
        return p

    @staticmethod
    def backward(ctx, _g):
        p, lab = ctx.saved_tensors
        diff = p - lab.reshape(p.shape).to(p.dtype)
        if ctx.mae:
            diff = torch.sign(diff)
        num_output = p.numel() // p.shape[0] if p.ndim > 0 and p.shape[0] \
            else 1
        d_lab = torch.zeros_like(lab) if ctx.needs_input_grad[1] else None
        return diff * (ctx.grad_scale / num_output), d_lab, None, None, None


def _regression(data, label, grad_scale, link, mae=False):
    if torch.is_grad_enabled() and (data.requires_grad or label.requires_grad):
        return _Regression.apply(data, label, link, float(grad_scale), mae)
    return _LINKS[link](data)


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def LinearRegressionOutput(data, label, grad_scale=1.0):
    """Identity forward; backward ``(data - label) * grad_scale / n``."""
    return _regression(data, label, grad_scale, "linear")


@register("LogisticRegressionOutput",
          aliases=("logistic_regression_output",))
def LogisticRegressionOutput(data, label, grad_scale=1.0):
    """sigmoid forward; backward ``(sigmoid(data) - label) * grad_scale /
    n``."""
    return _regression(data, label, grad_scale, "logistic")


@register("MAERegressionOutput", aliases=("mae_regression_output",))
def MAERegressionOutput(data, label, grad_scale=1.0):
    """Identity forward; backward ``sign(data - label) * grad_scale /
    n``."""
    return _regression(data, label, grad_scale, "linear", mae=True)


# ------------------------------------------------------------ sequence ops
def _steps_mask(data, sequence_length, axis):
    """[T, N] (axis 0) or [N, T] booleans: step < the sample's length,
    with a trailing 1 for every further axis of ``data``."""
    steps = torch.arange(data.shape[axis], device=data.device)
    lengths = sequence_length.to(torch.int32)
    mask = steps[:, None] < lengths[None, :] if axis == 0 \
        else steps[None, :] < lengths[:, None]
    return mask.reshape(tuple(mask.shape) + (1,) * (data.ndim - 2))


@register("SequenceMask")
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    """Steps at or past each sample's length set to ``value``; time is
    ``axis`` (0: TNC, 1: NTC) (ref: sequence_mask.cc)."""
    if not use_sequence_length or sequence_length is None:
        return data
    return torch.where(_steps_mask(data, sequence_length, axis), data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


@register("SequenceLast")
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    """Each sample's last valid step along ``axis`` (ref:
    sequence_last.cc)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = (sequence_length.to(torch.int64) - 1).clamp(min=0)
    moved = data.movedim(axis, 0)   # (T, N, ...)
    idx = last.reshape((1, -1) + (1,) * (moved.ndim - 2)).expand(
        (1,) + tuple(moved.shape[1:]))
    return moved.gather(0, idx)[0]


@register("SequenceReverse")
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """The first ``length`` steps of each sample reversed, the rest in
    place; time is axis 0 (ref: sequence_reverse.cc)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    lengths = sequence_length.to(torch.int64)[None, :]
    rev = torch.where(steps < lengths, lengths - 1 - steps, steps)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (data.ndim - 2))
    return data.gather(0, rev.expand(data.shape))


# ---------------------------------------------------- parameter shape rules
# The backward fill of each reference op's FInferShape (the weight's shape
# from the data's), read by Symbol.infer_shape through the registry.
@register_param_shapes("FullyConnected")
def _fc_param_shapes(shapes, attrs):
    data = shapes[0]
    if data is None:
        return {}
    num_hidden = int(attrs.get("num_hidden"))
    if attrs.get("flatten", True):
        in_units = math.prod(data[1:])
    else:
        in_units = data[-1]
    out = {1: (num_hidden, in_units)}
    if len(shapes) > 2 and not attrs.get("no_bias", False):
        out[2] = (num_hidden,)
    return out


def _conv_weight(attrs, data, transposed):
    ndim = len(data) - 2
    kernel = _pair(attrs.get("kernel"), ndim)
    num_filter = int(attrs.get("num_filter"))
    num_group = int(attrs.get("num_group", 1))
    layout = attrs.get("layout") or "NC" + "DHW"[3 - ndim:]
    channels_last = layout[-1] == "C"
    in_ch = data[layout.index("C")]
    if transposed:
        return (kernel + (num_filter // num_group, in_ch) if channels_last
                else (in_ch, num_filter // num_group) + kernel)
    return (kernel + (in_ch // num_group, num_filter) if channels_last
            else (num_filter, in_ch // num_group) + kernel)


@register_param_shapes("Convolution")
def _conv_param_shapes(shapes, attrs):
    if shapes[0] is None:
        return {}
    out = {1: _conv_weight(attrs, shapes[0], False)}
    if len(shapes) > 2 and not attrs.get("no_bias", False):
        out[2] = (int(attrs.get("num_filter")),)
    return out


@register_param_shapes("Deconvolution")
def _deconv_param_shapes(shapes, attrs):
    if shapes[0] is None:
        return {}
    out = {1: _conv_weight(attrs, shapes[0], True)}
    if len(shapes) > 2 and not attrs.get("no_bias", True):
        out[2] = (int(attrs.get("num_filter")),)
    return out


def _channel_param_shapes(shapes, attrs, default_axis):
    data = shapes[0]
    if data is None:
        return {}
    c = (data[int(attrs.get("axis", default_axis)) % len(data)],)
    return {i: c for i in range(1, len(shapes))}


register_param_shapes("BatchNorm")(
    lambda shapes, attrs: _channel_param_shapes(shapes, attrs, 1))
register_param_shapes("InstanceNorm")(
    lambda shapes, attrs: _channel_param_shapes(shapes, attrs, 1))
register_param_shapes("LayerNorm")(
    lambda shapes, attrs: _channel_param_shapes(shapes, attrs, -1))


@register_param_shapes("LeakyReLU")
def _leaky_param_shapes(shapes, attrs):
    # only PReLU learns a gamma, one per channel (ref: leaky_relu-inl.h)
    if attrs.get("act_type") != "prelu" or shapes[0] is None \
            or len(shapes) < 2:
        return {}
    return {1: (shapes[0][1],)}
