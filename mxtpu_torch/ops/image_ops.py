"""Image ops: decode-side tensor transforms (counterpart of
``mxtpu/ops/image_ops.py``).

Reference: ``src/operator/image/image_random-inl.h`` (to_tensor, normalize,
random flips, brightness, contrast, saturation, hue) and ``mx.image``'s
resize and crop.

The ops run on tensors of any device in plain torch. Resize repeats the
JAX package's ``jax.image.resize`` (half-pixel sample positions, a
triangle or Keys cubic kernel widened when downsampling, weights
normalized over the input's extent, one weight matrix per resized axis),
so its results agree to rounding. The random flips draw one Bernoulli for
the whole array from the port's generator of the array's device
(``mxtpu_torch.random``), where the reference splits its JAX key. Layout
follows the reference: HWC uint8 or float in, ``to_tensor`` gives CHW
float32 (NHWC gives NCHW).
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["image_to_tensor", "image_normalize", "image_resize",
           "image_crop", "image_center_crop", "image_flip_left_right",
           "image_flip_top_bottom", "image_random_flip_left_right",
           "image_random_flip_top_bottom", "image_brightness",
           "image_contrast", "image_saturation", "image_hue"]

_LUMA = (0.299, 0.587, 0.114)
_F32_EPS = 1.1920928955078125e-07   # np.finfo(np.float32).eps


def _f32(x):
    return x.to(torch.float32)


@register("_image_to_tensor", aliases=("image_to_tensor",))
def image_to_tensor(data):
    """HWC [0,255] -> CHW [0,1] float32 (ref: image_random-inl.h ToTensor).
    Batched NHWC input becomes NCHW."""
    x = _f32(data) / 255.0
    if x.ndim == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


def _channel(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


@register("_image_normalize", aliases=("image_normalize",))
def image_normalize(data, mean=0.0, std=1.0):
    """Channel-wise (x - mean) / std on CHW or NCHW input (ref: Normalize)."""
    mean = _channel(mean, data)
    std = _channel(std, data)
    lead = (-1, 1, 1) if data.ndim == 3 else (1, -1, 1, 1)
    if mean.ndim:
        mean = mean.reshape(lead)
    if std.ndim:
        std = std.reshape(lead)
    return (_f32(data) - mean) / std


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _weight_mat(in_size, out_size, kernel, device):
    """[in, out] interpolation weights of one axis (jax.image's
    ``compute_weight_mat`` with antialias, in float32)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=device)[:, None]).abs() \
        / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize_nearest(x, axes, sizes):
    for d, n in zip(axes, sizes):
        m = x.shape[d]
        if m == n:
            continue
        offsets = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5) * m / n)
        x = x.index_select(d, offsets.to(torch.long))
    return x


@register("_image_resize", aliases=("image_resize",))
def image_resize(data, size=None, keep_ratio=False, interp=1):
    """Resize HWC (or NHWC) images (ref: mx.image.imresize). interp:
    0=nearest, 1=bilinear, 2=bicubic; integer input is truncated back to
    its dtype."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size  # reference convention: size=(w, h)
    axes = (0, 1) if data.ndim == 3 else (1, 2)
    x = _f32(data)
    interp = int(interp)
    if interp == 0:
        out = _resize_nearest(x, axes, (h, w))
    else:
        kernel = _keys_cubic if interp == 2 else _triangle
        letters = "abcd"[:x.ndim]
        out_letters = list(letters)
        operands, specs = [x], [letters]
        for d, n, new in zip(axes, (h, w), "HW"):
            if x.shape[d] == n:
                continue
            operands.append(_weight_mat(x.shape[d], n, kernel, x.device))
            specs.append(letters[d] + new)
            out_letters[d] = new
        out = x if len(operands) == 1 else torch.einsum(
            ",".join(specs) + "->" + "".join(out_letters), *operands)
    if not data.is_floating_point():
        return out.to(data.dtype)
    return out


def _crop_raw(data, x, y, w, h):
    if data.ndim == 3:
        return data[y:y + h, x:x + w, :]
    return data[:, y:y + h, x:x + w, :]


@register("_image_crop", aliases=("image_crop",))
def image_crop(data, x=0, y=0, width=None, height=None):
    """Fixed crop of HWC/NHWC (ref: mx.image.fixed_crop)."""
    return _crop_raw(data, x, y, width, height)


@register("_image_center_crop", aliases=("image_center_crop",))
def image_center_crop(data, size=None):
    if isinstance(size, int):
        size = (size, size)
    w, h = size
    H, W = (data.shape[0], data.shape[1]) if data.ndim == 3 \
        else (data.shape[1], data.shape[2])
    y = max((H - h) // 2, 0)
    x = max((W - w) // 2, 0)
    return _crop_raw(data, x, y, w, h)


@register("_image_flip_left_right", aliases=("image_flip_left_right",))
def image_flip_left_right(data):
    return torch.flip(data, dims=(1 if data.ndim == 3 else 2,))


@register("_image_flip_top_bottom", aliases=("image_flip_top_bottom",))
def image_flip_top_bottom(data):
    return torch.flip(data, dims=(0 if data.ndim == 3 else 1,))


def _random_flip(data, p, axis):
    from ..random import generator
    draw = torch.rand((), generator=generator(data.device),
                      device=data.device)
    return torch.where(draw < p, torch.flip(data, dims=(axis,)), data)


@register("_image_random_flip_left_right",
          aliases=("image_random_flip_left_right",))
def image_random_flip_left_right(data, p=0.5):
    """Flip with probability ``p`` (one draw for the whole array, on the
    array's device: no host sync)."""
    return _random_flip(data, p, 1 if data.ndim == 3 else 2)


@register("_image_random_flip_top_bottom",
          aliases=("image_random_flip_top_bottom",))
def image_random_flip_top_bottom(data, p=0.5):
    return _random_flip(data, p, 0 if data.ndim == 3 else 1)


def _blend(a, b, alpha):
    return _f32(a) * alpha + b * (1.0 - alpha)


def _gray(data):
    coef = torch.tensor(_LUMA, dtype=torch.float32, device=data.device)
    return (_f32(data) * coef).sum(dim=-1, keepdim=True)


@register("_image_brightness", aliases=("image_brightness",))
def image_brightness(data, alpha=1.0):
    return _blend(data, 0.0, alpha)


@register("_image_contrast", aliases=("image_contrast",))
def image_contrast(data, alpha=1.0):
    mean = _gray(data).mean(dim=(-3, -2), keepdim=True)
    return _blend(data, mean, alpha)


@register("_image_saturation", aliases=("image_saturation",))
def image_saturation(data, alpha=1.0):
    return _blend(data, _gray(data), alpha)


@register("_image_hue", aliases=("image_hue",))
def image_hue(data, alpha=0.0):
    """Hue rotation through the YIQ rotation matrix (ref:
    image_random-inl.h RandomHue's yiq transform)."""
    dev = data.device
    u = math.cos(alpha * math.pi)
    w = math.sin(alpha * math.pi)
    t_yiq = torch.tensor([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], dtype=torch.float32,
                         device=dev)
    t_rgb = torch.tensor([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], dtype=torch.float32,
                         device=dev)
    rot = torch.tensor([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], dtype=torch.float32, device=dev)
    m = t_rgb @ rot @ t_yiq
    return torch.einsum("...c,dc->...d", _f32(data), m)
