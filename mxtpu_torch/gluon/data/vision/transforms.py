"""Vision transforms (counterpart of
``mxtpu/gluon/data/vision/transforms.py``; ref:
python/mxnet/gluon/data/vision/transforms.py).

Each transform is a Block over the _image_* ops (``ops/image_ops.py``), so
a chain runs on the array's device: an NDArray in gives an NDArray out, a
tensor a tensor. Host randomness (crop boxes, jitter factors, the jitter
order) comes from Python's ``random`` and ``RandomLighting``'s noise from
``np.random``, as in the reference, so a seeded chain draws the
reference's values; the random flips draw on the device from the port's
generator (``ops/image_ops.py``).
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch

from ....base import torch_dtype
from ....ndarray import NDArray
from ....ndarray.ndarray import _apply
from ....ops import image_ops as _ops
from ...block import Block, HybridBlock
from ...nn import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting"]


def _run(fn, data, **kwargs):
    """``fn`` on an NDArray (through ``_apply``) or on a tensor."""
    if isinstance(data, NDArray):
        return _apply(fn, (data,), kwargs)
    return fn(data, **kwargs)


class Compose(HybridSequential):
    """Sequentially compose transforms (ref: transforms.py:Compose)."""

    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            for t in transforms:
                self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.to(torch_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 -> CHW float32 in [0,1] (ref: transforms.py:ToTensor)."""

    def hybrid_forward(self, F, x):
        return _ops.image_to_tensor(x)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        return _ops.image_normalize(x, mean=self._mean, std=self._std)


class Resize(HybridBlock):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def hybrid_forward(self, F, x):
        size = self._size
        if self._keep and isinstance(size, int):
            h, w = x.shape[-3], x.shape[-2] if x.ndim == 4 else x.shape[1]
            if x.ndim == 3:
                h, w = x.shape[0], x.shape[1]
            scale = size / min(h, w)
            size = (int(round(w * scale)), int(round(h * scale)))
        return _ops.image_resize(x, size=size, interp=self._interp)


def _hw(x):
    return (x.shape[0], x.shape[1]) if x.ndim == 3 else \
        (x.shape[1], x.shape[2])


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if not isinstance(size, int) else (size, size)
        self._interp = interpolation

    def forward(self, x):
        w, h = self._size
        H, W = _hw(x)
        if H < h or W < w:
            x = _run(_ops.image_resize, x, size=(max(w, W), max(h, H)),
                     interp=self._interp)
        return _run(_ops.image_center_crop, x, size=self._size)


class RandomResizedCrop(Block):
    """Random area/aspect crop then resize (ref: transforms.py:
    RandomResizedCrop; the box drawn on the host from Python's random)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if not isinstance(size, int) else (size, size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        H, W = _hw(x)
        area = H * W
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            aspect = _pyrandom.uniform(*self._ratio)
            w = int(round((target_area * aspect) ** 0.5))
            h = int(round((target_area / aspect) ** 0.5))
            if w <= W and h <= H:
                x0 = _pyrandom.randint(0, W - w)
                y0 = _pyrandom.randint(0, H - h)
                crop = _run(_ops.image_crop, x, x=x0, y=y0, width=w,
                            height=h)
                return _run(_ops.image_resize, crop, size=self._size,
                            interp=self._interp)
        side = min(W, H)
        crop = _run(_ops.image_center_crop, x, size=(side, side))
        return _run(_ops.image_resize, crop, size=self._size,
                    interp=self._interp)


class RandomFlipLeftRight(HybridBlock):
    def hybrid_forward(self, F, x):
        return _ops.image_random_flip_left_right(x)


class RandomFlipTopBottom(HybridBlock):
    def hybrid_forward(self, F, x):
        return _ops.image_random_flip_top_bottom(x)


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._b, self._b)
        return _run(_ops.image_brightness, x, alpha=alpha)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._c, self._c)
        return _run(_ops.image_contrast, x, alpha=alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._s, self._s)
        return _run(_ops.image_saturation, x, alpha=alpha)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        alpha = _pyrandom.uniform(-self._h, self._h)
        return _run(_ops.image_hue, x, alpha=alpha)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = list(self._transforms)
        _pyrandom.shuffle(order)
        for t in order:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA noise (ref: transforms.py:RandomLighting)."""

    _eigval = np.asarray([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.asarray([[-0.5675, 0.7192, 0.4009],
                          [-0.5808, -0.0045, -0.8140],
                          [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = np.random.normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)

        def add(t):
            return t + torch.as_tensor(rgb.reshape((1, 1, 3)),
                                       device=t.device)
        return _run(add, x)
