"""Weight initializers (counterpart of ``mxtpu/initializer.py``).

The reference's name-suffix dispatch (``*weight`` -> ``_init_weight``,
``*bias``/``*beta``/``*running_mean`` -> zeros, ``*gamma``/``*running_var``
-> ones) over float32 draws from an explicit ``torch.Generator`` on the
host, so a seed gives the same weights on every device. ``Uniform(0.07)``
is the default, as in the reference. The reference's initializers are all
here (``Constant``, ``Normal``, ``Xavier``, ``MSRAPrelu``, ``Orthogonal``,
``Bilinear``, ``LSTMBias``, ``Mixed``), with their scale formulas; the
draws differ from JAX's keys, so one seed gives the same moments, not
the same numbers.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Mixed", "register", "create"]

_REGISTRY = {}


def register(klass):
    """Register an Initializer class under its lower-case name (ref:
    initializer.py:register); ``zeros``/``ones`` name Zero and One too."""
    _REGISTRY[klass.__name__.lower()] = klass
    alias = {"zero": "zeros", "one": "ones"}.get(klass.__name__.lower())
    if alias:
        _REGISTRY[alias] = klass
    return klass


class InitDesc(str):
    """Parameter name + attrs hint (ref: initializer.py:InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer: ``init(desc, arr, generator)`` fills the float CPU
    tensor ``arr`` in place, choosing the rule by the parameter's name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON, which ``create`` reads back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr, generator):
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr, generator)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr, generator)
        elif name.endswith(("bias", "beta", "running_mean", "moving_mean",
                            "min", "max")):
            arr.zero_()
        elif name.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            self._init_default(desc, arr, generator)

    def _init_weight(self, desc, arr, gen):  # pragma: no cover - abstract
        raise NotImplementedError

    def _init_default(self, desc, arr, gen):
        self._init_weight(desc, arr, gen)

    def __eq__(self, other):
        return type(self) is type(other) and self._kwargs == other._kwargs

    __hash__ = object.__hash__


def _uniform(shape, low, high, gen):
    d = torch.rand(shape, generator=gen, dtype=torch.float32)
    return d * (high - low) + low


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr, gen):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, desc, arr, gen):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr, gen):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr, gen):
        d = torch.rand(arr.shape, generator=gen, dtype=torch.float32)
        arr.copy_(d * (2 * self.scale) - self.scale)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr, gen):
        arr.copy_(torch.randn(arr.shape, generator=gen,
                              dtype=torch.float32) * self.sigma)


@register
class Xavier(Initializer):
    """Ref: initializer.py:Xavier: scale sqrt(magnitude / factor), the
    factor fan_in, fan_out or their mean (``factor_type`` in/out/avg),
    drawn uniform on [-scale, scale] or gaussian with sigma scale; a
    parameter of fewer than 2 dims gets U(-0.07, 0.07)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr, gen):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            arr.copy_(_uniform(shape, -0.07, 0.07, gen))
            return
        hw_scale = 1.0
        for s in shape[2:]:
            hw_scale *= s
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            factor = (fan_in + fan_out) / 2.0
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.copy_(_uniform(shape, -scale, scale, gen))
        else:
            arr.copy_(torch.randn(shape, generator=gen,
                                  dtype=torch.float32) * scale)


@register
class MSRAPrelu(Xavier):
    """Ref: initializer.py:MSRAPrelu: gaussian Xavier with magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor of a uniform or normal draw
    (ref: initializer.py:Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr, gen):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _uniform((nout, nin), -1.0, 1.0, gen)
        else:
            tmp = torch.randn((nout, nin), generator=gen,
                              dtype=torch.float32)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Bilinear(Initializer):
    """Upsampling deconvolution kernel (ref: initializer.py:Bilinear)."""

    def _init_weight(self, desc, arr, gen):
        shape = tuple(arr.shape)
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.reshape(shape)))


@register
class LSTMBias(Initializer):
    """Forget-gate bias ``forget_bias``, the rest 0 (ref:
    initializer.py:LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr, gen):
        arr.zero_()
        num_hidden = arr.shape[0] // 4
        arr[num_hidden:2 * num_hidden] = self.forget_bias

    _init_default = _init_weight


class Mixed:
    """Pattern -> initializer mapping: the first pattern that matches a
    parameter's name initializes it (ref: initializer.py:Mixed)."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise MXNetError("Parameter %s did not match any pattern" % name)


def create(init, **kwargs):
    """An Initializer from an instance, a registered name (with
    ``kwargs``) or ``Initializer.dumps()``'s JSON."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        if init.startswith("["):
            name, kw = json.loads(init)
            return _REGISTRY[name](**kw)
        klass = _REGISTRY.get(init.lower())
        if klass is not None:
            return klass(**kwargs)
    raise MXNetError("cannot create initializer from %r" % (init,))
