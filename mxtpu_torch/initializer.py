"""Weight initializers (counterpart of ``mxtpu/initializer.py``).

The reference's name-suffix dispatch (``*weight`` -> ``_init_weight``,
``*bias``/``*beta``/``*running_mean`` -> zeros, ``*gamma``/``*running_var``
-> ones) over float32 draws from an explicit ``torch.Generator`` on the
host, so a seed gives the same weights on every device. ``Uniform(0.07)``
is the default, as in the reference.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Uniform", "create"]


class InitDesc(str):
    """Parameter name + attrs hint (ref: initializer.py:InitDesc)."""

    def __new__(cls, name, attrs=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        return obj


class Initializer:
    """Base initializer: ``init(desc, arr, generator)`` fills the float CPU
    tensor ``arr`` in place, choosing the rule by the parameter's name."""

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
            self._init_weight(desc, arr, generator)

    def _init_weight(self, desc, arr, gen):  # pragma: no cover - abstract
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, desc, arr, gen):
        arr.zero_()


class One(Initializer):
    def _init_weight(self, desc, arr, gen):
        arr.fill_(1.0)


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, desc, arr, gen):
        d = torch.rand(arr.shape, generator=gen, dtype=torch.float32)
        arr.copy_(d * (2 * self.scale) - self.scale)


_BY_NAME = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
            "uniform": Uniform}


def create(init):
    """An Initializer from an instance or a registered name."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lower() in _BY_NAME:
        return _BY_NAME[init.lower()]()
    raise MXNetError("cannot create initializer from %r" % (init,))
