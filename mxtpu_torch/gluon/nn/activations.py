"""Activation layers (counterpart of ``mxtpu/gluon/nn/activations.py``)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """Wraps the Activation op; named after its type (relu0, relu1, ...)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)
