"""Activation layers (counterpart of ``mxtpu/gluon/nn/activations.py``):
Activation, LeakyReLU, PReLU, ELU, SELU, Swish and GELU."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class Activation(HybridBlock):
    """Wraps the Activation op; named after its type (relu0, relu1, ...)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation({})".format(self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU({})".format(self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU whose slope ``alpha`` (shape (1,), 0.25 by default) is a
    parameter (ref: activations.py:PReLU)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """GELU in the tanh form, as the JAX package's layer."""

    def hybrid_forward(self, F, x):
        return 0.5 * x * (1.0 + F.tanh(
            0.7978845608028654 * (x + 0.044715 * x * x * x)))
