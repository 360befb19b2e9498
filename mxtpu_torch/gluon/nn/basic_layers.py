"""Basic layers (counterpart of ``mxtpu/gluon/nn/basic_layers.py``):
HybridSequential, Dense, BatchNorm, LayerNorm, Embedding and Flatten."""
from __future__ import annotations

from ... import autograd
from ..block import Block, HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm", "LayerNorm",
           "Embedding", "Flatten"]


class HybridSequential(HybridBlock):
    """Children run in order (ref: basic_layers.py:HybridSequential)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer with the reference's (units, in_units) weight;
    ``flatten=True`` collapses the trailing dims; ``activation`` (a name or
    a block) is applied to the output."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = (None if activation is None
                        else _make_activation(activation))

    def infer_shape(self, x, *args):
        in_units = 1
        if self._flatten:
            for s in x.shape[1:]:
                in_units *= s
        else:
            in_units = x.shape[-1]
        self.weight._shape_resolved((self._units, in_units))
        if self.bias is not None:
            self.bias._shape_resolved((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        return out if self.act is None else self.act(out)


def _make_activation(activation):
    if isinstance(activation, Block):
        return activation
    from .activations import Activation
    return Activation(activation)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics as parameters; the layer's
    eps is 1e-5. In autograd training mode (unless ``use_global_stats``)
    it normalizes by the batch statistics and then moves the running ones
    toward them by ``momentum`` (the biased batch variance, no gradient),
    as the JAX package's layer does; otherwise it normalizes by the
    running statistics."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        if axis is None:
            from ...layout import channel_axis
            axis = channel_axis(None)
        self._kwargs = dict(axis=axis, eps=epsilon, momentum=momentum,
                            fix_gamma=not scale,
                            use_global_stats=use_global_stats)
        self._axis = axis
        self._momentum = momentum
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._shape_resolved((channels,))

    def cast(self, dtype):
        if str(dtype).startswith("float16") or "bfloat16" in str(dtype):
            dtype = "float32"  # statistics stay float32 (ref: BatchNorm.cast)
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        train = autograd.is_training() and not self._kwargs["use_global_stats"]
        out = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          output_mean_var=train, **self._kwargs)
        if train:
            out, mean, var = out
            m = self._momentum
            self.running_mean._update_aux(running_mean * m
                                          + mean.detach() * (1 - m))
            self.running_var._update_aux(running_var * m
                                         + var.detach() * (1 - m))
        return out


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (ref: basic_layers.py:LayerNorm);
    its gamma and beta follow ``cast`` like any parameter."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma._shape_resolved((channels,))
        self.beta._shape_resolved((channels,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Index -> vector lookup with an (input_dim, output_dim) weight (ref:
    basic_layers.py:Embedding). Ids are clipped into range; the ids
    themselves are never cast."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return x.reshape(x.shape[0], -1)
