"""Basic layers (counterpart of ``mxtpu/gluon/nn/basic_layers.py``):
Sequential, HybridSequential, Dense, Dropout, BatchNorm, InstanceNorm,
LayerNorm, Embedding, Flatten, Lambda, HybridLambda, Concurrent,
HybridConcurrent and Identity."""
from __future__ import annotations

import warnings

import torch

from ... import autograd
from ...base import MXNetError
from ...ndarray import NDArray
from ...ops.registry import REGISTRY
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda", "HybridConcurrent", "Concurrent", "Identity"]


class _Stack:
    """What Sequential and HybridSequential share: ``add``, indexing (a
    slice is a new stack of the same children), ``len`` and iteration."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def _run(self, x, args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)) and len(x) == 1:
                x = x[0]
        return x

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Children run in order (ref: basic_layers.py:Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        return self._run(x, args)

    def hybridize(self, active=True, **kwargs):
        if self._modules and all(isinstance(c, HybridBlock)
                                 for c in self._modules.values()):
            warnings.warn("All children of this Sequential layer are "
                          "HybridBlocks. Consider using HybridSequential for "
                          "the best performance.", stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(_Stack, HybridBlock):
    """Children run in order (ref: basic_layers.py:HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x, *args):
        return self._run(x, args)


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

    def __repr__(self):
        shape = self.weight.shape
        return "Dense({0} -> {1}, {2})".format(
            shape[1] if shape[1] else None, shape[0],
            self.act if self.act else "linear")


def _make_activation(activation):
    if isinstance(activation, Block):
        return activation
    from .activations import Activation
    return Activation(activation)


class Dropout(HybridBlock):
    """Inverted dropout of rate ``rate`` in autograd training mode, one
    draw shared along ``axes`` (ref: basic_layers.py:Dropout). Its draw
    comes from the port's generator; a hybridized block that holds one
    registers that generator with its captured graphs (``_draws``)."""

    _draws = True

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return "Dropout(p = {}, axes={})".format(self._rate, self._axes)


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

    def __repr__(self):
        return "BatchNorm(axis={}, eps={}, momentum={}, in_channels={})"\
            .format(self._axis, self._kwargs["eps"], self._momentum,
                    self.gamma.shape[0])


class InstanceNorm(HybridBlock):
    """Instance normalization over the spatial axes, channels on ``axis``
    (ref: basic_layers.py:InstanceNorm); gamma is fixed unless
    ``scale``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        self._axis = axis
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
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


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

    def __repr__(self):
        return "Embedding({} -> {}, {})".format(
            self._input_dim, self._output_dim, self.weight.dtype)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


def _named_op(function):
    if function not in REGISTRY:
        raise MXNetError("Function name %s is not found in mx.nd." % function)
    return REGISTRY[function]


class Lambda(Block):
    """A function as a Block (ref: basic_layers.py:Lambda); a name is an
    ``mx.nd`` op, run on NDArrays as ``mx.nd`` runs it and on tensors as
    the op's tensor function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            op = _named_op(function)

            def run(*args):
                if any(isinstance(a, NDArray) for a in args):
                    return op.wrapper(*args)
                return op.fn(*args)
            self._func_impl, self._func_name = run, function
        else:
            self._func_impl = function
            self._func_name = getattr(function, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda({})".format(self._func_name)


class HybridLambda(HybridBlock):
    """``function(F, *args)`` as a HybridBlock; a name is the op of that
    name (ref: basic_layers.py:HybridLambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            fn = _named_op(function).fn
            self._func = lambda F, *args: fn(*args)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)

    def __repr__(self):
        return "HybridLambda({})".format(self._func_name)


class Concurrent(Sequential):
    """Every child on the same input, the outputs concatenated on ``axis``
    (ref: contrib/nn/basic_layers.py:Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        outs = [block(x) for block in self._modules.values()]
        if any(isinstance(o, NDArray) for o in outs):
            return REGISTRY["Concat"].wrapper(*outs, dim=self.axis)
        return torch.cat(outs, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable Concurrent (ref: contrib/nn/basic_layers.py)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._modules.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """The identity (ref: contrib/nn/basic_layers.py:Identity)."""

    def hybrid_forward(self, F, x):
        return x
