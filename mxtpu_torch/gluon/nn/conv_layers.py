"""Convolution and pooling layers (counterpart of
``mxtpu/gluon/nn/conv_layers.py``): Conv2D, MaxPool2D and
GlobalAvgPool2D. Built under ``layout("NHWC")`` a Conv2D stores HWIO weights,
which the fused conv kernel reads as a row-major [K, C_out] matrix."""
from __future__ import annotations

from ...layout import channel_axis as _scope_channel_axis
from ...layout import conv_layout as _scope_conv_layout
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tuplify(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _Conv(HybridBlock):
    """Shared conv implementation (ref: conv_layers.py:_Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        layout = _scope_conv_layout(layout, len(kernel_size))
        self._layout = layout
        self._channels_last = _scope_channel_axis(layout) == -1
        self._kwargs = dict(kernel=kernel_size, stride=strides,
                            dilate=dilation, pad=padding, num_filter=channels,
                            num_group=groups, no_bias=not use_bias,
                            layout=layout)
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                from .activations import Activation
                self.act = Activation(activation)
            else:
                self.act = None

    def _weight_shape(self, in_channels):
        groups = self._kwargs["num_group"]
        kernel = tuple(self._kwargs["kernel"])
        in_g = in_channels // groups if in_channels else 0
        if self._channels_last:
            return kernel + (in_g, self._channels)
        return (self._channels, in_g) + kernel

    def infer_shape(self, x, *args):
        in_c = x.shape[_scope_channel_axis(self._layout)]
        self._in_channels = in_c
        self.weight._shape_resolved(self._weight_shape(in_c))
        if self.bias is not None:
            self.bias._shape_resolved((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        return out if self.act is None else self.act(out)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 2),
                         _tuplify(strides, 2), _tuplify(padding, 2),
                         _tuplify(dilation, 2), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    """Shared pooling implementation (ref: conv_layers.py:_Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = dict(
            kernel=pool_size, stride=strides, pad=padding,
            global_pool=global_pool, pool_type=pool_type,
            layout=_scope_conv_layout(layout, len(pool_size)),
            pooling_convention="full" if ceil_mode else "valid")

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout=None,
                 ceil_mode=False, **kwargs):
        super().__init__(_tuplify(pool_size, 2),
                         _tuplify(strides, 2) if strides is not None else None,
                         _tuplify(padding, 2), ceil_mode, False, "max", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout=None, **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kwargs)
