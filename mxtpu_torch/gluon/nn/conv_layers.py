"""Convolution and pooling layers (counterpart of
``mxtpu/gluon/nn/conv_layers.py``): 1-, 2- and 3-D convs and transposed
convs, max/avg and global pools, and ReflectionPad2D. Built under
``layout("NHWC")`` a conv stores its weight channels-last, ``(*k, in/g,
out)`` (a transposed conv ``(*k, out/g, in)``), as the JAX package's; a
2-D one is the HWIO matrix the fused conv kernel reads as a row-major
[K, C_out]. Channels-first weights are ``(out, in/g, *k)`` and ``(in,
out/g, *k)``, the reference's."""
from __future__ import annotations

from ...layout import channel_axis as _scope_channel_axis
from ...layout import conv_layout as _scope_conv_layout
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuplify(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _Conv(HybridBlock):
    """Shared conv implementation (ref: conv_layers.py:_Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        layout = _scope_conv_layout(layout, len(kernel_size))
        self._layout = layout
        self._channels_last = _scope_channel_axis(layout) == -1
        self._op_name = op_name
        self._kwargs = dict(kernel=kernel_size, stride=strides,
                            dilate=dilation, pad=padding, num_filter=channels,
                            num_group=groups, no_bias=not use_bias,
                            layout=layout)
        if adj is not None:
            self._kwargs["adj"] = adj
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
        out_g = self._channels // groups if self._channels else 0
        if self._op_name == "Convolution":
            if self._channels_last:
                return kernel + (in_g, self._channels)
            return (self._channels, in_g) + kernel
        if self._channels_last:
            return kernel + (out_g, in_channels)
        return (in_channels, out_g) + kernel

    def infer_shape(self, x, *args):
        in_c = x.shape[_scope_channel_axis(self._layout)]
        self._in_channels = in_c
        self.weight._shape_resolved(self._weight_shape(in_c))
        if self.bias is not None:
            self.bias._shape_resolved((self._channels,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        return out if self.act is None else self.act(out)

    def __repr__(self):
        return "{}({} -> {}, kernel_size={}, stride={})".format(
            self.__class__.__name__, self._in_channels or None,
            self._channels, self._kwargs["kernel"], self._kwargs["stride"])


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=None, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 1),
                         _tuplify(strides, 1), _tuplify(padding, 1),
                         _tuplify(dilation, 1), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


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


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1, layout=None,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tuplify(kernel_size, 3),
                         _tuplify(strides, 3), _tuplify(padding, 3),
                         _tuplify(dilation, 3), groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


def _transpose_class(n):
    """Conv{n}DTranspose: the Deconvolution op with ``output_padding``."""

    class ConvTranspose(_Conv):
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     output_padding=0, dilation=1, groups=1, layout=None,
                     activation=None, use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kwargs):
            super().__init__(channels, _tuplify(kernel_size, n),
                             _tuplify(strides, n), _tuplify(padding, n),
                             _tuplify(dilation, n), groups, layout,
                             in_channels, activation, use_bias,
                             weight_initializer, bias_initializer,
                             op_name="Deconvolution",
                             adj=_tuplify(output_padding, n), **kwargs)
            self.outpad = _tuplify(output_padding, n)

    ConvTranspose.__name__ = ConvTranspose.__qualname__ = \
        "Conv%dDTranspose" % n
    return ConvTranspose


Conv1DTranspose = _transpose_class(1)
Conv2DTranspose = _transpose_class(2)
Conv3DTranspose = _transpose_class(3)


class _Pooling(HybridBlock):
    """Shared pooling implementation (ref: conv_layers.py:_Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = dict(
            kernel=pool_size, stride=strides, pad=padding,
            global_pool=global_pool, pool_type=pool_type,
            layout=_scope_conv_layout(layout, len(pool_size)),
            pooling_convention="full" if ceil_mode else "valid")
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "{}(size={}, stride={}, padding={}, ceil_mode={})".format(
            self.__class__.__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"],
            self._kwargs["pooling_convention"] == "full")


def _pool_class(n, pool_type):
    """MaxPool{n}D / AvgPool{n}D (the latter with ``count_include_pad``)."""

    class Pool(_Pooling):
        def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                     ceil_mode=False, count_include_pad=True, **kwargs):
            super().__init__(
                _tuplify(pool_size, n),
                _tuplify(strides, n) if strides is not None else None,
                _tuplify(padding, n), ceil_mode, False, pool_type, layout,
                count_include_pad if pool_type == "avg" else None, **kwargs)

    Pool.__name__ = Pool.__qualname__ = "%sPool%dD" % (
        pool_type.capitalize(), n)
    return Pool


def _global_pool_class(n, pool_type):
    class GlobalPool(_Pooling):
        def __init__(self, layout=None, **kwargs):
            super().__init__((1,) * n, None, (0,) * n, True, True, pool_type,
                             layout, **kwargs)

    GlobalPool.__name__ = GlobalPool.__qualname__ = "Global%sPool%dD" % (
        pool_type.capitalize(), n)
    return GlobalPool


MaxPool1D, MaxPool2D, MaxPool3D = (_pool_class(n, "max") for n in (1, 2, 3))
AvgPool1D, AvgPool2D, AvgPool3D = (_pool_class(n, "avg") for n in (1, 2, 3))
GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D = (
    _global_pool_class(n, "max") for n in (1, 2, 3))
GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D = (
    _global_pool_class(n, "avg") for n in (1, 2, 3))


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W of NCHW input (ref:
    conv_layers.py:ReflectionPad2D); an int pads both sides of both."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
