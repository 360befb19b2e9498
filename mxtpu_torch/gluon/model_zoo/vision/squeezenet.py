"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxtpu/gluon/model_zoo/vision/squeezenet.py``).

Iandola et al., "SqueezeNet": fire modules (a 1x1 squeeze, then 1x1 and
3x3 expands run side by side and joined on channels), max pools in the
ceil ("full") convention, a Dropout and a 1x1 conv classifier.
"""
from __future__ import annotations

from ....base import MXNetError
from ....layout import channel_axis as _channel_axis
from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = nn.HybridConcurrent(axis=_channel_axis(None), prefix="")
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


_FIRES = {   # None: a 3x3/2 max pool in the "full" convention
    "1.0": [(16, 64, 64), (16, 64, 64), (32, 128, 128), None,
            (32, 128, 128), (48, 192, 192), (48, 192, 192), (64, 256, 256),
            None, (64, 256, 256)],
    "1.1": [(16, 64, 64), (16, 64, 64), None, (32, 128, 128),
            (32, 128, 128), None, (48, 192, 192), (48, 192, 192),
            (64, 256, 256), (64, 256, 256)],
}


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _FIRES:
            raise MXNetError("unsupported squeezenet version %s" % version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            for fire in _FIRES[version]:
                if fire is None:
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                                   ceil_mode=True))
                else:
                    self.features.add(_make_fire(*fire))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "squeezenet%s" % version, root, ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
