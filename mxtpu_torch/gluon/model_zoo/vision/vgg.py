"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxtpu/gluon/model_zoo/vision/vgg.py``).

Simonyan & Zisserman, "Very Deep Convolutional Networks": stages of 3x3
convs with a max pool after each, then a 4096-4096 dense head with two
Dropouts of rate 0.5.
"""
from __future__ import annotations

from ....base import MXNetError
from .... import initializer as init
from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    """``layers[i]`` 3x3 convs of width ``filters[i]`` per stage."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise MXNetError("layers/filters mismatch")
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3, padding=1,
                                         weight_initializer=init.Xavier(
                                             rnd_type="gaussian",
                                             factor_type="out", magnitude=2),
                                         bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    if num_layers not in vgg_spec:
        raise MXNetError("invalid vgg depth %s" % num_layers)
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "vgg%d%s" % (
            num_layers, "_bn" if kwargs.get("batch_norm") else ""), root, ctx)
    return net


def _named(depth, batch_norm):
    def make(**kwargs):
        if batch_norm:
            kwargs["batch_norm"] = True
        return get_vgg(depth, **kwargs)
    make.__name__ = make.__qualname__ = "vgg%d%s" % (
        depth, "_bn" if batch_norm else "")
    return make


vgg11, vgg13, vgg16, vgg19 = (_named(d, False) for d in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (_named(d, True)
                                          for d in (11, 13, 16, 19))
