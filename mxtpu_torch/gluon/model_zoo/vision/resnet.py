"""ResNet v1 (counterpart of ``mxtpu/gluon/model_zoo/vision/resnet.py``).

He et al., "Deep Residual Learning", with the stride on the bottleneck's
3x3 conv as in the reference. Block structure, naming and parameter shapes
equal the JAX package's, so weights carry across by name
(``mxtpu_torch.convert``). ResNet v2 is not ported yet.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    """conv3x3-BN-relu-conv3x3-BN + shortcut."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1-3x3-1x1 with the stride on the 3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, stride, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class ResNetV1(HybridBlock):
    """Stem (7x7/2 conv + 3x3/2 max pool), 4 stages, global average pool,
    dense classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError("layers/channels mismatch")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    if num_layers not in resnet_spec:
        raise MXNetError("invalid resnet depth %s" % num_layers)
    if version != 1:
        raise MXNetError("ResNet v%s is not ported yet (v1 only)" % version)
    if pretrained:
        raise MXNetError("pretrained weights are not ported: load them "
                         "with mxtpu_torch.convert.load_mxtpu_params")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
