"""Inception v3 (counterpart of ``mxtpu/gluon/model_zoo/vision/inception.py``).

Szegedy et al., "Rethinking the Inception Architecture", at 299x299: a
conv stem, then blocks A-E whose parallel branches (convs with 1x1, 3x3,
5x5, 1x7 and 7x1 kernels, average and max pools) are joined on the
channel axis, an 8x8 average pool, a Dropout of rate 0.5 and the
classifier. Every conv is conv-BN(eps 1e-3)-relu.
"""
from __future__ import annotations

from ....layout import channel_axis as _channel_axis
from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    """A pool ("avg" 3x3/1, "max" 3x3/2, or None) then convs given as
    (channels, kernel_size, strides, padding), None for a default."""
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        out.add(_make_basic_conv(**{names[i]: v for i, v in enumerate(setting)
                                    if v is not None}))
    return out


def _concurrent(prefix=""):
    return nn.HybridConcurrent(axis=_channel_axis(None), prefix=prefix)


def _make_A(pool_features, prefix):
    out = _concurrent(prefix)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _concurrent(prefix)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    c = channels_7x7
    out = _concurrent(prefix)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (c, 1, None, None), (c, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (c, 1, None, None), (c, (7, 1), None, (3, 0)),
                         (c, (1, 7), None, (0, 3)), (c, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _concurrent(prefix)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_E(prefix):
    out = _concurrent(prefix)
    out.add(_make_branch(None, (320, 1, None, None)))

    branch_3x3 = nn.HybridSequential(prefix="")
    out.add(branch_3x3)
    branch_3x3.add(_make_branch(None, (384, 1, None, None)))
    branch_3x3_split = _concurrent()
    branch_3x3_split.add(_make_branch(None, (384, (1, 3), None, (0, 1))))
    branch_3x3_split.add(_make_branch(None, (384, (3, 1), None, (1, 0))))
    branch_3x3.add(branch_3x3_split)

    branch_3x3dbl = nn.HybridSequential(prefix="")
    out.add(branch_3x3dbl)
    branch_3x3dbl.add(_make_branch(None, (448, 1, None, None),
                                   (384, 3, None, 1)))
    branch_3x3dbl_split = _concurrent()
    branch_3x3dbl.add(branch_3x3dbl_split)
    branch_3x3dbl_split.add(_make_branch(None, (384, (1, 3), None, (0, 1))))
    branch_3x3dbl_split.add(_make_branch(None, (384, (3, 1), None, (1, 0))))

    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "inceptionv3", root, ctx)
    return net
