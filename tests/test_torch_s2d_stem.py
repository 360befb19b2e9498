"""The port's space-to-depth ResNet stem held to ``mxtpu``'s
(tests/test_s2d_stem.py): the transforms and embedded weights equal the
reference's exactly, each mode's stem equals the plain 7x7/2 conv with
the gradient reaching the 7x7 weight, and a zoo ResNet with
``apply_to_resnet(net, mode)`` gives the plain net's logits and the
reference's wrapped net's. The mode is an argument: the reference's
policy mode (``None``, read from ``MXTPU_S2D_STEM``) raises here.
Tolerances: the reference test's 2e-4 for a rewritten stem, 1e-5 of
max|logit| against the reference's wrapped net, gradients 1e-4."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxtpu as mx
from mxtpu.contrib import s2d_stem as js2d
from mxtpu.gluon.model_zoo import vision as jvision
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.base import MXNetError
from mxtpu_torch.contrib import s2d_stem as s2d
from mxtpu_torch.gluon.model_zoo import vision

WIDTHS = ([1, 1, 1, 1], [8, 8, 16, 32, 64])


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_S2D_STEM", "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL"):
        monkeypatch.delenv(var, raising=False)


def _xw(seed=0, side=32, f=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, side, side, 3).astype(np.float32),
            (rng.randn(7, 7, 3, f) * 0.1).astype(np.float32))


def _plain(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
                    padding=3).permute(0, 2, 3, 1)


def test_transforms_and_weights_equal_the_reference():
    x, w = _xw()
    for mine, theirs in (
            (s2d.space_to_depth_nhwc(torch.from_numpy(x)),
             js2d.space_to_depth_nhwc(x)),
            (s2d.space_to_depth4_nhwc(torch.from_numpy(x)),
             js2d.space_to_depth4_nhwc(x)),
            (s2d.embed_stem_weight(torch.from_numpy(w)),
             js2d.embed_stem_weight(w)),
            (s2d.embed_stem_weight4(torch.from_numpy(w)),
             js2d.embed_stem_weight4(w))):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    y = np.random.RandomState(1).randn(2, 5, 6, 32).astype(np.float32)
    np.testing.assert_array_equal(
        s2d.depth_to_space2_nhwc(torch.from_numpy(y), 8).numpy(),
        np.asarray(js2d.depth_to_space2_nhwc(y, 8)))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_each_mode_is_the_plain_stem_with_its_gradient(mode):
    x, w = _xw(seed=2)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_(True)
    wr = torch.from_numpy(w).requires_grad_(True)
    got = s2d._stem(xt, wt, None, mode)
    ref = _plain(xt, wr)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    (got ** 2).sum().backward()
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), wr.grad.numpy(), rtol=1e-4,
                               atol=1e-4 * wr.grad.abs().max().item())


def _nets():
    with mt.layout("NHWC"):
        net = vision.ResNetV1(vision.BottleneckV1, *WIDTHS, classes=10)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 64, 64, 3))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=4)
    convert.load_mxtpu_params(net, arrays)
    with mx.layout("NHWC"):
        jnet = jvision.ResNetV1(jvision.BottleneckV1, *WIDTHS, classes=10)
    theirs = {k.partition("_")[2]: p for k, p in
              jnet.collect_params().items()}
    for k, a in arrays.items():
        theirs[k.partition("_")[2]].set_data(mx.nd.array(a))
    return net, jnet


@pytest.mark.parametrize("mode", [1, 2])
def test_zoo_resnet_keeps_its_function_and_trains(mode):
    net, jnet = _nets()
    x = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3))
    x = x.astype(np.float32)
    plain = net(torch.from_numpy(x)).detach().numpy()
    s2d.apply_to_resnet(net, mode)
    js2d.apply_to_resnet(jnet, mode=mode)
    got = net(torch.from_numpy(x)).detach().numpy()
    ref = jnet(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # training updates the original 7x7 stem weight
    stem = net.features[0].weight
    before = stem.data().asnumpy().copy()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xa = mt.nd.array(x, ctx=mt.cpu())
    ya = mt.nd.array(np.array([1.0, 2.0], np.float32), ctx=mt.cpu())
    with mt.autograd.record():
        loss = loss_fn(net(xa), ya)
    loss.backward()
    trainer.step(2)
    assert np.abs(stem.data().asnumpy() - before).sum() > 0


def test_mode_is_an_argument():
    net, _ = _nets()
    with pytest.raises(MXNetError, match="reads no environment"):
        s2d.apply_to_resnet(net, None)
    with pytest.raises(MXNetError, match="0, 1 or 2"):
        s2d.apply_to_resnet(net, "1")
    with mt.layout("NCHW"):
        nchw = vision.resnet18_v1(classes=10)
    with pytest.raises(MXNetError, match="NHWC"):
        s2d.apply_to_resnet(nchw, 1)
    with mt.layout("NHWC"):
        thumb = vision.resnet18_v1(classes=10, thumbnail=True)
    with pytest.raises(MXNetError, match="kernel != 7x7"):
        s2d.apply_to_resnet(thumb, 1)
