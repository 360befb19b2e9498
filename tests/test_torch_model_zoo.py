"""The vision model zoo of the port held to ``mxtpu``'s.

* ``get_model`` resolves the reference's 34 names (``vision._models``) and
  its dotted spellings;
* per family, the parameter names (after the top-level prefix) and
  shapes equal the reference's, so weights carry across by name;
* per family, the forward at ``classes=10`` and the reference test's
  sizes (tests/test_model_zoo.py: batch 1 at 224x224, multiplier 0.25 for
  MobileNet; Inception v3 at 299x299) equals ``mxtpu``'s on the same
  seeded weights (``convert.seeded_params``) and inputs, channels-first
  and, for three families, channels-last;
* a ``.params`` file saved by ``mxtpu`` loads into the port
  (``load_parameters``) and gives the same logits.

The JAX side runs hybridized on its plain XLA convs (no Pallas lever is
set); the port's convs run ``F.conv2d`` or, channels-last, the fused conv
kernel's plain version. Tolerance: float32 forward rtol=1e-5 and
atol=1e-5*max|logit|.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.gluon.model_zoo import vision as jvision
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.model_zoo import vision as tvision

FWD = 1e-5

# (name, side, layout): the reference test's models, then the families it
# leaves out (VGG with BN, DenseNet, Inception v3 at 299)
FAMILIES = [
    ("resnet18_v1", 224, "NCHW"), ("resnet18_v2", 224, "NCHW"),
    ("mobilenet0_25", 224, "NCHW"), ("mobilenet_v2_0_25", 224, "NCHW"),
    ("squeezenet1_0", 224, "NCHW"), ("squeezenet1_1", 224, "NCHW"),
    ("alexnet", 224, "NCHW"), ("vgg11_bn", 224, "NCHW"),
    ("densenet121", 224, "NCHW"), ("inception_v3", 299, "NCHW"),
    ("squeezenet1_1", 224, "NHWC"), ("mobilenet_v2_0_25", 224, "NHWC"),
    ("resnet18_v2", 224, "NHWC"),
]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL", "MXTPU_BN_ONEPASS"):
        monkeypatch.delenv(var, raising=False)


def _input(side, layout, seed=0):
    x = np.random.RandomState(seed).uniform(-1, 1, (1, 3, side, side))
    x = x.astype(np.float32)
    return x.transpose(0, 2, 3, 1).copy() if layout == "NHWC" else x


def _nets(name, side, layout):
    """(port net, reference net) with the same seeded weights: the port's
    shapes settled by a forward, the reference's by loading the arrays by
    name (its ``set_data`` refuses a shape that disagrees with one its
    constructor fixed), then hybridized."""
    with mt.layout(layout):
        net = tvision.get_model(name, classes=10)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.from_numpy(_input(side, layout)))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=5)
    convert.load_mxtpu_params(net, arrays)
    with mx.layout(layout):
        jnet = jvision.get_model(name, classes=10)
    theirs = {k.partition("_")[2]: p for k, p in
              jnet.collect_params().items()}
    for k, a in arrays.items():
        theirs[k.partition("_")[2]].set_data(mx.nd.array(a))
    jnet.hybridize()
    return net, jnet


def _keyed_shapes(params):
    return {k.partition("_")[2]: tuple(p.shape) for k, p in params.items()}


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=FWD,
                               atol=FWD * np.abs(ref).max())


def test_names_equal_the_reference():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    for dotted, name in (("mobilenet1.0", "MobileNet"),
                         ("squeezenet1.0", "SqueezeNet"),
                         ("MobileNet_V2_0.25", "MobileNetV2")):
        assert type(tvision.get_model(dotted)).__name__ == name
    with pytest.raises(MXNetError, match="not supported"):
        tvision.get_model("resnet19_v9")


@pytest.mark.parametrize("name,side,layout", FAMILIES,
                         ids=["%s-%s" % (n, l) for n, _, l in FAMILIES])
def test_family_matches_mxtpu(name, side, layout):
    """Names, shapes and logits equal the reference's."""
    net, jnet = _nets(name, side, layout)
    x = _input(side, layout, seed=1)
    ref = jnet(mx.nd.array(x)).asnumpy()
    assert _keyed_shapes(net.collect_params()) == _keyed_shapes(
        jnet.collect_params())
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (1, 10)
    assert np.abs(ref).max() > 1e-2   # real signal, not near-zeros
    _close(got, ref)


@pytest.mark.parametrize("name", ["vgg16", "densenet161", "resnet50_v2",
                                  "mobilenet_v2_1_0", "inception_v3"])
def test_full_width_shapes_equal_the_reference(name):
    """Full-width parameter names and shapes (no forward: the shapes the
    constructors fix, and the deferred ones stay 0 on both sides)."""
    jnet = jvision.get_model(name)
    net = tvision.get_model(name)
    assert _keyed_shapes(net.collect_params()) == _keyed_shapes(
        jnet.collect_params())


def test_mxtpu_params_file_gives_the_same_logits(tmp_path):
    _, jnet = _nets("mobilenet_v2_0_25", 224, "NCHW")
    path = str(tmp_path / "m.params")
    jnet.save_parameters(path)
    x = _input(224, "NCHW", seed=2)
    ref = jnet(mx.nd.array(x)).asnumpy()
    net = tvision.get_model("mobilenet_v2_0_25", classes=10)
    net.initialize(ctx=mt.cpu())
    net.load_parameters(path)
    _close(net(torch.from_numpy(x)).detach().numpy(), ref)


def test_resnet_v2_thumbnail_trains_one_step():
    """The reference's thumbnail train step (test_model_zoo.py) on v2."""
    net = tvision.get_resnet(2, 18, thumbnail=True, classes=10)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    x = mt.nd.array(np.random.RandomState(0).uniform(size=(4, 3, 32, 32)),
                    ctx=mt.cpu())
    y = mt.nd.array(np.array([0, 1, 2, 3]), ctx=mt.cpu())
    w = net.output.weight.data().asnumpy().copy()
    with mt.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(4)
    assert np.isfinite(loss.asnumpy()).all()
    assert np.abs(net.output.weight.data().asnumpy() - w).sum() > 0
