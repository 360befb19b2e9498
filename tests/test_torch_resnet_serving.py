"""The slice end to end: a ResNet v1 served through the JAX package's
Predictor and through the port's, with the same weights.

The JAX Predictor runs its Pallas conv kernel through the interpreter
(MXTPU_PALLAS_CONV=1, MXTPU_PALLAS_CONV_INTERPRET=1 around each call);
the port runs on the CPU, where its conv wrapper takes the plain version.
Weights are seeded and scaled (convert.seeded_params): the default
initializer gives logits near 1e-4, which would compare near-zeros. One
bucket and no warm-up keep the interpreter's compile cost down.
Tolerance: rtol=1e-4, atol=1e-4*max|logit|."""
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.gluon.model_zoo import vision as jvision
from mxtpu.ops.pallas import conv as jpc
from mxtpu.serving import BucketSpec as JBucketSpec
from mxtpu.serving import Predictor as JPredictor
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.gluon.model_zoo import vision as tvision
from mxtpu_torch.serving import BucketSpec, Predictor

WIDTHS = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
HW = 32


def _jax_predict(pred, x):
    """The JAX Predictor with its conv kernel on, through the interpreter
    (the levers are read when a bucket traces and key its executable)."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL"):
            mp.delenv(var, raising=False)
        mp.setenv("MXTPU_PALLAS_CONV", "1")
        mp.setenv("MXTPU_PALLAS_CONV_INTERPRET", "1")
        return pred.predict(mx.nd.array(x)).asnumpy()


def _shapes(params):
    return {k.partition("_")[2]: tuple(v.shape) for k, v in params.items()}


@pytest.fixture(scope="module")
def nets():
    """(mxtpu net, its arrays, port net) with the same seeded weights."""
    with mx.layout("NHWC"):
        jnet = jvision.ResNetV1(jvision.BottleneckV1, *WIDTHS, classes=10)
    jnet.initialize()
    jnet(mx.nd.zeros((1, HW, HW, 3)))
    jparams = jnet.collect_params()
    arrays = convert.seeded_params(
        {k: p.shape for k, p in jparams.items()}, seed=3)
    for k, p in jparams.items():
        p.set_data(mx.nd.array(arrays[k]))
    carried = {k: p.data().asnumpy() for k, p in jparams.items()}
    net = _port_net(carried)
    return jnet, carried, net


def _port_net(arrays):
    with mt.layout("NHWC"):
        net = tvision.ResNetV1(tvision.BottleneckV1, *WIDTHS, classes=10)
    convert.load_mxtpu_params(net, arrays)
    return net


@pytest.fixture(scope="module")
def jax_predictor(nets):
    jpc.reset_dispatch_stats()
    return JPredictor(nets[0], JBucketSpec(batch_sizes=[4]))


def _requests(n, seed):
    return np.random.RandomState(seed).randn(n, HW, HW, 3).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_names_and_shapes_equal_mxtpu(nets):
    jnet, _, net = nets
    mine = net.collect_params()
    assert _shapes(mine) == _shapes(jnet.collect_params())
    assert [k.partition("_")[2] for k in mine] == \
        [k.partition("_")[2] for k in jnet.collect_params()]
    assert all(p.data().to_torch().dtype == torch.float32
               for p in mine.values())


def test_ragged_batch_matches_mxtpu_predictor(nets, jax_predictor):
    x = _requests(3, 0)
    ref = _jax_predict(jax_predictor, x)
    assert jpc.DISPATCH_STATS["pallas"] > 0    # JAX really ran its kernel
    got = Predictor(nets[2], BucketSpec([4]), device="cpu").predict(x)
    assert isinstance(got, mt.nd.NDArray)
    assert got.shape == (3, 10) and got.context.type == "cpu"
    assert np.abs(ref).max() > 1e-2            # real signal, not near-zeros
    _close(got.asnumpy(), ref)


def test_chunked_batch_matches_mxtpu_predictor(nets, jax_predictor):
    """9 items through a largest bucket of 4: three dispatches each."""
    x = _requests(9, 1)
    ref = _jax_predict(jax_predictor, x)
    pred = Predictor(nets[2], BucketSpec([4]), device="cpu")
    calls = []
    real = pred._dispatch_one
    pred._dispatch_one = lambda datas, seq, bucket: calls.append(
        (datas[0].shape[0], bucket)) or real(datas, seq, bucket)
    got = pred.predict(torch.from_numpy(x))
    assert calls == [(4, 4), (4, 4), (1, 4)]
    _close(got.asnumpy(), ref)


def test_params_to_numpy_round_trip(nets):
    _, arrays, net = nets
    back = convert.params_to_numpy(net)
    strip = {k.partition("_")[2]: v for k, v in arrays.items()}
    assert {k.partition("_")[2] for k in back} == set(strip)
    for k, v in back.items():
        np.testing.assert_array_equal(v, strip[k.partition("_")[2]])
    again = _port_net(back)            # a third net, loaded from the dump
    x = torch.from_numpy(_requests(2, 2))
    with torch.no_grad():
        np.testing.assert_array_equal(net(x).numpy(), again(x).numpy())


def test_load_refuses_mismatch(nets):
    _, arrays, _ = nets
    bad = dict(arrays)
    key = next(k for k in bad if k.endswith("conv2d0_weight"))
    bad[key] = bad[key][..., :-1]
    with pytest.raises(mt.MXNetError, match="shape"):
        _port_net(bad)
    missing = dict(arrays)
    missing.pop(key)
    with pytest.raises(mt.MXNetError, match="missing"):
        _port_net(missing)


def test_bucket_spec_matches_mxtpu():
    for top in (1, 3, 8, 11):
        mine, ref = BucketSpec.pow2(top), JBucketSpec.pow2(top)
        assert mine.batch_sizes == ref.batch_sizes
        assert mine.max_batch == ref.max_batch
        for n in range(1, top + 3):
            assert mine.batch_bucket(n) == ref.batch_bucket(n)
    with pytest.raises(mt.MXNetError):
        BucketSpec([0])


def test_warmup_runs_every_bucket_with_templates(nets):
    pred = Predictor(nets[2], BucketSpec.pow2(4), device="cpu",
                     example=np.zeros((1, HW, HW, 3), np.float32),
                     site="test.warmup_templates")
    assert pred.input_templates == [((HW, HW, 3), torch.float32)]
    seen = []
    real = pred.run_bucket
    pred.run_bucket = lambda b, s=None: seen.append(b) or real(b, s)
    assert pred.warmup() is pred and seen == [1, 2, 4]
    assert pred.compile_stats()["compiles"] == 3
    with pytest.raises(mt.MXNetError, match="example"):
        Predictor(nets[2], BucketSpec([2]), device="cpu").warmup()


def test_resnet50_v1_names_and_shapes_equal_mxtpu():
    with mx.layout("NHWC"):
        jnet = jvision.resnet50_v1()
    jnet.initialize()
    jnet(mx.nd.zeros((1, HW, HW, 3)))
    with mt.layout("NHWC"):
        net = tvision.resnet50_v1()
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, HW, HW, 3))
    mine, ref = net.collect_params(), jnet.collect_params()
    assert len(list(mine.keys())) == len(list(ref.keys())) == 267
    assert list(_shapes(mine).items()) == list(_shapes(ref).items())
    assert _shapes(mine)["conv2d0_weight"] == (7, 7, 3, 64)
