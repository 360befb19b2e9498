"""The port's int8 quantization ops (``mxtpu_torch/ops/quantization.py``)
and the Predictor's ``int8=True`` weights against the JAX package's.

The ops take the same seeded numpy inputs in both packages. int8 results
and ranges must be equal; the int8 products accumulate exactly in both
(int32 in the JAX package, float64 taken to int32 in the port), so the
float outputs agree to float32 rounding (rtol 1e-6); against float32
math the reference's own tolerances hold (dequantize 3/127, fully
connected 0.08, convolution 0.3). The int8 Predictors of both packages
store the same int8 weights and ranges and serve the same outputs within
1e-5 of max|output| (float32)."""
import weakref

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.gluon import nn as jnn
from mxtpu.ops.registry import get_op as jget_op
from mxtpu.serving import BucketSpec as JBucketSpec
from mxtpu.serving import Predictor as JPredictor
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.ops import quantization as tq
from mxtpu_torch.ops.registry import REGISTRY
from mxtpu_torch.serving import BucketSpec, Predictor

OPS = ("quantize", "dequantize", "requantize", "quantized_fully_connected",
       "quantized_conv", "quantized_flatten", "quantized_pooling")


def _j(name, *args, **kw):
    out = jget_op(name).fn(*args, **kw)
    if isinstance(out, (list, tuple)):
        return [np.asarray(o) for o in out]
    return np.asarray(out)


def _t(fn, *args, **kw):
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]
    out = fn(*args, **kw)
    if isinstance(out, (list, tuple)):
        return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
                for o in out]
    return out.numpy()


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_registered_under_the_reference_names():
    for op in OPS:
        assert REGISTRY["_contrib_" + op] is REGISTRY[op]
        assert REGISTRY[op].name == jget_op(op).name == "_contrib_" + op
        assert hasattr(mt.nd.contrib, op) and hasattr(mt.nd, op)


@pytest.mark.parametrize("lo,hi", [(-3.0, 3.0), (-1.0, 0.5), (-0.01, 0.02)])
def test_quantize_matches_mxtpu(lo, hi):
    x = np.concatenate([_rand(0, (257,), -4, 4), [0.0, -0.0, 10.0, -10.0]])
    x = x.astype(np.float32)
    jq, jlo, jhi = _j("quantize", x, lo, hi)
    tqv, tlo, thi = _t(tq.quantize, x, lo, hi)
    assert tqv.dtype == np.int8
    np.testing.assert_array_equal(tqv, jq)
    assert float(tlo) == float(jlo) and float(thi) == float(jhi)


def test_dequantize_matches_mxtpu_and_round_trips():
    x = np.linspace(-3, 3, 64).astype(np.float32)
    q, lo, hi = _t(tq.quantize, x, -3.0, 3.0)
    back = _t(tq.dequantize, q, -3.0, 3.0)
    np.testing.assert_allclose(back, _j("dequantize", q, -3.0, 3.0),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(back, x, atol=3.0 / 127 + 1e-6)
    np.testing.assert_array_equal(_t(tq.quantize, np.array(
        [-10.0, 0.0, 10.0], np.float32), -1.0, 1.0)[0], [-127, 0, 127])


@pytest.mark.parametrize("calib", [None, (-0.4, 0.6)])
def test_requantize_matches_mxtpu(calib):
    acc = np.random.RandomState(1).randint(-2 ** 30, 2 ** 30,
                                           (5, 7)).astype(np.int32)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    j = _j("requantize", acc, -2.0, 2.0, **kw)
    t = _t(tq.requantize, acc, -2.0, 2.0, **kw)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[0].dtype == np.int8
    assert [float(v) for v in t[1:]] == [float(v) for v in j[1:]]


def test_quantized_fully_connected_matches_mxtpu():
    x, w, b = _rand(0, (4, 2, 4)), _rand(1, (3, 8), -0.5, 0.5), \
        _rand(2, (3,), -0.1, 0.1)
    xq = _t(tq.quantize, x, -1.0, 1.0)[0]
    wq = _t(tq.quantize, w, -0.5, 0.5)[0]
    kw = dict(min_data=-1.0, max_data=1.0, min_weight=-0.5, max_weight=0.5)
    got = _t(tq.quantized_fully_connected, xq, wq, b, **kw)
    ref = _j("quantized_fully_connected", xq, wq, b, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, x.reshape(4, 8) @ w.T + b, atol=0.08)
    got_nb = _t(tq.quantized_fully_connected, xq, wq, b, no_bias=True, **kw)
    np.testing.assert_allclose(
        got_nb, _j("quantized_fully_connected", xq, wq, b, no_bias=True,
                   **kw), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layout", [None, "NHWC"])
def test_quantized_conv_matches_mxtpu(layout):
    x, w = _rand(1, (2, 3, 8, 8)), _rand(2, (5, 3, 3, 3), -0.5, 0.5)
    b = _rand(3, (5,), -0.1, 0.1)
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1).copy(), w.transpose(2, 3, 1, 0).copy()
    xq = _t(tq.quantize, x, -1.0, 1.0)[0]
    wq = _t(tq.quantize, w, -0.5, 0.5)[0]
    kw = dict(min_data=-1.0, max_data=1.0, min_weight=-0.5, max_weight=0.5,
              kernel=(3, 3), pad=(1, 1), stride=(2, 1), num_filter=5,
              layout=layout)
    got = _t(tq.quantized_conv, xq, wq, b, **kw)
    ref = _j("quantized_conv", xq, wq, b, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    fp32 = _j("Convolution", x, w, b, kernel=(3, 3), pad=(1, 1),
              stride=(2, 1), num_filter=5, layout=layout)
    assert np.abs(got - fp32).max() < 0.3


def test_quantized_flatten_matches_mxtpu():
    xq = _t(tq.quantize, _rand(4, (2, 3, 4, 5)), -1.0, 1.0)[0]
    got = _t(tq.quantized_flatten, xq, -1.0, 1.0)
    ref = _j("quantized_flatten", xq, -1.0, 1.0)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == np.int8 and got[0].shape == (2, 60)
    assert float(got[1]) == -1.0 and float(got[2]) == 1.0


@pytest.mark.parametrize("kw", [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg"),
    dict(pool_type="avg", global_pool=True),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max", layout="NHWC"),
])
def test_quantized_pooling_matches_mxtpu(kw):
    xq = _t(tq.quantize, _rand(5, (2, 3, 6, 6)), -1.0, 1.0)[0]
    got = _t(tq.quantized_pooling, xq, -1.0, 1.0, **kw)
    ref = _j("quantized_pooling", xq, -1.0, 1.0, **kw)
    assert got[0].dtype == np.int8
    np.testing.assert_array_equal(got[0], ref[0])


def test_nd_wrappers_return_ndarrays():
    x = mt.nd.array(np.linspace(-2, 2, 9).astype(np.float32), ctx=mt.cpu())
    q, lo, hi = mt.nd.contrib.quantize(x, -2.0, 2.0)
    assert isinstance(q, mt.nd.NDArray) and q.dtype == np.int8
    back = mt.nd.dequantize(q, lo, hi)
    np.testing.assert_allclose(back.asnumpy(), x.asnumpy(),
                               atol=2.0 / 127 + 1e-6)


# --------------------------------------------------------- int8 Predictor
IN_DIM = 12


def _nets(seed=0):
    """(mxtpu net, port net) with the same seeded weights: two dense
    layers (2-d weights, stored as int8) and their biases (1-d, kept
    exact)."""
    def build(nn, prefix):
        net = nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu", in_units=IN_DIM),
                    nn.Dense(8, in_units=16))
        return net

    jnet = build(jnn, "mlp_")
    jnet.initialize()
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=seed)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    net = build(tnn, "mlp_")
    net.initialize(ctx=mt.cpu())
    convert.load_mxtpu_params(net, arrays)
    return jnet, net


def _x(n, seed):
    return np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32)


def test_int8_predictor_matches_mxtpu():
    jnet, net = _nets()
    spec = dict(batch_sizes=(2, 4))
    example = np.zeros((1, IN_DIM), np.float32)
    jpred = JPredictor(jnet, JBucketSpec(**spec), example=example,
                       int8=True, warmup=True)
    pred = Predictor(net, BucketSpec(**spec), example=example, int8=True,
                     warmup=True, device="cpu", site="test.int8")
    assert pred.int8 and jpred.int8
    qdts = [None if q is None else str(q).split(".")[-1]
            for q in pred._qdtypes]
    assert qdts == jpred._param_qdtypes == \
        ["float32", None, "float32", None]
    for mine, ref in zip(pred._stored, jpred._param_datas):
        assert mine.dtype == getattr(torch, str(ref.dtype))
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    for mine, ref in zip(pred._ranges, jpred._param_ranges):
        assert (mine is None) == (ref is None)
        if mine is not None:
            assert float(mine) == float(ref)
    for n, seed in ((1, 0), (3, 1), (4, 2), (9, 3)):
        x = _x(n, seed)
        ref = jpred.predict(x).asnumpy()
        got = pred.predict(x).asnumpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    exact = Predictor(net, BucketSpec(**spec), example=example,
                      device="cpu", site="test.int8.f32")
    f32 = exact.predict(_x(4, 2)).asnumpy()
    assert 0 < np.abs(pred.predict(_x(4, 2)).asnumpy() - f32).max() \
        < 0.05 * np.abs(f32).max()
    # 320 weights as int8 with two float32 ranges, 24 biases as float32
    assert pred.param_bytes() == 320 + 2 * 4 + 24 * 4
    assert exact.param_bytes() == (320 + 24) * 4
    assert pred.compile_stats()["compiles"] == 2


def test_int8_weights_are_dequantized_where_their_layer_reads_them(
        monkeypatch):
    """Each float copy of an int8 weight dies with its layer's forward:
    when the second layer reads its weight, the first layer's copy is
    gone (a captured graph's pool then never holds every copy)."""
    _, net = _nets()
    pred = Predictor(net, BucketSpec([2]), int8=True, device="cpu",
                     example=np.zeros((1, IN_DIM), np.float32),
                     site="test.int8.reads")
    real = pred._read_param
    copies, alive_at_read = [], []

    def read(t):
        out = real(t)
        if out is not t:
            alive_at_read.append(sum(r() is not None for r in copies))
            copies.append(weakref.ref(out))
        return out

    monkeypatch.setattr(pred, "_read_param", read)
    want = pred._forward(torch.from_numpy(_x(2, 3)))
    assert alive_at_read == [0, 0]
    ref = Predictor(net, BucketSpec([2]), int8=True, device="cpu",
                    example=np.zeros((1, IN_DIM), np.float32),
                    site="test.int8.reads.ref")
    torch.testing.assert_close(want[0], ref._forward(
        torch.from_numpy(_x(2, 3)))[0], rtol=0, atol=0)


def test_int8_refresh_requantizes_sticky_like_mxtpu():
    """A reload requantizes without a build; a weight that turns all-zero
    keeps its int8 slot on a unit grid, in both packages."""
    jnet, net = _nets()
    example = np.zeros((1, IN_DIM), np.float32)
    jpred = JPredictor(jnet, JBucketSpec([2]), example=example, int8=True,
                       warmup=True)
    pred = Predictor(net, BucketSpec([2]), example=example, int8=True,
                     warmup=True, device="cpu", site="test.int8.sticky")
    w0 = [k for k in net.collect_params() if k.endswith("dense0_weight")][0]
    jw0 = [k for k in jnet.collect_params() if k.endswith("dense0_weight")][0]
    zeros = np.zeros((16, IN_DIM), np.float32)
    net.collect_params()[w0].set_data(zeros)
    jnet.collect_params()[jw0].set_data(mx.nd.array(zeros))
    before = pred._stored[0]
    pred.refresh_params(version=2)
    jpred.refresh_params(version=2)
    assert pred._stored[0] is before          # written in place
    assert float(pred._ranges[0]) == float(jpred._param_ranges[0]) == 1.0
    assert pred._qdtypes[0] == torch.float32
    x = _x(2, 7)
    ref = jpred.predict(x).asnumpy()
    np.testing.assert_allclose(pred.predict(x).asnumpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert pred.compile_stats()["compiles"] == 1 and pred.param_version == 2
