"""The port's serving ops (mxtpu_torch/ops/nn.py, conv_acc.py) and layers
against the JAX package's (mxtpu/ops/nn.py, conv_acc.py, gluon/nn).

Same seeded numpy inputs through both; float32 at rtol=atol=1e-5 unless a
reduction order makes 1e-6 relative noise visible, bf16 outputs at one
bf16 ulp of the output scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.ops.conv_acc import conv_fast as j_conv_fast
import mxtpu_torch as mt
from mxtpu_torch.ops import nn as tnn
from mxtpu_torch.ops.conv_acc import conv_fast as t_conv_fast
from mxtpu_torch.ops.pallas import conv as tpc

DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL"):
        monkeypatch.delenv(var, raising=False)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


def _bf16_ulp(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pad=(0, 0), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(0, 0), pool_type="max",
         pooling_convention="full"),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="max"),
], ids=["max3s2p1", "avg2s2", "avg-nopad-count", "max-full", "global-avg",
        "global-max"])
def test_pooling_nhwc_matches_mxtpu(kw):
    x = _rng(1).randn(2, 10, 9, 5).astype(np.float32)
    ref = mx.nd.Pooling(mx.nd.array(x), layout="NHWC", **kw).asnumpy()
    got = tnn.Pooling(_t(x), layout="NHWC", **kw)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_inference_matches_mxtpu(dtype, fix_gamma):
    """Moving statistics, f32 params, computed in f32 and cast back."""
    r = _rng(2)
    x = r.randn(2, 5, 5, 6).astype(np.float32)
    g, b = r.rand(6) + 0.5, r.randn(6) * 0.1
    mean, var = r.randn(6) * 0.1, r.rand(6) + 0.5
    args = [mx.nd.array(a.astype(np.float32)) for a in (g, b, mean, var)]
    ref = mx.nd.BatchNorm(mx.nd.array(x).astype(dtype), *args, eps=1e-5,
                          fix_gamma=fix_gamma, axis=-1)
    got = tnn.BatchNorm(_t(x, getattr(torch, dtype)),
                        *[_t(a) for a in (g, b, mean, var)], eps=1e-5,
                        fix_gamma=fix_gamma, axis=-1)
    assert str(got.dtype).endswith(dtype) and ref.dtype == dtype
    ref = ref.astype("float32").asnumpy()
    atol = 1e-5 if dtype == "float32" else _bf16_ulp(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5 if dtype == "float32"
                               else 0, atol=atol)


def test_batchnorm_layer_eps_and_bf16_cast_keep_f32_stats():
    with mt.layout("NHWC"):
        bn = mt.gluon.nn.BatchNorm()
    with mx.layout("NHWC"):
        mbn = mx.gluon.nn.BatchNorm()
    assert bn._kwargs["eps"] == mbn._kwargs["eps"] == 1e-5
    assert bn._axis == mbn._axis == -1
    bn.initialize(ctx=mt.cpu())
    bn(torch.zeros(1, 2, 2, 3))
    bn.cast("bfloat16")
    assert all(p.data().to_torch().dtype == torch.float32
               for p in bn.collect_params().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_connected_on_pooled_nhwc_matches_mxtpu(dtype):
    """Dense after the global pool: x [N,1,1,C] flattens to [N,C]."""
    r = _rng(3)
    x = r.randn(4, 1, 1, 32).astype(np.float32)
    w = (r.randn(10, 32) * 0.2).astype(np.float32)
    b = r.randn(10).astype(np.float32)
    ref = mx.nd.FullyConnected(mx.nd.array(x).astype(dtype),
                               mx.nd.array(w).astype(dtype),
                               mx.nd.array(b).astype(dtype), num_hidden=10)
    got = tnn.FullyConnected(_t(x, getattr(torch, dtype)),
                             _t(w, getattr(torch, dtype)),
                             _t(b, getattr(torch, dtype)), num_hidden=10)
    ref = ref.astype("float32").asnumpy()
    assert got.shape == (4, 10)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=_bf16_ulp(ref))


def test_dense_layer_matches_mxtpu():
    r = _rng(4)
    x = r.randn(3, 1, 1, 16).astype(np.float32)
    net = mt.gluon.nn.Dense(7, in_units=16)
    mnet = mx.gluon.nn.Dense(7, in_units=16)
    net.initialize(ctx=mt.cpu())
    mnet.initialize()
    w, b = r.randn(7, 16).astype(np.float32), r.randn(7).astype(np.float32)
    mnet.weight.set_data(mx.nd.array(w))
    mnet.bias.set_data(mx.nd.array(b))
    net.weight.set_data(w)
    net.bias.set_data(b)
    np.testing.assert_allclose(_np(net(_t(x)).detach()),
                               mnet(mx.nd.array(x)).asnumpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_mxtpu(act):
    x = _rng(5).randn(3, 7).astype(np.float32) * 3
    np.testing.assert_allclose(
        _np(tnn.Activation(_t(x), act_type=act)),
        mx.nd.Activation(mx.nd.array(x), act_type=act).asnumpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_conv_fast_plain_branch_with_bias_matches_mxtpu(layout):
    """A conv the gate declines (K and C_out >= 128, or NCHW) runs the
    plain conv; the bias is added on that path too."""
    r = _rng(6)
    if layout == "NHWC":
        dims, xs, ws = DN, (2, 6, 6, 128), (3, 3, 128, 128)
    else:
        dims, xs, ws = ("NCHW", "OIHW", "NCHW"), (2, 4, 7, 7), (8, 4, 3, 3)
    x = r.randn(*xs).astype(np.float32)
    w = (r.randn(*ws) * 0.05).astype(np.float32)
    b = r.randn(ws[-1] if layout == "NHWC" else ws[0]).astype(np.float32)
    args = ((2, 2), [(1, 1), (1, 1)], (1, 1), (1, 1), dims, 1)
    ref = np.asarray(j_conv_fast(jnp.asarray(x), jnp.asarray(w), *args,
                                 bias=jnp.asarray(b)))
    before = tpc.fused_conv.launches
    got = t_conv_fast(_t(x), _t(w), *args, bias=_t(b))
    assert tpc.fused_conv.launches == before
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-4)


def test_conv_fast_gated_branch_keeps_promoting_bias_outside(monkeypatch):
    """bf16 operands with an f32 bias: the kernel runs, the bias stays an
    external add, and the output is f32 — the JAX package's rule."""
    monkeypatch.setenv("MXTPU_PALLAS_CONV", "1")
    monkeypatch.setenv("MXTPU_PALLAS_CONV_INTERPRET", "1")
    r = _rng(7)
    x = r.randn(1, 7, 7, 4).astype(np.float32)
    w = (r.randn(1, 1, 4, 8) * 0.1).astype(np.float32)
    b = r.randn(8).astype(np.float32)
    args = ((1, 1), [(0, 0), (0, 0)], (1, 1), (1, 1), DN, 1)
    ref = j_conv_fast(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16), *args,
                      bias=jnp.asarray(b))
    calls = []
    real = tpc.fused_conv
    monkeypatch.setattr(tpc, "fused_conv",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got = t_conv_fast(_t(x, torch.bfloat16), _t(w, torch.bfloat16), *args,
                      bias=_t(b))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert len(calls) == 1 and calls[0]["bias"] is None
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    same = t_conv_fast(_t(x, torch.bfloat16), _t(w, torch.bfloat16), *args,
                       bias=_t(b, torch.bfloat16))
    assert same.dtype == torch.bfloat16 and calls[1]["bias"] is not None


def test_layout_scope_matches_mxtpu():
    import importlib   # the packages export the scope class as `layout`
    jl = importlib.import_module("mxtpu.layout")
    tl = importlib.import_module("mxtpu_torch.layout")
    for name in ("NCHW", "NHWC", "channels_last", "channels_first"):
        with mx.layout(name), mt.layout(name):
            assert tl.current_layout(2) == jl.current_layout(2)
            assert tl.channel_axis(None) == jl.channel_axis(None)
            assert tl.conv_layout(None, 2) == jl.conv_layout(None, 2)
    for s in ("NCHW", "NHWC", "NCW", "NWC"):
        assert tl.channel_axis(s) == jl.channel_axis(s)
    with pytest.raises(mt.MXNetError):
        mt.layout("HWCN")
