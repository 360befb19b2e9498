"""The port's fused conv (mxtpu_torch/ops/pallas/conv.py) against the JAX
package's Pallas kernel (mxtpu/ops/pallas/conv.py).

On this host the port's wrapper gets CPU tensors, so it runs its plain
version, which repeats the CUDA kernel's arithmetic; the JAX kernel runs
through the Pallas interpreter (MXTPU_PALLAS_CONV_INTERPRET=1), as
tests/test_pallas_conv.py runs it. Inputs come from seeded numpy.
Tolerances: float32 rtol=atol=1e-5 (the reference's own); bfloat16 one
bf16 ulp of the output's largest magnitude (both sides accumulate in
float32 and round once). The shape gate must give the JAX package's
decision and reason for every ResNet-50 conv and the out-of-domain cases."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops.pallas import conv as jpc
import mxtpu_torch as mt
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops.pallas import conv as tpc

DN = ("NHWC", "HWIO", "NHWC")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (h, c_in, c_out, k, stride, pad): stem-like 7x7/2 on an odd size, 3x3
# odd, 1x1, strided 1x1 (the downsample shortcut), strided 3x3 — the
# matrix of tests/test_pallas_conv.py — plus a small 3->64 7x7/2 stem
SHAPES = [
    (15, 3, 8, 7, 2, 3),
    (9, 4, 8, 3, 1, 1),
    (8, 16, 8, 1, 1, 0),
    (9, 8, 8, 1, 2, 0),
    (11, 4, 8, 3, 2, 1),
    (32, 3, 64, 7, 2, 3),
]


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXTPU_PALLAS_CONV_INTERPRET", "1")
    jpc.reset_dispatch_stats()


def _inputs(seed, n, h, cin, cout, k, with_epi=(False, False, False)):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    sc = (rng.rand(cout) + 0.5).astype(np.float32) if with_epi[0] else None
    bi = (rng.randn(cout) * 0.1).astype(np.float32) if with_epi[1] else None
    return x, w, sc, bi, rng


def _jax(x, w, dtype, s, pad, sc=None, bi=None, res=None, relu=False):
    """(out, craw) of the JAX kernel, run through the interpreter."""
    dt = JDT[dtype]
    cfg = jpc._Cfg(strides=(s, s), padding=pad, relu=relu,
                   has_scale=sc is not None, has_bias=bi is not None,
                   has_residual=res is not None)
    a = [jnp.asarray(x, dt), jnp.asarray(w, dt),
         None if sc is None else jnp.asarray(sc),
         None if bi is None else jnp.asarray(bi),
         None if res is None else jnp.asarray(res[0], JDT[res[1]])]
    out, resid = jpc._core_fwd_impl(*a, cfg)
    assert jpc.DISPATCH_STATS["pallas"] >= 1   # the kernel, not a fallback
    craw = resid[-1]
    return (np.asarray(out.astype(jnp.float32)),
            None if craw is None else np.asarray(craw))


def _port(x, w, dtype, s, pad, sc=None, bi=None, res=None, relu=False):
    dt = TDT[dtype]
    out, craw = tpc.fused_conv_with_raw(
        torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt), (s, s), pad,
        scale=None if sc is None else torch.from_numpy(sc),
        bias=None if bi is None else torch.from_numpy(bi),
        residual=None if res is None else torch.from_numpy(res[0]).to(
            TDT[res[1]]),
        relu=relu)
    assert out.dtype == dt
    return out.float().numpy(), None if craw is None else craw.numpy()


def _bf16_ulp(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("h,cin,cout,k,s,p", SHAPES)
def test_fused_conv_matches_pallas_f32(h, cin, cout, k, s, p):
    x, w, _, _, _ = _inputs(0, 2, h, cin, cout, k)
    pad = ((p, p), (p, p))
    got, _ = _port(x, w, "float32", s, pad)
    ref, _ = _jax(x, w, "float32", s, pad)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,cin,cout,k,s,p", SHAPES)
def test_fused_conv_matches_pallas_bf16(h, cin, cout, k, s, p):
    x, w, _, _, _ = _inputs(1, 2, h, cin, cout, k)
    pad = ((p, p), (p, p))
    got, _ = _port(x, w, "bfloat16", s, pad)
    ref, _ = _jax(x, w, "bfloat16", s, pad)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulp(ref))


@pytest.mark.parametrize("scale,bias,residual,relu",
                         list(itertools.product((False, True), repeat=4)))
def test_fused_epilogue_matches_pallas(scale, bias, residual, relu):
    """Every epilogue combination, the raw conv included when scale is on."""
    x, w, sc, bi, rng = _inputs(2, 2, 9, 4, 8, 3, (scale, bias, residual))
    res = ((rng.randn(2, 9, 9, 8).astype(np.float32), "float32")
           if residual else None)
    pad = ((1, 1), (1, 1))
    got, craw = _port(x, w, "float32", 1, pad, sc, bi, res, relu)
    ref, rcraw = _jax(x, w, "float32", 1, pad, sc, bi, res, relu)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (craw is None) == (rcraw is None) == (not scale)
    if scale:
        np.testing.assert_allclose(craw, rcraw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("res_dtype", ["bfloat16", "float32"])
def test_fused_epilogue_bf16_matches_pallas(res_dtype):
    x, w, sc, bi, rng = _inputs(3, 2, 9, 4, 8, 3, (True, True, True))
    res = (rng.randn(2, 5, 5, 8).astype(np.float32), res_dtype)
    pad = ((1, 1), (1, 1))
    got, craw = _port(x, w, "bfloat16", 2, pad, sc, bi, res, True)
    ref, rcraw = _jax(x, w, "bfloat16", 2, pad, sc, bi, res, True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulp(ref))
    np.testing.assert_allclose(craw, rcraw, rtol=1e-5, atol=1e-5)


def test_fused_conv_asymmetric_padding_matches_pallas():
    x, w, _, _, _ = _inputs(4, 3, 13, 5, 24, 3)
    pad = ((1, 0), (2, 1))
    got, _ = _port(x, w, "float32", 2, pad)
    ref, _ = _jax(x, w, "float32", 2, pad)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _resnet50_convs():
    """(x shape, w shape, strides, padding, routed) of every conv of one
    224x224 ResNet-50 v1 forward through the port, in call order."""
    from mxtpu_torch.gluon.model_zoo import vision
    from mxtpu_torch.ops import nn as tnn
    seen = []
    real = tnn.conv_fast

    def recording(x, w, strides, padding, *a, **kw):
        seen.append([tuple(x.shape), tuple(w.shape), tuple(strides),
                     tuple(map(tuple, padding)), False])
        return real(x, w, strides, padding, *a, **kw)

    real_fused = tpc.fused_conv

    def counting(*a, **kw):
        seen[-1][-1] = True
        return real_fused(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnn, "conv_fast", recording)
        mp.setattr(tpc, "fused_conv", counting)
        with mt.layout("NHWC"):
            net = vision.resnet50_v1()
        net.initialize(ctx=mt.cpu())
        with torch.no_grad():
            net(torch.zeros(1, 224, 224, 3))
    return seen


def test_gate_matches_mxtpu_on_resnet50_and_admits_exactly_11():
    convs = _resnet50_convs()
    assert len(convs) == 53
    assert sum(routed for *_, routed in convs) == 11
    admitted = 0
    for xs, ws, strides, padding, routed in convs:
        for dt in ("float32", "bfloat16"):
            tx = torch.empty(xs, dtype=TDT[dt], device="meta")
            tw = torch.empty(ws, dtype=TDT[dt], device="meta")
            jx = jax.ShapeDtypeStruct(xs, JDT[dt])
            jw = jax.ShapeDtypeStruct(ws, JDT[dt])
            args = (strides, padding, (1, 1), (1, 1), DN, 1)
            mine = tpc.pallas_applicable(tx, tw, *args)
            assert mine == jpc.pallas_applicable(jx, jw, *args), (xs, ws)
            assert mine[0] == routed
            admitted += mine[0]
    assert admitted == 2 * 11
    # the 11: the stem and the ten stage-1 convs at 56x56
    assert sorted({ws for _, ws, _, _, r in convs if r}) == sorted(
        {(7, 7, 3, 64), (1, 1, 64, 64), (3, 3, 64, 64), (1, 1, 64, 256),
         (1, 1, 256, 64)})


@pytest.mark.parametrize("case", [
    "nchw", "grouped", "deconv", "dilated", "int32", "mixed", "negpad",
    "degenerate", "not2d", "filled"])
def test_gate_rejects_out_of_domain_like_mxtpu(case):
    xs, ws, dt, wdt = (1, 8, 8, 4), (3, 3, 4, 8), "float32", "float32"
    strides, pad, lhs, rhs, dims, groups = ((1, 1), ((0, 0), (0, 0)),
                                           (1, 1), (1, 1), DN, 1)
    if case == "nchw":
        dims = ("NCHW", "OIHW", "NCHW")
    elif case == "grouped":
        ws, groups = (3, 3, 2, 8), 2
    elif case == "deconv":
        lhs = (2, 2)
    elif case == "dilated":
        rhs = (2, 2)
    elif case == "int32":
        dt = "int32"
    elif case == "mixed":
        wdt = "bfloat16"
    elif case == "negpad":
        pad = ((-1, 0), (0, 0))
    elif case == "degenerate":
        xs = (1, 2, 2, 4)
    elif case == "not2d":
        xs = (1, 8, 4)
    elif case == "filled":
        xs, ws = (1, 6, 6, 128), (3, 3, 128, 128)
    jdt = {"int32": jnp.int32, **JDT}
    tdt = {"int32": torch.int32, **TDT}
    mine = tpc.pallas_applicable(
        torch.empty(xs, dtype=tdt[dt], device="meta"),
        torch.empty(ws, dtype=tdt[wdt], device="meta"),
        strides, pad, lhs, rhs, dims, groups)
    ref = jpc.pallas_applicable(jax.ShapeDtypeStruct(xs, jdt[dt]),
                                jax.ShapeDtypeStruct(ws, jdt[wdt]),
                                strides, pad, lhs, rhs, dims, groups)
    assert mine == ref
    assert mine[0] is False and mine[1]


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel."""

    @property
    def device(self):
        return torch.device("xpu", 0)


def _elsewhere(t):
    return torch.Tensor._make_subclass(_Elsewhere, t, t.requires_grad)


def test_wrapper_plain_on_cpu_counts_no_launch_and_refuses_misuse():
    x = torch.randn(1, 5, 5, 4)
    w = torch.randn(3, 3, 4, 8)
    before = tpc.fused_conv.launches
    out = tpc.fused_conv(x, w, (1, 1), ((1, 1), (1, 1)))
    assert out.shape == (1, 5, 5, 8)
    assert tpc.fused_conv.launches == before   # plain version: no launch
    with pytest.raises(MXNetError, match="float32 or both bfloat16"):
        tpc.fused_conv(x, w.bfloat16())
    with pytest.raises(MXNetError, match="residual must have shape"):
        tpc.fused_conv(x, w, residual=torch.zeros(1, 3, 3, 7))
    # off the CPU the wrapper launches a kernel or raises; it never falls
    # back to the plain version (a tensor that reports another device
    # stands in for one here); a meta tensor (shape inference) gives a
    # meta result and counts no launch
    xo = _elsewhere(x)
    wo = _elsewhere(w.clone().requires_grad_())
    with pytest.raises(MXNetError, match="no kernel for device"):
        tpc.fused_conv(xo, wo)
    with torch.no_grad(), pytest.raises(MXNetError,
                                        match="no kernel for device"):
        tpc.fused_conv(xo, _elsewhere(w))
    xm, wm = x.to("meta"), w.to("meta").requires_grad_()
    out = tpc.fused_conv(xm, wm, (2, 2), ((1, 1), (1, 1)))
    assert out.device.type == "meta" and out.shape == (1, 3, 3, 8)
    assert tpc.fused_conv.launches == before
    # the plain version on CPU tensors stays differentiable
    w.requires_grad_()
    tpc.fused_conv(x, w).sum().backward()
    assert w.grad.shape == w.shape
