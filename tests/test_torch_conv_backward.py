"""The fused conv's backward in the port (``ops/pallas/conv.py``:
``_FusedConv`` and ``fused_conv_backward``) against ``jax.grad`` of the JAX
package's ``fused_conv``, its kernel run by the Pallas interpreter
(``MXTPU_PALLAS_CONV_INTERPRET=1``), on seeded numpy inputs: gradients of
x, w, scale, bias and residual at strides 1 and 2, symmetric and
asymmetric padding, with and without ReLU, at
``tests/test_pallas_conv.py``'s tolerances: float32 rtol=atol=1e-4,
bfloat16 rtol=atol=5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops.pallas import conv as jpc
from mxtpu_torch.ops.pallas import conv as tpc

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD = 1e-4


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXTPU_PALLAS_CONV_INTERPRET", "1")
    jpc.reset_dispatch_stats()


# ------------------------------------------------------------- fused conv
# (h, c_in, c_out, k, stride, padding): tests/test_pallas_conv.py's shapes
# plus asymmetric padding at strides 1 and 2
CONV = [
    (15, 3, 8, 7, 2, ((3, 3), (3, 3))),
    (9, 4, 8, 3, 1, ((1, 1), (1, 1))),
    (8, 16, 8, 1, 1, ((0, 0), (0, 0))),
    (9, 8, 8, 1, 2, ((0, 0), (0, 0))),
    (11, 4, 8, 3, 2, ((1, 1), (1, 1))),
    (9, 4, 8, 3, 1, ((1, 0), (2, 1))),
    (13, 5, 24, 3, 2, ((0, 1), (1, 2))),
]
EPILOGUES = [(False, False, False, False), (True, True, True, True),
             (True, False, False, True), (False, True, True, False)]


def _conv_inputs(seed, h, cin, cout, k, s, pad):
    r = np.random.RandomState(seed)
    oh = (h + pad[0][0] + pad[0][1] - k) // s + 1
    ow = (h + pad[1][0] + pad[1][1] - k) // s + 1
    return dict(x=r.randn(2, h, h, cin).astype(np.float32),
                w=(r.randn(k, k, cin, cout) * 0.1).astype(np.float32),
                sc=(r.rand(cout) + 0.5).astype(np.float32),
                bi=(r.randn(cout) * 0.1).astype(np.float32),
                res=r.randn(2, oh, ow, cout).astype(np.float32),
                head=r.randn(2, oh, ow, cout).astype(np.float32))


def _jax_conv_grads(a, s, pad, epi, dtype):
    use_sc, use_bi, use_res, relu = epi
    dt = JDT[dtype]
    args = [jnp.asarray(a["x"], dt), jnp.asarray(a["w"], dt),
            jnp.asarray(a["sc"]), jnp.asarray(a["bi"]),
            jnp.asarray(a["res"], dt)]
    head = jnp.asarray(a["head"])

    def f(x, w, sc, bi, res):
        out = jpc.fused_conv(x, w, (s, s), pad,
                             scale=sc if use_sc else None,
                             bias=bi if use_bi else None,
                             residual=res if use_res else None, relu=relu)
        return jnp.sum(out.astype(jnp.float32) * head)
    grads = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*args)
    assert jpc.DISPATCH_STATS["pallas"] >= 1   # the kernel, not a fallback
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_conv_grads(a, s, pad, epi, dtype):
    use_sc, use_bi, use_res, relu = epi
    dt = TDT[dtype]
    x = torch.from_numpy(a["x"]).to(dt).requires_grad_()
    w = torch.from_numpy(a["w"]).to(dt).requires_grad_()
    sc = torch.from_numpy(a["sc"]).requires_grad_()
    bi = torch.from_numpy(a["bi"]).requires_grad_()
    res = torch.from_numpy(a["res"]).to(dt).requires_grad_()
    out = tpc.fused_conv(x, w, (s, s), pad, scale=sc if use_sc else None,
                         bias=bi if use_bi else None,
                         residual=res if use_res else None, relu=relu)
    (out.float() * torch.from_numpy(a["head"])).sum().backward()
    assert x.grad.dtype == dt and w.grad.dtype == dt
    if use_res:
        assert res.grad.dtype == dt
    return [None if t.grad is None else t.grad.float().numpy()
            for t in (x, w, sc, bi, res)]


# every shape plain; the epilogues on a stride-1 shape and a stride-2
# asymmetric one
F32_CASES = [c + (EPILOGUES[0],) for c in CONV] + [
    CONV[i] + (e,) for i in (1, 6) for e in EPILOGUES[1:]]


@pytest.mark.parametrize("h,cin,cout,k,s,pad,epi", F32_CASES)
def test_conv_backward_matches_jax_grad_f32(h, cin, cout, k, s, pad, epi):
    a = _conv_inputs(h * k + cin, h, cin, cout, k, s, pad)
    ref = _jax_conv_grads(a, s, pad, epi, "float32")
    got = _port_conv_grads(a, s, pad, epi, "float32")
    for name, used, g, r in zip(("x", "w", "scale", "bias", "residual"),
                                (True, True) + epi[:3], got, ref):
        if not used:
            assert g is None
            continue
        np.testing.assert_allclose(g, r, rtol=GRAD, atol=GRAD, err_msg=name)


@pytest.mark.parametrize("epi", EPILOGUES[:2], ids=["plain", "full"])
@pytest.mark.parametrize("h,cin,cout,k,s,pad",
                         [CONV[0], CONV[6]])
def test_conv_backward_matches_jax_grad_bf16(h, cin, cout, k, s, pad, epi):
    """The cotangent is cast to bf16 before the gradient convolutions, as
    the JAX package does; dx and dw come back in bf16."""
    a = _conv_inputs(h * k + cin + 1, h, cin, cout, k, s, pad)
    ref = _jax_conv_grads(a, s, pad, epi, "bfloat16")
    got = _port_conv_grads(a, s, pad, epi, "bfloat16")
    for name, used, g, r in zip(("x", "w", "scale", "bias", "residual"),
                                (True, True) + epi[:3], got, ref):
        if used:
            np.testing.assert_allclose(g, r, rtol=5e-2, atol=5e-2,
                                       err_msg=name)


