"""The port's external-kernel hook (mxtpu_torch.contrib.external_kernel)
against the JAX package's (mxtpu.contrib.external_kernel): the cases of
tests/test_external_kernel.py on the CPU, each kernel registered in both
packages and fed the same seeded numpy inputs. The symbol and hybridize
cases wait for the port's symbolic path.

Tolerances: forward rtol 1e-6, gradients rtol 1e-5; a numeric
(central-difference) gradient at rtol 1e-2, atol 1e-3, as in the JAX
package's test."""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.contrib import external_kernel as jek
from mxtpu_torch.contrib import external_kernel as tek

CPU = mt.cpu()


@pytest.fixture(autouse=True, scope="module")
def _registry_cleanup():
    """Unregister the ops this module adds, in both packages, so no later
    test (the JAX sweep's registry-coverage gate among them) sees them."""
    from mxtpu.ops.registry import REGISTRY as JREG
    from mxtpu_torch.ops.registry import REGISTRY as TREG
    import mxtpu.ndarray as j_nd
    import mxtpu.symbol as j_sym
    before = {id(JREG): set(JREG), id(TREG): set(TREG)}
    yield
    for reg, mods, subs in (
            (JREG, (j_nd, j_sym), (j_nd.contrib, j_nd._internal,
                                   j_sym.contrib)),
            (TREG, (mt.nd,), (mt.nd.contrib, mt.nd._internal))):
        for name in set(reg) - before[id(reg)]:
            del reg[name]
            short = name[len("_contrib_"):] \
                if name.startswith("_contrib_") else None
            for mod in mods:
                if name in vars(mod):
                    delattr(mod, name)
            for sub in subs:
                for attr in (name, short):
                    if attr and attr in vars(sub):
                        delattr(sub, attr)


def _t(a):
    return mt.nd.array(a, ctx=CPU)


def _gelu(lib):
    def scaled_gelu(x, scale=1.0):
        return scale * 0.5 * x * (1.0 + lib.tanh(
            0.7978845608 * (x + 0.044715 * x ** 3)))
    return scaled_gelu


def test_device_kernel_nd_and_grad():
    import jax.numpy as jnp
    fj = jek.register_external_kernel("_extt_scaled_gelu", _gelu(jnp))
    ft = tek.register_external_kernel("_extt_scaled_gelu", _gelu(torch))
    x = np.linspace(-2, 2, 7).astype(np.float32)
    ref = fj(mx.nd.array(x), scale=2.0).asnumpy()
    # the returned callable and the nd namespace are one op
    assert mt.nd._extt_scaled_gelu is ft
    # five float32 ops, tanh's last bit differs between the libraries:
    # rtol 1e-6 plus an atol of ~2 ulp of the largest value (4)
    np.testing.assert_allclose(ft(_t(x), scale=2.0).asnumpy(), ref,
                               rtol=1e-6, atol=1e-6)
    # autograd flows through torch's own differentiation of the kernel
    grads = []
    for pkg, fn, arr in ((mx, fj, mx.nd.array), (mt, ft, _t)):
        a = arr(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = fn(a, scale=2.0)
        y.backward(pkg.nd.ones_like(y))
        grads.append(a.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6)
    eps = 1e-3
    g = _gelu(np)
    num = (g(x + eps, 2.0) - g(x - eps, 2.0)) / (2 * eps)
    np.testing.assert_allclose(grads[1], num, rtol=1e-2, atol=1e-3)


def test_duplicate_name_rejected():
    tek.register_external_kernel("_extt_dup_probe", lambda x: x)
    with pytest.raises(mt.MXNetError, match="already registered"):
        tek.register_external_kernel("_extt_dup_probe", lambda x: x)
    # aliases must not silently shadow builtins either
    with pytest.raises(mt.MXNetError, match="already registered"):
        tek.register_external_kernel("_extt_other_probe", lambda x: x,
                                     aliases=("dot",))
    assert "_extt_other_probe" not in mt.ops.registry.REGISTRY


def test_vjp_kernel_accepts_attr_kwargs():
    """Attributes bind before the autograd.Function boundary."""
    def scaled(x, alpha=1.0):
        return alpha * x

    def vjp(g, x, alpha=1.0):
        return (alpha * g,)

    res = []
    for pkg, ek, arr in ((mx, jek, mx.nd.array), (mt, tek, _t)):
        fn = ek.register_external_kernel("_extt_scaled_id", scaled, vjp=vjp)
        a = arr(np.array([1.0, 2.0], np.float32))
        a.attach_grad()
        with pkg.autograd.record():
            y = fn(a, alpha=3.0)
        y.backward(pkg.nd.ones_like(y))
        res.append((y.asnumpy(), a.grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], [3.0, 6.0])
    np.testing.assert_allclose(res[1][1], [3.0, 3.0])
    np.testing.assert_allclose(res[1][1], res[0][1])


def test_late_contrib_registration_reaches_subnamespaces():
    tek.register_external_kernel("_contrib_extt_probe_op", lambda x: x + 1.0)
    a = _t(np.zeros(2, np.float32))
    np.testing.assert_allclose(mt.nd.contrib.extt_probe_op(a).asnumpy(), 1.0)
    np.testing.assert_allclose(
        mt.nd._internal._contrib_extt_probe_op(a).asnumpy(), 1.0)
    np.testing.assert_allclose(mt.nd._contrib_extt_probe_op(a).asnumpy(),
                               1.0)


def test_host_kernel_with_custom_vjp_trains():
    """A numpy host function with a hand-written vjp under record()."""
    calls = []

    def host_square(x):
        calls.append(type(x))
        return np.square(np.asarray(x))

    def vjp(g, x):
        return (2.0 * x * g,)

    x = np.array([1.0, -3.0, 0.5], np.float32)
    res = []
    for pkg, ek, arr in ((mx, jek, mx.nd.array), (mt, tek, _t)):
        fn = ek.register_host_kernel("_extt_host_square", host_square,
                                     vjp=vjp)
        a = arr(x)
        out = fn(a).asnumpy()
        a.attach_grad()
        with pkg.autograd.record():
            y = fn(a)
        y.backward(pkg.nd.ones_like(y))
        res.append((out, a.grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], [1.0, 9.0, 0.25], rtol=1e-6)
    assert calls[-1] is np.ndarray    # really ran on the host, on numpy
    np.testing.assert_allclose(res[1][1], 2.0 * x, rtol=1e-6)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5)


def test_host_kernel_out_shape_fn():
    import jax

    def row_sums(x):
        return np.asarray(x).sum(axis=1)

    fj = jek.register_host_kernel(
        "_extt_row_sums", row_sums,
        out_shape_fn=lambda x: jax.ShapeDtypeStruct((x.shape[0],), x.dtype))
    ft = tek.register_host_kernel(
        "_extt_row_sums", row_sums,
        out_shape_fn=lambda x: torch.empty((x.shape[0],), dtype=x.dtype,
                                           device="meta"))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_allclose(ft(_t(x)).asnumpy(), [3.0, 12.0])
    np.testing.assert_allclose(ft(_t(x)).asnumpy(),
                               fj(mx.nd.array(x)).asnumpy())
    bad = tek.register_host_kernel(
        "_extt_bad_shape", row_sums,
        out_shape_fn=lambda x: torch.empty((5,), device="meta"))
    with pytest.raises(mt.MXNetError, match="returned shape"):
        bad(_t(x))


def test_vjp_kernel_with_two_outputs_and_an_integer_input():
    """Several outputs give the vjp a tuple of cotangents; an integer input
    gets no gradient; a gradient count that is off raises."""
    def fn(x, idx):
        return x * idx, x + 1.0

    def vjp(gs, x, idx):
        g1, g2 = gs
        return g1 * idx + g2, None

    f = tek.register_external_kernel("_extt_two_out", fn, vjp=vjp)
    r = np.random.RandomState(1)
    x = r.randn(4).astype(np.float32)
    idx = np.array([1, 2, 3, 4], np.int32)
    a, i = _t(x), _t(idx)
    a.attach_grad()
    i.attach_grad()
    with mt.autograd.record():
        p, q = f(a, i)
        loss = (p * 2 + q * q).sum()
    loss.backward()
    np.testing.assert_allclose(a.grad.asnumpy(), 2 * idx + 2 * (x + 1),
                               rtol=1e-5)
    np.testing.assert_array_equal(i.grad.asnumpy(), 0)

    g = tek.register_external_kernel("_extt_bad_vjp", lambda x: x * 2,
                                     vjp=lambda g, x: (g, g))
    b = _t(x)
    b.attach_grad()
    with mt.autograd.record():
        y = g(b)
    with pytest.raises(mt.MXNetError, match="vjp returned 2 gradients"):
        y.backward()


def test_kernel_returning_ndarrays():
    """A kernel may return NDArrays (as an rtc launch does): the op
    unwraps them."""
    f = tek.register_external_kernel(
        "_extt_nd_out", lambda x: mt.nd.NDArray(x * 3.0),
        vjp=lambda g, x: mt.nd.NDArray(g * 3.0))
    a = _t(np.ones(3, np.float32))
    a.attach_grad()
    with mt.autograd.record():
        y = f(a)
    y.backward()
    np.testing.assert_allclose(y.asnumpy(), 3.0)
    np.testing.assert_allclose(a.grad.asnumpy(), 3.0)
