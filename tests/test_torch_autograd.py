"""The port's autograd (mxtpu_torch.autograd on torch autograd) against the
JAX package's tape (mxtpu.autograd), on the same seeded numpy inputs, on
the CPU: the record/pause/train flags, backward with head gradients and
retain_graph, grad_req write/add/null, grad(), Function, mark_variables
and integer inputs.

Tolerance: gradients rtol 1e-5, the reductions' rule, plus an atol of
1e-6 of the largest |value| (at least 1e-6): an element that cancels, as
LayerNorm's gradients do, carries the rounding of the large terms."""
import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.base import MXNetError as JaxMXNetError

CPU = mt.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


def both(a):
    return mx.nd.array(a), mt.nd.array(a, ctx=CPU)


def close(got, ref):
    assert got.shape == ref.shape
    r = ref.asnumpy()
    np.testing.assert_allclose(got.asnumpy(), r, rtol=1e-5, atol=1e-6 * max(
        1.0, float(np.abs(r).max(initial=0.0))))


def test_flags_follow_the_scopes():
    for ag in (mx.autograd, mt.autograd):
        seen = []
        seen.append((ag.is_recording(), ag.is_training()))
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
                with ag.train_mode():
                    seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        seen.append((ag.is_recording(), ag.is_training()))
        assert ag.set_recording(True) is False
        assert ag.set_training(True) is False
        seen.append((ag.is_recording(), ag.is_training()))
        assert ag.set_recording(False) is True
        assert ag.set_training(False) is True
        if ag is mx.autograd:
            ref = seen
    assert seen == ref
    assert seen[0] == (False, False) and seen[1] == (True, True)


def test_nothing_is_taped_outside_record_or_inside_pause():
    x = _rng(1).randn(3, 4).astype(np.float32)
    (xa, xb) = both(x)
    xa.attach_grad()
    xb.attach_grad()
    yb = xb * 2
    assert yb.to_torch().grad_fn is None      # outside record()
    with pytest.raises(mt.MXNetError, match="not part of a recorded"):
        yb.backward()
    with pytest.raises(JaxMXNetError, match="not part of a recorded"):
        (xa * 2).backward()
    for ag, x_ in ((mx.autograd, xa), (mt.autograd, xb)):
        with ag.record():
            with ag.pause():
                c = x_ * 3            # a constant: not taped
            z = (c * x_).sum()
        z.backward()
    close(xb.grad, xa.grad)
    np.testing.assert_allclose(xb.grad.asnumpy(), 3 * x, **TOL)


@pytest.mark.parametrize("head", ["none", "ones", "random"])
def test_backward_with_head_grads(head):
    r = _rng(2)
    x, w = r.randn(3, 4).astype(np.float32), r.randn(3, 4).astype(np.float32)
    g = r.randn(3, 4).astype(np.float32)
    out = []
    for pkg, (xa, wa) in ((mx, (mx.nd.array(x), mx.nd.array(w))),
                          (mt, (mt.nd.array(x, ctx=CPU),
                                mt.nd.array(w, ctx=CPU)))):
        xa.attach_grad()
        wa.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.exp(xa) * wa + xa * xa
        hg = {"none": None, "ones": np.ones_like(g), "random": g}[head]
        y.backward(None if hg is None else (
            mx.nd.array(hg) if pkg is mx else mt.nd.array(hg, ctx=CPU)))
        out.append((xa.grad, wa.grad))
    close(out[1][0], out[0][0])
    close(out[1][1], out[0][1])


def test_retain_graph_and_a_second_backward():
    x = _rng(3).randn(5).astype(np.float32)
    grads = []
    for pkg, err in ((mx, JaxMXNetError), (mt, mt.MXNetError)):
        xa = mx.nd.array(x) if pkg is mx else mt.nd.array(x, ctx=CPU)
        xa.attach_grad(grad_req="add")
        with pkg.autograd.record():
            y = (xa * xa).sum()
        y.backward(retain_graph=True)
        y.backward()                    # graph retained once: accumulates
        grads.append(xa.grad)
        with pytest.raises(err):
            y.backward()                # freed: raises in both packages
    close(grads[1], grads[0])
    np.testing.assert_allclose(grads[1].asnumpy(), 4 * x, **TOL)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    r = _rng(4)
    x, w = r.randn(4).astype(np.float32), r.randn(4).astype(np.float32)
    res = []
    for pkg in (mx, mt):
        xa, wa = (pkg.nd.array(x), pkg.nd.array(w)) if pkg is mx else \
            (mt.nd.array(x, ctx=CPU), mt.nd.array(w, ctx=CPU))
        xa.attach_grad(grad_req=req)
        wa.attach_grad()
        for step in range(3):
            with pkg.autograd.record():
                loss = (pkg.nd.sin(xa) * wa * (step + 1)).sum()
            loss.backward()
        res.append((xa.grad, wa.grad))
    close(res[1][0], res[0][0])
    close(res[1][1], res[0][1])
    expect = {"write": 3, "add": 6, "null": 0}[req] * np.cos(x) * w
    np.testing.assert_allclose(res[1][0].asnumpy(), expect, **TOL)


def test_mark_variables_and_optimizer_update_keeps_the_leaf():
    r = _rng(5)
    w0 = r.randn(3).astype(np.float32)
    final = []
    for pkg in (mx, mt):
        w = pkg.nd.array(w0) if pkg is mx else mt.nd.array(w0, ctx=CPU)
        g = pkg.nd.zeros((3,)) if pkg is mx else mt.nd.zeros((3,), ctx=CPU)
        pkg.autograd.mark_variables([w], [g], grad_reqs="write")
        for _ in range(3):
            with pkg.autograd.record():
                loss = (w * w).sum()
            loss.backward()
            w -= 0.1 * w.grad           # outside record: not taped
        assert w.grad is g
        final.append(w)
    close(final[1], final[0])
    np.testing.assert_allclose(final[1].asnumpy(), w0 * 0.8 ** 3, **TOL)


def test_inplace_ops_under_record_are_taped():
    x = _rng(6).randn(4).astype(np.float32)
    out = []
    for pkg in (mx, mt):
        xa = pkg.nd.array(x) if pkg is mx else mt.nd.array(x, ctx=CPU)
        xa.attach_grad()
        with pkg.autograd.record():
            y = xa * 2
            y += xa * xa
            y *= 3
            loss = y.sum()
        loss.backward()
        out.append(xa.grad)
    close(out[1], out[0])


@pytest.mark.parametrize("retain", [False, True])
def test_grad_function(retain):
    r = _rng(7)
    x, y0 = r.randn(3, 2).astype(np.float32), r.randn(3, 2).astype(np.float32)
    hg = r.randn(3, 2).astype(np.float32)
    res = []
    for pkg in (mx, mt):
        arr = (lambda a: mx.nd.array(a)) if pkg is mx else \
            (lambda a: mt.nd.array(a, ctx=CPU))
        xa, ya = arr(x), arr(y0)
        xa.attach_grad()
        ya.attach_grad()
        with pkg.autograd.record():
            z = pkg.nd.tanh(xa) * ya
        gx, gy = pkg.autograd.grad(z, [xa, ya], head_grads=arr(hg),
                                   retain_graph=retain)
        single = pkg.autograd.grad(z, xa, head_grads=arr(hg)) if retain \
            else None
        res.append((gx, gy, single, xa.grad))
    for got, ref in zip(res[1][:2], res[0][:2]):
        close(got, ref)
    if retain:
        close(res[1][2], res[0][2])
    # grad() leaves the grad buffers alone
    np.testing.assert_array_equal(res[1][3].asnumpy(), 0.0)
    with pytest.raises(mt.MXNetError, match="used in the recorded graph"):
        mt.autograd.grad(mt.nd.array(x, ctx=CPU),
                         mt.nd.array(x, ctx=CPU))


class _Sigmoid:
    """The reference's autograd.Function example, for either package."""

    @staticmethod
    def make(pkg):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + pkg.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)
        return Sigmoid()


class _SplitScale:
    """Two inputs, two outputs, a list return."""

    @staticmethod
    def make(pkg):
        class SplitScale(pkg.autograd.Function):
            def forward(self, x, s):
                self.save_for_backward(x, s)
                return [x * s, x + s]

            def backward(self, d1, d2):
                x, s = self.saved_tensors
                return d1 * s + d2, d1 * x + d2
        return SplitScale()


@pytest.mark.parametrize("fn", ["sigmoid", "split"])
def test_function(fn):
    r = _rng(8)
    x, s = r.randn(5).astype(np.float32), r.randn(5).astype(np.float32)
    res = []
    for pkg in (mx, mt):
        arr = (lambda a: mx.nd.array(a)) if pkg is mx else \
            (lambda a: mt.nd.array(a, ctx=CPU))
        xa, sa = arr(x), arr(s)
        xa.attach_grad()
        sa.attach_grad()
        with pkg.autograd.record():
            if fn == "sigmoid":
                out = _Sigmoid.make(pkg)(xa)
                loss = (out * out).sum()
            else:
                o1, o2 = _SplitScale.make(pkg)(xa, sa)
                loss = (o1 * 3 + o2 * o2).sum()
                out = o1
        loss.backward()
        plain = _Sigmoid.make(pkg)(xa) if fn == "sigmoid" else None
        res.append((out, xa.grad, sa.grad, plain))
    for got, ref in zip(res[1][:3], res[0][:3]):
        close(got, ref)
    if fn == "sigmoid":     # outside record a Function is its forward
        close(res[1][3], res[0][3])
        assert res[1][3].to_torch().grad_fn is None


def test_integer_inputs_get_no_gradient():
    r = _rng(9)
    x = r.randn(4, 6).astype(np.float32)
    idx = np.array([0, 5, 2, 3], np.int32)
    res = []
    for pkg in (mx, mt):
        arr = (lambda a: mx.nd.array(a)) if pkg is mx else \
            (lambda a: mt.nd.array(a, ctx=CPU))
        xa, ia = arr(x), arr(idx)
        xa.attach_grad()
        ia.attach_grad()
        with pkg.autograd.record():
            loss = (pkg.nd.pick(xa, ia, axis=1) * 2
                    + (xa * ia.reshape(4, 1)).sum(axis=1)).sum()
        loss.backward()
        res.append((xa.grad, ia.grad))
    close(res[1][0], res[0][0])
    assert str(res[1][1].dtype) == "int32"
    np.testing.assert_array_equal(res[1][1].asnumpy(), 0)
    np.testing.assert_array_equal(res[0][1].asnumpy(), 0)


_CHAINS = {
    "reduce": lambda nd, x, w: (nd.mean(nd.exp(x) * w, axis=1)
                                + nd.max(x, axis=1)).sum(),
    "dot": lambda nd, x, w: nd.sum(nd.square(nd.dot(x, w.T))),
    "softmax_ce": lambda nd, x, w: nd.softmax_cross_entropy(
        x * w, nd.argmax(w, axis=1)),
    "shape_ops": lambda nd, x, w: nd.sum(nd.concat(
        nd.transpose(x), nd.flip(w, axis=0).T, dim=0)
        * nd.tile(nd.slice_axis(x, axis=0, begin=0, end=1).T, reps=(2, 1))),
    "clip_relu": lambda nd, x, w: nd.sum(nd.clip(x, -0.5, 0.5) * nd.relu(w)
                                         + nd.sigmoid(x) * nd.tanh(w)),
    "norm_l2": lambda nd, x, w: nd.sum(nd.L2Normalization(x * w)
                                       + nd.norm(x, axis=1).reshape(3, 1)),
    "make_loss": lambda nd, x, w: nd.sum(nd.make_loss(x * w, grad_scale=2.0)),
    "block_grad": lambda nd, x, w: nd.sum(nd.BlockGrad(x * w) * x),
    "where_hard": lambda nd, x, w: nd.sum(nd.where(
        x > 0, nd.hard_sigmoid(x), nd.smooth_l1(w)) * nd.broadcast_to(
            nd.sum(w, axis=0, keepdims=True), shape=(3, 4))),
    "fully_connected": lambda nd, x, w: nd.sum(nd.LayerNorm(
        nd.FullyConnected(x, w, nd.sum(w, axis=1), num_hidden=3),
        nd.ones((3,), ctx=x.context), nd.zeros((3,), ctx=x.context))
        * nd.arange(3, ctx=x.context)),
}


@pytest.mark.parametrize("chain", sorted(_CHAINS))
def test_gradients_through_registry_ops(chain):
    r = _rng(10)
    x = r.uniform(-1, 1, (3, 4)).astype(np.float32)
    w = r.uniform(0.2, 1.0, (3, 4)).astype(np.float32)
    res = []
    for pkg in (mx, mt):
        arr = (lambda a: mx.nd.array(a)) if pkg is mx else \
            (lambda a: mt.nd.array(a, ctx=CPU))
        xa, wa = arr(x), arr(w)
        xa.attach_grad()
        wa.attach_grad()
        with pkg.autograd.record():
            loss = _CHAINS[chain](pkg.nd, xa, wa)
        loss.backward()
        res.append((loss, xa.grad, wa.grad))
    for got, ref in zip(res[1], res[0]):
        close(got, ref)
