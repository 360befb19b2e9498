"""``gluon.utils`` of the port held to ``mxtpu``'s: ``split_data``,
``split_and_load``, ``clip_global_norm`` (the returned norm and the
scaled arrays, on plain arrays and on gradients between backward and a
Trainer step), ``check_sha1`` and ``download`` (raises: no network).
Tolerance: float32 rtol=atol=1e-5 (sums in another order)."""
import hashlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon import utils as jutils
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon import utils as tutils

TOL = 1e-5


def _arrays(seed, shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("n,num,axis,even", [
    (8, 4, 0, True), (7, 3, 0, False), (2, 5, 0, False), (6, 3, 1, True)])
def test_split_data(n, num, axis, even):
    shape = (n, 3) if axis == 0 else (2, n)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ref = jutils.split_data(mx.nd.array(x), num, axis, even)
    got = tutils.split_data(mt.nd.array(x, ctx=mt.cpu()), num, axis, even)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())


def test_uneven_split_raises_unless_allowed():
    for mod, pkg, kw in ((jutils, mx, {}), (tutils, mt, {"ctx": mt.cpu()})):
        with pytest.raises(Exception, match="evenly split"):
            mod.split_data(pkg.nd.array(np.ones((7, 2)), **kw), 3)


def test_split_and_load_places_each_slice():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    got = tutils.split_and_load(x, [mt.cpu(), mt.cpu()])
    ref = jutils.split_and_load(x, [mx.cpu(), mx.cpu()])
    assert [g.shape for g in got] == [tuple(r.shape) for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())
        assert g.context == mt.cpu()
    one = tutils.split_and_load(x, [mt.cpu()])
    assert len(one) == 1
    np.testing.assert_array_equal(one[0].asnumpy(), x)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_global_norm(max_norm):
    arrs = _arrays(0, [(4, 5), (7,), (2, 3, 3)])
    jl = [mx.nd.array(a) for a in arrs]
    tl = [mt.nd.array(a, ctx=mt.cpu()) for a in arrs]
    ref = jutils.clip_global_norm(jl, max_norm)
    got = tutils.clip_global_norm(tl, max_norm)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref, rtol=TOL)
    for g, r in zip(tl, jl):
        np.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=TOL,
                                   atol=TOL)
    if max_norm > got:
        for g, a in zip(tl, arrs):
            np.testing.assert_array_equal(g.asnumpy(), a)


def test_clip_global_norm_of_gradients_before_a_step():
    """As a training script calls it: gradients clipped between backward
    and ``Trainer.step``; the weights after the step equal the
    reference's."""
    x = _arrays(1, [(6, 5)])[0]
    w0, b0 = _arrays(2, [(3, 5), (3,)], scale=3.0)
    out = []
    for pkg, ctx in ((mx, {}), (mt, {"ctx": mt.cpu()})):
        net = pkg.gluon.nn.Dense(3, in_units=5)
        net.initialize(**ctx)
        net.weight.set_data(pkg.nd.array(w0, **ctx))
        net.bias.set_data(pkg.nd.array(b0, **ctx))
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        with pkg.autograd.record():
            loss = (net(pkg.nd.array(x, **ctx)) ** 2).sum()
        loss.backward()
        grads = [p.grad() for p in net.collect_params().values()]
        norm = (jutils if pkg is mx else tutils).clip_global_norm(grads, 1.0)
        trainer.step(1)
        out.append((norm, net.weight.data().asnumpy(),
                    net.bias.data().asnumpy()))
    assert out[1][0] > 1.0
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=TOL)
    for g, r in zip(out[1][1:], out[0][1:]):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)


def test_clip_global_norm_warns_on_nan_and_refuses_nothing():
    with pytest.warns(UserWarning, match="nan or inf"):
        tutils.clip_global_norm(
            [mt.nd.array(np.array([np.nan, 1.0]), ctx=mt.cpu())], 1.0)
    with pytest.raises(MXNetError, match="must not be empty"):
        tutils.clip_global_norm([], 1.0)


def test_check_sha1_and_download(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"mxtpu" * 1000)
    digest = hashlib.sha1(b"mxtpu" * 1000).hexdigest()
    assert tutils.check_sha1(str(f), digest)
    assert tutils.check_sha1(str(f), digest) == jutils.check_sha1(str(f),
                                                                  digest)
    assert not tutils.check_sha1(str(f), "0" * 40)
    with pytest.raises(MXNetError, match="network"):
        tutils.download("http://example.invalid/x.params")
