"""ROADMAP A10.2's draws against the JAX package: the registry samplers of
``ops/random_ops.py``, ``mx.nd.random`` (the reference's whole
``__all__``) and ``mx.sym.random``, on the CPU.

torch's generators and JAX's keys give different streams from one seed
(ROADMAP §C, a deliberate difference), so each draw is held by
its shape and dtype against the reference's, by its support, and by its
sample mean and variance against the analytic ones: the mean within 5
standard errors of 2^16 draws, the variance within 5 of its own (from the
sample's fourth moment). ``multinomial``'s frequencies are held per
category the same way and its log-probabilities exactly;
``_sample_unique_zipfian``, whose rejection loop is the same numpy code in
both packages, by distinct ids in range and by the mean of its first
sample against the reference's. A captured ``mx.sym`` graph that draws
(through the CPU stand-in of a CUDA graph that registers the generator)
draws afresh on every replay.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import graphs
from mxtpu_torch.base import MXNetError

CPU = mt.cpu()
N = 1 << 16


def _moments(x, mean, var, k=5.0):
    """Sample mean and variance of ``x`` against the analytic ones."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    m, v = x.mean(), x.var()
    assert abs(m - mean) < k * np.sqrt(var / n), (m, mean)
    m4 = ((x - m) ** 4).mean()
    se_v = np.sqrt(max(m4 - v * v, 1e-12) / n)
    assert abs(v - var) < k * se_v + 1e-6, (v, var)


def _dtype_name(d):
    return np.dtype(d).name


# (registry name, kwargs, analytic mean, analytic variance, support check)
DRAWS = [
    ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12,
     lambda x: (x >= -1).all() and (x < 3).all()),
    ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25, None),
    ("_random_gamma", dict(alpha=2.5, beta=1.5), 3.75, 2.5 * 1.5 ** 2,
     lambda x: (x > 0).all()),
    ("exponential", dict(lam=0.5), 2.0, 4.0, lambda x: (x >= 0).all()),
    ("poisson", dict(lam=3.5), 3.5, 3.5,
     lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    ("negative_binomial", dict(k=3, p=0.4), 4.5, 3 * 0.6 / 0.16,
     lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0, 4.0,
     lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    ("randint", dict(low=-3, high=7), 1.5, (10 ** 2 - 1) / 12,
     lambda x: (x >= -3).all() and (x < 7).all()),
]


@pytest.mark.parametrize("name,kw,mean,var,support", DRAWS,
                         ids=[d[0] for d in DRAWS])
def test_draw_moments_shape_and_dtype_are_the_references(name, kw, mean,
                                                         var, support):
    ref = getattr(mx.nd, name)(shape=(N,), **kw)
    mt.random.seed(3)
    got = getattr(mt.nd, name)(shape=(N,), ctx=CPU, **kw)
    assert got.shape == ref.shape and got.context == torch.device("cpu")
    assert _dtype_name(got.dtype) == _dtype_name(ref.dtype)
    x = got.asnumpy()
    if support is not None:
        assert support(x)
    _moments(x, mean, var)
    mt.random.seed(3)
    again = getattr(mt.nd, name)(shape=(N,), ctx=CPU, **kw)
    np.testing.assert_array_equal(again.asnumpy(), x)   # one seed, one stream


def test_draws_broadcast_array_parameters():
    """Parameters given as arrays broadcast together and ``shape`` is
    appended: one sample set per parameter element, as the reference's
    multisample ops."""
    lam = mt.nd.array(np.array([1.0, 20.0], np.float32), ctx=CPU)
    p = mt.nd.poisson(lam=lam, shape=(N // 4,))
    assert p.shape == (2, N // 4)
    _moments(p.asnumpy()[1], 20.0, 20.0)
    a = mt.nd.array(np.array([[1.0], [4.0]], np.float32), ctx=CPU)
    b = mt.nd.array(np.array([0.5, 2.0, 1.0], np.float32), ctx=CPU)
    g = mt.nd.random.gamma(a, b, shape=(N // 8,))
    assert g.shape == (2, 3, N // 8)
    _moments(g.asnumpy()[1, 1], 8.0, 16.0)
    k = mt.nd.array(np.array([2.0, 5.0], np.float32), ctx=CPU)
    nb = mt.nd.negative_binomial(k=k, p=0.5, shape=(N // 4,))
    _moments(nb.asnumpy()[1], 5.0, 10.0)


def test_nd_random_namespace_is_the_references():
    """``mx.nd.random``'s whole ``__all__``, each name a registry op (the
    reference's aliases) but ``randn`` and ``exponential``, which take
    ``*shape`` and the mean."""
    assert mt.nd.random.__all__ == mx.nd.random.__all__
    reg = mt.ops.registry.REGISTRY
    for name, op in (("uniform", "uniform"), ("normal", "normal"),
                     ("gamma", "_random_gamma"), ("poisson", "poisson"),
                     ("negative_binomial", "negative_binomial"),
                     ("generalized_negative_binomial",
                      "generalized_negative_binomial"),
                     ("multinomial", "multinomial"), ("shuffle", "shuffle"),
                     ("randint", "randint")):
        assert getattr(mt.nd.random, name) is reg[op].wrapper, name
    e = mt.nd.random.exponential(scale=3.0, shape=(N,), ctx=CPU)
    _moments(e.asnumpy(), 3.0, 9.0)
    with CPU:
        r = mt.nd.random.randn(4, 5, loc=1.0)
    assert r.shape == mx.nd.random.randn(4, 5, loc=1.0).shape
    for alias in ("_random_uniform", "random_normal", "randn",
                  "sample_gamma", "_sample_gamma", "_random_exponential",
                  "_random_poisson", "_random_negative_binomial",
                  "_random_generalized_negative_binomial", "_random_randint",
                  "_sample_multinomial", "_shuffle"):
        assert reg[alias].name == mx.ops.registry.REGISTRY[alias].name
    for name in ("uniform", "normal", "gamma", "exponential", "poisson",
                 "negative_binomial", "generalized_negative_binomial",
                 "multinomial", "randint", "shuffle", "randn"):
        assert callable(getattr(mt.sym.random, name)), name


def test_creation_draws_land_on_the_current_context(monkeypatch):
    with CPU:
        assert mt.nd.normal(shape=(2,)).context == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.random.uniform(shape=(2,))


def test_multinomial_frequencies_and_log_probabilities():
    p = np.array([[0.1, 0.2, 0.3, 0.4, 0.0],
                  [5.0, 1.0, 1.0, 1.0, 2.0]], np.float32)
    mt.random.seed(4)
    ids, lp = mt.nd.random.multinomial(mt.nd.array(p, ctx=CPU),
                                       shape=(N // 4,), get_prob=True)
    assert ids.shape == lp.shape == (2, N // 4)
    assert _dtype_name(ids.dtype) == "int32"
    norm = p / p.sum(1, keepdims=True)
    x = ids.asnumpy()
    for row in range(2):
        for c in range(5):
            f = (x[row] == c).mean()
            se = np.sqrt(norm[row, c] * (1 - norm[row, c]) / x.shape[1])
            assert abs(f - norm[row, c]) < 5 * se + 1e-9, (row, c, f)
    want = np.log(np.maximum(norm, 1e-30))[np.arange(2)[:, None], x]
    np.testing.assert_allclose(lp.asnumpy(), want, rtol=1e-5, atol=1e-6)
    # the reference's shapes: one id a row, and a 1-D distribution
    ref_ids, ref_lp = mx.nd.random.multinomial(mx.nd.array(p),
                                               get_prob=True)
    got_ids, got_lp = mt.nd.random.multinomial(mt.nd.array(p, ctx=CPU),
                                               get_prob=True)
    assert got_ids.shape == ref_ids.shape and got_lp.shape == ref_lp.shape
    assert _dtype_name(got_ids.dtype) == _dtype_name(ref_ids.dtype)
    one = mt.nd.random.multinomial(mt.nd.array(p[0], ctx=CPU), shape=7)
    assert one.shape == mx.nd.random.multinomial(mx.nd.array(p[0]),
                                                 shape=7).shape


def test_shuffle_and_like_draws():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    s = mt.nd.random.shuffle(mt.nd.array(x, ctx=CPU)).asnumpy()
    ref = mx.nd.random.shuffle(mx.nd.array(x))
    assert s.shape == ref.shape
    assert sorted(map(tuple, s)) == sorted(map(tuple, x))
    assert not np.array_equal(s, x)
    base = mt.nd.zeros((N // 2, 2), ctx=CPU, dtype="float16")
    u = mt.nd.uniform_like(base, low=2.0, high=4.0)
    z = mt.nd.normal_like(base, loc=-1.0, scale=2.0)
    for got, name in ((u, "uniform_like"), (z, "normal_like")):
        ref = getattr(mx.nd, name)(mx.nd.zeros((N // 2, 2),
                                               dtype="float16"))
        assert got.shape == ref.shape
        assert _dtype_name(got.dtype) == _dtype_name(ref.dtype) == "float16"
    _moments(u.asnumpy(), 3.0, 4 / 12, k=6)
    _moments(z.asnumpy(), -1.0, 4.0, k=6)


def test_unique_zipfian_is_the_references_host_loop():
    ids, tries = mt.nd._sample_unique_zipfian(1000, shape=(3, 50), ctx=CPU)
    rids, rtries = mx.nd._sample_unique_zipfian(1000, shape=(3, 50))
    assert ids.shape == rids.shape and tries.shape == rtries.shape
    assert _dtype_name(ids.dtype) == _dtype_name(rids.dtype) == "int32"
    x = ids.asnumpy()
    assert ((x >= 0) & (x < 1000)).all()
    assert all(len(set(row)) == 50 for row in x)
    assert (tries.asnumpy() >= 50).all()
    first, _ = mt.nd._sample_unique_zipfian(1000, shape=(4000, 1), ctx=CPU)
    rfirst, _ = mx.nd._sample_unique_zipfian(1000, shape=(4000, 1))
    a, b = first.asnumpy().ravel(), rfirst.asnumpy().ravel()
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 5 * se
    with pytest.raises(ValueError, match="unique samples"):
        mt.nd._sample_unique_zipfian(10, shape=(1, 11), ctx=CPU)


def test_zipfian_raises_inside_a_capture():
    """``_sample_unique_zipfian`` is a host loop: it refuses a graph
    capture, naming itself."""
    graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
    try:
        with pytest.raises(MXNetError, match="_sample_unique_zipfian"):
            mt.ops.random_ops._sample_unique_zipfian(10, shape=(1, 2),
                                                     ctx=CPU)
    finally:
        graphs._STATE.depth -= 1


class _DrawingGraph:
    """A CPU stand-in for ``graphs.CapturedGraph`` that, like the real
    one, lets ``fn`` draw only from the generators the graph registered;
    each replay runs ``fn`` again (a real replay draws afresh from the
    registered generator's offset)."""

    made = []

    def __init__(self, fn, static_inputs, pool=None, device=None,
                 generators=()):
        self._fn, self.static_inputs = fn, list(static_inputs)
        self._gens = {id(g) for g in generators}
        self.outputs = [o.detach().clone() for o in self._run()]
        _DrawingGraph.made.append(self)

    def _run(self):
        st = graphs._STATE
        prev = getattr(st, "generators", ())
        st.depth = getattr(st, "depth", 0) + 1
        st.generators = set(prev) | self._gens
        try:
            return self._fn(*self.static_inputs)
        finally:
            st.generators = prev
            st.depth -= 1

    def replay(self):
        with torch.no_grad():
            for static, o in zip(self.outputs, self._run()):
                static.copy_(o)
        return self.outputs


def _vae(pkg):
    s = pkg.sym
    mu, logvar = s.var("mu"), s.var("logvar")
    return mu + s.exp(0.5 * logvar) * s.normal_like(mu)


def test_drawing_symbol_replays_afresh(monkeypatch):
    """A VAE's reparameterisation ``mu + exp(logvar / 2) * normal_like(mu)``
    bound through the Executor's captured path: the graph registers the
    generator (``normal_like`` is among the drawing ops), two replays draw
    differently, and the draws have the right moments. ``infer_shape``
    runs the drawing node on meta tensors."""
    monkeypatch.setattr(graphs, "CapturedGraph", _DrawingGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    _DrawingGraph.made = []
    sym = _vae(mt)
    assert sym.infer_shape(mu=(64, 512), logvar=(64, 512))[1] == \
        _vae(mx).infer_shape(mu=(64, 512), logvar=(64, 512))[1]
    mu = np.full((256, 256), 1.5, np.float32)
    lv = np.full((256, 256), np.log(0.25), np.float32)
    exe = sym.bind(CPU, args={"mu": mt.nd.array(mu, ctx=CPU),
                              "logvar": mt.nd.array(lv, ctx=CPU)},
                   grad_req="null")
    a = exe.forward(is_train=False)[0].asnumpy()
    b = exe.forward(is_train=False)[0].asnumpy()
    assert len(_DrawingGraph.made) == 1
    assert not np.array_equal(a, b)
    for x in (a, b):
        _moments(x, 1.5, 0.25)
    # a number-parameter draw in a graph lands on the graph's device
    n = mt.sym.normal(shape=(3, 4)) + mt.sym.var("y")
    out = n.eval(y=mt.nd.zeros((3, 4), ctx=CPU))[0]
    assert out.context == torch.device("cpu") and out.shape == (3, 4)
