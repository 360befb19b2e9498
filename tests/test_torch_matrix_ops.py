"""ROADMAP A10.1 against the JAX package: the dense shape, indexing and
ordering ops of ``ops/matrix.py``, the nn ops ``softmin``,
``SoftmaxActivation``, ``UpSampling``, ``LRN`` and the three regression
heads, and ``arange_like``, each fed the same seeded numpy inputs in
``mxtpu.nd`` and in ``mxtpu_torch.nd`` on the CPU.

Tolerances: indexing, ordering, one-hot and ravel ops exactly, ties
included, with the dtypes equal; elementwise ops, ``LRN`` and
``UpSampling`` (bilinear: ``F.interpolate`` with half-pixel centres
against ``jax.image.resize``) within 1e-6 relative (atol 1e-7 where a
value can be 0); gradients and a ``Module``'s parameters after three SGD
steps within 1e-5. Scatter tests use unique ids: duplicates are
unspecified in both packages. Every trap of an id out of range is held:
``take``'s three modes, ``gather_nd`` (clamps), the scatters and
``index_copy`` (drop), ``one_hot`` (a row of ``off_value``).
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt

CPU = mt.cpu()
EW = dict(rtol=1e-6, atol=1e-7)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _dtype_name(d):
    return "bfloat16" if d == torch.bfloat16 else np.dtype(d).name


def _same(got, ref, tol=None):
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, tol)
        return
    assert isinstance(got, mt.nd.NDArray)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert _dtype_name(got.dtype) == _dtype_name(ref.dtype)
    if tol is None:
        np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    else:
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **tol)


def _run(name, arrays, kw, tol=None):
    """``name`` on the same arrays in both packages."""
    ref = getattr(mx.nd, name)(*[mx.nd.array(a) for a in arrays], **kw)
    got = getattr(mt.nd, name)(*[mt.nd.array(a, ctx=CPU) for a in arrays],
                               **kw)
    _same(got, ref, tol)
    return got


def _f(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _ties(seed=1):
    """Rows of small integers as float32: many ties, both signs."""
    return _rng(seed).randint(-3, 4, (4, 9)).astype(np.float32)


_IDX = np.array([[0, 5, -1, 2], [-7, 3, 9, -4]], np.float32)   # size 4 or 5

CASES = [
    ("slice_like", [_f(4, 5, 6), _f(2, 3, 6)], {}),
    ("slice_like", [_f(4, 5, 6), _f(2, 3, 4)], dict(axes=(0, 2))),
    ("depth_to_space", [_f(2, 8, 3, 4)], dict(block_size=2)),
    ("space_to_depth", [_f(2, 2, 6, 8)], dict(block_size=2)),
    ("diag", [_f(5)], {}),
    ("diag", [_f(5)], dict(k=2)),
    ("diag", [_f(4, 6)], dict(k=-1)),
    ("diag", [_f(2, 4, 5)], dict(k=1)),
    ("shape_array", [_f(3, 4, 5)], {}),
    ("size_array", [_f(3, 4, 5)], {}),
    ("take", [_f(5, 3), _IDX], {}),
    ("take", [_f(5, 3), _IDX], dict(mode="wrap")),
    ("take", [_f(5, 3), _IDX], dict(mode="raise")),
    ("take", [_f(2, 4, 3), _IDX], dict(axis=1, mode="fill")),
    ("take", [np.arange(4, dtype=np.int32), _IDX], dict(mode="raise")),
    ("batch_take", [_f(4, 5), np.array([0, 4, 7, -2], np.float32)], {}),
    ("gather_nd", [np.arange(6, dtype=np.float32).reshape(2, 3),
                   np.array([[5, 0, 1, -2], [-1, 2, 7, 0]], np.float32)],
     {}),
    ("gather_nd", [_f(3, 4, 2), np.array([[0, 2, -1], [1, 3, 2]],
                                         np.float32)], {}),
    ("scatter_nd", [np.array([7, 8, 9, 10], np.float32),
                    np.array([[5, 1, -1, -4]], np.float32)],
     dict(shape=(3,))),
    ("scatter_nd", [_f(4, 2), np.array([[0, 2, 1, 9], [1, 0, -1, 0]],
                                       np.float32)],
     dict(shape=(3, 2, 2))),
    ("_scatter_set_nd", [_f(3, 4), np.array([[0, 2, 5], [1, -1, 0]],
                                            np.float32), _f(3, seed=2)],
     dict(shape=(3, 4))),
    ("one_hot", [np.array([0, 3, 5, -1, 2.7, 4], np.float32)],
     dict(depth=5)),
    ("one_hot", [np.array([[1, 7], [-3, 0]], np.float32)],
     dict(depth=4, on_value=2.5, off_value=-0.5)),
    ("one_hot", [np.array([1, 9, 0], np.float32)],
     dict(depth=3, dtype="int32")),
    ("index_copy", [_f(5, 3), np.array([4, 0, 9], np.float32),
                    _f(3, 3, seed=3)], {}),
    ("_contrib_index_copy", [_f(4, 2), np.array([-1, 1], np.float32),
                             _f(2, 2, seed=4)], {}),
    ("sort", [_ties()], {}),
    ("sort", [_ties()], dict(is_ascend=False)),
    ("sort", [_ties()], dict(axis=0, is_ascend=False)),
    ("argsort", [_ties()], {}),
    ("argsort", [_ties()], dict(is_ascend=False)),
    ("argsort", [_ties()], dict(axis=0, dtype="int32")),
    ("topk", [np.array([1, 1, .5, 1], np.float32)], dict(k=2)),
    ("topk", [_ties()], dict(k=3)),
    ("topk", [_ties()], dict(k=3, is_ascend=True, ret_typ="value")),
    ("topk", [_ties()], dict(k=2, axis=0, ret_typ="both")),
    ("topk", [_ties()], dict(k=4, ret_typ="mask")),
    ("topk", [_ties()], dict(k=2, axis=0, is_ascend=True, ret_typ="mask")),
    ("khatri_rao", [_f(2, 3), _f(4, 3, seed=5), _f(3, 3, seed=6)], {}),
    ("reshape_like", [_f(2, 6), _f(3, 4)], {}),
    ("reshape_like", [_f(2, 3, 4), _f(6, 5)],
     dict(lhs_begin=0, lhs_end=2, rhs_begin=0, rhs_end=1)),
    ("reshape_like", [_f(2, 12), _f(5, 3, 4)],
     dict(lhs_begin=-1, lhs_end=None, rhs_begin=1, rhs_end=None)),
    ("_ravel_multi_index", [np.array([[1, 0, 2], [3, 4, 0]], np.float32)],
     dict(shape=(3, 5))),
    ("ravel_multi_index", [np.array([[1], [2], [3]], np.float32)],
     dict(shape=(2, 3, 4))),
    ("_unravel_index", [np.array([0, 7, 14, 23], np.float32)],
     dict(shape=(2, 3, 4))),
    ("unravel_index", [np.array([-1, 5], np.float32)], dict(shape=(3, 2))),
    ("arange_like", [_f(3, 4)], {}),
    ("arange_like", [_f(3, 4)], dict(start=0.5, step=0.25, axis=1)),
    ("arange_like", [_f(2, 5)], dict(start=-1.7, step=0.1, repeat=3)),
    ("_contrib_arange_like", [_f(6)], dict(start=2.0)),
]


@pytest.mark.parametrize("name,arrays,kw", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_exact_op_is_the_references(name, arrays, kw):
    with CPU:
        _run(name, arrays, kw)


EW_CASES = [
    ("softmin", [_f(3, 7)], {}),
    ("softmin", [_f(3, 4, 5)], dict(axis=1)),
    ("SoftmaxActivation", [_f(2, 3, 4)], {}),
    ("SoftmaxActivation", [_f(2, 3, 4, 2)], dict(mode="channel")),
    ("UpSampling", [_f(2, 3, 5, 4)], dict(scale=2)),
    ("UpSampling", [_f(2, 3, 5, 4)], dict(scale=3, sample_type="nearest")),
    ("UpSampling", [_f(2, 3, 5, 4)], dict(scale=2, sample_type="bilinear")),
    ("UpSampling", [_f(1, 2, 4, 6), _f(1, 2, 4, 6, seed=1)],
     dict(scale=2, sample_type="bilinear", num_args=2)),
    ("LRN", [_f(2, 7, 4, 3)], {}),
    ("LRN", [np.abs(_f(2, 6, 5, 5)) * 3], dict(nsize=3, alpha=1e-2,
                                               beta=0.5, knorm=1.0)),
]


@pytest.mark.parametrize("name,arrays,kw", EW_CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(EW_CASES)])
def test_elementwise_op_is_the_references(name, arrays, kw):
    _run(name, arrays, kw, EW)


def test_up_sampling_reads_only_the_first_input():
    """The reference's quirk: ``UpSampling`` of two inputs reads
    ``data[0]`` alone."""
    a, b = _f(1, 2, 3, 3), _f(1, 2, 3, 3, seed=9)
    one = mt.nd.UpSampling(mt.nd.array(a, ctx=CPU), scale=2)
    two = mt.nd.UpSampling(mt.nd.array(a, ctx=CPU), mt.nd.array(b, ctx=CPU),
                           scale=2, num_args=2)
    np.testing.assert_array_equal(one.asnumpy(), two.asnumpy())


def test_arange_like_ignores_repeat_and_lands_on_the_context():
    """The reference's quirks: ``repeat`` is ignored, the result is
    float32 whatever the input's type; as a creation op it lands on the
    current context (``cuda:0`` outside a scope, raising without a
    card)."""
    x = mt.nd.array(np.zeros((2, 3), np.int32), ctx=CPU)
    with CPU:
        a = mt.nd.arange_like(x, repeat=4)
    assert a.shape == (2, 3) and a.dtype == np.float32
    assert a.context == torch.device("cpu")
    np.testing.assert_array_equal(a.asnumpy().ravel(), np.arange(6.0))
    assert mt.ops.init_ops.arange_like(x._data, ctx="meta").device.type \
        == "meta"


def test_ndarray_methods_are_the_references():
    x = _ties(3)
    jx, tx = mx.nd.array(x), mt.nd.array(x, ctx=CPU)
    idx = np.array([2, 0, -1], np.float32)
    with CPU:
        _same(tx.topk(k=2, ret_typ="both"), jx.topk(k=2, ret_typ="both"))
        _same(tx.sort(is_ascend=False), jx.sort(is_ascend=False))
        _same(tx.argsort(axis=0), jx.argsort(axis=0))
        _same(tx.diag(k=1), jx.diag(k=1))
        _same(tx.take(mt.nd.array(idx, ctx=CPU)), jx.take(mx.nd.array(idx)))
        _same(tx[0].one_hot(5), jx[0].one_hot(5))
        _same(tx.slice_like(mt.nd.array(x[:2, :3], ctx=CPU)),
              jx.slice_like(mx.nd.array(x[:2, :3])))
        _same(tx.reshape_like(mt.nd.zeros((9, 4), ctx=CPU)),
              jx.reshape_like(mx.nd.zeros((9, 4))))


# -------------------------------------------------------- regression heads
HEADS = ["LinearRegressionOutput", "LogisticRegressionOutput",
         "MAERegressionOutput"]


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("label_shape", [(6, 1), (6,)])
def test_regression_head_gradient_is_the_references(head, label_shape):
    """Forward and the data's gradient through autograd, a (N,) label
    against a (N, 1) prediction included (no (N, N) broadcast); the label's
    gradient is zero. The head's backward ignores the output's cotangent,
    as the reference's does."""
    r = _rng(11)
    d = r.randn(6, 1).astype(np.float32)
    lab = r.rand(*label_shape).astype(np.float32)
    out = {}
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        x, y = pkg.nd.array(d, **kw), pkg.nd.array(lab, **kw)
        x.attach_grad()
        y.attach_grad()
        with pkg.autograd.record():
            p = getattr(pkg.nd, head)(x, y, grad_scale=0.5)
            loss = p * 3.0
        loss.backward()
        out[pkg] = (p.asnumpy(), x.grad.asnumpy(), y.grad.asnumpy())
    for g, w in zip(out[mt], out[mx]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert not out[mt][2].any()
    d2 = r.randn(4, 3).astype(np.float32)
    x = mt.nd.array(d2, ctx=CPU)
    x.attach_grad()
    with mt.autograd.record():
        p = getattr(mt.nd, head)(x, mt.nd.zeros((4, 3), ctx=CPU))
    p.backward()
    assert x.grad.shape == (4, 3)     # divided by 3 outputs a row


def _head_module(pkg, head, steps=3):
    """A 2-layer MLP ending in ``head``, three SGD-momentum steps through
    ``mx.mod.Module`` on seeded weights and batches."""
    from mxtpu.symbol import symbol as jsym
    from mxtpu_torch.symbol import symbol as tsym
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    s = pkg.sym
    h = s.FullyConnected(s.var("data"), num_hidden=8, name="fc1")
    h = s.Activation(h, act_type="tanh")
    h = s.FullyConnected(h, num_hidden=3, name="fc2")
    net = getattr(s, head)(h, name="head")
    kw = {} if pkg is mx else {"context": CPU}
    mod = pkg.mod.Module(net, label_names=("head_label",), **kw)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("head_label", (4, 3))])
    r = _rng(21)
    args = {"fc1_weight": r.randn(8, 5) * 0.5, "fc1_bias": r.randn(8) * 0.1,
            "fc2_weight": r.randn(3, 8) * 0.5, "fc2_bias": r.randn(3) * 0.1}
    ctx = {} if pkg is mx else {"ctx": CPU}
    mod.init_params(arg_params={k: pkg.nd.array(v.astype(np.float32), **ctx)
                                for k, v in args.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    outs = []
    for _ in range(steps):
        x = r.randn(4, 5).astype(np.float32)
        y = r.rand(4, 3).astype(np.float32)
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x, **ctx)],
                                     label=[pkg.nd.array(y, **ctx)]),
                    is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    return outs, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("head", HEADS)
def test_module_fits_through_a_regression_head_like_mxtpu(head):
    ref_outs, ref_params = _head_module(mx, head)
    outs, params = _head_module(mt, head)
    for a, b in zip(outs, ref_outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert sorted(params) == sorted(ref_params)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k], v, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ mx.sym plumbing
def _sym_graph(pkg):
    from mxtpu.symbol import symbol as jsym
    from mxtpu_torch.symbol import symbol as tsym
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    s = pkg.sym
    x, ids = s.var("x"), s.var("ids")
    a = s.LRN(x, nsize=3)
    b = s.UpSampling(a, scale=2, sample_type="nearest")
    c = s.topk(s.reshape(b, shape=(2, -1)), k=3)
    v = s.topk(s.reshape(b, shape=(2, -1)), k=3, ret_typ="value")
    d = s.one_hot(ids, depth=4) + s.take(s.reshape(x, shape=(-1, 4)), ids)
    e = s.sort(s.softmin(d), is_ascend=False)
    return s.Group([v, c, e, s.arange_like(e, axis=1)])


def test_symbol_json_with_the_new_ops_loads_in_both_packages():
    """The same graph built in both packages gives the same JSON text;
    each package loads the other's and evaluates it to the same
    numbers; ``infer_shape`` of the multi-output ops is the reference's."""
    jg, tg = _sym_graph(mx), _sym_graph(mt)
    assert tg.tojson() == jg.tojson()
    x = _f(2, 3, 2, 4)
    ids = np.array([0, 3, 5], np.float32)
    ref = jg.eval(x=mx.nd.array(x), ids=mx.nd.array(ids))
    with CPU:
        got = mt.sym.load_json(jg.tojson()).eval(
            x=mt.nd.array(x, ctx=CPU), ids=mt.nd.array(ids, ctx=CPU))
        back = mx.sym.load_json(tg.tojson()).eval(x=mx.nd.array(x),
                                                  ids=mx.nd.array(ids))
    for g, r, b in zip(got, ref, back):
        _same(g, r, EW)
        np.testing.assert_array_equal(b.asnumpy(), r.asnumpy())
    shapes = dict(x=(2, 3, 2, 4), ids=(3,))
    assert tg.infer_shape(**shapes) == jg.infer_shape(**shapes)
    # the port knows topk's output count before execution (the
    # reference's composes one output and cannot index the second)
    both = mt.sym.topk(mt.sym.var("a"), k=2, ret_typ="both")
    assert len(both.list_outputs()) == 2
    assert both[1].infer_shape(a=(3, 5))[1] == [(3, 2)]
    for op in ("linalg_gelqf", "linalg_syevd", "linalg_slogdet"):
        jv, tv = getattr(mx.sym, op)(mx.sym.var("a")), getattr(mt.sym, op)(
            mt.sym.var("a"))
        assert tv.list_outputs() == jv.list_outputs()
        assert tv.infer_shape(a=(2, 3, 4 if op == "linalg_gelqf" else 3)) \
            == jv.infer_shape(a=(2, 3, 4 if op == "linalg_gelqf" else 3))


def test_executor_captures_the_new_ops(monkeypatch):
    """A graph of the new ops through the Executor's captured path (the
    CPU stand-in for a CUDA graph): the same numbers as the eager path."""
    from mxtpu_torch import graphs
    from test_torch_train_graph import FakeGraph
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    g = _sym_graph(mt)
    x = _f(2, 3, 2, 4)
    ids = np.array([0, 3, 5], np.float32)
    with CPU:
        eager = g.eval(x=mt.nd.array(x, ctx=CPU),
                       ids=mt.nd.array(ids, ctx=CPU))
        exe = g.bind(CPU, args={"x": mt.nd.array(x, ctx=CPU),
                                "ids": mt.nd.array(ids, ctx=CPU)},
                     grad_req="null")
        outs = exe.forward(is_train=False)
        outs = exe.forward(is_train=False)
    assert FakeGraph.made
    for a, b in zip(outs, eager):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_every_registry_name_resolves_like_mxtpu():
    """Each of the reference's registry names (aliases included) whose op
    the port has resolves in ``mx.nd`` and ``mx.sym`` to the same
    canonical op; the 32 ops left are ROADMAP A10.4's."""
    jreg, treg = mx.ops.registry.REGISTRY, mt.ops.registry.REGISTRY
    ported = {op.name for op in treg.values()}
    assert len(ported & {op.name for op in jreg.values()}) == 240
    for name, op in jreg.items():
        if op.name not in ported:
            continue
        assert treg[name].name == op.name, name
        assert callable(getattr(mt.nd, name)), name
        assert callable(getattr(mt.sym, name)), name
        if op.name.startswith("_contrib_"):
            short = name[len("_contrib_"):] if name.startswith(
                "_contrib_") else name
            assert callable(getattr(mt.nd.contrib, short)), name
    assert len({op.name for op in jreg.values()} - ported) == 32
