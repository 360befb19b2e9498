"""Sparse storage (``mxtpu_torch.ndarray.sparse``), its registry ops, lazy
optimizer updates, ``row_sparse_pull``, Gluon's sparse-gradient layers and
dlpack, held to the JAX package on the same seeded inputs.

Tolerances: index results and value gathers bit-equal; elementwise maps
within 1e-6 relative; sums (dot, index_add) within 1e-5 relative of the
result's scale; rows an update does not touch bit-equal to before it.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ndarray import sparse as tsp

EW_TOL = 1e-6
SUM_TOL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    return float(np.abs(got - ref).max()) / scale if ref.size else 0.0


def _close(got, ref, tol):
    assert _rel(got, ref) <= tol, _rel(got, ref)


def _np(a):
    return np.asarray(a.asnumpy())


def _dense(seed=0, shape=(8, 5), rows_zero=(1, 4, 6), cut=-0.3):
    rng = np.random.RandomState(seed)
    d = rng.standard_normal(shape).astype(np.float32)
    d[list(rows_zero)] = 0
    d[d < cut] = 0
    return d


def _pair(d, stype):
    """(the JAX package's, the port's) array of storage ``stype``."""
    with mt.cpu():
        t = mt.nd.array(d).tostype(stype)
    return mx.nd.array(d).tostype(stype), t


def _same_parts(got, ref):
    assert got.stype == ref.stype and got.shape == ref.shape
    names = ("indices", "data") + (("indptr",) if ref.stype == "csr"
                                   else ())
    for n in names:
        g, r = _np(getattr(got, n)), _np(getattr(ref, n))
        assert g.dtype == r.dtype, (n, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r)


# ------------------------------------------------------ storage and casts
@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_both_ways_like_mxtpu(stype):
    d = _dense()
    j, t = _pair(d, stype)
    _same_parts(t, j)
    np.testing.assert_array_equal(t.asnumpy(), d)
    np.testing.assert_array_equal(t.tostype("default").asnumpy(), d)
    assert t.tostype(stype) is t and t.context == torch.device("cpu")
    other = "csr" if stype == "row_sparse" else "row_sparse"
    _same_parts(t.tostype(other), j.tostype(other))
    _same_parts(tsp.cast_storage(t.todense(), stype),
                mx.nd.sparse.cast_storage(j.todense(), stype))


def test_constructors_and_zeros_like_mxtpu():
    vals = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    with mt.cpu():
        t = mt.nd.sparse.row_sparse_array((vals, [1, 4]), shape=(6, 3))
        c = mt.nd.sparse.csr_matrix(
            (np.array([1.0, 2.0, 3.0], np.float32), [0, 3, 1], [0, 2, 3]),
            shape=(2, 4))
        zr = mt.nd.sparse.zeros("row_sparse", (5, 3))
        zc = mt.nd.sparse.zeros("csr", (2, 4))
        zd = mt.nd.sparse.zeros("default", (2, 4))
    _same_parts(t, mx.nd.sparse.row_sparse_array((vals, [1, 4]),
                                                 shape=(6, 3)))
    _same_parts(c, mx.nd.sparse.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32), [0, 3, 1], [0, 2, 3]),
        shape=(2, 4)))
    _same_parts(zr, mx.nd.sparse.zeros("row_sparse", (5, 3)))
    _same_parts(zc, mx.nd.sparse.zeros("csr", (2, 4)))
    assert zd.stype == "default" and zd.shape == (2, 4)
    assert isinstance(t, mt.nd.RowSparseNDArray) and \
        isinstance(c, mt.nd.CSRNDArray)


@pytest.mark.parametrize("key", [0, 3, -1, slice(1, 5), slice(None),
                                 slice(2, 2), slice(0, 7, 2), (2, 3)])
def test_csr_indexing_like_mxtpu(key):
    d = _dense(1, (7, 6))
    j, t = _pair(d, "csr")
    ref = _np(j[key])
    got = t[key]
    assert got.stype == "default"
    np.testing.assert_array_equal(got.asnumpy(), ref)


def test_retain_and_copyto_like_mxtpu():
    d = _dense(2)
    j, t = _pair(d, "row_sparse")
    with mt.cpu():
        keep = mt.nd.array(np.array([0, 2, 3, 7], np.int32))
    _same_parts(t.retain(keep), j.retain(mx.nd.array(
        np.array([0, 2, 3, 7], np.int32))))
    jo, to = _pair(np.zeros_like(d), "row_sparse")
    _same_parts(t.copyto(to), j.copyto(jo))
    with mt.cpu():
        dense_out = mt.nd.zeros(d.shape)
    np.testing.assert_array_equal(t.copyto(dense_out).asnumpy(), d)
    jc, tc = _pair(d, "csr")
    jo, to = _pair(np.zeros_like(d), "csr")
    _same_parts(tc.copyto(to), jc.copyto(jo))


# ------------------------------------------------------------ arithmetic
_SCALAR_OPS = {
    "mul": lambda a: a * 2.5, "rmul": lambda a: 0.5 * a,
    "div": lambda a: a / 4.0, "neg": lambda a: -a, "abs": lambda a: abs(a),
    "pow": lambda a: a ** 2,
}
_FALLBACK_OPS = {
    "add_dense": lambda a, d: a + d, "radd_dense": lambda a, d: d + a,
    "sub_dense": lambda a, d: a - d, "rsub_dense": lambda a, d: d - a,
    "mul_dense": lambda a, d: a * d, "div_dense": lambda a, d: a / (d + 3),
    "rdiv_scalar": lambda a, d: 2.0 / (a + 10.0),
    "pow_zero": lambda a, d: a ** 0, "eq": lambda a, d: a == d,
    "gt": lambda a, d: a > d, "le": lambda a, d: a <= d,
    "add_scalar": lambda a, d: a + 1.0, "mod": lambda a, d: a % 3.0,
}


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
@pytest.mark.parametrize("op", sorted(_SCALAR_OPS))
def test_zero_preserving_maps_keep_the_format(stype, op):
    d = _dense(3)
    j, t = _pair(d, stype)
    got, ref = _SCALAR_OPS[op](t), _SCALAR_OPS[op](j)
    assert got.stype == ref.stype == stype
    _close(got.asnumpy(), _np(ref), EW_TOL)
    np.testing.assert_array_equal(_np(got.indices), _np(ref.indices))


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
@pytest.mark.parametrize("op", sorted(_FALLBACK_OPS))
def test_dense_fallbacks_like_mxtpu(stype, op):
    d = _dense(4)
    other = np.random.RandomState(9).standard_normal(d.shape).astype(
        np.float32)
    j, t = _pair(d, stype)
    with mt.cpu():
        to = mt.nd.array(other)
    got, ref = _FALLBACK_OPS[op](t, to), _FALLBACK_OPS[op](j,
                                                           mx.nd.array(other))
    assert got.stype == ref.stype == "default"
    _close(got.asnumpy(), _np(ref), EW_TOL)


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_same_format_merges_and_in_place_ops(stype):
    a, b = _dense(5), _dense(6, rows_zero=(0, 2))
    ja, ta = _pair(a, stype)
    jb, tb = _pair(b, stype)
    for got, ref in ((ta + tb, ja + jb), (ta - tb, ja - jb)):
        assert got.stype == ref.stype == stype
        _same_parts(got, ref) if stype == "csr" else \
            np.testing.assert_array_equal(_np(got.indices), _np(ref.indices))
        _close(got.asnumpy(), _np(ref), EW_TOL)
    ta += tb
    ja += jb
    ta *= 2.0
    ja *= 2.0
    _close(ta.asnumpy(), _np(ja), EW_TOL)
    with pytest.raises(MXNetError):
        ta *= ta.todense()
    with pytest.raises(MXNetError):
        ta += 1.0


# ------------------------------------------------------------------ dot
@pytest.mark.parametrize("transpose_b", [False, True])
def test_csr_dense_dot_and_its_gradients_like_mxtpu(transpose_b):
    d = _dense(7, (7, 9))
    w = np.random.RandomState(8).standard_normal(
        (3, 9) if transpose_b else (9, 3)).astype(np.float32)
    j, t = _pair(d, "csr")
    with mt.cpu():
        tw = mt.nd.array(w)
    jw = mx.nd.array(w)
    for arr in (t, tw, j, jw):
        arr.attach_grad()
    with mt.autograd.record():
        out = mt.nd.sparse.dot(t, tw, transpose_b=transpose_b)
        loss = (out * out).sum()
    loss.backward()
    with mx.autograd.record():
        ref = mx.nd.sparse.dot(j, jw, transpose_b=transpose_b)
        jloss = (ref * ref).sum()
    jloss.backward()
    _close(out.asnumpy(), _np(ref), SUM_TOL)
    _close(tw.grad.asnumpy(), _np(jw.grad), SUM_TOL)
    assert t.grad.stype == "csr" and t.grad._data.shape == t._data.shape
    _close(t.grad.data.asnumpy(), _np(j.grad.data), SUM_TOL)


@pytest.mark.parametrize("case", ["rsp_lhs", "csr_transpose_a", "dense"])
def test_dot_fallbacks_like_mxtpu(case):
    d = _dense(10, (7, 4))
    w = np.random.RandomState(11).standard_normal((7, 3) if case ==
                                                  "csr_transpose_a"
                                                  else (4, 3)).astype(
        np.float32)
    stype = {"rsp_lhs": "row_sparse", "csr_transpose_a": "csr",
             "dense": "default"}[case]
    j, t = _pair(d, stype)
    with mt.cpu():
        tw = mt.nd.array(w)
    kw = {"transpose_a": case == "csr_transpose_a"}
    _close(mt.nd.sparse.dot(t, tw, **kw).asnumpy(),
           _np(mx.nd.sparse.dot(j, mx.nd.array(w), **kw)), SUM_TOL)


def test_dot_at_a_million_features_never_densifies(monkeypatch):
    """A 64-row batch over 1,000,001 features: dot never builds the (64,
    F) matrix (todense and cast_storage raise)."""
    rng = np.random.RandomState(12)
    f, b, per = 1_000_001, 64, 15
    idx = np.concatenate([np.sort(rng.choice(f, per, replace=False))
                          for _ in range(b)]).astype(np.int32)
    vals = rng.standard_normal(b * per).astype(np.float32)
    indptr = np.arange(0, b * per + 1, per, dtype=np.int32)
    w = (rng.standard_normal((f, 2)) * 0.01).astype(np.float32)
    ref = _np(mx.nd.sparse.dot(
        mx.nd.sparse.csr_matrix((vals, idx, indptr), shape=(b, f)),
        mx.nd.array(w)))

    def refuse(*a, **k):
        raise AssertionError("a dense (B, F) matrix was built")
    monkeypatch.setattr(tsp.CSRNDArray, "todense", refuse)
    monkeypatch.setattr(tsp.RowSparseNDArray, "todense", refuse)
    monkeypatch.setattr(tsp, "cast_storage", refuse)
    with mt.cpu():
        csr = mt.nd.sparse.csr_matrix((vals, idx, indptr), shape=(b, f))
        got = mt.nd.sparse.dot(csr, mt.nd.array(w))
    _close(got.asnumpy(), ref, SUM_TOL)


# --------------------------------------------------------- registry ops
def test_getnnz_and_sparse_embedding_ops_like_mxtpu():
    d = _dense(13)
    with mt.cpu():
        td = mt.nd.array(d)
    for axis in (None, 0, 1):
        got = mt.nd.contrib.getnnz(td, axis=axis)
        ref = mx.nd.contrib.getnnz(mx.nd.array(d), axis=axis)
        assert str(got.dtype) == str(ref.dtype) == "int32"
        np.testing.assert_array_equal(got.asnumpy(), _np(ref))
    w = np.random.RandomState(14).standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[1, 9, 3], [0, 12, -1]], np.float32)
    with mt.cpu():
        got = mt.nd.contrib.SparseEmbedding(mt.nd.array(ids), mt.nd.array(w),
                                            input_dim=10, output_dim=4)
    ref = mx.nd.contrib.SparseEmbedding(mx.nd.array(ids), mx.nd.array(w),
                                        input_dim=10, output_dim=4)
    np.testing.assert_array_equal(got.asnumpy(), _np(ref))


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
@pytest.mark.parametrize("axis,keepdims", [(1, True), (1, False), (0, False),
                                           (0, True), (None, False)])
def test_square_sum_like_mxtpu(stype, axis, keepdims):
    d = _dense(15)
    j, t = _pair(d, stype)
    got = mt.nd._internal._square_sum(t, axis=axis, keepdims=keepdims)
    ref = mx.nd._internal._square_sum(j, axis=axis, keepdims=keepdims)
    assert got.stype == ref.stype
    if ref.stype == "row_sparse":
        np.testing.assert_array_equal(_np(got.indices), _np(ref.indices))
    _close(got.asnumpy(), _np(ref), SUM_TOL)


@pytest.mark.parametrize("stype", ["row_sparse", "csr", "default"])
def test_scatter_ops_like_mxtpu(stype):
    d = _dense(16)
    rhs = np.random.RandomState(17).uniform(1, 2, d.shape).astype(np.float32)
    j, t = _pair(d, stype)
    with mt.cpu():
        trhs = mt.nd.array(rhs)
    cases = [
        (mt.nd._internal._scatter_plus_scalar(t, scalar=1.5),
         mx.nd._internal._scatter_plus_scalar(j, scalar=1.5)),
        (mt.nd._internal._scatter_minus_scalar(t, scalar=0.5),
         mx.nd._internal._scatter_minus_scalar(j, scalar=0.5)),
        (mt.nd._internal._scatter_elemwise_div(t, trhs),
         mx.nd._internal._scatter_elemwise_div(j, mx.nd.array(rhs)))]
    for got, ref in cases:
        assert got.stype == ref.stype
        _close(got.asnumpy(), _np(ref), EW_TOL)
    jo, to = _pair(np.zeros_like(d), stype)
    got = mt.nd._internal._scatter_plus_scalar(t, scalar=2.0, out=to)
    mx.nd._internal._scatter_plus_scalar(j, scalar=2.0, out=jo)
    assert got is to
    _close(to.asnumpy(), _np(jo), EW_TOL)


# ------------------------------------------------------- lazy optimizers
_LAZY = [("sgd", {"learning_rate": 0.1, "wd": 0.01}),
         ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
                  "clip_gradient": 0.5}),
         ("adam", {"learning_rate": 0.05, "wd": 0.01}),
         ("adagrad", {"learning_rate": 0.1}),
         ("groupadagrad", {"learning_rate": 0.1})]


def _rsp_grad(pkg, rng, rows, shape, ctx=None):
    vals = rng.standard_normal((len(rows),) + shape[1:]).astype(np.float32)
    rows = np.asarray(rows, np.int32)
    if ctx is None:
        return pkg.nd.sparse.RowSparseNDArray(mx.nd.array(vals),
                                              mx.nd.array(rows), shape)
    with ctx:
        return pkg.nd.sparse.RowSparseNDArray(pkg.nd.array(vals),
                                              pkg.nd.array(rows), shape)


def _leaves(st):
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [x for s in st for x in _leaves(s)]
    return [st]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name,kw", _LAZY, ids=["sgd", "sgd_mom", "adam",
                                                 "adagrad", "groupadagrad"])
def test_lazy_updates_move_only_the_gradients_rows(name, kw, fused):
    shape = (12, 3)
    w0 = np.random.RandomState(18).standard_normal(shape).astype(np.float32)
    steps = [[1, 4, 7], [0, 4, 11]]
    with mt.cpu():
        tw = mt.nd.array(w0)
    jw = mx.nd.array(w0)
    tu = (mt.optimizer.get_updater if fused else mt.optimizer.Updater)(
        mt.optimizer.create(name, **kw))
    ju = mx.optimizer.Updater(mx.optimizer.create(name, **kw))
    for s, rows in enumerate(steps):
        before_w = tw.asnumpy()
        before_st = [x.asnumpy() for x in _leaves(tu.states.get(0))]
        gt = _rsp_grad(mt, np.random.RandomState(20 + s), rows, shape,
                       mt.cpu())
        gj = _rsp_grad(mx, np.random.RandomState(20 + s), rows, shape)
        if fused:
            tu.update_batch([0], [gt], [tw])
        else:
            tu(0, gt, tw)
        ju(0, gj, jw)
        _close(tw.asnumpy(), _np(jw), SUM_TOL)
        for a, b in zip(_leaves(tu.states[0]), _leaves(ju.states[0])):
            _close(a.asnumpy(), _np(b), SUM_TOL)
        rest = np.setdiff1d(np.arange(shape[0]), rows)
        np.testing.assert_array_equal(tw.asnumpy()[rest], before_w[rest])
        for a, b in zip(_leaves(tu.states[0]), before_st):
            np.testing.assert_array_equal(a.asnumpy()[rest], b[rest])


# ------------------------------------------------------- row_sparse_pull
def test_row_sparse_pull_into_both_kinds_of_out_like_mxtpu():
    w = np.random.RandomState(21).standard_normal((10, 3)).astype(np.float32)
    rows = np.array([2, 5, 9], np.int32)
    jkv, tkv = mx.kv.create("local"), mt.kv.create("local")
    jkv.init("w", mx.nd.array(w))
    with mt.cpu():
        tkv.init("w", mt.nd.array(w))
        t_rsp = mt.nd.sparse.zeros("row_sparse", (10, 3))
        t_dense = mt.nd.array(np.full((10, 3), 7.0, np.float32))
        t_rows = mt.nd.array(rows)
    j_rsp = mx.nd.sparse.zeros("row_sparse", (10, 3))
    j_dense = mx.nd.array(np.full((10, 3), 7.0, np.float32))
    tkv.row_sparse_pull("w", out=t_rsp, row_ids=t_rows)
    jkv.row_sparse_pull("w", out=j_rsp, row_ids=mx.nd.array(rows))
    _same_parts(t_rsp, j_rsp)
    tkv.row_sparse_pull("w", out=t_dense, row_ids=t_rows)
    jkv.row_sparse_pull("w", out=j_dense, row_ids=mx.nd.array(rows))
    np.testing.assert_array_equal(t_dense.asnumpy(), _np(j_dense))
    with pytest.raises(MXNetError):
        tkv.row_sparse_pull("w", out=t_dense)


# ----------------------------------------- the sparse linear classifier
def _classifier_batches(features, batch, per, steps, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        idx = np.concatenate([np.sort(rng.choice(features, per,
                                                 replace=False))
                              for _ in range(batch)]).astype(np.int32)
        vals = rng.standard_normal(batch * per).astype(np.float32)
        indptr = np.arange(0, batch * per + 1, per, dtype=np.int32)
        y = rng.randint(0, 2, batch).astype(np.float32)
        out.append((vals, idx, indptr, y))
    return out


def _classifier(pkg, features, batches, ctx=None):
    """The flow of the sparse linear classification example: forward
    ``sparse.dot(csr, weight) + bias``, the weight's gradient gathered at
    the batch's unique ids into a row-sparse gradient, lazy Adam, a push
    and ``row_sparse_pull`` on a local store. Returns per step (loss, the
    weight, the Adam states, the unique ids)."""
    import contextlib
    scope = ctx if ctx is not None else contextlib.nullcontext()
    rng = np.random.RandomState(1)
    w0 = rng.normal(0, 0.01, (features, 2)).astype(np.float32)
    with scope:
        weight, bias = pkg.nd.array(w0), pkg.nd.zeros((2,))
        kv = pkg.kv.create("local")
        kv.init("weight", weight)
    updater = pkg.optimizer.get_updater(
        pkg.optimizer.create("adam", learning_rate=0.05, lazy_update=True))
    bias_updater = pkg.optimizer.get_updater(
        pkg.optimizer.create("adam", learning_rate=0.05))
    weight.attach_grad()
    bias.attach_grad()
    out = []
    for vals, idx, indptr, y in batches:
        with scope:
            csr = pkg.nd.sparse.csr_matrix((vals, idx, indptr),
                                           shape=(len(y), features))
            label = pkg.nd.array(y)
            uniq = pkg.nd.array(np.unique(idx).astype(np.int32))
        with pkg.autograd.record():
            logits = pkg.nd.sparse.dot(csr, weight) + bias
            loss = -pkg.nd.pick(pkg.nd.log_softmax(logits), label).mean()
        loss.backward()
        grad = pkg.nd.sparse.RowSparseNDArray(
            pkg.nd.take(weight.grad, uniq), uniq, weight.shape)
        updater(0, grad, weight)
        bias_updater(1, bias.grad, bias)
        kv.push("weight", weight)
        kv.row_sparse_pull("weight", out=weight, row_ids=csr.indices)
        out.append((float(loss.asnumpy()), _np(weight),
                    [_np(s) for s in updater.states[0]], np.unique(idx)))
    return out


def test_sparse_linear_classifier_three_steps_like_mxtpu(monkeypatch):
    features = 10_000
    batches = _classifier_batches(features, 64, 15, 3, seed=22)
    ref = _classifier(mx, features, batches)

    def refuse(*a, **k):
        raise AssertionError("a dense (B, F) matrix was built")
    monkeypatch.setattr(tsp.CSRNDArray, "todense", refuse)
    monkeypatch.setattr(tsp, "cast_storage", refuse)
    got = _classifier(mt, features, batches, mt.cpu())
    w0 = np.random.RandomState(1).normal(0, 0.01, (features, 2)).astype(
        np.float32)
    prev_w, prev_st = w0, [np.zeros_like(w0), np.zeros_like(w0)]
    for (gl, gw, gst, uniq), (rl, rw, rst, _) in zip(got, ref):
        assert abs(gl - rl) <= SUM_TOL * abs(rl)
        _close(gw[uniq], rw[uniq], SUM_TOL)
        for a, b in zip(gst, rst):
            _close(a[uniq], b[uniq], SUM_TOL)
        rest = np.setdiff1d(np.arange(features), uniq)
        np.testing.assert_array_equal(gw[rest], prev_w[rest])
        for a, b in zip(gst, prev_st):
            np.testing.assert_array_equal(a[rest], b[rest])
        prev_w, prev_st = gw, gst


# ------------------------------------------------------------------ gluon
def test_parameter_stypes_and_row_sparse_data_like_mxtpu():
    w = np.random.RandomState(23).standard_normal((6, 2)).astype(np.float32)
    jp = mx.gluon.Parameter("w", shape=(6, 2), grad_stype="row_sparse",
                            stype="default")
    jp.initialize()
    jp.set_data(mx.nd.array(w))
    with mt.cpu():
        tp = mt.gluon.Parameter("w", shape=(6, 2), grad_stype="row_sparse",
                                stype="default")
        tp.initialize(ctx=mt.cpu())
        tp.set_data(mt.nd.array(w))
        rows = mt.nd.array(np.array([4, 1], np.int32))
    assert (tp._stype, tp._grad_stype) == (jp._stype, jp._grad_stype)
    _same_parts(tp.row_sparse_data(rows), jp.row_sparse_data(
        mx.nd.array(np.array([4, 1], np.int32))))


@pytest.mark.parametrize("block", ["embedding", "sparse_embedding"])
def test_sparse_grad_embeddings_train_like_mxtpu(block):
    """Their gradient is dense in both packages; two Adam steps agree."""
    w = np.random.RandomState(24).standard_normal((30, 4)).astype(np.float32)
    ids = np.random.RandomState(25).randint(0, 30, (3, 5)).astype(np.float32)

    def make(pkg):
        if block == "embedding":
            net = pkg.gluon.nn.Embedding(30, 4, sparse_grad=True)
        else:
            net = pkg.gluon.contrib.nn.SparseEmbedding(30, 4)
        return net
    jn, tn = make(mx), make(mt)
    assert tn.weight._grad_stype == jn.weight._grad_stype == "row_sparse"
    assert repr(tn) == repr(jn)
    jn.initialize()
    jn.weight.set_data(mx.nd.array(w))
    tn.initialize(ctx=mt.cpu())
    with mt.cpu():
        tn.weight.set_data(mt.nd.array(w))
    jt = mx.gluon.Trainer(jn.collect_params(), "adam", {"learning_rate": 0.1})
    tt = mt.gluon.Trainer(tn.collect_params(), "adam", {"learning_rate": 0.1})
    for _ in range(2):
        with mx.autograd.record():
            jl = (jn(mx.nd.array(ids)) ** 2).sum()
        jl.backward()
        jt.step(1)
        with mt.cpu(), mt.autograd.record():
            tl = (tn(mt.nd.array(ids)) ** 2).sum()
        tl.backward()
        assert tn.weight.grad().stype == "default"
        tt.step(1)
        _close(tn.weight.data().asnumpy(), _np(jn.weight.data()), SUM_TOL)


# ------------------------------------------------------------------ dlpack
def test_dlpack_shares_memory_and_interchanges_with_mxtpu():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with mt.cpu():
        t = mt.nd.array(x)
        n = mt.nd.from_numpy(x)
    np.testing.assert_array_equal(n.asnumpy(), _np(mx.nd.from_numpy(x)))
    r = mt.nd.from_dlpack(t.to_dlpack_for_read())
    assert r._data.data_ptr() == t._data.data_ptr()
    w = mt.nd.from_dlpack(mt.nd.to_dlpack_for_write(t))
    w._data[0, 0] = 42.0
    assert float(t.asnumpy()[0, 0]) == 42.0   # the writer's memory
    x[0, 0] = 42.0
    np.testing.assert_array_equal(
        np.asarray(mx.nd.from_dlpack(t.to_dlpack_for_read()).asnumpy()), x)
    j = mx.nd.array(x)
    np.testing.assert_array_equal(
        mt.nd.from_dlpack(j.to_dlpack_for_read()).asnumpy(), x)
    with pytest.raises(MXNetError):
        mt.nd.from_numpy(x.T)
    with pytest.raises(MXNetError):
        mt.nd.to_dlpack_for_read(x)
