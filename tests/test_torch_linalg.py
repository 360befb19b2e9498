"""ROADMAP A10.2's linear algebra against the JAX package: the 15
``linalg_*`` registry ops of ``ops/linalg_ops.py``, ``mx.nd.linalg`` and
``mx.sym.linalg``, on the same seeded float32 numpy inputs on the CPU
(batches of 3 matrices of 5 x 5, SPD where the op needs it).

Tolerances: each op against the reference within rtol 1e-4, atol 1e-5
(both packages factorise in float32 LAPACK here); the factorisations also
by their residuals against float64 numpy (``L L^T = A``, ``L Q = A`` with
orthonormal rows, ``U^T diag(lam) U = A`` with ascending eigenvalues)
within 1e-4 of ``|A|``. ``gelqf``'s Q and ``syevd``'s U are defined up to
the signs of their rows: the port gives LAPACK's Householder signs (on the
card cuSOLVER's), held here by ``|Q|`` and ``|U|`` against the
reference's. Inside a graph capture ``syevd`` runs a fixed-sweep Jacobi
method (``eigh`` checks its error code on the host), held to the
reference by its eigenvalues (rtol 1e-5) and its residuals. The
reference's quirks are held too: ``potrf`` of a matrix that is not
positive definite gives NaN in its lower triangle and raises nothing;
``trmm`` multiplies by the whole of ``A`` whatever ``lower`` says;
``makediag`` ignores ``offset``.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt

CPU = mt.cpu()
TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _m(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _spd(b=3, n=5, seed=1):
    a = _rng(seed).randn(b, n, n)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def _lower(b=3, n=5, seed=2):
    a = np.tril(_rng(seed).randn(b, n, n)) + 3 * np.eye(n)
    return a.astype(np.float32)


def _both(name, arrays, kw, tol=TOL):
    """``mx.nd.linalg.<name>`` in both packages: (port, reference), the
    outputs as lists of numpy arrays with shapes and dtypes equal."""
    ref = getattr(mx.nd.linalg, name)(*[mx.nd.array(a) for a in arrays],
                                      **kw)
    got = getattr(mt.nd.linalg, name)(*[mt.nd.array(a, ctx=CPU)
                                        for a in arrays], **kw)
    ref = ref if isinstance(ref, list) else [ref]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.dtype(g.dtype) == np.dtype(r.dtype)
    got = [g.asnumpy() for g in got]
    ref = [r.asnumpy() for r in ref]
    if tol is not None:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, **tol)
    return got, ref


CASES = [
    ("gemm", [_m(3, 4, 5), _m(3, 5, 2, seed=1), _m(3, 4, 2, seed=2)],
     dict(alpha=0.5, beta=2.0)),
    ("gemm", [_m(3, 5, 4), _m(3, 2, 5, seed=1), _m(3, 4, 2, seed=2)],
     dict(transpose_a=True, transpose_b=True)),
    ("gemm2", [_m(2, 4, 3), _m(2, 3, 6, seed=3)], dict(alpha=-1.5)),
    ("gemm2", [_m(4, 3), _m(6, 3, seed=3)], dict(transpose_b=True)),
    ("potrf", [_spd()], {}),
    ("potri", [_lower()], {}),
    ("trmm", [_lower(), _m(3, 5, 4)], dict(alpha=2.0)),
    ("trmm", [_lower(), _m(3, 4, 5)], dict(rightside=True, transpose=True)),
    ("trmm", [_m(3, 5, 5, seed=7), _m(3, 5, 2)], dict(lower=False)),
    ("trsm", [_lower(), _m(3, 5, 4)], dict(alpha=0.5)),
    ("trsm", [_lower(), _m(3, 5, 4)], dict(transpose=True)),
    ("trsm", [_lower(), _m(3, 4, 5)], dict(rightside=True)),
    ("trsm", [_lower(), _m(3, 4, 5)], dict(rightside=True, transpose=True)),
    ("trsm", [_lower().transpose(0, 2, 1).copy(), _m(3, 5, 4)],
     dict(lower=False)),
    ("trsm", [_lower().transpose(0, 2, 1).copy(), _m(3, 4, 5)],
     dict(lower=False, rightside=True, transpose=True)),
    ("sumlogdiag", [_spd()], {}),
    ("syrk", [_m(3, 4, 5)], dict(alpha=0.5)),
    ("syrk", [_m(3, 4, 5)], dict(transpose=True)),
    ("makediag", [_m(3, 4)], {}),
    ("makediag", [_m(4)], dict(offset=2)),
    ("extractdiag", [_m(3, 4, 5)], {}),
    ("extractdiag", [_m(4, 5)], dict(offset=-1)),
    ("inverse", [_spd()], {}),
    ("det", [_spd() / 5], {}),
    ("slogdet", [_m(3, 5, 5, seed=8)], {}),
]


@pytest.mark.parametrize("name,arrays,kw", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_linalg_op_is_the_references(name, arrays, kw):
    _both(name, arrays, kw)


def test_potrf_residual_and_non_spd_gives_nan_like_mxtpu():
    a = _spd()
    (L,), _ = _both("potrf", [a], {})
    np.testing.assert_allclose(L.astype(np.float64) @ L.transpose(0, 2, 1),
                               a, atol=1e-4 * np.abs(a).max())
    assert (np.triu(L, 1) == 0).all()
    bad = np.stack([np.array([[1, 2], [2, 1]], np.float32),
                    np.array([[4, 2], [2, 3]], np.float32)])
    (got,), (ref,) = _both("potrf", [bad], {}, tol=None)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0][np.tril_indices(2)]).all() and got[0, 0, 1] == 0
    np.testing.assert_allclose(got[1], ref[1], **TOL)


def test_potri_inverts_from_the_factor():
    a = _spd()
    L = np.linalg.cholesky(a.astype(np.float64)).astype(np.float32)
    (inv,), _ = _both("potri", [L], {})
    np.testing.assert_allclose(inv @ a, np.broadcast_to(np.eye(5), a.shape),
                               atol=1e-4)


def test_trmm_ignores_lower_like_mxtpu():
    a, b = _m(2, 4, 4, seed=4), _m(2, 4, 3, seed=5)
    (got,), _ = _both("trmm", [a, b], dict(lower=True))
    np.testing.assert_allclose(got, a @ b, **TOL)   # the whole of A


def test_gelqf_by_reconstruction_and_signs():
    a = _m(3, 4, 6, seed=9)
    (L, Q), (rL, rQ) = _both("gelqf", [a], {}, tol=None)
    np.testing.assert_allclose(L.astype(np.float64) @ Q, a, atol=1e-4 * 3)
    np.testing.assert_allclose(Q @ Q.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(4), (3, 4, 4)),
                               atol=1e-5)
    assert (np.triu(L, 1) == 0).all()
    np.testing.assert_allclose(np.abs(Q), np.abs(rQ), **TOL)
    np.testing.assert_allclose(np.abs(L), np.abs(rL), **TOL)


def test_syevd_by_reconstruction_and_ascending_eigenvalues():
    a = _spd(seed=10)
    (U, lam), (rU, rlam) = _both("syevd", [a], {}, tol=None)
    np.testing.assert_allclose(lam, rlam, rtol=1e-4, atol=1e-4)
    assert (np.diff(lam, axis=-1) > 0).all()
    rec = U.transpose(0, 2, 1).astype(np.float64) @ (lam[..., None] * U)
    np.testing.assert_allclose(rec, a, atol=1e-4 * np.abs(a).max())
    np.testing.assert_allclose(U @ U.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(5), a.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.abs(U), np.abs(rU), atol=1e-4)


def test_linalg_namespaces_are_the_references():
    names = {n for n in dir(mx.nd.linalg) if not n.startswith("_")}
    assert names <= {n for n in dir(mt.nd.linalg) if not n.startswith("_")}
    assert len(names) == 15
    for n in names:
        assert callable(getattr(mt.sym.linalg, n)), n
    for alias in ("inverse", "det", "slogdet"):
        assert mt.ops.registry.REGISTRY[alias].name == "linalg_" + alias
    x = _spd()
    with CPU:
        np.testing.assert_allclose(
            mt.nd.det(mt.nd.array(x / 5)).asnumpy(),
            mx.nd.det(mx.nd.array(x / 5)).asnumpy(), **TOL)
        g = mt.sym.linalg.potrf(mt.sym.var("a"))
        out = g.eval(a=mt.nd.array(x))[0].asnumpy()
    np.testing.assert_allclose(out, np.linalg.cholesky(x), **TOL)


def test_syevd_inside_a_capture_is_the_jacobi_method():
    """Inside a capture (the thread's capture depth raised, as a graph's
    warm-up and capture run) ``syevd`` takes the Jacobi path: eigenvalues
    ascending and within 1e-5 of the reference's, ``U^T diag(lam) U = A``
    and ``U U^T = I`` within 1e-5, odd sizes and a 1 x 1 included; an
    Executor graph on the capture stand-in gives the same."""
    from mxtpu_torch import graphs
    from mxtpu_torch.ops.linalg_ops import linalg_syevd
    for a in (_spd(seed=12), _spd(2, 7, seed=13), _spd(2, 1, seed=14),
              _m(9, 9, seed=15) + _m(9, 9, seed=15).T):
        rU, rlam = [o.asnumpy() for o in mx.nd.linalg.syevd(
            mx.nd.array(a))]
        graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
        try:
            U, lam = [o.numpy() for o in linalg_syevd(torch.tensor(a))]
        finally:
            graphs._STATE.depth -= 1
        n = a.shape[-1]
        scale = np.abs(a).max()
        np.testing.assert_allclose(lam, rlam, rtol=1e-5, atol=1e-5 * scale)
        assert (np.diff(lam, axis=-1) >= 0).all()
        Ut = np.swapaxes(U, -1, -2).astype(np.float64)
        np.testing.assert_allclose(Ut @ (lam[..., None] * U), a,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(U @ np.swapaxes(U, -1, -2),
                                   np.broadcast_to(np.eye(n), U.shape),
                                   atol=1e-5)
    from test_torch_train_graph import FakeGraph
    saved = (graphs.CapturedGraph, graphs.captures)
    graphs.CapturedGraph, graphs.captures = FakeGraph, lambda d: True
    try:
        a = _spd(seed=16)
        sym = mt.sym.linalg.syevd(mt.sym.var("a"))
        exe = sym.bind(CPU, args={"a": mt.nd.array(a, ctx=CPU)},
                       grad_req="null")
        U, lam = [o.asnumpy() for o in exe.forward(is_train=False)]
    finally:
        graphs.CapturedGraph, graphs.captures = saved
    np.testing.assert_allclose(lam, np.linalg.eigvalsh(
        a.astype(np.float64)), rtol=1e-5, atol=1e-5 * np.abs(a).max())
