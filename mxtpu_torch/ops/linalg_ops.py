"""Linear-algebra ops (counterpart of ``mxtpu/ops/linalg_ops.py``; ref:
src/operator/tensor/la_op.cc). These are cuBLAS and cuSOLVER calls through
``torch.linalg`` (LAPACK on the CPU), as the JAX package's are XLA's own
decompositions; no Pallas kernel computes them. Every op works on the last
two axes, batched over the rest.

None of them reads anything back to the host, so a graph capture can
record them: ``potrf`` and ``inverse`` use the ``_ex`` forms, which leave
LAPACK's error code on the device, and ``potrf`` of a matrix that is not
positive definite gives NaN in its lower triangle, as the JAX package's
Cholesky does. The LU-based ops (``inverse``, ``det``, ``slogdet``) run
on the card with torch's cuSOLVER/cuBLAS backend: its default picks
MAGMA for a batch of small matrices, and MAGMA's batched LU cannot be
captured. ``torch.linalg.eigh`` checks its error code on the host, so
inside a capture ``syevd`` runs a cyclic Jacobi of a fixed number of
sweeps in float64 instead (the TPU's own ``eigh`` is a Jacobi method too):
eigenvalues and eigenvectors to float32's precision, its signs its own.

``gelqf`` and ``syevd`` are defined up to the signs of Q's rows and of the
eigenvectors; the port gives LAPACK's (on the card cuSOLVER's) Householder
signs. The reference's quirks are kept: ``trmm`` multiplies by the whole
of ``A`` whatever ``lower`` says, and ``makediag`` ignores ``offset``.
"""
from __future__ import annotations

import contextlib
import math

import torch

from .. import graphs
from .registry import register

__all__ = ["linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_potri",
           "linalg_trmm", "linalg_trsm", "linalg_sumlogdiag", "linalg_syrk",
           "linalg_gelqf", "linalg_syevd", "linalg_makediag",
           "linalg_extractdiag", "linalg_inverse", "linalg_det",
           "linalg_slogdet"]


def _t(x):
    return x.transpose(-1, -2)


@contextlib.contextmanager
def _cusolver(a):
    """torch's cuSOLVER/cuBLAS linear-algebra backend for the block, on a
    CUDA tensor (the process-wide setting is given back after)."""
    if a.device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _solve_lower(a, b, lower):
    """``a x = b`` reading only ``a``'s lower (``lower``) or upper
    triangle, as ``jax.scipy.linalg.solve_triangular`` does."""
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2):
    """``alpha * op(A) @ op(B) + beta * C`` (``axis`` is ignored, as in
    the JAX package)."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2):
    """``alpha * op(A) @ op(B)``."""
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    """The lower Cholesky factor; NaN in the lower triangle of a matrix
    that is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    n = A.shape[-1]
    lower = torch.ones(n, n, dtype=torch.bool, device=A.device).tril()
    bad = (info > 0).reshape(tuple(info.shape) + (1, 1)) & lower
    return torch.where(bad, torch.full((), float("nan"), dtype=L.dtype,
                                       device=L.device), L)


@register("linalg_potri")
def linalg_potri(A):
    """The inverse of ``L L^T`` from its Cholesky factor ``L = A``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    inv_l = _solve_lower(A, eye, True)
    return torch.matmul(_t(inv_l), inv_l)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``alpha * op(A) @ B`` (``B @ op(A)`` with ``rightside``), with the
    whole of ``A``: ``lower`` is ignored, as in the JAX package."""
    a = _t(A) if transpose else A
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """``X`` with ``op(A) X = alpha B`` (``X op(A) = alpha B`` with
    ``rightside``), ``A`` triangular (its ``lower`` or upper triangle is
    read)."""
    if rightside:
        eff_lower = lower if transpose else not lower
        x = _solve_lower(A if transpose else _t(A), _t(alpha * B), eff_lower)
        return _t(x)
    if transpose:
        return _solve_lower(_t(A), alpha * B, not lower)
    return _solve_lower(A, alpha * B, lower)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    """The sum of the logs of the diagonal."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    """``alpha * op(A) @ op(A)^T``."""
    a = _t(A) if transpose else A
    return alpha * torch.matmul(a, _t(a))


@register("linalg_gelqf", num_outputs=2)
def linalg_gelqf(A):
    """``[L, Q]`` with ``A = L Q``, Q's rows orthonormal: the QR of
    ``A^T`` transposed."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return [_t(r), _t(q)]


def _jacobi_sweeps(n):
    """Sweeps that take a symmetric n x n matrix's off-diagonal part below
    float32's resolution: 12 at n 128, two more each time n doubles."""
    return max(12, 2 * math.ceil(math.log2(max(n, 2))) - 2)


def _jacobi_eigh(A):
    """(eigenvalues ascending, eigenvectors as rows) of the symmetric
    matrices ``A`` (the lower triangle read, as ``eigh`` reads it), by the
    cyclic Jacobi method in float64: each round rotates the n/2 disjoint
    pairs of a round-robin schedule at once, ``_jacobi_sweeps(n)`` sweeps
    of n - 1 rounds. Every step is a kernel on the device and the count is
    fixed, so a graph capture can hold it."""
    n = A.shape[-1]
    lead = tuple(A.shape[:-2])
    a = A.to(torch.float64).reshape((-1, n, n))
    a = torch.tril(a) + torch.tril(a, -1).transpose(-1, -2)
    m = n + n % 2       # an odd size gets an isolated zero row and column
    if m != n:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    b, dev = a.shape[0], a.device
    eye = torch.eye(m, dtype=torch.float64, device=dev).reshape(1, m * m) \
        .expand(b, m * m)
    v = eye.reshape(b, m, m).clone()
    # the circle method: in round r player m - 1 meets r, r + i meets r - i
    i = torch.arange(m // 2, device=dev)
    r = torch.arange(m - 1, device=dev).unsqueeze(1)
    P = torch.where(i == 0, m - 1, (r + i) % (m - 1))
    Q = (r - i) % (m - 1)
    # per round: the flat positions of a_pp, a_qq, a_pq and of the
    # rotation's entries (pp, qq, pq, qp)
    diag = torch.cat([P * (m + 1), Q * (m + 1), P * m + Q], 1)
    entries = torch.cat([P * (m + 1), Q * (m + 1), P * m + Q, Q * m + P], 1)
    h = m // 2
    for _ in range(_jacobi_sweeps(n)):
        for k in range(m - 1):
            g = a.reshape(b, m * m).index_select(1, diag[k])
            app, aqq, apq = g[:, :h], g[:, h:2 * h], g[:, 2 * h:]
            # the angle that zeroes a_pq, |phi| <= pi/4 (0 where a_pq and
            # a_qq - a_pp are both 0)
            phi = torch.nan_to_num(0.5 * torch.atan(2 * apq / (aqq - app)))
            c, s = torch.cos(phi), torch.sin(phi)
            rot = eye.scatter(1, entries[k].expand(b, 4 * h),
                              torch.cat([c, c, s, -s], 1)).reshape(b, m, m)
            a = rot.transpose(-1, -2) @ a @ rot
            v = v @ rot
    lam, idx = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1)[:, :n], dim=-1)
    u = torch.gather(v[:, :n, :n].transpose(-1, -2), 1,
                     idx.unsqueeze(-1).expand(b, n, n))
    return lam.reshape(lead + (n,)), u.reshape(lead + (n, n))


def _recording(A):
    """Whether ``A``'s op is being recorded: on the card a stream capture
    (a graph's warm-up runs eagerly and may call ``eigh``); on the CPU,
    where nothing is recorded, the capture stand-in's depth."""
    if A.device.type == "cuda":
        return torch.cuda.is_current_stream_capturing()
    return graphs.capturing()


@register("linalg_syevd", num_outputs=2)
def linalg_syevd(A):
    """``[U, lam]`` with ``A = U^T diag(lam) U``, the eigenvalues
    ascending: ``torch.linalg.eigh``, or while a graph records (where
    ``eigh``'s check of its error code on the host cannot run) the
    Jacobi method of ``_jacobi_eigh``."""
    if _recording(A):
        lam, u = _jacobi_eigh(A)
        return [u.to(A.dtype), lam.to(A.dtype)]
    w, v = torch.linalg.eigh(A)
    return [_t(v), w]


@register("linalg_makediag")
def linalg_makediag(A, offset=0):
    """A diagonal matrix from each last-axis vector of ``A``; ``offset``
    is ignored, as in the JAX package."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return A.unsqueeze(-2) * eye


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    """The ``offset``-th diagonal of the last two axes."""
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1).clone()


@register("linalg_inverse", aliases=("inverse",))
def linalg_inverse(A):
    with _cusolver(A):
        return torch.linalg.inv_ex(A, check_errors=False)[0]


@register("linalg_det", aliases=("det",))
def linalg_det(A):
    with _cusolver(A):
        return torch.linalg.det(A)


@register("linalg_slogdet", aliases=("slogdet",), num_outputs=2)
def linalg_slogdet(A):
    """``[sign, log|det|]``."""
    with _cusolver(A):
        sign, ld = torch.linalg.slogdet(A)
    return [sign, ld]
