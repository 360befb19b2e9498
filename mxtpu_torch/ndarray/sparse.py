"""Sparse NDArrays: ``row_sparse`` and ``csr`` storage (counterpart of
``mxtpu/ndarray/sparse.py``; ref: include/mxnet/ndarray.h:61-66,
python/mxnet/ndarray/sparse.py, cast_storage-inl.h, dot-inl.h).

As in the JAX package, a sparse array is a set of dense tensors: a
``RowSparseNDArray`` is (indices (nnz,), values (nnz, *row_shape)), a
``CSRNDArray`` (indptr, indices, data). Its ``_data`` is the values
tensor, so autograd and ``_apply`` see the values; the index tensors
(int32) and the logical shape live in ``_aux``. The ops are plain torch
gathers and scatters (``index_select``, ``index_add``,
``torch.searchsorted`` for a CSR's row ids) on whatever device the values
are on: ``dot(csr, dense)`` never builds the dense (rows, features)
matrix. Host data lands on the current context, as ``array``'s does.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .ndarray import NDArray, _apply, _to_tensor, array

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros", "dot"]


def _tensor(x, device=None, dtype=None):
    """A tensor from an NDArray, a tensor or host data; host data lands on
    ``device`` (the current context when None)."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        return _to_tensor(x, device, dtype)
    return t if dtype is None else t.to(dtype)


class BaseSparseNDArray(NDArray):
    """Common behaviour of the sparse storage types (ref: the reference's
    storage dispatch and its dense fallback): zero-preserving scalar ops
    (``*``, ``/``, ``-x``, ``abs``, ``**k`` for k > 0) map the stored values
    and keep the format; ``+``/``-`` of two arrays of one format merge
    sparsely; everything else densifies both operands and returns a dense
    NDArray."""

    __slots__ = ("_aux",)

    _SCALAR = (int, float, bool, _np.number)

    def asnumpy(self):
        return self.todense().asnumpy()

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self.shape)), self.context)

    def todense(self) -> NDArray:
        raise NotImplementedError

    def _replace_values(self, vals):
        """Same indices and shape, new values (zero-preserving maps only)."""
        raise NotImplementedError

    def attach_grad(self, grad_req="write", stype=None):
        """Mark a sparse leaf; its gradient is an array of the same format
        over this array's indices, values-shaped (the tape sees the values
        tensor)."""
        if stype is not None and stype != self.stype:
            raise MXNetError(
                "grad stype %r unsupported for a %s leaf: its tape "
                "cotangents are values-shaped" % (stype, self.stype))
        self._make_leaf(self._replace_values(
            torch.zeros_like(self._data.detach())), grad_req)

    def _values_map(self, fn, name):
        """A zero-preserving map over the stored values, through ``_apply``
        (taped under ``record()``, seen by the profiler)."""
        return self._replace_values(_apply(fn, (self,), name=name)._data)

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self.todense(), stype)

    # ------------------------------------------------------- arithmetic
    def _dense_fallback(self, other, op):
        rhs = other.todense() if isinstance(other, BaseSparseNDArray) \
            else other
        return getattr(self.todense(), op)(rhs)

    def _binop(self, other, fn, name):
        return self.todense()._binop(other, fn, name)

    def _rbinop(self, other, fn, name):
        return self.todense()._rbinop(other, fn, name)

    def __mul__(self, o):
        if isinstance(o, self._SCALAR):
            return self._values_map(lambda v: v * o, "_mul_scalar")
        return self._dense_fallback(o, "__mul__")

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, self._SCALAR):
            return self._values_map(lambda v: v / o, "_div_scalar")
        return self._dense_fallback(o, "__truediv__")

    def __rtruediv__(self, o):   # scalar / x maps zeros to inf: densify
        return self._dense_fallback(o, "__rtruediv__")

    def __pow__(self, o):
        # 0 ** k == 0 iff k > 0 (real k; complex takes the dense fallback)
        if isinstance(o, self._SCALAR) \
                and not isinstance(o, (complex, _np.complexfloating)) \
                and o > 0:
            return self._values_map(lambda v: v ** o, "_power_scalar")
        return self._dense_fallback(o, "__pow__")

    def __neg__(self):
        return self._values_map(torch.neg, "negative")

    def __abs__(self):
        return self._values_map(torch.abs, "abs")

    def __add__(self, o):
        merged = self._sparse_merge(o, 1.0)
        return merged if merged is not None \
            else self._dense_fallback(o, "__add__")

    __radd__ = __add__

    def __sub__(self, o):
        merged = self._sparse_merge(o, -1.0)
        return merged if merged is not None \
            else self._dense_fallback(o, "__sub__")

    def __rsub__(self, o):
        return self._dense_fallback(o, "__rsub__")

    def _sparse_merge(self, other, sign):
        """Same-format sparse +/-; None means the dense fallback."""
        return None

    # in place: only a format-preserving result may replace the payload
    def _inplace_from(self, res, opname):
        if res is None:
            raise MXNetError("in-place %s on %s supports only a "
                             "format-preserving rhs; use explicit "
                             "tostype('default')" % (opname, self.stype))
        self._set_data(res._data)
        self._aux = dict(res._aux)
        return self

    def __imul__(self, o):
        if not isinstance(o, self._SCALAR):
            raise MXNetError("in-place *= on %s would densify; use explicit "
                             "tostype('default')" % self.stype)
        return self._inplace_from(self.__mul__(o), "*=")

    def __itruediv__(self, o):
        if not isinstance(o, self._SCALAR):
            raise MXNetError("in-place /= on %s would densify; use explicit "
                             "tostype('default')" % self.stype)
        return self._inplace_from(self.__truediv__(o), "/=")

    def __iadd__(self, o):
        return self._inplace_from(self._sparse_merge(o, 1), "+=")

    def __isub__(self, o):
        return self._inplace_from(self._sparse_merge(o, -1), "-=")

    # comparisons: never meaningful on the raw values buffer
    def __eq__(self, o):
        return self._dense_fallback(o, "__eq__")

    def __ne__(self, o):
        return self._dense_fallback(o, "__ne__")

    def __gt__(self, o):
        return self._dense_fallback(o, "__gt__")

    def __ge__(self, o):
        return self._dense_fallback(o, "__ge__")

    def __lt__(self, o):
        return self._dense_fallback(o, "__lt__")

    def __le__(self, o):
        return self._dense_fallback(o, "__le__")

    __hash__ = NDArray.__hash__


class RowSparseNDArray(BaseSparseNDArray):
    """(indices, values): ``values[i]`` is the dense row at row id
    ``indices[i]`` (ref: sparse.py:RowSparseNDArray)."""

    def __init__(self, values, indices, shape):
        v = _tensor(values)
        super().__init__(v)
        self._aux = {"indices": _tensor(indices, v.device).to(
            device=v.device, dtype=torch.int32), "shape": tuple(shape)}

    @property
    def stype(self):
        return "row_sparse"

    @property
    def shape(self):
        return self._aux["shape"]

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"])

    @property
    def data(self) -> NDArray:
        return NDArray(self._data)

    def todense(self) -> NDArray:
        indices, shape = self._aux["indices"], self.shape

        def fn(v):
            return torch.zeros(shape, dtype=v.dtype, device=v.device) \
                .index_add(0, indices, v)

        return _apply(fn, (self,), name="cast_storage")

    def _replace_values(self, vals):
        return RowSparseNDArray(vals, self._aux["indices"], self.shape)

    def _sparse_merge(self, other, sign):
        """rsp +/- rsp without densifying: the union of the row ids
        (``torch.unique``) and an ``index_add`` of both value blocks."""
        if not isinstance(other, RowSparseNDArray) \
                or other.shape != self.shape:
            return None
        idx = torch.cat([self._aux["indices"],
                         other._aux["indices"].to(self._data.device)])
        uidx, inv = torch.unique(idx, sorted=True, return_inverse=True)
        n_out = int(uidx.shape[0])
        row_shape = tuple(self._data.shape[1:])
        dtype = torch.promote_types(self._data.dtype, other._data.dtype)

        def fn(va, vb):
            vb = vb.to(dtype)
            cat = torch.cat([va.to(dtype), -vb if sign < 0 else vb])
            return torch.zeros((n_out,) + row_shape, dtype=dtype,
                               device=va.device).index_add(0, inv, cat)

        out = _apply(fn, (self, other), name="elemwise_add")
        return RowSparseNDArray(out._data, uidx, self.shape)

    def retain(self, row_ids):
        """Keep only the given rows (ref: sparse_retain-inl.h)."""
        idx = self._aux["indices"]
        rid = _tensor(row_ids, idx.device).to(device=idx.device,
                                              dtype=torch.int32)
        keep = torch.isin(idx, rid)
        return RowSparseNDArray(self._data.detach()[keep], idx[keep],
                                self.shape)

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            other._set_data(self._data)
            other._aux = dict(self._aux)
            return other
        return self.todense().copyto(other)

    def _serialize_parts(self):
        return [("indices", self._aux["indices"].cpu().numpy()),
                ("values", self.data.asnumpy())]


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (ref: sparse.py:CSRNDArray): ``data``
    (values), ``indptr`` and ``indices`` (int32) and a 2-D ``shape``."""

    def __init__(self, data, indptr, indices, shape):
        d = _tensor(data)
        super().__init__(d)
        self._aux = {
            "indptr": _tensor(indptr, d.device).to(device=d.device,
                                                   dtype=torch.int32),
            "indices": _tensor(indices, d.device).to(device=d.device,
                                                     dtype=torch.int32),
            "shape": tuple(shape)}

    @property
    def stype(self):
        return "csr"

    @property
    def shape(self):
        return self._aux["shape"]

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"])

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._aux["indptr"])

    @property
    def data(self) -> NDArray:
        return NDArray(self._data)

    def todense(self) -> NDArray:
        m, n = self.shape
        rows = _csr_row_ids(self._aux["indptr"], self._data.shape[0])
        indices = self._aux["indices"].long()

        def fn(d):
            return torch.zeros((m, n), dtype=d.dtype, device=d.device) \
                .index_put((rows, indices), d, accumulate=True)

        return _apply(fn, (self,), name="cast_storage")

    def _replace_values(self, vals):
        return CSRNDArray(vals, self._aux["indptr"], self._aux["indices"],
                          self.shape)

    def _sparse_merge(self, other, sign):
        """csr +/- csr keeps the format: through the dense sum (a batch's
        width), compressed again."""
        if not isinstance(other, CSRNDArray) or other.shape != self.shape:
            return None
        dense = self.todense() + (-other.todense() if sign < 0
                                  else other.todense())
        return cast_storage(dense, "csr")

    def __getitem__(self, key):
        """A dense NDArray, as the reference's ``todense()[key]``; a row or
        a unit-step row slice builds only its own rows."""
        m, n = self.shape
        if isinstance(key, (int, _np.integer)):
            i = int(key) + m if key < 0 else int(key)
            if not 0 <= i < m:
                raise IndexError("index %d is out of bounds for axis 0 with "
                                 "size %d" % (key, m))
            return self._rows(i, i + 1)[0]
        if isinstance(key, slice) and key.step in (None, 1):
            start, stop, _ = key.indices(m)
            return self._rows(start, max(start, stop))
        return self.todense()[key]

    def _rows(self, start, stop):
        """Rows [start, stop) as a dense (stop - start, n) NDArray."""
        n = self.shape[1]
        ip = self._aux["indptr"].long()
        lo, hi = ip[start], ip[stop]
        sub = ip[start:stop + 1] - lo
        cnt = int(hi - lo)
        rows = _csr_row_ids(sub, cnt)
        cols = self._aux["indices"].long()

        def fn(d):
            part = d.narrow(0, int(lo), cnt)
            return torch.zeros((stop - start, n), dtype=d.dtype,
                               device=d.device).index_put(
                (rows, cols.narrow(0, int(lo), cnt)), part, accumulate=True)

        return _apply(fn, (self,), name="slice")

    def copyto(self, other):
        if isinstance(other, CSRNDArray):
            other._set_data(self._data)
            other._aux = dict(self._aux)
            return other
        return self.todense().copyto(other)

    def _serialize_parts(self):
        return [("indptr", self._aux["indptr"].cpu().numpy()),
                ("indices", self._aux["indices"].cpu().numpy()),
                ("data", self.data.asnumpy())]


def _deserialize_parts(stype, shape, parts):
    if stype == "row_sparse":
        return RowSparseNDArray(parts["values"], parts["indices"], shape)
    if stype == "csr":
        return CSRNDArray(parts["data"], parts["indptr"], parts["indices"],
                          shape)
    raise MXNetError("unknown stype " + stype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices) or a dense source (ref:
    mx.nd.sparse.row_sparse_array)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = array(data, ctx=ctx, dtype=dtype)
        return RowSparseNDArray(data, array(indices, ctx=data.context),
                                shape)
    return cast_storage(array(arg1, ctx=ctx, dtype=dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr) or a dense source (ref:
    mx.nd.sparse.csr_matrix)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = array(data, ctx=ctx, dtype=dtype)
        return CSRNDArray(data, array(indptr, ctx=data.context),
                          array(indices, ctx=data.context), shape)
    return cast_storage(array(arg1, ctx=ctx, dtype=dtype), "csr")


def cast_storage(arr, stype):
    """dense <-> row_sparse <-> csr (ref: cast_storage-inl.h). Which rows
    or elements are stored is found on the array's device (one sync for
    the count); the values are gathered through ``_apply``, so the cast
    stays on the tape."""
    if arr.stype == stype:
        return arr
    if isinstance(arr, BaseSparseNDArray):
        arr = arr.todense()
        if stype == "default":
            return arr
    a = arr._data.detach()
    if stype == "row_sparse":
        if a.ndim < 1:
            raise MXNetError("row_sparse requires ndim>=1")
        ridx = torch.nonzero(a.reshape(a.shape[0], -1).any(dim=1)) \
            .reshape(-1).to(torch.int32)
        vals = _apply(lambda d: d.index_select(0, ridx), (arr,),
                      name="cast_storage")
        return RowSparseNDArray(vals._data, ridx, tuple(a.shape))
    if stype == "csr":
        if a.ndim != 2:
            raise MXNetError("csr requires 2D")
        nz = torch.nonzero(a)
        ri, ci = nz[:, 0], nz[:, 1]
        indptr = torch.zeros(a.shape[0] + 1, dtype=torch.int64,
                             device=a.device)
        indptr[1:] = torch.cumsum(torch.bincount(ri, minlength=a.shape[0]),
                                  0)
        vals = _apply(lambda d: d[ri, ci], (arr,), name="cast_storage")
        return CSRNDArray(vals._data, indptr, ci, tuple(a.shape))
    if stype == "default":
        return arr
    raise MXNetError("unknown stype " + stype)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An all-zero array of the storage type (ref: mx.nd.sparse.zeros)."""
    from ..base import canonical_dtype
    if stype not in ("row_sparse", "csr"):
        from ..ops.init_ops import zeros as dense_zeros
        return NDArray(dense_zeros(shape, ctx=ctx, dtype=dtype))
    dev, dt = resolve_device(ctx), canonical_dtype(dtype)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    if stype == "row_sparse":
        rs = tuple(shape[1:]) if len(shape) > 1 else ()
        return RowSparseNDArray(torch.zeros((0,) + rs, dtype=dt, device=dev),
                                empty, shape)
    return CSRNDArray(torch.zeros(0, dtype=dt, device=dev),
                      torch.zeros(shape[0] + 1, dtype=torch.int32,
                                  device=dev), empty, shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (ref: dot-inl.h's sparse paths). ``csr (B, F) x
    dense (F, C)`` (the sparse linear model's forward) never builds the
    dense (B, F) matrix: each stored element gathers its weight row
    (``index_select``) and an ``index_add`` sums them into the B rows, O(nnz
    * C) work and memory; taped through ``_apply``, so gradients reach the
    csr values and the dense rhs. Every other case densifies its sparse
    operands and runs the dense ``dot``."""
    from ..ops.registry import get_op
    if isinstance(lhs, CSRNDArray) and not transpose_a \
            and not isinstance(rhs, BaseSparseNDArray) and rhs.ndim == 2:
        num_rows = lhs.shape[0]

        def fn(data, indptr, indices, r):
            if transpose_b:
                r = r.t()
            return _csr_dns_dot(data, indptr, indices, num_rows, r)

        return _apply(fn, (lhs, lhs.indptr, lhs.indices, rhs),
                      name="dot_csr_dns")
    lhs = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rhs = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return get_op("dot").wrapper(lhs, rhs, transpose_a=transpose_a,
                                 transpose_b=transpose_b)


def _csr_row_ids(indptr, nnz):
    """The row id of each stored element of a CSR matrix (int64)."""
    pos = torch.arange(nnz, device=indptr.device, dtype=indptr.dtype)
    return torch.searchsorted(indptr, pos, right=True).long() - 1


def _csr_dns_dot(data, indptr, indices, num_rows, rhs):
    """out[b] = sum over row b's elements j of data[j] * rhs[indices[j]]."""
    rows = _csr_row_ids(indptr, data.shape[0])
    contrib = rhs.index_select(0, indices) * data[:, None].to(rhs.dtype)
    return torch.zeros((num_rows, rhs.shape[1]), dtype=contrib.dtype,
                       device=contrib.device).index_add(0, rows, contrib)
