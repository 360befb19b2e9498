"""The compressed-sparse-row array that ``io.LibSVMIter`` yields
(counterpart of ``mxtpu/ndarray/sparse.py:CSRNDArray``).

Only the container is ported: its three component arrays, ``todense`` and
``asnumpy``. The sparse ops of the reference's module (``dot``,
``cast_storage``, ``row_sparse`` arrays) are ROADMAP A10.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray, _apply, array

__all__ = ["CSRNDArray"]


class CSRNDArray:
    """Compressed sparse row matrix (ref: ndarray/sparse.py:CSRNDArray):
    ``data`` (values), ``indptr`` and ``indices`` (int32) and a 2-D
    ``shape``. Host inputs land on the current context, as ``array``'s
    do."""

    def __init__(self, data, indptr, indices, shape):
        self._values = data if isinstance(data, NDArray) else array(data)
        ctx = self._values.context
        self._indptr = (indptr if isinstance(indptr, NDArray)
                        else array(indptr, ctx=ctx)).astype("int32")
        self._indices = (indices if isinstance(indices, NDArray)
                         else array(indices, ctx=ctx)).astype("int32")
        self._shape = tuple(shape)

    @property
    def stype(self):
        return "csr"

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._values.dtype

    @property
    def context(self):
        return self._values.context

    @property
    def data(self) -> NDArray:
        return self._values

    @property
    def indices(self) -> NDArray:
        return self._indices

    @property
    def indptr(self) -> NDArray:
        return self._indptr

    def todense(self) -> NDArray:
        m, n = self._shape
        indptr = self._indptr.to_torch().long()
        indices = self._indices.to_torch().long()
        rows = torch.repeat_interleave(
            torch.arange(m, device=indptr.device), indptr[1:] - indptr[:-1])

        def fn(d):
            return torch.zeros((m, n), dtype=d.dtype,
                               device=d.device).index_put_(
                (rows, indices), d, accumulate=True)

        return _apply(fn, (self._values,), name="cast_storage")

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError("cannot convert csr to %r" % (stype,))

    def asnumpy(self):
        return self.todense().asnumpy()
