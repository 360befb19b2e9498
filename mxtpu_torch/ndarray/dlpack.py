"""DLPack interchange (counterpart of ``mxtpu/ndarray/dlpack.py``; ref:
python/mxnet/ndarray/ndarray.py ``to_dlpack_for_read`` /
``to_dlpack_for_write`` / ``from_dlpack`` / ``from_numpy``), over
``torch.utils.dlpack``.

A capsule shares the array's memory, on its device: nothing is copied
either way. A torch tensor is mutable, so the capsule of
``to_dlpack_for_write`` is the array's own memory too, and a consumer's
writes show in the array (the reference's contract; the JAX package,
whose buffers are immutable, hands out a host copy instead).
"""
from __future__ import annotations

import ctypes

import numpy as _np
import torch.utils.dlpack

from ..base import MXNetError
from .ndarray import NDArray, array as _nd_array

__all__ = ["to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack",
           "from_numpy"]

def to_dlpack_for_read(data):
    """NDArray -> PyCapsule("dltensor") over its memory. The capsule is
    one-shot: its consumer (``from_dlpack``, another framework's importer)
    takes ownership. ``to_dlpack_for_write`` is the same function: a
    consumer's writes show in the NDArray."""
    if not isinstance(data, NDArray):
        raise MXNetError("to_dlpack expects an NDArray, got %s"
                         % type(data).__name__)
    data.wait_to_read()
    return torch.utils.dlpack.to_dlpack(data._data.detach())


to_dlpack_for_write = to_dlpack_for_read


def from_dlpack(dlpack) -> NDArray:
    """PyCapsule (or any object with ``__dlpack__``) -> NDArray over the
    same memory. The producer's capsule is consumed (renamed
    "used_dltensor", per the DLPack contract)."""
    if ctypes.pythonapi.PyCapsule_IsValid(
            ctypes.py_object(dlpack), b"dltensor_versioned"):
        raise MXNetError(
            "from_dlpack got a DLPack-1.0 'dltensor_versioned' capsule; "
            "this importer consumes the pre-1.0 'dltensor' layout. "
            "Re-export from the producer without max_version (the legacy "
            "protocol, e.g. tensor.__dlpack__()), or pass the producer "
            "object itself so the exchange negotiates a version.")
    return NDArray(torch.utils.dlpack.from_dlpack(dlpack))


def from_numpy(ndarray, zero_copy=True):
    """numpy -> NDArray on the current context (ref: mx.nd.from_numpy). As
    in the JAX package the values are copied (the array lands on the
    card), and ``zero_copy`` is accepted for the reference's signature."""
    if not isinstance(ndarray, _np.ndarray):
        raise MXNetError("from_numpy expects a numpy.ndarray")
    if not ndarray.flags["C_CONTIGUOUS"]:
        raise MXNetError("the numpy ndarray must be C-contiguous "
                         "(reference from_numpy raises the same)")
    return _nd_array(ndarray)
