"""Base types of the PyTorch/CUDA port (counterpart of ``mxtpu/base.py``)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "canonical_dtype", "numpy_dtype"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
# the JAX package runs with x64 off: 64-bit requests give 32-bit arrays
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32}


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: python/mxnet/base.py:MXNetError)."""


def torch_dtype(dtype):
    """A torch dtype from a name, a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if dtype in _DTYPES else np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]


def canonical_dtype(dtype):
    """The torch dtype the JAX package gives for ``dtype``: float64 and
    int64 become float32 and int32, as with JAX's x64 mode off."""
    dt = torch_dtype(dtype)
    return _X64_OFF.get(dt, dt)


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks,
    stays ``torch.bfloat16``."""
    if dtype == torch.bfloat16:
        return dtype
    return np.dtype(str(dtype).split(".")[-1])
