"""Base types of the PyTorch/CUDA port (counterpart of ``mxtpu/base.py``)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64}


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: python/mxnet/base.py:MXNetError)."""


def torch_dtype(dtype):
    """A torch dtype from a name, a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]
