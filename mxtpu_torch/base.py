"""Base types of the PyTorch/CUDA port (counterpart of ``mxtpu/base.py``):
the error type, dtype names, and the context names that ``context.py``
defines (``Context``, ``cpu``, ``gpu``, ``tpu``, ``current_context``), as
the reference's ``base`` exports them."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "Context", "cpu", "gpu", "tpu", "current_context",
           "np_dtype", "torch_dtype", "canonical_dtype", "numpy_dtype",
           "numeric_types", "string_types", "DTYPE_TO_CODE",
           "CODE_TO_DTYPE", "num_gpus"]

# dtype codes, wire-compatible with the reference's mshadow TypeFlag
DTYPE_TO_CODE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
                 "int32": 4, "int8": 5, "int64": 6, "bfloat16": 7,
                 "bool": 8}
CODE_TO_DTYPE = {v: k for k, v in DTYPE_TO_CODE.items()}

# ref: python/mxnet/base.py numeric_types/string_types
numeric_types = (float, int, np.generic)
string_types = (str,)

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


def np_dtype(dtype):
    """A dtype's canonical name (``"bfloat16"`` for bfloat16), None for
    None (ref: mxtpu/base.py:np_dtype)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = dtype
    elif "bfloat16" in str(dtype):
        name = "bfloat16"
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = np.dtype(dtype).name
    return "bfloat16" if name == "bfloat16" else np.dtype(name).name


# the context names, defined in context.py (which imports MXNetError above)
from .context import (Context, cpu, current_context, gpu,  # noqa: E402
                      num_gpus)


def tpu(device_id=0):
    """The accelerator, as the reference's ``tpu()`` names its own: here
    CUDA device ``device_id``, the same context as ``gpu(device_id)``."""
    return gpu(device_id)
