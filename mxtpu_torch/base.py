"""Base types of the PyTorch/CUDA port (counterpart of ``mxtpu/base.py``)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Error raised by the framework (ref: python/mxnet/base.py:MXNetError)."""
