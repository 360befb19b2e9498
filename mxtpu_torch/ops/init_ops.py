"""Array-creation ops (counterpart of ``mxtpu/ops/init_ops.py``)."""
from __future__ import annotations

import torch

from ..base import torch_dtype
from ..context import resolve_device

__all__ = ["arange"]


def arange(start, stop=None, step=1.0, ctx=None, dtype="float32"):
    """``start, start + step, ...`` below ``stop`` (``[0, start)`` when
    ``stop`` is None) on ``ctx`` (default: the CUDA device, or raise)."""
    if stop is None:
        start, stop = 0, start
    return torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                        device=resolve_device(ctx))
