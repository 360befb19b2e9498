"""Contrib ops (counterpart of ``mxtpu/ops/contrib_ops.py``): so far
``_contrib_arange_like``. The detection, resize and pooling ops of the
JAX package's module are ROADMAP A10.4."""
from __future__ import annotations

from .init_ops import arange_like
from .registry import register

__all__ = ["contrib_arange_like"]


@register("_contrib_arange_like")
def contrib_arange_like(data, start=0.0, step=1.0, repeat=1, axis=None,
                        ctx=None):
    """``arange_like`` under its contrib name."""
    return arange_like(data, start=start, step=step, repeat=repeat,
                       axis=axis, ctx=ctx)
