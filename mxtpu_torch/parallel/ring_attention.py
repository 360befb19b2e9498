"""Self-attention over a sequence axis (counterpart of
``mxtpu/parallel/ring_attention.py``).

Only the single-device branch is ported: with no mesh, or a mesh whose
sequence axis has size 1, ``ring_self_attention`` is the fused flash
kernel. The sharded ring (K/V blocks rotated between devices, merged by
their log-sum-exps) needs ``torch.distributed`` and comes with ROADMAP
item A8; a mesh with a sequence axis larger than 1 raises until then.
``mesh`` is anything whose ``.shape`` maps axis names to sizes, as a JAX
mesh's does.

Layout: ``[batch, heads, seq, head_dim]``.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ops.pallas.flash_attention import (flash_attention,
                                          flash_attention_reference)

__all__ = ["ring_self_attention", "ring_attention_nd"]


def _dense_attention(q, k, v, causal=False, scale=None):
    """Single-device reference path (the degenerate 1-shard ring): the
    flash kernel's plain version."""
    return flash_attention_reference(q, k, v, causal, scale)[0]


def ring_self_attention(q, k, v, mesh=None, seq_axis="sp", batch_axis=None,
                        causal=False, scale=None):
    """Attention of ``[B, H, T, D]`` q, k, v; the flash kernel when the
    sequence is not sharded (``batch_axis`` only matters to the ring)."""
    size = 1 if mesh is None else dict(mesh.shape).get(seq_axis, 1)
    if size == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise MXNetError(
        "ring attention over mesh axis %r of size %d is not ported yet: the "
        "sharded ring needs torch.distributed (ROADMAP A8); pass mesh=None "
        "for single-device attention" % (seq_axis, size))


def ring_attention_nd(q, k, v, mesh=None, seq_axis="sp", batch_axis=None,
                      causal=False, scale=None):
    """The ``_contrib_ring_attention`` op of the JAX package, as a plain
    function of tensors."""
    return ring_self_attention(q, k, v, mesh=mesh, seq_axis=seq_axis,
                               batch_axis=batch_axis, causal=causal,
                               scale=scale)
