"""Ring attention: attention over a sequence sharded across ranks
(counterpart of ``mxtpu/parallel/ring_attention.py``).

Each rank holds its query, key and value blocks ``[B, H, T/n, D]`` of a
mesh axis of size n; the key/value blocks rotate around the ring with
``ppermute`` while each rank keeps its queries and merges the partial
attentions exactly. Two bodies, as the reference's:

* ``ring_attention``: the dense body, float32 scores of one block pair at
  a time with the online softmax (running max and sum);
* ``ring_flash_attention``: B2, the hand-written flash kernel
  (``flash_attention_with_lse``), once per ring step, the partials
  merged by their float32 log-sum-exps. Causal: at step 0 a rank attends
  its own block with the causal kernel, past blocks run the kernel
  non-causal and future blocks skip it; K/V still rotate at every step,
  so every rank makes the same collective calls in the same order.

``set_ring_flash(flag)`` chooses the body of ``ring_self_attention`` (the
reference's ``MXTPU_RING_FLASH``, off by default). Both are
differentiable: the collectives' backwards rotate the key/value
gradients back to their ranks.

Layout: ``[batch, heads, seq, head_dim]``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.pallas.flash_attention import (flash_attention,
                                          flash_attention_reference,
                                          flash_attention_with_lse)
from ..ops.registry import register
from .collectives import ppermute

__all__ = ["ring_attention", "ring_flash_attention", "ring_self_attention",
           "ring_attention_nd", "set_ring_flash"]

_NEG_INF = -1e30   # a mask value that keeps -inf - -inf out of the rescale
_RING_FLASH = [False]


def set_ring_flash(flag):
    """Run the sharded ring on the flash kernel (True) or the dense body
    (False, the default); returns the previous setting."""
    prev, _RING_FLASH[0] = _RING_FLASH[0], bool(flag)
    return prev


def _axis(axis_name, mesh):
    return axis_name if mesh is None else mesh.axis(axis_name)


def _ring(n):
    return [(j, (j + 1) % n) for j in range(n)]


class _Touch(torch.autograd.Function):
    """``x`` unchanged, with a zero gradient for ``block``: a key/value
    block whose attention a causal rank skips still sends its (zero)
    gradient back around the ring, so every rank runs the same
    collectives in its backward, in the same order."""

    @staticmethod
    def forward(ctx, x, block):
        ctx.shape, ctx.dtype = block.shape, block.dtype
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)


def _blocks(k, v, axis):
    """The key/value blocks a rank holds at each ring step, K and V
    stacked so that one ``ppermute`` moves both; ``(step, src, k, v)``.
    n - 1 rotations: the last block is not sent on."""
    n, idx = axis.size, axis.index
    kv = torch.stack([k, v])
    for j in range(n):
        yield j, (idx - j) % n, kv
        if j < n - 1:
            kv = ppermute(kv, axis, _ring(n))


def ring_attention(q, k, v, axis_name, causal=False, scale=None,
                   mesh=None):
    """The dense ring body over this rank's ``[B, H, T/n, D]`` blocks;
    ``axis_name`` a ``MeshAxis``, or an axis name with ``mesh``."""
    axis = _axis(axis_name, mesh)
    idx = axis.index
    b, h, t_local, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    q32 = q.float()
    q_pos = idx * t_local + torch.arange(t_local, device=q.device)
    acc = torch.zeros((b, h, t_local, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((b, h, t_local), dtype=torch.float32,
                        device=q.device)
    for _, src, kv in _blocks(k, v, axis):
        if causal and src > idx:
            acc = _Touch.apply(acc, kv)
            continue
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kv[0].float()) * scale
        if causal:
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s,
                            torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, kv[1].float())
        m = m_new
    out = acc / torch.clamp(l_sum[..., None], min=1e-30)
    return out.to(q.dtype)


def _merge(o_a, lse_a, o_b, lse_b):
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    den = torch.clamp(wa + wb, min=1e-30)
    o = (o_a * wa[..., None] + o_b * wb[..., None]) / den[..., None]
    return o, m + torch.log(den)


def ring_flash_attention(q, k, v, axis_name, causal=False, scale=None,
                         block_q=512, block_k=512, mesh=None):
    """The ring on B2: ``flash_attention_with_lse`` once per step, merged
    by log-sum-exp; ``axis_name`` a ``MeshAxis``, or an axis name with
    ``mesh``. Launches per call: n non-causal, or ``1 + index`` causal."""
    axis = _axis(axis_name, mesh)
    idx = axis.index
    b, h, t_local, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    o_run = torch.zeros((b, h, t_local, d), dtype=torch.float32,
                        device=q.device)
    lse_run = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32,
                         device=q.device)
    for j, src, kv in _blocks(k, v, axis):
        if causal and j > 0 and src > idx:
            o_run = _Touch.apply(o_run, kv)
            continue
        out_j, lse_j = flash_attention_with_lse(
            q, kv[0], kv[1], causal=causal and j == 0, scale=scale,
            block_q=block_q, block_k=block_k)
        o_run, lse_run = _merge(o_run, lse_run, out_j.float(), lse_j)
    return o_run.to(q.dtype)


def _dense_attention(q, k, v, causal=False, scale=None):
    """Single-device reference path (the degenerate 1-shard ring): the
    flash kernel's plain version."""
    return flash_attention_reference(q, k, v, causal, scale)[0]


def ring_self_attention(q, k, v, mesh=None, seq_axis="sp", batch_axis=None,
                        causal=False, scale=None):
    """Attention of this rank's ``[B, H, T, D]`` q, k, v blocks, their
    sequence split over ``seq_axis`` of ``mesh`` (and the batch over
    ``batch_axis``, which the ring does not read): the fused flash kernel
    when the sequence is not split, else the ring, its body chosen by
    ``set_ring_flash``."""
    size = 1 if mesh is None else dict(mesh.shape).get(seq_axis, 1)
    if size == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    from .. import graphs
    if graphs.capturing():
        raise MXNetError(
            "ring attention runs its collectives between the kernels, "
            "outside any captured graph: do not hybridize a block whose "
            "sequence is split over %r" % seq_axis)
    body = ring_flash_attention if _RING_FLASH[0] else ring_attention
    return body(q, k, v, mesh.axis(seq_axis), causal=causal, scale=scale)


@register("_contrib_ring_attention")
def ring_attention_nd(q, k, v, mesh=None, seq_axis="sp", batch_axis=None,
                      causal=False, scale=None):
    """The ``_contrib_ring_attention`` op (``ring_self_attention`` on
    tensors; ``mx.nd._contrib_ring_attention`` on NDArrays)."""
    return ring_self_attention(q, k, v, mesh=mesh, seq_axis=seq_axis,
                               batch_axis=batch_axis, causal=causal,
                               scale=scale)
