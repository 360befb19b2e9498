"""Ops behind the subgraph/partition framework (counterpart of
``mxtpu/ops/subgraph_ops.py``; symbol/subgraph.py makes the nodes).

* ``_subgraph_exec`` runs a serialized sub-symbol INLINE, in predict and
  training mode alike; only the parsed sub-symbol is cached. (The
  reference gives each region its own jit in predict mode; inside the
  port's executor a region is part of the outer captured CUDA graph, as a
  capture cannot nest, and the numbers are the same.)
* ``_sg_flash_attention``, the node ``FlashAttentionProperty`` puts in
  place of a matched softmax(QK^T * scale)V chain: q/k/v go to the flash
  kernel (``pallas/flash_attention.py``).
"""
from __future__ import annotations

from .registry import register

__all__ = ["subgraph_exec", "sg_flash_attention"]

# subgraph_json -> parsed Symbol
_SUBGRAPH_CACHE = {}


def _load_sym(subgraph_json):
    hit = _SUBGRAPH_CACHE.get(subgraph_json)
    if hit is None:
        from ..symbol.symbol import load_json
        hit = _SUBGRAPH_CACHE[subgraph_json] = load_json(subgraph_json)
    return hit


@register("_subgraph_exec")
def subgraph_exec(*inputs, subgraph_json=None, input_names=(), n_outputs=1):
    """Execute a partitioned region inline. Training-mode BatchNorm inside
    it normalizes by the batch statistics (the mode is read at call time),
    but its moving statistics are not written back: partition for
    deployment, not for statistics-updating training (the reference's
    default property has the same blind spot: aux writes stay inside the
    CachedOp)."""
    outs = _load_sym(subgraph_json)._execute(dict(zip(input_names, inputs)))
    return outs if int(n_outputs) > 1 else outs[0]


@register("_sg_flash_attention")
def sg_flash_attention(q, k, v, scale=1.0, transpose_b=False):
    """The matched attention chain on the flash kernel.

    q: [B, T, D]; k: [B, T, D] if the matched batch_dot had transpose_b,
    else [B, D, T]; v: [B, T, D]. The matched pattern scaled the scores
    before the softmax, so ``scale`` goes to the kernel as it is. On a CUDA
    tensor this is B2's kernel forward (its gradient ``_Flash``'s)."""
    from .pallas.flash_attention import flash_attention

    if not transpose_b:
        k = k.transpose(1, 2)
    out = flash_attention(q[:, None], k[:, None], v[:, None], causal=False,
                          scale=float(scale))
    return out[:, 0]
