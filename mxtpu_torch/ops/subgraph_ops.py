"""Ops behind the subgraph/partition framework (counterpart of
``mxtpu/ops/subgraph_ops.py``; symbol/subgraph.py makes the nodes).

* ``_subgraph_exec`` runs a serialized sub-symbol INLINE, in predict and
  training mode alike; only the parsed sub-symbol is cached, in the
  compile service at site ``subgraph_exec`` (keyed by the JSON's digest,
  under its LRU bound; nothing goes to disk). (The
  reference gives each region its own jit in predict mode; inside the
  port's executor a region is part of the outer captured CUDA graph, as a
  capture cannot nest, and the numbers are the same.)
* ``_sg_flash_attention``, the node ``FlashAttentionProperty`` puts in
  place of a matched softmax(QK^T * scale)V chain: q/k/v go to the flash
  kernel (``pallas/flash_attention.py``).
"""
from __future__ import annotations

import hashlib

from .. import compile_service
from .registry import register

__all__ = ["subgraph_exec", "sg_flash_attention"]

# JSON digest -> parsed Symbol: the compile service's subgraph_exec entries
_SUBGRAPH_CACHE = compile_service.SiteTable(
    lambda k: k.site == "subgraph_exec", name=lambda k: k.fn_id)


def _load_sym(subgraph_json):
    from ..symbol.symbol import load_json
    key = compile_service.canonical_key(
        site="subgraph_exec", fn_id="subgraph:" + hashlib.sha256(
            subgraph_json.encode()).hexdigest()[:32], signature=())
    return compile_service.get_or_build(
        key, lambda: load_json(subgraph_json), persist=False,
        provenance={"bytes": len(subgraph_json)}).fn


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
