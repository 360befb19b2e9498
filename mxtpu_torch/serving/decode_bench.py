"""The decode workload's model, engine builder and requests (the port's copy
of ``tools/serve_bench.py:build_decode_model``, ``build_decode_engine`` and
``_decode_workload``), shared by the tests and ``chip_smoke.py``.

``TinyCausalLM`` is the executable reference of the
:class:`~mxtpu_torch.serving.decode.DecodeModel` contract: a single-head
causal-attention LM whose prefill returns ``(logits[b, s, V], k[b, s, d],
v[b, s, d])`` and whose ``decode_step`` attends the cache rows before
``pos`` and this token's own row, returning the new k/v rows for the
engine to persist. Its parameters carry the reference's names (``embed``,
``posemb``, ``wq``, ``wk``, ``wv``, ``wo``, ``wout`` under the prefix
``decodebench_``), so ``convert.load_mxtpu_params`` loads the JAX
package's weights unchanged.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..context import cpu
from ..gluon.block import HybridBlock, read_params
from .decode import DecodeEngine, DecodeModel
from .engine import BucketSpec

__all__ = ["TinyCausalLM", "build_decode_model", "build_decode_engine",
           "decode_workload"]

_MASKED = -1e30


class TinyCausalLM(HybridBlock, DecodeModel):
    """One causal attention head over token and position embeddings, a
    residual and an output projection (see the module docstring)."""

    def __init__(self, vocab, dim, max_len, **kwargs):
        super().__init__(**kwargs)
        self._dim = int(dim)
        self._max_len = int(max_len)
        with self.name_scope():
            self.embed = self.params.get("embed", shape=(vocab, dim))
            self.posemb = self.params.get("posemb", shape=(max_len, dim))
            self.wq = self.params.get("wq", shape=(dim, dim))
            self.wk = self.params.get("wk", shape=(dim, dim))
            self.wv = self.params.get("wv", shape=(dim, dim))
            self.wo = self.params.get("wo", shape=(dim, dim))
            self.wout = self.params.get("wout", shape=(dim, vocab))

    def hybrid_forward(self, F, tokens, embed, posemb, wq, wk, wv, wo, wout):
        t = tokens.long()
        s = t.shape[1]
        x = embed[t] + posemb[:s][None]
        q, k, v = x @ wq, x @ wk, x @ wv
        scores = torch.einsum("bsd,btd->bst", q, k) / float(self._dim) ** 0.5
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask[None], scores, _MASKED)
        h = torch.einsum("bst,btd->bsd", torch.softmax(scores, dim=-1),
                         v) @ wo
        return (x + h) @ wout, k, v

    def decode_step(self, kv, tok, pos):
        p = read_params(self)
        k_cache, v_cache = kv                            # [c, L, d]
        L = k_cache.shape[1]
        pos = pos.long()
        x = p["embed"][tok.long()] + p["posemb"][pos]    # [c, d]
        q = x @ p["wq"]
        k_new, v_new = x @ p["wk"], x @ p["wv"]
        scale = float(self._dim) ** 0.5
        # the cache rows before pos, then this token's own row (the
        # reference writes it at pos and masks past it: the same terms)
        sc = torch.einsum("cd,cld->cl", q, k_cache) / scale
        sc = torch.where(torch.arange(L, device=x.device)[None, :]
                         < pos[:, None], sc, _MASKED)
        sn = (q * k_new).sum(dim=-1, keepdim=True) / scale
        attn = torch.softmax(torch.cat([sc, sn], dim=-1), dim=-1)
        h = (torch.einsum("cl,cld->cd", attn[:, :L], v_cache)
             + attn[:, L:] * v_new) @ p["wo"]
        return (x + h) @ p["wout"], [k_new, v_new]

    def decode_chunk(self, kv, toks, pos):
        # the speculative verify's fast path: queries attend cache rows
        # before pos plus the chunk's own earlier rows (causal)
        p = read_params(self)
        k_cache, v_cache = kv                            # [c, L, d]
        L, t = k_cache.shape[1], toks.shape[1]
        dev = k_cache.device
        pw = pos.long()[:, None] + torch.arange(t, device=dev)[None]
        x = p["embed"][toks.long()] \
            + p["posemb"][pw.clamp(max=self._max_len - 1)]   # [c, t, d]
        q = x @ p["wq"]
        k_new, v_new = x @ p["wk"], x @ p["wv"]
        scale = float(self._dim) ** 0.5
        sc = torch.einsum("ctd,cld->ctl", q, k_cache) / scale
        sc = torch.where(torch.arange(L, device=dev)[None, None, :]
                         < pos.long()[:, None, None], sc, _MASKED)
        sn = torch.einsum("ctd,cud->ctu", q, k_new) / scale
        causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        sn = torch.where(causal[None], sn, _MASKED)
        attn = torch.softmax(torch.cat([sc, sn], dim=-1), dim=-1)
        h = (torch.einsum("ctl,cld->ctd", attn[..., :L], v_cache)
             + torch.einsum("ctu,cud->ctd", attn[..., L:], v_new)) @ p["wo"]
        return (x + h) @ p["wout"], [k_new, v_new]


def build_decode_model(vocab=96, dim=32, max_len=96, seed=0):
    """A ``TinyCausalLM`` on the host with seeded weights: each parameter,
    in declaration order, drawn from N(0, 0.5²) by one
    ``numpy.random.RandomState(seed)`` (the reference's ``Normal(0.5)``
    initializer; JAX's keys give other numbers from one seed, so a parity
    check loads the JAX weights with ``convert.load_mxtpu_params``)."""
    net = TinyCausalLM(vocab, dim, max_len, prefix="decodebench_")
    net.initialize(ctx=cpu())
    rng = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(rng.normal(0.0, 0.5, p.shape).astype(np.float32))
    return net


def build_decode_engine(model, slots=4, max_prompt=24, max_new=24,
                        int8=False, continuous=True, accountant=None,
                        start=False, clock=time.monotonic, page_tokens=0,
                        pool_pages=None, prefix_cache=False,
                        draft_model=None, spec_k=0, device=None):
    """A warmed DecodeEngine over the model: prefill seq buckets
    ``max(4, max_prompt // 2)`` and ``max_prompt``, a pow2 cohort ladder up
    to ``slots``, cache length ``max_prompt + max_new``; ``page_tokens`` >
    0 for paged KV (with ``pool_pages``, the prefix cache or a draft)."""
    pspec = BucketSpec([1], seq_lens=[max(4, max_prompt // 2), max_prompt])
    dspec = BucketSpec.pow2(decode_slots=slots)
    return DecodeEngine(model, pspec, dspec, max_len=max_prompt + max_new,
                        int8=int8, continuous=continuous,
                        accountant=accountant, warmup=True, start=start,
                        clock=clock, page_tokens=page_tokens,
                        pool_pages=pool_pages, prefix_cache=prefix_cache,
                        draft_model=draft_model, spec_k=spec_k,
                        device=device)


def decode_workload(n_requests, vocab, max_prompt, max_new, seed=11):
    """``(prompt, max_new)`` pairs of varied lengths (prompts of 3 to
    ``max_prompt`` - 1 tokens, budgets of 2 to ``max_new``): the regime
    where continuous batching saves the steps a restart-per-batch cohort
    spends on finished slots."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        prompt = rng.randint(0, vocab,
                             size=rng.randint(3, max_prompt)).astype(np.int32)
        reqs.append((prompt, int(rng.randint(2, max_new + 1))))
    return reqs
