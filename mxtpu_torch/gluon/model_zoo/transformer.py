"""Transformer language model (counterpart of
``mxtpu/gluon/model_zoo/transformer.py``).

A pre-norm trunk: token and position embeddings, N blocks of
``x + attn(ln(x))`` and ``x + mlp(ln(x))``, a final LayerNorm and a vocab
head. ``causal=False`` is the bidirectional (BERT-style encoder) variant.
Parameter names equal the JAX package's (``wte_``, ``wpe_``, ``h_``,
``attn_``, ``qkv_``, ``proj_``, ``mlp1_``, ``mlp2_``, ``head_``), so
``convert.load_mxtpu_params`` carries its weights.

Attention runs through ``parallel.ring_attention.ring_attention_nd``:
the flash kernel on one rank, the ring when ``mesh`` splits the sequence
over ``seq_axis``. Then each rank takes its block of the tokens ``[B,
T/n]`` and offsets its positions by its block's start (the reference's
trace sees the global T).

``num_experts > 0`` puts a Switch mixture of experts (``SwitchMoE``,
``moe_``) in every block in place of the MLP. The model's forward then
sums the blocks' load-balancing losses as a second output of its own (so
a hybridized model's captured pair returns it, and ``0.01 * aux`` reaches
the router's gradient) and returns the logits; ``aux_loss()`` reads that
sum. ``tensor_parallel_rules`` and ``expert_parallel_rules`` are the
reference's ``param_specs`` rules, as tuples (``parallel.P``).
"""
from __future__ import annotations

from ...base import MXNetError
from ...parallel.mesh import P
from ...parallel.ring_attention import ring_attention_nd
from ..block import HybridBlock
from .. import nn

__all__ = ["TransformerLM", "TransformerBlock", "MultiHeadSelfAttention",
           "tensor_parallel_rules", "expert_parallel_rules"]


class MultiHeadSelfAttention(HybridBlock):
    """Multi-head self-attention over ``[B, T, C]`` (causal by default)."""

    def __init__(self, dim, num_heads, mesh=None, seq_axis="sp",
                 batch_axis="data", causal=True, **kwargs):
        super().__init__(**kwargs)
        if dim % num_heads:
            raise MXNetError("dim %d not divisible by num_heads %d"
                             % (dim, num_heads))
        self._dim = dim
        self._heads = num_heads
        self._mesh = mesh
        self._seq_axis = seq_axis
        self._batch_axis = batch_axis
        self._causal = causal
        with self.name_scope():
            self.qkv = nn.Dense(3 * dim, use_bias=False, flatten=False,
                                prefix="qkv_")
            self.proj = nn.Dense(dim, use_bias=False, flatten=False,
                                 prefix="proj_")

    def hybrid_forward(self, F, x):
        b, t, _ = x.shape
        h, d = self._heads, self._dim // self._heads
        qkv = self.qkv(x)                                  # [B, T, 3C]
        qkv = F.reshape(qkv, (b, t, 3, h, d))
        qkv = F.transpose(qkv, (2, 0, 3, 1, 4))            # [3, B, H, T, D]
        q, k, v = qkv[0], qkv[1], qkv[2]                   # strided views
        out = ring_attention_nd(q, k, v, mesh=self._mesh,
                                seq_axis=self._seq_axis,
                                batch_axis=self._batch_axis,
                                causal=self._causal)       # [B, H, T, D]
        out = F.reshape(F.transpose(out, (0, 2, 1, 3)), (b, t, self._dim))
        return self.proj(out)


class TransformerBlock(HybridBlock):
    """Pre-norm block: x + attn(ln(x)); x + mlp(ln(x))."""

    def __init__(self, dim, num_heads, hidden_mult=4, mesh=None,
                 seq_axis="sp", batch_axis="data", causal=True,
                 num_experts=0, capacity_factor=1.25, **kwargs):
        super().__init__(**kwargs)
        self._moe = num_experts > 0
        with self.name_scope():
            self.ln1 = nn.LayerNorm()
            self.attn = MultiHeadSelfAttention(
                dim, num_heads, mesh=mesh, seq_axis=seq_axis,
                batch_axis=batch_axis, causal=causal, prefix="attn_")
            self.ln2 = nn.LayerNorm()
            if self._moe:
                from ..contrib.nn import SwitchMoE
                self.moe = SwitchMoE(dim, hidden_mult * dim, num_experts,
                                     capacity_factor=capacity_factor,
                                     prefix="moe_")
            else:
                self.fc1 = nn.Dense(hidden_mult * dim, flatten=False,
                                    activation="relu", prefix="mlp1_")
                self.fc2 = nn.Dense(dim, flatten=False, prefix="mlp2_")

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        if self._moe:
            out, aux = self.moe(self.ln2(x))
            self._last_aux = aux   # summed by TransformerLM's forward
            return x + out
        return x + self.fc2(self.fc1(self.ln2(x)))


class TransformerLM(HybridBlock):
    """Decoder-only LM: embed -> N blocks -> LayerNorm -> vocab head.

    Input: int token ids [B, T]; output: logits [B, T, vocab] in the
    parameters' type. ``causal=False`` gives the bidirectional variant.
    """

    def __init__(self, vocab_size, dim=256, num_heads=8, num_layers=2,
                 max_len=2048, hidden_mult=4, mesh=None, seq_axis="sp",
                 batch_axis="data", causal=True, num_experts=0,
                 capacity_factor=1.25, **kwargs):
        super().__init__(**kwargs)
        self._max_len = max_len
        self._moe = num_experts > 0
        self._aux = None
        self._mesh = mesh
        self._seq_axis = seq_axis
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, dim, prefix="wte_")
            self.pos_embed = nn.Embedding(max_len, dim, prefix="wpe_")
            self.blocks = nn.HybridSequential(prefix="h_")
            with self.blocks.name_scope():
                for _ in range(num_layers):
                    self.blocks.add(TransformerBlock(
                        dim, num_heads, hidden_mult=hidden_mult, mesh=mesh,
                        seq_axis=seq_axis, batch_axis=batch_axis,
                        causal=causal, num_experts=num_experts,
                        capacity_factor=capacity_factor))
            self.ln_f = nn.LayerNorm()
            self.head = nn.Dense(vocab_size, use_bias=False, flatten=False,
                                 prefix="head_")

    def _seq_block(self):
        """(this rank's block index, the number of blocks) of the
        sequence."""
        if self._mesh is None or \
                dict(self._mesh.shape).get(self._seq_axis, 1) == 1:
            return 0, 1
        axis = self._mesh.axis(self._seq_axis)
        return axis.index, axis.size

    def hybrid_forward(self, F, tokens):
        t = tokens.shape[-1]
        index, n = self._seq_block()
        if t * n > self._max_len:
            raise MXNetError(
                "sequence length %d exceeds max_len %d (positions would be "
                "clamped to the last positional embedding)"
                % (t * n, self._max_len))
        pos = F.arange(index * t, (index + 1) * t, dtype="int32",
                       ctx=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos)
        x = self.blocks(x)
        logits = self.head(self.ln_f(x))
        if not self._moe:
            return logits
        aux = None
        for blk in self.blocks:
            aux = blk._last_aux if aux is None else aux + blk._last_aux
        return logits, aux

    def forward(self, *args):
        """The logits; a MoE model keeps its forward's summed aux loss for
        ``aux_loss()`` (an NDArray where the call took NDArrays)."""
        from ... import graphs
        from ...ndarray import NDArray
        out = super().forward(*args)
        if isinstance(out, tuple):   # the MoE trunk's (logits, aux)
            out, aux = out
            self._aux = (aux, graphs.capturing())
        elif isinstance(out, NDArray) and self._aux is not None \
                and not isinstance(self._aux[0], NDArray):
            self._aux = (NDArray(self._aux[0]), self._aux[1])
        return out

    def aux_loss(self):
        """The sum of the blocks' Switch load-balancing losses of the last
        forward (0.0 for the dense model). Add it scaled by your alpha.
        Raises before any forward, and where the last forward ran inside
        another block's capture (its value is the capture's, not the
        replay's: the reference's stale trace-time value)."""
        if not self._moe:
            return 0.0
        if self._aux is None:
            raise MXNetError(
                "aux_loss() before any forward: no load-balancing loss has "
                "been recorded yet")
        aux, stale = self._aux
        if stale:
            raise MXNetError(
                "aux_loss() on a hybridized MoE TransformerLM would return "
                "a stale trace-time value; compute the loss inside the "
                "traced forward (use the SwitchMoE layer's (out, aux) "
                "return) or call aux_loss() before hybridize()")
        return aux


def tensor_parallel_rules(model_axis="model"):
    """``param_specs`` rules sharding the projections over the model axis
    (Dense weights are ``[units, in]``: dim 0 column-parallel, dim 1
    row-parallel), the reference's patterns."""
    return [
        (r".*qkv_weight", P(model_axis, None)),
        (r".*proj_weight", P(None, model_axis)),
        (r".*mlp1_weight", P(model_axis, None)),
        (r".*mlp2_weight", P(None, model_axis)),
        (r".*head_weight", P(model_axis, None)),
        (r".*wte_weight", P(None, model_axis)),
    ]


def expert_parallel_rules(expert_axis="expert"):
    """``param_specs`` rules for the MoE variant: the expert-stacked FFN
    weights shard on their leading E axis."""
    return [
        (r".*moe_w1", P(expert_axis)),
        (r".*moe_b1", P(expert_axis)),
        (r".*moe_w2", P(expert_axis)),
        (r".*moe_b2", P(expert_axis)),
    ]
