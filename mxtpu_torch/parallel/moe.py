"""Switch (top-1) mixture of experts (counterpart of
``mxtpu/parallel/moe.py``), and its expert-parallel form.

Routing as the reference's: top-1 over the softmax of ``x @ router_w``;
each expert takes at most ``cap = ceil(T * capacity_factor / E)`` tokens in
token order, a token over capacity gives zeros (the surrounding block's
residual carries it); the load-balancing loss is ``aux = E * sum_e
fraction_e * mean_prob_e`` (Switch Transformer, arXiv:2101.03961).

A token's slot in its expert's queue is counted in int32. The reference
counts it as a cumulative sum in the input's dtype, and bfloat16 holds
integers exactly only up to 256: above that two tokens round to one slot
and are summed into it. The port does not copy that; in float32 the two
agree.

``switch_ffn`` dispatches by index into an ``(E, C + 1, D)`` buffer whose
last slot takes the dropped tokens (static shapes, so a training step can
be captured), runs the experts as ``torch.bmm`` over ``(E, C, .)`` and
combines by index, times the gate. Each of the reference's one-hot
einsums has a single nonzero term per sum, so in float32 this is the same
arithmetic. ``switch_ffn_reference`` is the reference's dense ``(T, E, C)``
einsums with exact slots; the tests hold the main path against it.

Expert parallelism (``switch_ffn`` with an ``expert_axis``; ``SwitchMoE``
passes it when ``ShardedTrainStep`` holds its expert weights sharded over
an expert axis): each rank of an expert group holds the same tokens (its data
shard), routes them identically, runs only its ``E / n`` experts, and the
partial outputs are summed through ``reduce_from``; the tokens and gates
enter through ``copy_to``, so each rank's loss counts every gradient once.
The reference's step sees the global batch, so two quantities are global
over the data axis:

* slots are taken in the global token order: this rank's slots are offset
  by the per-expert counts of the data ranks before it (an all-gather of
  the counts), and ``cap`` comes from the global T;
* ``fraction`` and ``mean_prob`` are means over the global batch: each is
  ``pmean``-ed over the data axis before their product.

Those collectives run in the forward, so a captured graph cannot hold
them: ``switch_ffn`` over an axis of more than one rank raises under a
capture.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.registry import register
from .collectives import all_gather, copy_to, pmean, reduce_from

__all__ = ["switch_ffn", "switch_ffn_reference", "shard_experts",
           "switch_moe"]


def capacity(tokens, num_experts, capacity_factor):
    """Each expert's capacity, the reference's ``ceil(T * factor / E)``
    (computed on the host from the shapes)."""
    return int(-(-tokens * capacity_factor // num_experts))


def _route(x, router_w):
    probs = torch.softmax(x @ router_w, dim=-1)
    gate, expert = torch.max(probs, dim=-1)
    return probs, gate, expert


def _onehot(expert, e):
    """(E, T) int32, tokens along the contiguous axis (a comparison, since
    ``F.one_hot`` checks its values on the host)."""
    return (expert[None, :] == torch.arange(
        e, device=expert.device)[:, None]).to(torch.int32)


def slots(expert, num_experts):
    """Each token's position in its expert's queue, in token order
    (int32, exact at any T). The count runs along the contiguous T axis of
    (E, T): a scan down the T rows of (T, E) is a sequential kernel on the
    card (7.5 of a 14.8 ms served forward)."""
    onehot = _onehot(expert, num_experts)
    pos = torch.cumsum(onehot, 1, dtype=torch.int32) * onehot
    return pos.sum(0, dtype=torch.int32) - 1


def _aux(probs, expert, e, data=None):
    fraction = _onehot(expert, e).float().mean(1)
    mean_prob = probs.float().mean(0)
    if data is not None and data.size > 1:
        fraction = pmean(fraction, data)
        mean_prob = pmean(mean_prob, data)
    return (e * torch.sum(fraction * mean_prob)).to(probs.dtype)


def _experts(x, gate, expert, slot, keep, cap, w1, b1, w2, b2):
    """Dispatch each kept token into ``(E, cap + 1, D)`` (its expert, its
    slot; a dropped token into the last slot), run the experts over the
    first ``cap`` slots, combine by index times the gate (a dropped token
    reads a zero row)."""
    e, d = w1.shape[0], x.shape[1]
    idx = torch.where(keep, slot, torch.full_like(slot, cap)).long()
    flat = expert.long() * (cap + 1) + idx     # row of (E * (cap + 1), D)
    buf = x.new_zeros((e * (cap + 1), d)).index_put((flat,), x) \
        .view(e, cap + 1, d)
    h = torch.relu(torch.bmm(buf[:, :cap], w1) + b1[:, None, :])
    out = torch.bmm(h, w2) + b2[:, None, :]
    out = torch.cat([out, out.new_zeros((e, 1, d))], 1)
    # a gather whose backward is an index_add (the dropped tokens' rows
    # all read the zero row)
    return out.view(e * (cap + 1), d).index_select(0, flat) * gate[:, None]


def switch_ffn(x, router_w, w1, b1, w2, b2, capacity_factor=1.25,
               expert_axis=None, data_axis=None):
    """Top-1 switch FFN: ``x (T, D)``, ``router_w (D, E)``, ``w1 (E, D,
    H)``, ``b1 (E, H)``, ``w2 (E, H, D)``, ``b2 (E, D)``. Returns ``(out
    (T, D), aux)`` (module docstring). Expert parallel: ``w1``, ``b1``,
    ``w2``, ``b2`` are this rank's ``E / n`` experts of ``expert_axis`` (a
    ``MeshAxis``), ``x`` its shard of ``data_axis``; the whole ``(out,
    aux)`` comes back on every rank of the expert axis. An axis of one
    rank, or None, runs no collective."""
    e = router_w.shape[1]
    ep = expert_axis if expert_axis is not None and expert_axis.size > 1 \
        else None
    dp = data_axis if data_axis is not None and data_axis.size > 1 else None
    if ep is not None or dp is not None:
        from .. import graphs
        if graphs.capturing():
            raise MXNetError(
                "switch_ffn over an expert or data axis runs collectives, "
                "which run outside any captured graph: do not hybridize a "
                "block whose experts are sharded by param_specs")
    cap = capacity(x.shape[0] * (1 if dp is None else dp.size), e,
                   capacity_factor)
    probs, gate, expert = _route(x, router_w)
    slot = slots(expert, e)
    if dp is not None:
        counts = _onehot(expert, e).sum(1, dtype=torch.int32)
        before = all_gather(counts[None], dp)[:dp.index]
        slot = slot + before.sum(0, dtype=torch.int32)[expert.long()]
    keep = slot < cap
    if ep is not None:
        e_local = w1.shape[0]
        if e_local * ep.size != e:
            raise MXNetError("switch_ffn: %d experts on each of %d ranks, "
                             "the router has %d" % (e_local, ep.size, e))
        lo = ep.index * e_local
        mine = (expert >= lo) & (expert < lo + e_local)
        keep = keep & mine
        expert_here = torch.where(mine, expert - lo, torch.zeros_like(expert))
        out = _experts(copy_to(x, ep), copy_to(gate, ep), expert_here, slot,
                       keep, cap, w1, b1, w2, b2)
        out = reduce_from(out, ep)
    else:
        out = _experts(x, gate, expert, slot, keep, cap, w1, b1, w2, b2)
    return out, _aux(probs, expert, e, dp)


def switch_ffn_reference(x, router_w, w1, b1, w2, b2, capacity_factor=1.25):
    """The reference's dense formulation, ``(T, E, C)`` dispatch and
    combine einsums, with int32 slots."""
    t = x.shape[0]
    e = router_w.shape[1]
    cap = capacity(t, e, capacity_factor)
    probs, gate, expert = _route(x, router_w)
    slot = slots(expert, e)
    keep = (slot < cap)[:, None] & (_onehot(expert, e).t() > 0)
    pos = torch.where(slot < cap, slot, torch.zeros_like(slot))
    slot1h = (pos[:, None] == torch.arange(cap, device=x.device)).to(x.dtype)
    dispatch = keep.to(x.dtype)[:, :, None] * slot1h[:, None, :]
    xin = torch.einsum("tec,td->ecd", dispatch, x)
    h = torch.relu(torch.einsum("ecd,edh->ech", xin, w1) + b1[:, None, :])
    xout = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    combine = dispatch * gate[:, None, None]
    out = torch.einsum("tec,ecd->td", combine, xout)
    return out, _aux(probs, expert, e)


@register("_contrib_switch_moe", aliases=("switch_moe",), num_outputs=2)
def switch_moe(data, router, w1, b1, w2, b2, capacity_factor=1.25):
    """The ``_contrib_switch_moe`` op: ``data (..., D)`` flattened to
    tokens through ``switch_ffn``; returns ``(out, aux_loss)``."""
    dim = data.shape[-1]
    out, aux = switch_ffn(data.reshape(-1, dim), router, w1, b1, w2, b2,
                          capacity_factor=capacity_factor)
    return out.reshape(data.shape), aux


def shard_experts(params, mesh, num_experts, expert_axis="expert"):
    """This rank's experts of ``params`` (a dict, list or tuple of tensors
    or numpy arrays, nested): a leaf of two or more dimensions whose dim 0
    equals ``num_experts`` is cut to this rank's block over
    ``expert_axis``; other leaves (the router) stay whole."""
    if expert_axis not in mesh.shape:
        raise MXNetError("mesh has no %r axis; axes: %s"
                         % (expert_axis, tuple(mesh.shape)))
    size = mesh.shape[expert_axis]
    if num_experts % size:
        raise MXNetError("num_experts (%d) must divide over the %r axis "
                         "(%d)" % (num_experts, expert_axis, size))
    k = num_experts // size
    index = mesh.axis(expert_axis).index if size > 1 else 0

    def place(leaf):
        if isinstance(leaf, dict):
            return {key: place(v) for key, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(place(v) for v in leaf)
        if len(leaf.shape) >= 2 and leaf.shape[0] == num_experts:
            return leaf[index * k:(index + 1) * k]
        return leaf
    return place(params)
