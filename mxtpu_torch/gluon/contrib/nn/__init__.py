"""Contrib layers (counterpart of ``mxtpu/gluon/contrib/nn``):
``Concurrent``, ``HybridConcurrent`` and ``Identity`` are Gluon's own
layers; ``SyncBatchNorm`` takes its batch statistics over the ranks of a
mesh axis (or the world); ``SwitchMoE`` is the top-1 mixture of experts
(``parallel.moe``); ``SparseEmbedding`` (row-sparse gradients) is not
ported yet and raises naming its ROADMAP item."""
import torch

from .... import autograd
from ....base import MXNetError
from ...block import HybridBlock
from ...nn import BatchNorm, Concurrent, HybridConcurrent, Identity

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "SwitchMoE"]


def _not_ported(name, item, what):
    def __init__(self, *args, **kwargs):
        raise MXNetError("%s is not ported yet: it needs %s (ROADMAP %s)"
                         % (name, what, item))
    return type(name, (), {"__init__": __init__,
                           "__doc__": "Not ported yet (ROADMAP %s)." % item})


SparseEmbedding = _not_ported("SparseEmbedding", "A10",
                              "row-sparse gradients")


class SyncBatchNorm(BatchNorm):
    """BatchNorm whose batch statistics are those of the batch across the
    ranks (ref: contrib SyncBatchNorm; in the reference, plain BatchNorm
    over a mesh-sharded batch). Channels on axis 1. ``mesh``/``axis``
    name the ranks (default: every rank of the process group, or this
    process alone outside one); ``num_devices`` is accepted and ignored,
    as the reference's. In training mode each rank sums its float32
    ``x`` and ``x^2`` per channel and its count, the sums go through a
    differentiable ``psum``, and ``mean = E[x]``, ``var = max(E[x^2] -
    mean^2, 0)`` as BatchNorm's one-pass form; the moving statistics move
    toward them as BatchNorm's do."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", mesh=None,
                 axis="data", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._mesh = mesh
        self._mesh_axis = axis

    def _axis_of_ranks(self):
        from ....parallel.mesh import world_axis
        if self._mesh is not None:
            return self._mesh.axis(self._mesh_axis)
        return world_axis()

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        kw = self._kwargs
        if not autograd.is_training() or kw["use_global_stats"]:
            return super().hybrid_forward(F, x, gamma, beta, running_mean,
                                          running_var)
        from ....parallel.collectives import psum
        x32 = x.float()
        red = [i for i in range(x.ndim) if i != 1]
        count = torch.tensor([float(x32.numel() // x32.shape[1])],
                             device=x.device)
        sums = torch.cat([x32.sum(dim=red), x32.square().sum(dim=red),
                          count])
        axis = self._axis_of_ranks()
        if axis.size > 1:
            sums = psum(sums, axis)
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp_min(sums[c:2 * c] / n - mean.square(), 0.0)
        shape = [1] * x.ndim
        shape[1] = c
        g = torch.ones_like(gamma) if kw["fix_gamma"] else gamma
        inv = torch.rsqrt(var + kw["eps"])
        out = (x32 - mean.reshape(shape)) * (inv * g.float()).reshape(shape) \
            + beta.float().reshape(shape)
        m = self._momentum
        self.running_mean._update_aux(running_mean * m
                                      + mean.detach() * (1 - m))
        self.running_var._update_aux(running_var * m
                                     + var.detach() * (1 - m))
        return out.to(x.dtype)

    def __repr__(self):
        return "SyncBatchNorm(eps={}, momentum={}, in_channels={})".format(
            self._kwargs["eps"], self._momentum, self.gamma.shape[0])


class SwitchMoE(HybridBlock):
    """Top-1 switch mixture-of-experts FFN layer (ref: contrib
    ``SwitchMoE``): a router ``(dim, E)`` and E expert FFNs ``w1 (E, dim,
    hidden)``, ``b1``, ``w2 (E, hidden, dim)``, ``b2``, through the
    ``_contrib_switch_moe`` op. Input ``(..., dim)`` is flattened to
    tokens and restored; returns ``(out, aux_loss)``, the Switch
    load-balancing loss a real second output.

    When ``ShardedTrainStep`` holds the expert weights as this rank's
    shard of an expert axis (``expert_parallel_rules``), the layer runs
    its experts only (``parallel.moe.switch_ffn`` over the expert axis),
    and ``ShardedTrainStep`` leaves its parameters to it
    (``_reads_shards``)."""

    _reads_shards = True

    def __init__(self, dim, hidden, num_experts, capacity_factor=1.25,
                 **kwargs):
        super().__init__(**kwargs)
        self._dim, self._hidden = dim, hidden
        self._num_experts = num_experts
        self._capacity_factor = capacity_factor
        with self.name_scope():
            self.router = self.params.get("router", shape=(dim, num_experts))
            self.w1 = self.params.get("w1", shape=(num_experts, dim, hidden))
            self.b1 = self.params.get("b1", shape=(num_experts, hidden),
                                      init="zeros")
            self.w2 = self.params.get("w2", shape=(num_experts, hidden, dim))
            self.b2 = self.params.get("b2", shape=(num_experts, dim),
                                      init="zeros")

    def hybrid_forward(self, F, x, router, w1, b1, w2, b2):
        if x.shape[-1] != self._dim:
            raise ValueError(
                "SwitchMoE(dim=%d) got input with last axis %d"
                % (self._dim, x.shape[-1]))
        from ....parallel import train as _train
        from ....parallel.moe import switch_ffn
        router = _train.read_whole(self.router, router)
        place = _train.placement(self.w1)
        if place is not None and place.spec[0] is not None:
            # the experts split over an axis: this rank's experts only
            data = place.data_axis
            out, aux = switch_ffn(
                x.reshape(-1, self._dim), router, w1, b1, w2, b2,
                capacity_factor=self._capacity_factor,
                expert_axis=place.mesh.axis(place.spec[0]),
                data_axis=None if data is None else place.mesh.axis(data))
            return out.reshape(x.shape), aux
        w1, b1, w2, b2 = (_train.read_whole(p, t) for p, t in zip(
            (self.w1, self.b1, self.w2, self.b2), (w1, b1, w2, b2)))
        return F._contrib_switch_moe(x, router, w1, b1, w2, b2,
                                     capacity_factor=self._capacity_factor)

    def __repr__(self):
        return "SwitchMoE(dim=%d, hidden=%d, experts=%d)" % (
            self._dim, self._hidden, self._num_experts)
