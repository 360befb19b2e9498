"""Contrib layers (counterpart of ``mxtpu/gluon/contrib/nn``):
``Concurrent``, ``HybridConcurrent`` and ``Identity`` are Gluon's own
layers; ``SyncBatchNorm`` takes its batch statistics over the ranks of a
mesh axis (or the world); ``SparseEmbedding`` (row-sparse gradients) and
``SwitchMoE`` are not ported yet and raise naming their ROADMAP items."""
import torch

from .... import autograd
from ....base import MXNetError
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

SwitchMoE = _not_ported("SwitchMoE", "A10", "the mixture-of-experts layers")
