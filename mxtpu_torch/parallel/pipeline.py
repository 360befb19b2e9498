"""Pipeline parallelism: a homogeneous layer stack over a ``pipe`` mesh
axis (counterpart of ``mxtpu/parallel/pipeline.py``).

GPipe fill-drain, as the reference's: S stages, M microbatches, S - 1 + M
ticks. At each tick every stage runs ``layer_fn`` over its ``L / S``
layers on what it holds (stage 0 on the next microbatch), and sends the
result to the next stage with ``ppermute``. The last stage finishes
microbatch j at tick j + S - 1; its outputs are summed over the axis
through ``reduce_from`` (the other stages contribute zeros), so every rank
holds the whole output and the caller's loss, the same on every rank,
counts each gradient once. Autograd runs the backward through the
permutes in reverse.

Every rank of the axis computes the same loss, so its gradients must be
whole, as the reference's ``jax.grad`` of the global arrays is: ``x`` and
each of ``stacked_params`` enter through ``copy_to``, whose backward sums
over the axis the parts each stage computes (stage 0's gradient of ``x``,
each stage's rows of the stack). A parameter upstream of the pipeline
(an embedding) and every row of the stack then take the same whole
gradient on every rank, and ``ShardedTrainStep`` sums nothing more over
the axis. A stack held as ``P("pipe")`` shards and read whole through
``gather_from`` takes its shard's whole gradient the same way.

``stacked_params`` is a dict of tensors with a leading layer axis of L
(a multiple of S), the same on every rank; a rank computes with its
stage's rows. ``x`` is the whole batch, the same on every rank; with
``batch_axis`` each rank of that axis runs its rows of each microbatch
and the output is gathered over it with ``gather_from`` (then the
gradients are this rank's rows' part: sum them over ``batch_axis`` as over
a data axis). Every stage builds the same graph (the stage picks its
input with ``where``), so the ranks make their collectives, backward
included, in one order.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .collectives import copy_to, gather_from, ppermute, reduce_from

__all__ = ["pipeline_apply"]


def pipeline_apply(layer_fn, stacked_params, x, mesh, axis="pipe",
                   num_microbatches=None, batch_axis=None):
    """Apply the stacked layer sequence to ``x``, pipelined over ``axis``
    (module docstring). ``layer_fn(params_i, h) -> y`` keeps the shape of
    ``h``; ``params_i`` maps each key of ``stacked_params`` to one
    layer's row. Returns the output for the whole batch, ordered like
    ``x``."""
    n_stages = mesh.shape[axis]
    n_layers = next(iter(stacked_params.values())).shape[0]
    if n_layers % n_stages:
        raise MXNetError("n_layers (%d) must divide over the %r axis (%d)"
                         % (n_layers, axis, n_stages))
    m = n_stages if num_microbatches is None else int(num_microbatches)
    if m < 1:
        raise MXNetError("num_microbatches must be >= 1, got %d" % m)
    if x.shape[0] % m:
        raise MXNetError("batch %d not divisible into %d microbatches"
                         % (x.shape[0], m))
    pipe = mesh.axis(axis) if n_stages > 1 else None
    stage = 0 if pipe is None else pipe.index
    per = n_layers // n_stages
    if pipe is not None:
        stacked_params = {k: copy_to(v, pipe)
                          for k, v in stacked_params.items()}
        x = copy_to(x, pipe)
    rows = [{k: v[stage * per + j] for k, v in stacked_params.items()}
            for j in range(per)]
    xs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    batch = None
    if batch_axis is not None and mesh.shape[batch_axis] > 1:
        batch = mesh.axis(batch_axis)
        mb = xs.shape[1]
        if mb % batch.size:
            raise MXNetError("microbatch %d does not divide the %r axis "
                             "(%d)" % (mb, batch_axis, batch.size))
        k = mb // batch.size
        xs = xs[:, batch.index * k:(batch.index + 1) * k]

    def apply_stage(h):
        for p in rows:
            h = layer_fn(p, h)
        return h

    perm = [(i, i + 1) for i in range(n_stages - 1)]
    zero = torch.zeros_like(xs[0])
    first = torch.tensor(stage == 0, device=xs.device)
    last = torch.tensor(stage == n_stages - 1, device=xs.device)
    state = zero
    done = []
    # the same ops on every stage (the reference's where), so that every
    # rank's backward makes every collective's call in the same order
    for t in range(m + n_stages - 1):
        y = apply_stage(torch.where(first, xs[t] if t < m else zero, state))
        if t >= n_stages - 1:
            done.append(torch.where(last, y, zero))
        if pipe is not None and t < m + n_stages - 2:
            state = ppermute(y, pipe, perm)
    out = torch.stack(done)
    if pipe is not None:
        out = reduce_from(out, pipe)
    if batch is not None:
        out = gather_from(out, batch, dim=1)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))
