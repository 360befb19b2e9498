"""Collectives over one mesh axis (the port's counterpart of the
``jax.lax`` collectives that ``mxtpu/parallel`` calls inside
``shard_map``: ``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
``ppermute``, ``axis_index``).

Each takes this rank's value and a ``MeshAxis`` (``mesh.axis(name)``) and
is differentiable, a ``torch.autograd.Function`` whose backward is the
transposed collective: ``psum``'s is ``psum`` (every rank's loss reads
the sum), ``all_gather``'s a reduce-scatter, ``reduce_scatter``'s an
all-gather and ``ppermute``'s the inverse permutation. They are right
where each rank of the axis computes its own part of the loss (the data
and ``sp`` axes). On an axis whose ranks all compute the same loss (a
``model``, ``expert`` or ``pipe`` axis) they would count each gradient once
per rank; there Megatron's conjugate pair applies: ``copy_to`` (identity
forward, all-reduce backward) and ``reduce_from`` (all-reduce forward,
identity backward), with ``gather_from`` (all-gather forward, this rank's
slice backward, no sum). Every rank of the axis must make the same calls
in the same order, backward included.

On a gloo group a CUDA tensor travels through a pinned host buffer (gloo
moves host memory; several ranks sharing one card use it), and
``reduce_scatter`` is an all-reduce and a slice. Under NCCL the tensors
stay on the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["psum", "pmean", "all_gather", "reduce_scatter", "ppermute",
           "copy_to", "reduce_from", "gather_from", "axis_index",
           "all_reduce_", "all_gather_into_", "broadcast_"]


def axis_index(axis):
    """This rank's index along ``axis``."""
    return axis.index


def _gloo(group):
    return str(dist.get_backend(group)).lower() == "gloo"


def _to_host(t):
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce_(t, axis):
    """Sum ``t`` over ``axis`` in place (no autograd)."""
    if axis.size == 1:
        return t
    if _gloo(axis.group) and t.device.type != "cpu":
        host = _to_host(t)
        dist.all_reduce(host, group=axis.group)
        t.copy_(host, non_blocking=True)
        return t
    if not t.is_contiguous():
        c = t.contiguous()
        dist.all_reduce(c, group=axis.group)
        return t.copy_(c)
    dist.all_reduce(t, group=axis.group)
    return t


def broadcast_(t, axis, src=0):
    """``t`` of the rank at index ``src`` of ``axis``, in place."""
    if axis.size == 1:
        return t
    root = axis.ranks[src]
    if _gloo(axis.group) and t.device.type != "cpu":
        host = _to_host(t)
        dist.broadcast(host, root, group=axis.group)
        return t.copy_(host, non_blocking=True)
    c = t if t.is_contiguous() else t.contiguous()
    dist.broadcast(c, root, group=axis.group)
    return t if c is t else t.copy_(c)


def all_gather_into_(out, t, axis):
    """Concatenate every rank's ``t`` along dim 0 into ``out`` (no
    autograd)."""
    if axis.size == 1:
        if out.data_ptr() != t.data_ptr():
            out.copy_(t)
        return out
    if _gloo(axis.group):
        src = _to_host(t)
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.group)
        out.copy_(torch.cat(parts).reshape(out.shape), non_blocking=True)
        return out
    dist.all_gather_into_tensor(out, t.contiguous(), group=axis.group)
    return out


def _reduce_scatter0(t, axis):
    """Sum over ``axis`` of ``t``, this rank's 1/size of dim 0."""
    n = axis.size
    k = t.shape[0] // n
    if n == 1:
        return t.clone()
    if _gloo(axis.group):
        s = t.clone()
        all_reduce_(s, axis)
        return s.narrow(0, axis.index * k, k).clone()
    out = torch.empty((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=axis.group)
    return out


def _gather(t, axis, dim):
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((axis.size * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    all_gather_into_(out, moved, axis)
    return out.movedim(0, dim)


def _scatter(t, axis, dim):
    moved = t.movedim(dim, 0)
    if moved.shape[0] % axis.size:
        raise ValueError("reduce_scatter: dimension %d (%d) does not divide "
                         "the axis (%d)" % (dim, moved.shape[0], axis.size))
    return _reduce_scatter0(moved, axis).movedim(0, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.k = axis, dim, x.shape[dim]
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return g.narrow(ctx.dim, a.index * ctx.k, ctx.k).contiguous(), \
            None, None


def _permute(x, axis, perm):
    """Send ``x`` along ``perm`` ((source index, destination index)
    pairs of the axis); a rank that receives nothing gets zeros."""
    me = axis.index
    out = torch.zeros_like(x)
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if sends == [me] and recvs == [me]:
        return x.clone()
    gloo = _gloo(axis.group)
    src = _to_host(x) if gloo else x.contiguous()
    buf = torch.empty_like(src) if recvs else None
    ops = [dist.P2POp(dist.isend, src, axis.ranks[d], axis.group)
           for d in sends]
    ops += [dist.P2POp(dist.irecv, buf, axis.ranks[s], axis.group)
            for s in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if buf is not None:
        out.copy_(buf)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g.contiguous(), ctx.axis, inverse), None, None


def psum(x, axis):
    """The sum of every rank's ``x`` over ``axis``."""
    return _PSum.apply(x, axis)


def pmean(x, axis):
    """The mean of every rank's ``x`` over ``axis``."""
    return psum(x, axis) / axis.size


def all_gather(x, axis, dim=0):
    """Every rank's ``x`` concatenated along ``dim`` in axis order."""
    return _AllGather.apply(x, axis, dim)


def reduce_scatter(x, axis, dim=0):
    """The sum over ``axis`` of ``x``, this rank's 1/size block of
    ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``)."""
    return _ReduceScatter.apply(x, axis, dim)


def ppermute(x, axis, perm):
    """``x`` sent along ``perm``, ``(source, destination)`` index pairs of
    ``axis`` (``jax.lax.ppermute``)."""
    return _PPermute.apply(x, axis, tuple(tuple(p) for p in perm))


def copy_to(x, axis):
    """``x`` itself; its gradient summed over ``axis`` (Megatron's ``f``):
    where the ranks of ``axis`` each use ``x`` for their part of one
    replicated loss."""
    return _CopyTo.apply(x, axis)


def reduce_from(x, axis):
    """The sum of every rank's ``x`` over ``axis``, its gradient passed
    through whole (Megatron's ``g``): each rank's loss reads the one sum,
    so no rank's gradient is counted twice."""
    return _ReduceFrom.apply(x, axis)


def gather_from(x, axis, dim=0):
    """Every rank's ``x`` concatenated along ``dim``; the gradient is this
    rank's slice of the whole one, not summed over ``axis``: for a weight
    sharded over an axis whose ranks compute the same loss."""
    return _GatherFrom.apply(x, axis, dim)
