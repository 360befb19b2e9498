"""One optimizer step over the whole parameter list (counterpart of
``mxtpu/optimizer_fused.py:FusedUpdater``, on one device).

The per-index ``Updater`` issues a handful of elementwise kernels per
parameter: ResNet-50's 161 parameters make ~800 launches a step.
``FusedUpdater.update_batch`` groups the parameters by rule, dtype, device
and multi-precision, and updates each group with ``torch._foreach_*``
ops, a few launches per group. SGD (with and without momentum), NAG and
Adam have a foreach form; every other rule, and every optimizer subclass,
runs the per-index path. A foreach form repeats its rule's arithmetic op
for op in the same order (``ops/optimizer_ops.py``), with the per-index
lr and wd as scalar lists, so it gives the per-index ``Updater``'s weights
and states: on the CPU bit for bit; on the card up to the rounding of
torch's multi-tensor kernels.

It advances the same update counts in the same index order (so an lr
scheduler reads the same ``num_update`` for every index), and makes no
host sync: the hyperparameters are Python floats.

Not ported: the mesh plan and ZeRO-1 (ROADMAP A8), the compile service,
and the numerics guard with its loss scaler (A9).
"""
from __future__ import annotations

import torch

from .optimizer import NAG, SGD, Adam, Updater

__all__ = ["FusedUpdater"]


def _rescale_clip(grads, weights, rescale, clip, wds):
    """``ops.optimizer_ops._rescale_clip`` over lists: rescale, clip, then
    ``+ w * wd`` where that index's wd is not 0."""
    g = torch._foreach_mul(grads, rescale)
    if clip is not None and clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    keep = [k for k, wd in enumerate(wds) if wd != 0.0]
    if keep:
        torch._foreach_add_([g[k] for k in keep], torch._foreach_mul(
            [weights[k] for k in keep], [wds[k] for k in keep]))
    return g


def _sgd_step(opt, ws, gs, states, hyper):
    lrs, wds = hyper
    g = _rescale_clip(gs, ws, opt.rescale_grad, opt.clip_gradient, wds)
    torch._foreach_mul_(g, lrs)
    if states[0] is None:          # w - g * lr
        torch._foreach_sub_(ws, g)
        return
    moms = [s._data for s in states]   # mom = mom * momentum - g * lr
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_sub_(moms, g)
    torch._foreach_add_(ws, moms)      # w + mom


def _nag_step(opt, ws, gs, states, hyper):
    lrs, wds = hyper
    g = _rescale_clip(gs, ws, opt.rescale_grad, opt.clip_gradient, wds)
    if states[0] is None:
        torch._foreach_mul_(g, lrs)
        torch._foreach_sub_(ws, g)
        return
    moms = [s._data for s in states]   # mom = mom * momentum + g
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_add_(moms, g)
    t = torch._foreach_mul(moms, opt.momentum)   # w - (mom*momentum + g)*lr
    torch._foreach_add_(t, g)
    torch._foreach_mul_(t, lrs)
    torch._foreach_sub_(ws, t)


def _adam_step(opt, ws, gs, states, hyper):
    lr_ts, wds = hyper
    g = _rescale_clip(gs, ws, opt.rescale_grad, opt.clip_gradient, wds)
    means = [s[0]._data for s in states]
    variances = [s[1]._data for s in states]
    torch._foreach_mul_(means, opt.beta1)        # mean*b1 + g*(1-b1)
    torch._foreach_add_(means, torch._foreach_mul(g, 1 - opt.beta1))
    sq = torch._foreach_mul(g, g)                # var*b2 + (g*g)*(1-b2)
    torch._foreach_mul_(sq, 1 - opt.beta2)
    torch._foreach_mul_(variances, opt.beta2)
    torch._foreach_add_(variances, sq)
    den = torch._foreach_sqrt(variances)         # (mean*lr)/(sqrt(var)+eps)
    torch._foreach_add_(den, opt.epsilon)
    num = torch._foreach_mul(means, lr_ts)
    torch._foreach_div_(num, den)
    torch._foreach_sub_(ws, num)


# rule -> (hyperparameters of one index, its foreach step); exact classes
# only: a subclass that overrides ``update`` keeps its own
_RULES = {
    SGD: (lambda opt, i: (opt._get_lr(i), opt._get_wd(i)), _sgd_step),
    NAG: (lambda opt, i: (opt._get_lr(i), opt._get_wd(i)), _nag_step),
    Adam: (lambda opt, i: (opt._lr_t(i), opt._get_wd(i)), _adam_step),
}


def _bump(states):
    for s in states:
        if s is None:
            continue
        for arr in (s if isinstance(s, tuple) else (s,)):
            if arr is not None:
                arr._version += 1


class FusedUpdater(Updater):
    """An ``Updater`` whose ``update_batch`` runs each group of parameters
    through its rule's foreach form (module docstring); ``__call__`` is
    the per-index path."""

    def update_batch(self, indices, grads, weights):
        opt = self.optimizer
        rule = _RULES.get(type(opt))
        if rule is None:
            return super().update_batch(indices, grads, weights)
        hyper_of, step = rule
        groups = {}
        with torch.no_grad():
            for i, g, w in zip(indices, grads, weights):
                state = self._state(i, w)
                opt._update_count(i)
                mp = opt._mp(w)
                key = (w._data.dtype, w._data.device, mp,
                       (state[1] if mp else state) is None)
                groups.setdefault(key, []).append(
                    (w, g, state, hyper_of(opt, i)))
            for (_, _, mp, _), items in groups.items():
                hyper = tuple(list(h) for h in zip(*(it[3] for it in items)))
                if mp:
                    masters = [it[2][0]._data for it in items]
                    states = [it[2][1] for it in items]
                    step(opt, masters, [it[1]._data.float() for it in items],
                         states, hyper)
                    torch._foreach_copy_([it[0]._data for it in items],
                                         masters)
                    _bump(it[2][0] for it in items)
                else:
                    states = [it[2] for it in items]
                    step(opt, [it[0]._data for it in items],
                         [it[1]._data for it in items], states, hyper)
                _bump(states)
                _bump(it[0] for it in items)
