"""One optimizer step over the whole parameter list (counterpart of
``mxtpu/optimizer_fused.py:FusedUpdater``).

The per-index ``Updater`` issues a handful of elementwise kernels per
parameter: ResNet-50's 161 parameters make ~800 launches a step.
``FusedUpdater.update_batch`` groups the parameters by rule, dtype,
device, multi-precision, state structure and the values of their
hyperparameters, and updates each group with ``torch._foreach_*`` ops.
Every optimizer the reference fuses has a foreach form (``_RULES``: SGD,
NAG, Signum, FTML, DCASGD, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl,
Adamax, Nadam, GroupAdaGrad, Test); a foreach form repeats its rule's
arithmetic op for op in the same order (``ops/optimizer_ops.py``,
``optimizer.py``), with the scalars the per-index rule computes on the
host (bias corrections, ``1 - lr * wd_lh``) computed there too, so it
gives the per-index ``Updater``'s weights and states bit for bit on the
CPU. ``functional_rule``/``traced_rule_names`` expose the registry to
``parallel.ShardedTrainStep``; Nadam's hyperparameters move with host
state at every update (``m_schedule``), so it has no traced twin and its
groups are one parameter each.

On a CUDA device each group's update is one captured CUDA graph (the
reference's one donated jit per ``Trainer.step``), keyed on the rule, its
static configuration (momentum, betas, epsilon, clip), whether the wd is
0, and the group's indices, shapes, dtypes and state structure. What
moves between steps lives in a static device tensor that the host writes
before each replay (``rescale_grad = scale / batch_size`` and the group's
hyperparameters): an lr-schedule tick or a batch-size change replays
with no new build. Each build counts at retrace site ``fused_optimizer``
and in ``FUSED_STATS``. The first step of a group is the graph's warm-up
run; each later step copies the gradients into the group's static
buffers (the autograd pass rebinds each gradient buffer) and replays.
The graph reads and writes the weights and states at the addresses it
was captured with: one replaced since (``set_data``, ``set_states``) is
copied into the captured storage, which its holder then shares, before
the replay. The host stages the hyperparameters through a ring of pinned
buffers, a slot written again only after the copy that read it has run.
On the CPU the same groups run eagerly.

On a mesh (``set_mesh``, a ``MeshPlan``; ``gluon.Trainer(mesh=)`` and
``ShardedTrainStep`` set it) ``update_batch`` takes this rank's
gradients and sums them over the mesh before the update, one flat buffer
a dtype, outside any graph; under ZeRO-1 each parameter whose dim 0
divides the data axis is reduce-scattered, its rows updated (the states
shard-sized, the weight a view of its rows) and all-gathered back.
``get_states`` all-gathers the rows' states whole, and a restored whole
state is cut to the rows on first use. An axis of one rank runs no
collective.

Update counts (``_update_count``), state versions and ``ignore_stale_grad``
stay on the host, in index order (an lr scheduler reads the same
``num_update`` for every index), and nothing syncs with the device.
The reference's eager paths stay eager, counted in
``FUSED_STATS["eager_updates"]``: rules without a foreach form (SGLD,
LBSGD), optimizer subclasses, items whose weight or state shares storage
with another item's, and every item while ``set_enabled(False)``. On a
captured graph the hyperparameters of a bfloat16 or float16 group
without multi-precision round to its dtype.

Not ported: the numerics guard with its loss scaler (ROADMAP A9).
"""
from __future__ import annotations

import collections
import math
import threading
import weakref

import torch

from . import graphs, telemetry
from .ndarray import NDArray
from .optimizer import (DCASGD, FTML, NAG, SGD, AdaDelta, AdaGrad, Adam,
                        Adamax, Ftrl, GroupAdaGrad, Nadam, RMSProp, Signum,
                        Test, Updater)

__all__ = ["FusedUpdater", "MeshPlan", "set_enabled", "fused_enabled",
           "cache_size", "reset", "FUSED_STATS", "functional_rule",
           "traced_rule_names"]

_ENABLED = [True]

# fused_steps: update_batch calls that updated a group; traces and
# compiles: graphs built (one each per build; they differ only in the
# reference, which can load a compiled executable from disk);
# eager_updates: items updated by the per-index path
FUSED_STATS = {"fused_steps": 0, "traces": 0, "compiles": 0,
               "eager_updates": 0}
_UPDATERS = weakref.WeakSet()
_STATS_LOCK = threading.Lock()


def set_enabled(flag):
    """Turn the fused step on or off (the reference's
    ``MXTPU_FUSED_OPTIMIZER``); read per call. Returns the previous
    setting."""
    prev, _ENABLED[0] = _ENABLED[0], bool(flag)
    return prev


def fused_enabled():
    return _ENABLED[0]


def cache_size():
    """Captured update graphs held by live updaters."""
    return sum(len(u._graphs) for u in list(_UPDATERS))


def reset():
    """Test hook: drop every captured update graph and zero the counters."""
    for u in list(_UPDATERS):
        u._graphs.clear()
    with _STATS_LOCK:
        for k in FUSED_STATS:
            FUSED_STATS[k] = 0


def _stat(key, n=1):
    with _STATS_LOCK:
        FUSED_STATS[key] += n


def _rescale_clip(cfg, grads, weights, rescale, wd, wd_zero):
    """``ops.optimizer_ops._rescale_clip`` over lists: rescale, clip, then
    ``+ w * wd`` unless the group's wd is 0 (``wd_zero`` None: always, as
    ``Optimizer._rescaled``)."""
    g = torch._foreach_mul(grads, rescale)
    if cfg["clip"] is not None and cfg["clip"] > 0:
        torch._foreach_clamp_min_(g, -cfg["clip"])
        torch._foreach_clamp_max_(g, cfg["clip"])
    if wd is not None and not wd_zero:
        torch._foreach_add_(g, torch._foreach_mul(weights, wd))
    return g


def _sign(xs):
    """``ops.optimizer_ops._sign`` per tensor (jnp.sign)."""
    out = []
    for x in xs:
        s = torch.sign(x)
        out.append(torch.where(s == 0, x, s))
    return out


def _sgd_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd = h[0], h[1], h[2]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    torch._foreach_mul_(g, lr)
    if states[0] is None:          # w - g * lr
        torch._foreach_sub_(ws, g)
        return
    moms = [s._data for s in states]   # mom = mom * momentum - g * lr
    torch._foreach_mul_(moms, cfg["momentum"])
    torch._foreach_sub_(moms, g)
    torch._foreach_add_(ws, moms)      # w + mom


def _nag_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd = h[0], h[1], h[2]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    if states[0] is None:
        torch._foreach_mul_(g, lr)
        torch._foreach_sub_(ws, g)
        return
    moms = [s._data for s in states]   # mom = mom * momentum + g
    torch._foreach_mul_(moms, cfg["momentum"])
    torch._foreach_add_(moms, g)
    t = torch._foreach_mul(moms, cfg["momentum"])  # w - (mom*m + g)*lr
    torch._foreach_add_(t, g)
    torch._foreach_mul_(t, lr)
    torch._foreach_sub_(ws, t)


def _adam_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr_t, wd = h[0], h[1], h[2]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    b1, b2 = cfg["beta1"], cfg["beta2"]
    means = [s[0]._data for s in states]
    variances = [s[1]._data for s in states]
    torch._foreach_mul_(means, b1)               # mean*b1 + g*(1-b1)
    torch._foreach_add_(means, torch._foreach_mul(g, 1 - b1))
    sq = torch._foreach_mul(g, g)                # var*b2 + (g*g)*(1-b2)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(variances, b2)
    torch._foreach_add_(variances, sq)
    den = torch._foreach_sqrt(variances)         # (mean*lr)/(sqrt(var)+eps)
    torch._foreach_add_(den, cfg["epsilon"])
    num = torch._foreach_mul(means, lr_t)
    torch._foreach_div_(num, den)
    torch._foreach_sub_(ws, num)


def _signum_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd, decay = h[0], h[1], h[2], h[3]
    if states[0] is None:      # w - (sign(g) + w*wd) * lr, g without wd
        g = _rescale_clip(cfg, gs, ws, rescale, None, None)
        t = _sign(g)
        torch._foreach_add_(t, torch._foreach_mul(ws, wd))
        torch._foreach_mul_(t, lr)
        torch._foreach_sub_(ws, t)
        return
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    moms = [s._data for s in states]   # mom*m - g*(1-m)
    m = cfg["momentum"]
    torch._foreach_mul_(moms, m)
    torch._foreach_sub_(moms, torch._foreach_mul(g, 1 - m))
    step = _sign(moms)                 # w*(1 - lr*wd_lh) + sign(mom)*lr
    torch._foreach_mul_(step, lr)
    torch._foreach_mul_(ws, decay)
    torch._foreach_add_(ws, step)


def _ftml_step(cfg, ws, gs, states, h, wd_zero):
    rescale, wd, bc2, c = h[0], h[1], h[2], h[3]
    b1, b2 = cfg["beta1"], cfg["beta2"]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    d = [s[0]._data for s in states]
    v = [s[1]._data for s in states]
    z = [s[2]._data for s in states]
    sq = torch._foreach_mul(g, g)                # v*b2 + (g*g)*(1-b2)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, sq)
    d_new = torch._foreach_div(v, bc2)   # (sqrt(v/bc2) + eps) * ((1-b1^t)/lr)
    torch._foreach_sqrt_(d_new)
    torch._foreach_add_(d_new, cfg["epsilon"])
    torch._foreach_mul_(d_new, c)
    sigma = torch._foreach_mul(d, b1)            # d_new - d*b1
    torch._foreach_neg_(sigma)
    torch._foreach_add_(sigma, d_new)
    torch._foreach_mul_(z, b1)   # z*b1 + g*(1-b1) - sigma*w
    torch._foreach_add_(z, torch._foreach_mul(g, 1 - b1))
    torch._foreach_sub_(z, torch._foreach_mul(sigma, ws))
    torch._foreach_copy_(d, d_new)
    w = torch._foreach_neg(z)                    # -z / d
    torch._foreach_div_(w, d)
    torch._foreach_copy_(ws, w)


def _dcasgd_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd, neg_lr = h[0], h[1], h[2], h[3]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, None)
    prevs = [s[1]._data for s in states]
    comp = torch._foreach_mul(g, cfg["lamda"])   # g + g*lamda*g*(w - prev)
    torch._foreach_mul_(comp, g)
    torch._foreach_mul_(comp, torch._foreach_sub(ws, prevs))
    torch._foreach_add_(comp, g)
    if states[0][0] is None:
        step = torch._foreach_mul(comp, neg_lr)
    else:
        moms = [s[0]._data for s in states]      # mom*m - comp*lr
        step = torch._foreach_mul(moms, cfg["momentum"])
        torch._foreach_sub_(step, torch._foreach_mul(comp, lr))
        torch._foreach_copy_(moms, step)
    torch._foreach_copy_(prevs, ws)
    torch._foreach_add_(ws, step)


def _adagrad_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd = h[0], h[1], h[2]
    g = _rescale_clip(cfg, gs, ws, rescale, None, None)
    hist = [s._data for s in states]
    torch._foreach_add_(hist, torch._foreach_mul(g, g))
    den = torch._foreach_add(hist, cfg["epsilon"])  # (g/sqrt(h+eps) + w*wd)*lr
    torch._foreach_sqrt_(den)
    t = torch._foreach_div(g, den)
    torch._foreach_add_(t, torch._foreach_mul(ws, wd))
    torch._foreach_mul_(t, lr)
    torch._foreach_sub_(ws, t)


def _rmsprop_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd = h[0], h[1], h[2]
    g1 = cfg["gamma1"]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    n = [s[0]._data for s in states]
    sq = torch._foreach_mul(g, g)                # (g*g)*(1-g1) + n*g1
    torch._foreach_mul_(sq, 1 - g1)
    torch._foreach_mul_(n, g1)
    torch._foreach_add_(n, sq)
    if cfg["centered"]:
        g_avg = [s[1]._data for s in states]     # g*(1-g1) + g_avg*g1
        torch._foreach_mul_(g_avg, g1)
        torch._foreach_add_(g_avg, torch._foreach_mul(g, 1 - g1))
        delta = [s[2]._data for s in states]
        den = torch._foreach_mul(g_avg, g_avg)   # sqrt(n - g_avg^2 + eps)
        torch._foreach_neg_(den)
        torch._foreach_add_(den, n)
        torch._foreach_add_(den, cfg["epsilon"])
        torch._foreach_sqrt_(den)
        num = torch._foreach_mul(g, lr)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(delta, cfg["gamma2"])  # delta*g2 - (g*lr)/den
        torch._foreach_sub_(delta, num)
        torch._foreach_add_(ws, delta)
    else:
        den = torch._foreach_add(n, cfg["epsilon"])  # w - (g*lr)/sqrt(n+eps)
        torch._foreach_sqrt_(den)
        num = torch._foreach_mul(g, lr)
        torch._foreach_div_(num, den)
        torch._foreach_sub_(ws, num)
    if cfg["clip_weights"] > 0:
        torch._foreach_clamp_min_(ws, -cfg["clip_weights"])
        torch._foreach_clamp_max_(ws, cfg["clip_weights"])


def _adadelta_step(cfg, ws, gs, states, h, wd_zero):
    rescale, wd = h[0], h[1]
    rho, eps = cfg["rho"], cfg["epsilon"]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, None)
    acc_g = [s[0]._data for s in states]
    acc_d = [s[1]._data for s in states]
    sq = torch._foreach_mul(g, g)          # acc_g*rho + (g*g)*(1-rho)
    torch._foreach_mul_(sq, 1 - rho)
    torch._foreach_mul_(acc_g, rho)
    torch._foreach_add_(acc_g, sq)
    delta = torch._foreach_add(acc_d, eps)  # sqrt(acc_d+eps)/sqrt(ag+eps)*g
    torch._foreach_sqrt_(delta)
    den = torch._foreach_add(acc_g, eps)
    torch._foreach_sqrt_(den)
    torch._foreach_div_(delta, den)
    torch._foreach_mul_(delta, g)
    sq = torch._foreach_mul(delta, delta)  # acc_d*rho + (delta^2)*(1-rho)
    torch._foreach_mul_(sq, 1 - rho)
    torch._foreach_mul_(acc_d, rho)
    torch._foreach_add_(acc_d, sq)
    torch._foreach_sub_(ws, delta)


def _ftrl_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr, wd = h[0], h[1], h[2]
    l1, beta = cfg["lamda1"], cfg["beta"]
    g = _rescale_clip(cfg, gs, ws, rescale, None, None)
    z = [s[0]._data for s in states]
    n = [s[1]._data for s in states]
    sqrt_n = torch._foreach_sqrt(n)
    torch._foreach_add_(n, torch._foreach_mul(g, g))     # n + g*g
    sqrt_new = torch._foreach_sqrt(n)
    sigma = torch._foreach_sub(sqrt_new, sqrt_n)         # (.. - ..)/lr
    torch._foreach_div_(sigma, lr)
    torch._foreach_add_(z, g)                            # z + g - sigma*w
    torch._foreach_sub_(z, torch._foreach_mul(sigma, ws))
    den = torch._foreach_add(sqrt_new, beta)  # (beta + sqrt(n))/lr + wd
    torch._foreach_div_(den, lr)
    torch._foreach_add_(den, wd)
    for w, zi, s, di in zip(ws, z, _sign(z), den):
        w.copy_(torch.where(torch.abs(zi) > l1, -(zi - s * l1) / di,
                            torch.zeros_like(zi)))


def _adamax_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr_t, wd = h[0], h[1], h[2]
    b1 = cfg["beta1"]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, None)
    m = [s[0]._data for s in states]
    u = [s[1]._data for s in states]
    torch._foreach_mul_(m, b1)                   # m*b1 + g*(1-b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(u, cfg["beta2"])         # max(u*b2, |g|)
    torch._foreach_maximum_(u, torch._foreach_abs(g))
    num = torch._foreach_mul(m, lr_t)            # w - (m*lr_t)/(u + 1e-8)
    torch._foreach_div_(num, torch._foreach_add(u, 1e-8))
    torch._foreach_sub_(ws, num)


def _nadam_step(cfg, ws, gs, states, h, wd_zero):
    (rescale, lr, wd, one_minus_mt, mt_1, one_minus_ms, one_minus_msn,
     bc2) = h[:8]
    b1, b2 = cfg["beta1"], cfg["beta2"]
    g = _rescale_clip(cfg, gs, ws, rescale, wd, None)
    m = [s[0]._data for s in states]
    v = [s[1]._data for s in states]
    torch._foreach_mul_(m, b1)                   # m*b1 + g*(1-b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    sq = torch._foreach_mul(g, g)                # v*b2 + (g*g)*(1-b2)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, sq)
    m_bar = torch._foreach_div(g, one_minus_ms)  # g' * (1-mom_t)
    torch._foreach_mul_(m_bar, one_minus_mt)
    m_prime = torch._foreach_div(m, one_minus_msn)   # + m' * mom_t_1
    torch._foreach_mul_(m_prime, mt_1)
    torch._foreach_add_(m_bar, m_prime)
    den = torch._foreach_div(v, bc2)   # w - (m_bar*lr)/(sqrt(v') + eps)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg["epsilon"])
    torch._foreach_mul_(m_bar, lr)
    torch._foreach_div_(m_bar, den)
    torch._foreach_sub_(ws, m_bar)


def _groupadagrad_step(cfg, ws, gs, states, h, wd_zero):
    rescale, lr = h[0], h[1]
    g = torch._foreach_mul(gs, rescale)
    if cfg["clip"] is not None:
        torch._foreach_clamp_min_(g, -cfg["clip"])
        torch._foreach_clamp_max_(g, cfg["clip"])
    for w, gi, s in zip(ws, g, states):
        red = tuple(range(1, gi.ndim))
        hist = s._data
        hist.copy_(hist + torch.mean(gi * gi, dim=red) if red
                   else hist + gi * gi)
        div = torch.sqrt(hist + cfg["epsilon"])
        w.sub_((gi * lr) / div.reshape((-1,) + (1,) * (gi.ndim - 1)))


def _test_step(cfg, ws, gs, states, h, wd_zero):
    torch._foreach_add_(ws, torch._foreach_mul(gs, h[0]))   # w + g*rescale
    torch._foreach_copy_([s._data for s in states], ws)


class _Rule:
    """One optimizer class's update over lists (the reference's
    ``optimizer_fused._Rule``): ``static(opt)`` its configuration (part
    of a graph's key); ``hyper(opt, index)`` the index's scalars after
    its update count moved (lr and wd after their multipliers, bias
    corrections of the count), computed on the host in double precision
    as the per-index rule computes them; ``step(cfg, ws, gs, states, h,
    wd_zero)`` the foreach update, ``h`` being ``(rescale_grad,) +
    hyper`` (floats, or a device tensor in a captured graph);
    ``thyper(cfg, lr, wd, t)`` the hyperparameters from (lr, wd, the
    update count), None where they depend on host state that moves with
    every update (Nadam's ``m_schedule``); ``wd_at``: the position of wd
    in ``hyper`` whose zero skips the wd term, or None."""

    __slots__ = ("static", "hyper", "step", "thyper", "wd_at")

    def __init__(self, static, hyper, step, thyper, wd_at=1):
        self.static = static
        self.hyper = hyper
        self.step = step
        self.thyper = thyper
        self.wd_at = wd_at


def _clip_cfg(opt, **more):
    return dict(clip=opt.clip_gradient, **more)


def _lr_wd(opt, i):
    return (opt._get_lr(i), opt._get_wd(i))


def _t_lr_wd(cfg, lr, wd, t):
    return (lr, wd)


def _count(opt, i):
    return opt._index_update_count[i]


def _adam_t(cfg, lr, wd, t):
    return (lr * math.sqrt(1.0 - cfg["beta2"] ** t)
            / (1.0 - cfg["beta1"] ** t), wd)


def _ftml_t(cfg, lr, wd, t):
    return (wd, 1 - cfg["beta2"] ** t, (1 - cfg["beta1"] ** t) / lr)


def _adamax_t(cfg, lr, wd, t):
    return (lr / (1.0 - cfg["beta1"] ** t), wd)


def _nadam_hyper(opt, i):
    lr, wd = _lr_wd(opt, i)
    t = _count(opt, i)
    momentum_t = opt.beta1 * (1.0 - 0.5 * 0.96 ** (t * opt.schedule_decay))
    momentum_t_1 = opt.beta1 * (
        1.0 - 0.5 * 0.96 ** ((t + 1) * opt.schedule_decay))
    opt.m_schedule *= momentum_t          # the per-index rule's host state
    return (lr, wd, 1 - momentum_t, momentum_t_1, 1 - opt.m_schedule,
            1 - opt.m_schedule * momentum_t_1, 1 - opt.beta2 ** t)


def _from_t(static, thyper):
    """A host ``hyper`` from a rule's ``thyper`` and the index's count."""
    def hyper(opt, i):
        lr, wd = _lr_wd(opt, i)
        return thyper(static(opt), lr, wd, _count(opt, i))
    return hyper


def _adam_cfg(opt):
    return _clip_cfg(opt, beta1=opt.beta1, beta2=opt.beta2,
                     epsilon=opt.epsilon)


def _momentum_cfg(opt):
    return _clip_cfg(opt, momentum=opt.momentum)


# rule of each optimizer class; exact classes only: a subclass that
# overrides ``update`` (LBSGD) keeps its own, as do SGLD (a draw per
# update) and every optimizer while ``set_enabled(False)``
_RULES = {
    SGD: _Rule(_momentum_cfg, _lr_wd, _sgd_step, _t_lr_wd),
    NAG: _Rule(_momentum_cfg, _lr_wd, _nag_step, _t_lr_wd),
    Signum: _Rule(lambda o: _clip_cfg(o, momentum=o.momentum,
                                      wd_lh=o.wd_lh),
                  lambda o, i: _lr_wd(o, i) + (1 - o._get_lr(i) * o.wd_lh,),
                  _signum_step,
                  lambda c, lr, wd, t: (lr, wd, 1 - lr * c["wd_lh"])),
    FTML: _Rule(_adam_cfg, None, _ftml_step, _ftml_t, wd_at=0),
    DCASGD: _Rule(lambda o: _clip_cfg(o, momentum=o.momentum,
                                      lamda=o.lamda),
                  lambda o, i: _lr_wd(o, i) + (-o._get_lr(i),),
                  _dcasgd_step, lambda c, lr, wd, t: (lr, wd, -lr),
                  wd_at=None),
    Adam: _Rule(_adam_cfg, lambda o, i: (o._lr_t(i), o._get_wd(i)),
                _adam_step, _adam_t),
    AdaGrad: _Rule(lambda o: _clip_cfg(o, epsilon=o.float_stable_eps),
                   _lr_wd, _adagrad_step, _t_lr_wd, wd_at=None),
    RMSProp: _Rule(lambda o: _clip_cfg(
        o, gamma1=o.gamma1, gamma2=o.gamma2, epsilon=o.epsilon,
        centered=bool(o.centered),
        clip_weights=o.clip_weights if o.clip_weights else -1.0),
        _lr_wd, _rmsprop_step, _t_lr_wd),
    AdaDelta: _Rule(lambda o: _clip_cfg(o, rho=o.rho, epsilon=o.epsilon),
                    lambda o, i: (o._get_wd(i),), _adadelta_step,
                    lambda c, lr, wd, t: (wd,), wd_at=None),
    Ftrl: _Rule(lambda o: _clip_cfg(o, lamda1=o.lamda1, beta=o.beta),
                _lr_wd, _ftrl_step, _t_lr_wd, wd_at=None),
    Adamax: _Rule(lambda o: _clip_cfg(o, beta1=o.beta1, beta2=o.beta2),
                  None, _adamax_step, _adamax_t, wd_at=None),
    Nadam: _Rule(_adam_cfg, _nadam_hyper, _nadam_step, None, wd_at=None),
    GroupAdaGrad: _Rule(lambda o: _clip_cfg(o, epsilon=o.float_stable_eps),
                        lambda o, i: (o._get_lr(i),), _groupadagrad_step,
                        lambda c, lr, wd, t: (lr,), wd_at=None),
    Test: _Rule(lambda o: {}, lambda o, i: (), _test_step,
                lambda c, lr, wd, t: (), wd_at=None),
}
for _rule in _RULES.values():
    if _rule.hyper is None:
        _rule.hyper = _from_t(_rule.static, _rule.thyper)
del _rule


def functional_rule(optimizer):
    """The foreach rule of an Optimizer instance (exact class), or None
    for the per-index set (SGLD, LBSGD, subclasses). One registry serves
    the fused Trainer step and ``parallel.ShardedTrainStep``."""
    return _RULES.get(type(optimizer))


def traced_rule_names():
    """Registry names of the optimizers whose hyperparameters follow from
    (lr, wd, update count) alone: those ``ShardedTrainStep`` takes."""
    return sorted(k.__name__.lower()
                  for k, r in _RULES.items() if r.thyper is not None)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _kind(state):
    """A state's nesting without its shapes (groups are made by it)."""
    if isinstance(state, tuple):
        return tuple(_kind(s) for s in state)
    return None if state is None else state._data.dtype


def _structure(state):
    if isinstance(state, tuple):
        return tuple(_structure(s) for s in state)
    return None if state is None else (tuple(state.shape),
                                       state._data.dtype)


def _bump(arrays):
    for arr in arrays:
        arr._version += 1


def _split_aliased(items):
    """(items, items whose weight or state shares storage with another
    item's): the second run per index, as the reference's donation rule."""
    seen = collections.Counter()
    ptrs = []
    for it in items:
        mine = {a._data.untyped_storage().data_ptr()
                for a in [it[2]] + _leaves(it[3])}
        ptrs.append(mine)
        seen.update(mine)
    keep, aliased = [], []
    for it, mine in zip(items, ptrs):
        (aliased if any(seen[p] > 1 for p in mine) else keep).append(it)
    return keep, aliased


class _Staging:
    """Host buffers for the hyperparameters' host-to-device copies, in a
    ring: a slot is written again only after the copies that read it have
    run (its event). Pinned, so the copies are asynchronous."""

    SLOTS = 4

    def __init__(self):
        self._slots = []
        self._next = 0

    def write(self, values, device):
        """A host tensor holding ``values`` (float32) that no copy in
        flight reads; call ``issued()`` after the copies from it."""
        n = len(values)
        if not self._slots or self._slots[0][0].numel() < n:
            pin = device.type == "cuda"
            self._slots = [[torch.empty(max(n, 16), dtype=torch.float32,
                                        pin_memory=pin), None]
                           for _ in range(self.SLOTS)]
            self._next = 0
        slot = self._slots[self._next]
        if slot[1] is not None:
            slot[1].synchronize()
            slot[1] = None
        slot[0].numpy()[:n] = values
        return slot[0]

    def issued(self, device):
        """Record that the copies from the current slot are enqueued."""
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._slots[self._next][1] = event
        self._next = (self._next + 1) % self.SLOTS


class _Group:
    """One captured update: the graph and the tensors of its holders
    (``_holders``) that it was captured over."""

    def __init__(self, graph, tensors):
        self.graph = graph
        self.tensors = tensors


def _holders(members):
    """The NDArrays a group's update writes: each weight, then each state
    leaf (the float32 master first under multi-precision)."""
    return [it[2] for it in members] + [x for it in members
                                        for x in _leaves(it[3])]


def _bump_all(members):
    _bump(_holders(members))


class FusedUpdater(Updater):
    """An ``Updater`` whose ``update_batch`` runs each group of parameters
    through its rule's foreach form, one captured graph a group on a CUDA
    device (module docstring); ``__call__`` is the per-index path."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self._graphs = {}
        self._staging = _Staging()
        self._plan = None
        self._views = {}
        _UPDATERS.add(self)

    def set_mesh(self, mesh, data_axis="data", zero1=True):
        """Adopt a ``MeshPlan``: ``update_batch`` then takes this rank's
        gradients, sums them over the mesh and, under ZeRO-1, updates this
        rank's rows only (module docstring). None detaches."""
        self._plan = None if mesh is None else \
            MeshPlan(mesh, data_axis, zero1)
        self._views = {}

    def update_batch(self, indices, grads, weights):
        if self._plan is not None:
            self._mesh_update(indices, grads, weights)
        else:
            self._update_items(indices, grads, weights)

    def _mesh_update(self, indices, grads, weights):
        """Sum the gradients over the axes that replicate the parameters,
        then, over the data axis, reduce-scatter those of the ZeRO-1 rows
        (dim 0 divides the axis) and all-reduce the rest; update (the
        rows' shards as views of the weights, their states shard-sized);
        all-gather the rows' weights."""
        plan = self._plan
        gs = [g._data for g in grads]
        with torch.no_grad():
            for axis in plan.other_axes():
                _bucket_all_reduce(gs, axis)
            data = plan.data()
            rows = [k for k, w in enumerate(weights)
                    if indices[k] not in plan.sharded
                    and plan.zero_eligible(tuple(w.shape))]
            rest = [k for k in range(len(indices)) if k not in set(rows)]
            _bucket_all_reduce([gs[k] for k in rest], data)
            shards = _bucket_reduce_scatter([gs[k] for k in rows], data)
        items_g, items_w = list(grads), list(weights)
        for k, sh in zip(rows, shards):
            items_g[k] = NDArray(sh)
            items_w[k] = self._view(indices[k], weights[k], data)
        self._update_items(indices, items_g, items_w)
        if rows:
            with torch.no_grad():
                _bucket_all_gather([weights[k]._data for k in rows],
                                   [items_w[k]._data for k in rows], data)
            _bump([weights[k] for k in rows])

    def _state(self, index, weight):
        """As ``Updater._state``; under ZeRO-1 a restored whole state is
        cut to this rank's rows on its first use."""
        restored = index in self.states and \
            not self.states_synced.get(index, False)
        state = super()._state(index, weight)
        if restored and index in self._views:
            data = self._plan.data()
            rows = weight.shape[0]

            def cut(a):
                t = a._data
                if t.shape and t.shape[0] == rows * data.size:
                    return NDArray(t.narrow(0, data.index * rows,
                                            rows).clone())
                return a
            state = self.states[index] = _map_state(state, cut)
        return state

    def get_states(self, dump_optimizer=False):
        """As ``Updater.get_states``; under ZeRO-1 the rows' states are
        all-gathered whole first (a collective: every rank calls it)."""
        if self._plan is None or not self._views:
            return super().get_states(dump_optimizer)
        from .parallel.collectives import all_gather
        data = self._plan.data()
        saved = self.states
        whole = {}
        for i, st in saved.items():
            if i in self._views:
                st = _map_state(st, lambda a: NDArray(all_gather(
                    a._data.detach().contiguous(), data)))
            whole[i] = st
        self.states = whole
        try:
            return super().get_states(dump_optimizer)
        finally:
            self.states = saved

    def _view(self, index, weight, data):
        """This rank's rows of ``weight`` as an NDArray over its storage
        (kept, so that a captured update sees the same holder)."""
        t = weight._data
        got = self._views.get(index)
        if got is not None and got[0] == t.data_ptr():
            return got[1]
        k = t.shape[0] // data.size
        view = NDArray(t.narrow(0, data.index * k, k))
        self._views[index] = (t.data_ptr(), view)
        return view

    def _update_items(self, indices, grads, weights):
        opt = self.optimizer
        rule = _RULES.get(type(opt)) if fused_enabled() else None
        if rule is None:
            super().update_batch(indices, grads, weights)
            _stat("eager_updates", len(indices))
            return
        items = [(i, g, w, self._state(i, w))
                 for i, g, w in zip(indices, grads, weights)]
        _, aliased = _split_aliased(items)
        aliased = {id(it) for it in aliased}
        groups = {}
        with torch.no_grad():
            for it in items:
                i, g, w, state = it
                if id(it) in aliased:
                    self(i, g, w)    # the per-index path, in index order
                    _stat("eager_updates")
                    continue
                opt._update_count(i)
                hyper = tuple(float(x) for x in rule.hyper(opt, i))
                key = (w._data.dtype, w._data.device, opt._mp(w),
                       _kind(state), hyper)
                groups.setdefault(key, []).append(it)
            if not groups:
                return
            _stat("fused_steps")
            cfg = rule.static(opt)
            device = next(iter(groups))[1]
            if graphs.captures(device):
                self._replay(groups, cfg, rule, opt.rescale_grad, device)
                return
            for (_, _, mp, _, hyper), members in groups.items():
                ws, gs, states = _lists(members, mp)
                rule.step(cfg, ws, gs, states, (opt.rescale_grad,) + hyper,
                          _wd_zero(rule, hyper))
                if mp:
                    torch._foreach_copy_([it[2]._data for it in members], ws)
                _bump_all(members)

    def _replay(self, groups, cfg, rule, rescale, device):
        """Each group's captured graph: stage the hyperparameters; per
        group copy them and the gradients into its static buffers, put any
        replaced weight or state back into the captured storage, and
        replay. A group seen for the first time is captured, its warm-up
        run being this step's update."""
        values = []
        for (_, _, _, _, hyper) in groups:
            values += (rescale,) + hyper
        host = self._staging.write(values, device)
        at = 0
        for (dtype, _, mp, _, hyper), members in groups.items():
            wd_zero = _wd_zero(rule, hyper)
            gkey = (type(self.optimizer), tuple(sorted(cfg.items())), mp,
                    wd_zero, tuple((it[0], tuple(it[2].shape), dtype,
                                    _structure(it[3])) for it in members))
            h = host[at:at + 1 + len(hyper)]
            at += 1 + len(hyper)
            group = self._graphs.get(gkey)
            if group is None:
                self._graphs[gkey] = self._capture(
                    gkey, members, mp, cfg, rule.step,
                    h.to(device, copy=True), wd_zero)
            else:
                static = group.graph.static_inputs
                static[-1].copy_(h, non_blocking=True)
                torch._foreach_copy_(static[:-1],
                                     [it[1]._data for it in members])
                for arr, t in zip(_holders(members), group.tensors):
                    if arr._data.data_ptr() != t.data_ptr():
                        t.copy_(arr._data)   # replaced since the capture
                        arr._set_data(t)
                group.graph.replay()
            _bump_all(members)
        self._staging.issued(device)

    def _capture(self, gkey, members, mp, cfg, step, hyper, wd_zero):
        ws, _, states = _lists(members, mp)
        weights = [it[2]._data for it in members]
        static = [it[1]._data.detach().clone() for it in members] + [hyper]

        def update(*xs):
            gs, h = list(xs[:-1]), xs[-1]
            if mp:
                gs = [g.float() for g in gs]
            step(cfg, ws, gs, states, h, wd_zero)
            if mp:
                torch._foreach_copy_(weights, ws)
            return []

        graph = graphs.CapturedGraph(update, static)
        _stat("traces")
        _stat("compiles")
        telemetry.record_retrace("fused_optimizer", {
            "optimizer": gkey[0].__name__, "params": len(members),
            "multi_precision": mp, "dtype": str(gkey[-1][0][2])})
        return _Group(graph, [a._data for a in _holders(members)])


class MeshPlan:
    """The update's placement on a mesh (ref: optimizer_fused.MeshPlan):
    parameters are replicated over every axis; ``zero1`` shards the
    optimizer state and the update of each parameter whose dim 0 divides
    the ``data_axis`` over that axis (ZeRO-1, arXiv:2004.13336):
    reduce-scatter the gradient, update this rank's rows, all-gather the
    weight. Other parameters keep whole states and a whole update.
    ``sharded`` holds the indices of parameters held as this rank's shard
    (``ShardedTrainStep`` param_specs): their gradients are summed over
    the data axis whole, never ZeRO-1's rows."""

    __slots__ = ("mesh", "data_axis", "zero1", "axis_size", "sharded")

    # the axes whose ranks all compute the same loss (tensor, expert and
    # pipeline parallelism): a gradient there is whole on every rank
    WHOLE_GRADIENT_AXES = ("model", "expert", "pipe")

    def __init__(self, mesh, data_axis="data", zero1=True):
        if data_axis not in mesh.shape:
            raise ValueError("data_axis %r not in mesh axes %s"
                             % (data_axis, tuple(mesh.shape)))
        self.mesh = mesh
        self.data_axis = data_axis
        self.zero1 = bool(zero1)
        self.axis_size = int(mesh.shape[data_axis])
        self.sharded = set()

    def data(self):
        return self.mesh.axis(self.data_axis)

    def other_axes(self):
        """The axes besides the data axis that have more than one rank and
        whose ranks each compute a part of the loss (the sequence axis of
        a ring): their gradients are summed too. Not a ``model``,
        ``expert`` or ``pipe`` axis (``WHOLE_GRADIENT_AXES``)."""
        return [self.mesh.axis(n) for n, size in self.mesh.shape.items()
                if n != self.data_axis and size > 1
                and n not in self.WHOLE_GRADIENT_AXES]

    def zero_eligible(self, w_shape):
        return (self.zero1 and self.axis_size > 1 and len(w_shape) >= 1
                and w_shape[0] % self.axis_size == 0)


def _map_state(state, fn):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_map_state(x, fn) for x in state)
    return fn(state)


def _by_dtype(tensors):
    groups = collections.OrderedDict()
    for k, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(k)
    return groups.values()


def _bucket_all_reduce(tensors, axis):
    """Sum ``tensors`` over ``axis`` in place, one flat buffer a dtype."""
    if axis.size == 1 or not tensors:
        return
    from .parallel.collectives import all_reduce_
    for ks in _by_dtype(tensors):
        flat = torch.cat([tensors[k].reshape(-1) for k in ks])
        all_reduce_(flat, axis)
        for k, piece in zip(ks, flat.split([tensors[k].numel()
                                            for k in ks])):
            tensors[k].copy_(piece.view_as(tensors[k]))


def _bucket_reduce_scatter(tensors, axis):
    """This rank's rows of the sum over ``axis`` of each tensor (dim 0
    divides the axis), one buffer a dtype laid out rank-major."""
    from .parallel.collectives import _reduce_scatter0
    n = axis.size
    out = [None] * len(tensors)
    for ks in _by_dtype(tensors):
        lens = [tensors[k].numel() // n for k in ks]
        t0 = tensors[ks[0]]
        buf = torch.empty((n, sum(lens)), dtype=t0.dtype, device=t0.device)
        off = 0
        for k, ln in zip(ks, lens):
            buf[:, off:off + ln].copy_(tensors[k].reshape(n, ln))
            off += ln
        mine = _reduce_scatter0(buf, axis)[0]
        off = 0
        for k, ln in zip(ks, lens):
            t = tensors[k]
            out[k] = mine[off:off + ln].view((t.shape[0] // n,)
                                             + tuple(t.shape[1:]))
            off += ln
    return out


def _bucket_all_gather(fulls, shards, axis):
    """Each ``full`` from every rank's rows (``shards`` this rank's)."""
    from .parallel.collectives import all_gather_into_
    n = axis.size
    for ks in _by_dtype(shards):
        flat = torch.cat([shards[k].reshape(-1) for k in ks])
        out = torch.empty((n, flat.numel()), dtype=flat.dtype,
                          device=flat.device)
        all_gather_into_(out, flat, axis)
        off = 0
        for k in ks:
            ln = shards[k].numel()
            fulls[k].view(n, ln).copy_(out[:, off:off + ln])
            off += ln


def _wd_zero(rule, hyper):
    return rule.wd_at is not None and hyper[rule.wd_at] == 0.0


def _lists(members, mp):
    """(weights or masters, gradients (float32 under multi-precision),
    rule states) of a group."""
    if mp:
        return ([it[3][0]._data for it in members],
                [it[1]._data.float() for it in members],
                [it[3][1] for it in members])
    return ([it[2]._data for it in members],
            [it[1]._data for it in members],
            [it[3] for it in members])
