"""One optimizer step over the whole parameter list (counterpart of
``mxtpu/optimizer_fused.py:FusedUpdater``, on one device).

The per-index ``Updater`` issues a handful of elementwise kernels per
parameter: ResNet-50's 161 parameters make ~800 launches a step.
``FusedUpdater.update_batch`` groups the parameters by rule, dtype,
device, multi-precision, state structure and the values of their
hyperparameters (lr and wd, Adam's bias-corrected lr), and updates each
group with ``torch._foreach_*`` ops. SGD (with and without momentum), NAG
and Adam have a foreach form; a foreach form repeats its rule's
arithmetic op for op in the same order (``ops/optimizer_ops.py``), so it
gives the per-index ``Updater``'s weights and states bit for bit.

On a CUDA device each group's update is one captured CUDA graph (the
reference's one donated jit per ``Trainer.step``), keyed on the rule, its
static configuration (momentum, betas, epsilon, clip), whether the wd is
0, and the group's indices, shapes, dtypes and state structure. What
moves between steps lives in a static device tensor that the host writes
before each replay (``rescale_grad = scale / batch_size``, the group's lr
and wd): an lr-schedule tick or a batch-size change replays with no new
build. Each build counts at retrace site ``fused_optimizer`` and in
``FUSED_STATS``. The first step of a group is the graph's warm-up run; each
later step copies the gradients into the group's static buffers (the
autograd pass rebinds each gradient buffer) and replays. The graph reads
and writes the weights and states at the addresses it was captured with:
one replaced since (``set_data``, ``set_states``) is copied into the
captured storage, which its holder then shares, before the replay. The
host stages the hyperparameters through a ring of pinned buffers, a slot
written again only after the copy that read it has run. On the CPU the
same groups run eagerly.

Update counts (``_update_count``), state versions and ``ignore_stale_grad``
stay on the host, in index order (an lr scheduler reads the same
``num_update`` for every index), and nothing syncs with the device.
The reference's eager paths stay eager, counted in
``FUSED_STATS["eager_updates"]``: rules without a foreach form, optimizer
subclasses, items whose weight or state shares storage with another item's,
and every item while ``set_enabled(False)``. On a captured graph the
hyperparameters of a bfloat16 or float16 group without multi-precision
round to its dtype.

Not ported: the mesh plan and ZeRO-1 (ROADMAP A8) and the numerics guard
with its loss scaler (A9).
"""
from __future__ import annotations

import collections
import threading
import weakref

import torch

from . import graphs, telemetry
from .optimizer import NAG, SGD, Adam, Updater

__all__ = ["FusedUpdater", "set_enabled", "fused_enabled", "cache_size",
           "reset", "FUSED_STATS"]

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
    ``+ w * wd`` unless the group's wd is 0."""
    g = torch._foreach_mul(grads, rescale)
    if cfg["clip"] is not None and cfg["clip"] > 0:
        torch._foreach_clamp_min_(g, -cfg["clip"])
        torch._foreach_clamp_max_(g, cfg["clip"])
    if not wd_zero:
        torch._foreach_add_(g, torch._foreach_mul(weights, wd))
    return g


def _sgd_step(cfg, ws, gs, states, rescale, lr, wd, wd_zero):
    g = _rescale_clip(cfg, gs, ws, rescale, wd, wd_zero)
    torch._foreach_mul_(g, lr)
    if states[0] is None:          # w - g * lr
        torch._foreach_sub_(ws, g)
        return
    moms = [s._data for s in states]   # mom = mom * momentum - g * lr
    torch._foreach_mul_(moms, cfg["momentum"])
    torch._foreach_sub_(moms, g)
    torch._foreach_add_(ws, moms)      # w + mom


def _nag_step(cfg, ws, gs, states, rescale, lr, wd, wd_zero):
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


def _adam_step(cfg, ws, gs, states, rescale, lr_t, wd, wd_zero):
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


def _momentum_cfg(opt):
    return {"clip": opt.clip_gradient, "momentum": opt.momentum}


def _adam_cfg(opt):
    return {"clip": opt.clip_gradient, "beta1": opt.beta1,
            "beta2": opt.beta2, "epsilon": opt.epsilon}


# rule -> (its static configuration, the (lr, wd) of one index, its
# foreach step); exact classes only: a subclass that overrides ``update``
# keeps its own
_RULES = {
    SGD: (_momentum_cfg, lambda opt, i: (opt._get_lr(i), opt._get_wd(i)),
          _sgd_step),
    NAG: (_momentum_cfg, lambda opt, i: (opt._get_lr(i), opt._get_wd(i)),
          _nag_step),
    Adam: (_adam_cfg, lambda opt, i: (opt._lr_t(i), opt._get_wd(i)),
           _adam_step),
}


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
        _UPDATERS.add(self)

    def update_batch(self, indices, grads, weights):
        opt = self.optimizer
        rule = _RULES.get(type(opt)) if fused_enabled() else None
        if rule is None:
            super().update_batch(indices, grads, weights)
            _stat("eager_updates", len(indices))
            return
        cfg_of, hyper_of, step = rule
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
                lr, wd = hyper_of(opt, i)
                key = (w._data.dtype, w._data.device, opt._mp(w),
                       _kind(state), float(lr), float(wd))
                groups.setdefault(key, []).append(it)
            if not groups:
                return
            _stat("fused_steps")
            cfg = cfg_of(opt)
            device = next(iter(groups))[1]
            if graphs.captures(device):
                self._replay(groups, cfg, step, opt.rescale_grad, device)
                return
            for (_, _, mp, _, lr, wd), members in groups.items():
                ws, gs, states = _lists(members, mp)
                step(cfg, ws, gs, states, opt.rescale_grad, lr, wd,
                     wd == 0.0)
                if mp:
                    torch._foreach_copy_([it[2]._data for it in members], ws)
                _bump_all(members)

    def _replay(self, groups, cfg, step, rescale, device):
        """Each group's captured graph: stage the hyperparameters; per
        group copy them and the gradients into its static buffers, put any
        replaced weight or state back into the captured storage, and
        replay. A group seen for the first time is captured, its warm-up
        run being this step's update."""
        values = []
        for (_, _, _, _, lr, wd) in groups:
            values += [rescale, lr, wd]
        host = self._staging.write(values, device)
        for n, ((dtype, _, mp, _, _, wd), members) in enumerate(
                groups.items()):
            gkey = (type(self.optimizer), tuple(sorted(cfg.items())), mp,
                    wd == 0.0, tuple((it[0], tuple(it[2].shape), dtype,
                                      _structure(it[3])) for it in members))
            hyper = host[3 * n:3 * n + 3]
            group = self._graphs.get(gkey)
            if group is None:
                self._graphs[gkey] = self._capture(
                    gkey, members, mp, cfg, step,
                    hyper.to(device, copy=True), wd == 0.0)
            else:
                static = group.graph.static_inputs
                static[-1].copy_(hyper, non_blocking=True)
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
            step(cfg, ws, gs, states, h[0], h[1], h[2], wd_zero)
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
