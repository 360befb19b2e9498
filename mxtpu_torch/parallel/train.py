"""The data- and sequence-parallel training step (counterpart of
``mxtpu/parallel/train.py``: ``ShardedTrainStep`` and ``pure_forward``).

The reference compiles forward, loss, backward and update into one
sharded jit over a global batch. The port runs one process per card:
each rank takes its own shard of the batch (the reference's multi-process
input convention) and runs

1. the recorded forward and backward of its shard: a hybridized block
   replays its captured forward/backward pair (``CachedOp.record``), and
   a ring over a sequence axis (``sp``) runs its collectives inside it;
2. the gradients' collectives, outside any graph: summed over every mesh
   axis (``FusedUpdater`` with a ``MeshPlan``), under
   ``shard_weight_update`` (ZeRO-1) reduce-scattered over the data axis
   for each parameter whose dim 0 divides it;
3. the update, each group of parameters one captured update graph on the
   card (``optimizer_fused``), on this rank's rows under ZeRO-1, the
   rows all-gathered back into the weights;
4. the BatchNorm moving statistics (parameters without a gradient)
   averaged over the mesh, and the loss averaged for the caller.

The loss is the mean over the global batch, so the summed gradients are
scaled by 1 / (the ranks they are summed over). A world of one runs no
collective and takes the plain captured Trainer's step bit for bit. The
rule comes from ``optimizer_fused.functional_rule``, refusing what the
reference refuses (no rule, a rule with host state, multi-precision).
Dropout masks differ across ranks: in a process group the port's
generators are seeded with the seed plus the rank (``random``).

``param_specs`` (the reference's ``:187-223``): the first rule whose
pattern matches a parameter's name gives its spec (a tuple or
``parallel.P``); a shape that does not divide the axes falls back to
replicated, an axis not in the mesh raises. A matched parameter is held
as this rank's shard (``Sharding``), so are its optimizer states; ZeRO-1
applies to replicated parameters only. The ranks of a ``model``,
``expert`` or ``pipe`` axis all compute the same loss, so their gradients
are whole and summed over the data (and ``sp``) axes only:

* tensor parallel: a layer reads a sharded weight whole through
  ``gather_from`` (``read_whole``, the parameter's ``_read``), whose
  backward takes this rank's slice. This holds for any spec; the reference's ``qkv_weight`` rule
  does not split the fused projection by heads, so every rank computes
  the whole layer (a head-local layout would save that compute);
* expert parallel: ``SwitchMoE`` reads its expert shards as they are and
  runs this rank's experts (``parallel.moe``): the step gives no
  ``_read`` to a block that reads its shards itself (``_reads_shards``);
* pipeline parallel: ``pipeline_apply`` makes its gradients whole on
  every rank of the pipe axis itself (``parallel.pipeline``).
"""
from __future__ import annotations

import functools
import re

import torch

from .. import optimizer as opt_mod
from .. import optimizer_fused as _fused
from ..base import MXNetError
from . import collectives
from .mesh import P, Sharding

__all__ = ["ShardedTrainStep", "pure_forward", "placement", "read_whole"]


class _Placement(Sharding):
    """A parameter held as this rank's shard: its ``Sharding`` and the
    data axis of the step that placed it."""

    def __init__(self, mesh, spec, data_axis):
        super().__init__(mesh, spec)
        self.data_axis = data_axis


def placement(param):
    """The ``_Placement`` of a sharded parameter, else None."""
    return getattr(param, "_placement", None)


def read_whole(param, t):
    """``t``, the tensor of ``param``, whole: where the parameter is
    sharded, gathered over each split dimension's axis with
    ``gather_from``."""
    pl = placement(param)
    if pl is None:
        return t
    from .. import graphs
    if graphs.capturing():
        raise MXNetError(
            "%s is sharded over the mesh: its all-gather runs outside any "
            "captured graph, so do not hybridize a block with sharded "
            "param_specs" % param.name)
    for dim, name in enumerate(pl.spec):
        if name is not None:
            t = collectives.gather_from(t, pl.mesh.axis(name), dim)
    return t


def _spec_for(name, shape, rules, mesh):
    """The spec of the first rule whose pattern matches ``name`` (None:
    replicated). An axis not in the mesh raises; a shape that does not
    divide its axes falls back to replicated."""
    for pat, spec in rules:
        if not pat.match(name):
            continue
        spec = spec if isinstance(spec, P) else P(*spec)
        for dim, axis in zip(shape, spec):
            if axis is None:
                continue
            if axis not in mesh.shape:
                raise MXNetError(
                    "param_specs rule %r -> %s names axis %r not in mesh "
                    "axes %s" % (pat.pattern, spec, axis, tuple(mesh.shape)))
            if dim % mesh.shape[axis]:
                return None
        if any(a is not None and mesh.shape[a] > 1 for a in spec):
            return spec
        return None
    return None


def _param_names(block):
    """The ``functional_call`` name of each of ``collect_params()``."""
    where = {id(m): n for n, m in block.named_modules()}
    names = []
    for p in block.collect_params().values():
        module, attr = p._owner
        prefix = where[id(module)]
        names.append(prefix + "." + attr if prefix else attr)
    return names


def pure_forward(block, train=False):
    """The block's forward as a function of its parameters: ``(fn,
    param_datas)`` where ``fn(param_datas, *inputs, rng=None)`` maps
    tensors to tensor(s) through ``torch.func.functional_call``. In
    ``train=True`` mode a Dropout draws from ``rng`` (a
    ``torch.Generator``) or, when None, the device generator, so two
    calls draw two masks; ``train=False`` is deterministic."""
    from .. import autograd
    params = list(block.collect_params().values())
    if not all(p.initialized for p in params):
        raise MXNetError(
            "pure_forward requires initialized parameters; call initialize() "
            "and run one forward pass to settle deferred shapes")
    names = _param_names(block)
    param_datas = [p.data()._data for p in params]

    def fn(param_datas, *inputs, rng=None):
        from .. import random as _random
        scope = autograd.train_mode() if train else autograd.predict_mode()
        with scope:
            if rng is not None and inputs:
                dev = inputs[0].device
                gen = _random.generator(dev)
                state = gen.get_state()
                gen.set_state(rng.get_state())
            try:
                out = torch.func.functional_call(
                    block, dict(zip(names, param_datas)), tuple(inputs))
            finally:
                if rng is not None and inputs:
                    rng.set_state(gen.get_state())
                    gen.set_state(state)
        return out

    return fn, param_datas


def _mean(x):
    return x.mean() if x.ndim else x


class ShardedTrainStep:
    """One training step over a mesh for a gluon block (module
    docstring). Arguments as the reference's: ``loss(out, label)``;
    ``mesh`` with a ``data_axis`` (and optionally ``sp``);
    ``optimizer``/``optimizer_params`` (an ``lr_scheduler`` among them
    moves the lr with the step count); ``forward(block, *batch) -> loss``
    overrides ``loss(block(data), label)``; ``shard_weight_update``
    ZeRO-1. The inputs are this rank's shards, so ``batch_specs`` must be
    None; ``donate`` is accepted for the reference's signature (updates
    are in place)."""

    def __init__(self, block, loss, mesh, optimizer="sgd",
                 optimizer_params=None, data_axis="data", param_specs=(),
                 batch_specs=None, forward=None, donate=True,
                 shard_weight_update=False):
        if batch_specs is not None:
            raise MXNetError(
                "batch_specs: each rank passes its own shard of the batch "
                "(Trainer.shard_batch or a parallel.Sharding cuts it)")
        if data_axis not in mesh.shape:
            raise MXNetError("mesh has no %r axis (axes: %s)"
                             % (data_axis, tuple(mesh.shape)))
        self._block = block
        self._loss = loss
        self._mesh = mesh
        self._data_axis = data_axis
        self._forward = forward
        opt_params = dict(optimizer_params or {})
        if isinstance(optimizer, opt_mod.Optimizer):
            if opt_params:
                raise MXNetError("optimizer_params must be empty when "
                                 "optimizer is an Optimizer instance")
            opt = optimizer
        else:
            try:
                opt = opt_mod.create(optimizer, **opt_params)
            except TypeError as e:
                raise MXNetError("unknown optimizer_params for %r: %s"
                                 % (optimizer, e))
        rule = _fused.functional_rule(opt)
        if rule is None or rule.thyper is None:
            raise MXNetError(
                "ShardedTrainStep needs an update rule whose "
                "hyperparameters follow from (lr, wd, step count); %r has "
                "none (supported: %s). Host-state optimizers (Nadam/SGLD/"
                "LBSGD) keep their per-index semantics on the gluon.Trainer "
                "path." % (optimizer, _fused.traced_rule_names()))
        if getattr(opt, "multi_precision", False):
            raise MXNetError(
                "ShardedTrainStep does not implement the multi-precision "
                "(float32 master) storage rule; use gluon.Trainer(mesh=...), "
                "whose FusedUpdater handles multi_precision")
        params = list(block.collect_params().values())
        if not all(p.initialized for p in params):
            raise MXNetError(
                "initialize() the block and run one forward pass before "
                "building a ShardedTrainStep")
        self._params = params
        self._trainable = [i for i, p in enumerate(params)
                           if p.grad_req != "null"]
        self._aux = [i for i, p in enumerate(params)
                     if p.grad_req == "null"]
        opt.param_dict = dict(enumerate(params))
        self._opt = opt
        self._updater = _fused.FusedUpdater(opt)
        self._updater.set_mesh(mesh, data_axis, shard_weight_update)
        self._axes = [mesh.axis(n) for n, size in mesh.shape.items()
                      if size > 1]
        plan = self._updater._plan
        self._ranks = 1     # the ranks whose gradients are summed
        for axis in [plan.data()] + plan.other_axes():
            self._ranks *= axis.size
        with torch.no_grad():   # one replicated copy: every rank takes index 0's
            for axis in self._axes:
                for p in params:
                    collectives.broadcast_(p.data()._data, axis)
        rules = [(re.compile(pat), spec) for pat, spec in param_specs]
        for i, p in enumerate(params):
            spec = _spec_for(p.name, tuple(p.data().shape), rules, mesh)
            if spec is None:
                continue
            pl = _Placement(mesh, spec, data_axis
                            if mesh.shape[data_axis] > 1 else None)
            p._put(pl.shard(p.data()._data.detach()).contiguous())
            p._placement = pl
            plan.sharded.add(i)
            if not getattr(p._owner[0], "_reads_shards", False):
                p._read = functools.partial(read_whole, p)
        self._num_update = 0

    def _inputs(self, batch):
        from ..ndarray import NDArray
        device = self._params[0].data()._data.device
        out = []
        for x in batch:
            t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
            out.append(NDArray(t.to(device)))
        return out

    def __call__(self, *batch):
        """One step on this rank's shard of the batch (``(data, label)``
        by default). Returns the global mean loss, an NDArray on the
        card (no host sync)."""
        from .. import autograd
        from ..ndarray import NDArray
        args = self._inputs(batch)
        self._last_args = args
        with autograd.record():
            if self._forward is not None:
                out = self._forward(self._block, *args)
            else:
                if len(args) < 2:
                    raise MXNetError(
                        "default convention needs (data..., label); pass "
                        "forward= for custom batch structures")
                out = self._loss(self._block(*args[:-1]), args[-1])
            scalar = out.mean()
        scalar.backward()
        self._num_update += 1
        self._opt.rescale_grad = 1.0 / self._ranks
        params = self._params
        self._updater.update_batch(
            list(self._trainable), [params[i].grad() for i in self._trainable],
            [params[i].data() for i in self._trainable])
        loss = scalar._data.detach().float()
        with torch.no_grad():
            for axis in self._axes:
                loss = collectives.all_reduce_(loss.clone(), axis)
                for i in self._aux:
                    t = params[i].data()._data
                    collectives.all_reduce_(t, axis)
                    t.div_(axis.size)
        return NDArray(loss / self._mesh.size)

    def compiled_step_flops(self):
        """FLOPs of one step's forward and backward, counted by the port's
        FLOP ledger (``xprof.measuring``: torch's op counts plus the kernel
        wrappers' own) on the last step's batch. The pass runs the block
        eagerly, as a child inside a capture runs, gives back the state it
        moves (BatchNorm's statistics, the generator) and writes no
        gradient; the update's few FLOPs a weight are left out. In a
        process group every rank calls it (the forward's collectives run).
        Raises before the first step (the shapes are not known)."""
        from .. import autograd, graphs, random, xprof
        args = getattr(self, "_last_args", None)
        if args is None:
            raise MXNetError("run at least one step before asking for FLOPs")
        params = self._params
        diff = [params[i].data()._data for i in self._trainable]
        aux = [params[i].data()._data for i in self._aux]
        device = (diff or aux)[0].device
        diff = [t for t in diff if t.requires_grad]
        gen = random.generator(device)
        state = graphs._STATE
        prev_gens = getattr(state, "generators", ())
        with graphs.keeping(aux), graphs.keeping_generators([gen]), \
                xprof.measuring() as counted:
            state.depth = getattr(state, "depth", 0) + 1
            state.generators = set(prev_gens) | {id(gen)}
            try:
                with autograd.record():
                    if self._forward is not None:
                        out = self._forward(self._block, *args)
                    else:
                        out = self._loss(self._block(*args[:-1]), args[-1])
                    scalar = out.mean()._data
                torch.autograd.grad(scalar, diff, allow_unused=True)
            finally:
                state.generators = prev_gens
                state.depth -= 1
        return counted["flops"]

    @property
    def learning_rate(self):
        return self._opt.learning_rate

    def set_learning_rate(self, lr):
        """A new lr from the next step on; the captured update graphs read
        it from their static inputs, so nothing is built again."""
        if self._opt.lr_scheduler is not None:
            raise MXNetError(
                "cannot set learning_rate: an lr_scheduler is active")
        self._opt.set_learning_rate(float(lr))
