"""The fused optimizer rules of the port (``mxtpu_torch/optimizer_fused.py``
``_RULES``, the foreach form of every optimizer the reference fuses)
against the JAX package, on the CPU.

Each of the twelve rules added beside SGD, NAG and Adam takes three steps
through ``gluon.Trainer`` in both packages on the same seeded MLP, the
reference's gradients fed to both; weights agree within 5e-7 (both run
the same formulas in float32 in the same order; the reference's XLA may
contract a multiply-add). On
the port the fused path must also give the per-index ``Updater``'s
weights and states bit for bit. ``functional_rule``/``traced_rule_names``
name the reference's set: Nadam keeps host state and has no traced twin.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import optimizer as topt
from mxtpu_torch import optimizer_fused
from mxtpu_torch.optimizer_fused import FusedUpdater

TOL = 5e-7

NEW_RULES = [
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd=1e-3, wd_lh=1e-2)),
    ("signum", dict(learning_rate=0.01, momentum=0.0, wd=1e-3)),
    ("ftml", dict(learning_rate=0.01, wd=1e-3)),
    ("dcasgd", dict(learning_rate=0.05, momentum=0.9, wd=1e-3)),
    ("dcasgd", dict(learning_rate=0.05)),
    ("adagrad", dict(learning_rate=0.05, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=2.0)),
    ("adadelta", dict(wd=1e-3)),
    ("ftrl", dict(learning_rate=0.1, wd=1e-3)),
    ("adamax", dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.5)),
    ("nadam", dict(learning_rate=0.01, wd=1e-3)),
    ("groupadagrad", dict(learning_rate=0.1, clip_gradient=0.5)),
    ("test", dict()),
]
IDS = ["%s%d" % (o[0], i) for i, o in enumerate(NEW_RULES)]


def _mlp(pkg, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6),
            pkg.gluon.nn.Dense(3, in_units=8))
    net.initialize(**ctx)
    return net


def _setup(pkg, name, kw, r):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    net = _mlp(pkg, ctx)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(r.randn(*p.shape).astype(np.float32) * 0.5,
                                **ctx))
    return net, pkg.gluon.Trainer(net.collect_params(), name, dict(kw)), ctx


@pytest.mark.parametrize("name,kw", NEW_RULES, ids=IDS)
def test_three_trainer_steps_match_mxtpu(name, kw):
    """Lockstep: each step the reference's gradients go into both
    Trainers (the backward passes of the two packages round apart), so
    the weights compare the two update paths alone."""
    optimizer_fused.reset()
    nets = {}
    for pkg in (mt, mx):
        nets[pkg] = _setup(pkg, name, kw, np.random.RandomState(3))
    r = np.random.RandomState(4)
    for step in range(3):
        x = r.randn(5, 6).astype(np.float32)
        y = r.randn(5, 3).astype(np.float32)
        net, trainer, ctx = nets[mx]
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(net(mx.nd.array(x)),
                                          mx.nd.array(y))
        loss.backward()
        trainer.step(5)
        grads = [p.grad().asnumpy() for p in net.collect_params().values()]
        net, trainer, ctx = nets[mt]
        for p, g in zip(net.collect_params().values(), grads):
            p.grad()[:] = mt.nd.array(g, ctx=mt.cpu())
        trainer.step(5)
    assert optimizer_fused.FUSED_STATS["fused_steps"] == 3
    assert optimizer_fused.FUSED_STATS["eager_updates"] == 0
    for a, b in zip(nets[mt][0].collect_params().values(),
                    nets[mx][0].collect_params().values()):
        np.testing.assert_allclose(a.data().asnumpy(), b.data().asnumpy(),
                                   rtol=TOL, atol=TOL)


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s]


@pytest.mark.parametrize("name,kw", NEW_RULES, ids=IDS)
def test_fused_rule_equals_updater_bit_for_bit(name, kw):
    r = np.random.RandomState(9)
    shapes = [(3, 4), (5,), (2, 3, 2), (4, 3)]
    weights = [r.randn(*s) for s in shapes]
    grads = [[r.randn(*s) for s in shapes] for _ in range(3)]

    def run(upd_cls):
        opt = mt.optimizer.create(
            name, lr_scheduler=mt.lr_scheduler.FactorScheduler(2, 0.5)
            if "learning_rate" in kw else None, **kw)
        upd = upd_cls(opt)
        ws = [mt.nd.array(w.astype(np.float32), ctx=mt.cpu())
              for w in weights]
        for step in range(3):
            opt.rescale_grad = 1.0 / (step + 2)
            gs = [mt.nd.array(g.astype(np.float32), ctx=mt.cpu())
                  for g in grads[step]]
            if upd_cls is FusedUpdater:
                upd.update_batch(list(range(len(ws))), gs, ws)
            else:
                for i, (g, w) in enumerate(zip(gs, ws)):
                    upd(i, g, w)
        return ws, upd

    fw, fu = run(FusedUpdater)
    uw, uu = run(topt.Updater)
    for a, b in zip(fw, uw):
        assert torch.equal(a._data, b._data)
    for i in fu.states:
        fs, us = _leaves(fu.states[i]), _leaves(uu.states[i])
        assert len(fs) == len(us)
        for a, b in zip(fs, us):
            assert torch.equal(a._data, b._data)


def test_functional_rule_and_traced_names_are_the_references():
    assert optimizer_fused.traced_rule_names() == \
        mx.optimizer_fused.traced_rule_names()
    assert "nadam" not in optimizer_fused.traced_rule_names()
    for name in ("sgd", "adam", "nadam", "ftml", "groupadagrad"):
        opt = mt.optimizer.create(name)
        rule = optimizer_fused.functional_rule(opt)
        ref = mx.optimizer_fused.functional_rule(mx.optimizer.create(name))
        assert (rule is None) == (ref is None)
        assert (rule.thyper is None) == (ref.thyper is None)
    for name in ("sgld", "lbsgd"):
        assert optimizer_fused.functional_rule(
            mt.optimizer.create(name)) is None
        assert mx.optimizer_fused.functional_rule(
            mx.optimizer.create(name)) is None
