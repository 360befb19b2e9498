"""The port's update ops, optimizers, lr schedulers, fused updater and
metrics (mxtpu_torch/{ops/optimizer_ops,optimizer,optimizer_fused,
lr_scheduler,metric}.py) against the JAX package's, on the same seeded
numpy inputs, on the CPU.

Tolerances: float32 rtol=atol=1e-5 for update ops and three optimizer
steps (the same formulas in the same order; the two sides may round a
fused multiply-add differently); bfloat16 weights under multi_precision
one bf16 spacing (2^-8 relative) plus 1e-6, since both sides cast a
float32 master that agrees to 1e-5; SGLD draws its noise from each
package's own generator, so its test checks the noise's spread. The
``FusedUpdater`` must give the per-index ``Updater``'s weights and states
bit for bit on the CPU. Schedulers and metrics are pure Python and numpy:
equal to 1e-12.
"""
import math
import pickle

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import optimizer as topt
from mxtpu_torch import optimizer_fused
from mxtpu_torch.optimizer_fused import FusedUpdater

TOL = 1e-5
SHAPES = [(3, 4), (5,), (2, 3, 2)]


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _t(a):
    return mt.nd.array(np.asarray(a, np.float32), ctx=mt.cpu())


def _j(a):
    return mx.nd.array(np.asarray(a, np.float32))


def _close(got, ref, tol=TOL, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=what)


# ----------------------------------------------------------------- update ops
UPDATE_OPS = [
    ("sgd_update", 0, dict(lr=0.1, wd=0.01, rescale_grad=0.5)),
    ("sgd_update", 0, dict(lr=0.1, clip_gradient=0.3)),
    ("sgd_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("nag_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("adam_update", 2, dict(lr=0.01, wd=0.001, rescale_grad=0.25)),
    ("rmsprop_update", 1, dict(lr=0.01, gamma1=0.9, clip_weights=0.8)),
    ("rmspropalex_update", 3, dict(lr=0.01, gamma1=0.9, gamma2=0.8)),
    ("ftrl_update", 2, dict(lr=0.1, lamda1=0.01, beta=1.0, wd=0.01)),
    ("adagrad_update", 1, dict(lr=0.1, epsilon=1e-7, wd=0.01)),
    ("signsgd_update", 0, dict(lr=0.1, wd=0.01)),
    ("signum_update", 1, dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.01)),
]


@pytest.mark.parametrize("name,n_state,kw", UPDATE_OPS,
                         ids=[u[0] + str(i) for i, u in enumerate(UPDATE_OPS)])
def test_update_op_matches_mxtpu_in_place(name, n_state, kw):
    r = np.random.RandomState(len(name) + n_state)
    w, g = r.randn(4, 5), r.randn(4, 5)
    states = [np.abs(r.randn(4, 5)) * 0.1 for _ in range(n_state)]
    tw, tg, ts = _t(w), _t(g), [_t(s) for s in states]
    jw, jg, js = _j(w), _j(g), [_j(s) for s in states]
    before = tw._data
    for _ in range(2):
        getattr(mt.nd, name)(tw, tg, *ts, **kw)
        getattr(mx.nd, name)(jw, jg, *js, **kw)
    assert tw._data is before           # written in place
    _close(tw, jw, what=name)
    for a, b in zip(ts, js):
        _close(a, b, what=name + " state")


def test_update_fn_skips_zero_wd_so_inf_weights_stay_finite_updates():
    from mxtpu_torch.ops import optimizer_ops as uo
    w = torch.tensor([float("inf"), 1.0])
    out = uo.sgd_update_fn(w, torch.ones(2), 0.1, wd=0.0)
    assert torch.isinf(out[0]) and out[1] == 0.9   # no 0 * inf = nan


# ----------------------------------------------------------------- optimizers
OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("sgd", dict(learning_rate=0.1, wd=1e-3, clip_gradient=0.5)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("signum", dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01)),
    ("ftml", dict(learning_rate=0.01, wd=1e-3)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, clip_gradient=1.0)),
    ("adagrad", dict(learning_rate=0.1, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=2.0)),
    ("adadelta", dict(wd=1e-3)),
    ("ftrl", dict(learning_rate=0.1, wd=1e-3)),
    ("adamax", dict(learning_rate=0.01, wd=1e-3)),
    ("nadam", dict(learning_rate=0.01, wd=1e-3)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9,
                   warmup_strategy="lars")),
    ("test", dict(rescale_grad=0.5)),
    ("groupadagrad", dict(learning_rate=0.1, clip_gradient=0.5)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, multi_precision=True)),
    ("adam", dict(learning_rate=0.01, multi_precision=True)),
]


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s]


def _run_updater(pkg, upd_cls, name, kw, weights, grads, dtype="float32"):
    opt = pkg.optimizer.create(name, **kw)
    upd = upd_cls(opt)
    arr = _t if pkg is mt else _j
    ws = [arr(w).astype(dtype) for w in weights]
    for step in range(3):
        for i, (w, g) in enumerate(zip(ws, grads)):
            upd(i, arr(g[step]).astype(dtype), w)
    return ws, upd


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["%s%d" % (o[0], i)
                              for i, o in enumerate(OPTIMIZERS)])
def test_optimizer_three_steps_match_mxtpu(name, kw):
    r = np.random.RandomState(7)
    weights = [r.randn(*s) for s in SHAPES]
    grads = [[r.randn(*s) for _ in range(3)] for s in SHAPES]
    dtype = "bfloat16" if kw.get("multi_precision") else "float32"
    tws, tupd = _run_updater(mt, topt.Updater, name, kw, weights, grads,
                             dtype)
    jws, jupd = _run_updater(mx, mx.optimizer.Updater, name, kw, weights,
                             grads, dtype)
    tol = 2.0 ** -8 if dtype == "bfloat16" else TOL
    for i, (a, b) in enumerate(zip(tws, jws)):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        _close(a.astype("float32"), b.astype("float32"), tol, "w%d" % i)
    # the states, leaf by leaf (float32 masters and states under mp)
    for i in range(len(SHAPES)):
        ta, ja = _leaves(tupd.states[i]), _leaves(jupd.states[i])
        assert len(ta) == len(ja)
        for a, b in zip(ta, ja):
            _close(a, b, TOL, "state %d" % i)
    assert tupd.optimizer.num_update == jupd.optimizer.num_update
    assert tupd.optimizer._index_update_count == \
        jupd.optimizer._index_update_count


def test_sgld_noise_has_the_reference_spread():
    lr = 0.04
    opt = mt.optimizer.create("sgld", learning_rate=lr)
    w = _t(np.zeros((200, 200)))
    mt.random.seed(3)
    topt.Updater(opt)(0, _t(np.ones((200, 200))), w)
    noise = w.asnumpy() + lr / 2       # w - lr/2 * g + N(0, lr)
    assert abs(noise.mean()) < 0.01
    assert abs(noise.std() - math.sqrt(lr)) < 0.01


def test_lr_and_wd_mult_from_parameters_and_tables():
    p = mt.gluon.Parameter("w", shape=(2,), lr_mult=0.5, wd_mult=0.0)
    opt = mt.optimizer.create("sgd", learning_rate=0.2, wd=0.1,
                              param_dict={0: p})
    assert opt._get_lr(0) == 0.1 and opt._get_wd(0) == 0.0
    opt = mt.optimizer.create("sgd", learning_rate=0.2, wd=0.1,
                              param_idx2name={1: "b"})
    opt.set_lr_mult({"b": 3.0})
    opt.set_wd_mult({"b": 2.0})
    assert abs(opt._get_lr(1) - 0.6) < 1e-12 and opt._get_wd(1) == 0.2


def test_updater_states_round_trip_and_restore_on_first_use():
    r = np.random.RandomState(8)
    opt = mt.optimizer.create("adam", learning_rate=0.01)
    upd = topt.Updater(opt)
    w = _t(r.randn(3, 4))
    upd(0, _t(r.randn(3, 4)), w)
    blob = upd.get_states(dump_optimizer=True)
    states, dumped = pickle.loads(blob)
    assert isinstance(dumped, topt.Adam) and dumped.param_dict == {}
    other = topt.Updater(mt.optimizer.create("adam", learning_rate=0.01))
    other.set_states(blob)
    assert isinstance(other.optimizer, topt.Adam)
    w2 = _t(w.asnumpy())
    g = r.randn(3, 4)
    upd(0, _t(g), w)
    other(0, _t(g), w2)      # the dumped optimizer carries the counts
    np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())


def test_create_refuses_unknown_optimizer():
    with pytest.raises(mt.MXNetError, match="Cannot find optimizer"):
        mt.optimizer.create("nope")
    assert mt.optimizer.contrib.GroupAdaGrad is topt.GroupAdaGrad


# -------------------------------------------------------------- fused updater
FUSED = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("sgd", dict(learning_rate=0.1, wd=0.0, clip_gradient=0.2)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, multi_precision=True)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, multi_precision=True)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9)),   # per index
]


@pytest.mark.parametrize("name,kw", FUSED,
                         ids=["%s%d" % (o[0], i) for i, o in enumerate(FUSED)])
def test_fused_updater_equals_updater_bit_for_bit(name, kw):
    r = np.random.RandomState(9)
    shapes = SHAPES + [(4, 3), (7,)]
    dt = "bfloat16" if kw.get("multi_precision") else "float32"
    weights = [r.randn(*s) for s in shapes]
    grads = [[r.randn(*s) for s in shapes] for _ in range(3)]
    mults = [1.0, 0.5, 2.0, 1.0, 0.0]

    def run(upd_cls):
        params = {}
        for i in range(len(shapes)):
            p = mt.gluon.Parameter("p%d" % i, lr_mult=mults[i],
                                   wd_mult=mults[-1 - i])
            params[i] = p
        opt = mt.optimizer.create(
            name, param_dict=params,
            lr_scheduler=mt.lr_scheduler.FactorScheduler(2, 0.5), **kw)
        upd = upd_cls(opt)
        ws = [_t(w).astype(dt) for w in weights]
        for step in range(3):
            opt.rescale_grad = 1.0 / (step + 2)
            gs = [_t(g).astype(dt) for g in grads[step]]
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
    assert fu.optimizer._index_update_count == \
        uu.optimizer._index_update_count
    assert fu.optimizer.num_update == uu.optimizer.num_update


def test_fused_updater_has_foreach_forms_and_no_host_sync(monkeypatch):
    assert sorted(k.__name__ for k in optimizer_fused._RULES) == \
        sorted(k.__name__ for k in mx.optimizer_fused._RULES)
    calls = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append("item"))
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: calls.append("cpu"))
    upd = FusedUpdater(mt.optimizer.create("adam", learning_rate=0.1))
    ws = [_t(np.ones((3, 3))), _t(np.ones(4))]
    upd.update_batch([0, 1], [_t(np.ones((3, 3))), _t(np.ones(4))], ws)
    assert calls == []


# ----------------------------------------------------------------- schedulers
SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=1.0)),
    ("FactorScheduler", dict(step=2, factor=0.9, base_lr=0.1,
                             warmup_steps=4, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3, base_lr=0.5)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.2, pwr=2,
                           final_lr=0.01, warmup_steps=3)),
    ("CosineScheduler", dict(max_update=10, base_lr=0.3, final_lr=0.05,
                             warmup_steps=2, warmup_mode="constant")),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=["%s%d" % (s[0], i)
                              for i, s in enumerate(SCHEDULERS)])
def test_lr_scheduler_matches_mxtpu(name, kw):
    a = getattr(mt.lr_scheduler, name)(**kw)
    b = getattr(mx.lr_scheduler, name)(**kw)
    for n in range(0, 15):
        assert abs(a(n) - b(n)) <= 1e-12


def test_optimizer_reads_scheduler_at_num_update():
    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    opt = mt.optimizer.create("sgd", learning_rate=1.0, lr_scheduler=sched)
    upd = topt.Updater(opt)
    w = _t(np.zeros(2))
    for _ in range(3):
        upd(0, _t(np.ones(2)), w)
    # num_update 1, 2, 3 -> lr 1, 0.5, 0.25 (steps past count + step)
    np.testing.assert_allclose(w.asnumpy(), -(1.0 + 0.5 + 0.25) * np.ones(2))
    assert opt.learning_rate == 0.25


# -------------------------------------------------------------------- metrics
def _metric_data(seed):
    r = np.random.RandomState(seed)
    labels = [r.randint(0, 3, 8).astype(np.float32) for _ in range(2)]
    preds = [np.abs(r.randn(8, 3)).astype(np.float32) for _ in range(2)]
    preds = [p / p.sum(1, keepdims=True) for p in preds]
    return labels, preds


METRICS = [("acc", {}), ("top_k_accuracy", {"top_k": 2}), ("f1", {}),
           ("mcc", {}), ("perplexity", {"ignore_label": 1}), ("mae", {}),
           ("mse", {}), ("rmse", {}), ("ce", {}), ("nll_loss", {}),
           ("pearsoncorrelation", {}), ("loss", {})]


@pytest.mark.parametrize("name,kw", METRICS, ids=[m[0] for m in METRICS])
def test_metric_matches_mxtpu(name, kw):
    labels, preds = _metric_data(11)
    if name in ("f1", "mcc"):
        labels = [(lab > 0).astype(np.float32) for lab in labels]
    if name in ("mae", "mse", "rmse", "pearsoncorrelation"):
        preds = [p[:, 0] for p in preds]
    a, b = mt.metric.create(name, **kw), mx.metric.create(name, **kw)
    for lab, p in zip(labels, preds):
        a.update([_t(lab)], [_t(p)])
        b.update([_j(lab)], [_j(p)])
    (na, va), (nb, vb) = a.get(), b.get()
    assert na == nb
    np.testing.assert_allclose(va, vb, rtol=1e-6, atol=1e-12)
    a.reset()
    assert math.isnan(a.get()[1]) or name in ("f1", "mcc")


def test_metric_composite_custom_and_tensor_inputs():
    labels, preds = _metric_data(12)
    comp = mt.metric.create(["acc", "ce"])
    ref = mx.metric.create(["acc", "ce"])
    comp.update([torch.from_numpy(labels[0])], [torch.from_numpy(preds[0])])
    ref.update([_j(labels[0])], [_j(preds[0])])
    assert comp.get()[0] == ref.get()[0]
    np.testing.assert_allclose(comp.get()[1], ref.get()[1], rtol=1e-6)

    def top1(label, pred):
        return float((pred.argmax(1) == label).mean())
    a = mt.metric.np_metric(top1)
    b = mx.metric.np_metric(top1)
    a.update([_t(labels[1])], [_t(preds[1])])
    b.update([_j(labels[1])], [_j(preds[1])])
    assert a.get() == b.get()
    acc = mt.metric.Accuracy()
    acc.update(_t(labels[0]), _t(preds[0]))     # a single array each
    assert acc.get()[1] == pytest.approx(ref.get()[1][0])
