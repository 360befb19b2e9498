"""The captured training step on the CPU: a hybridized block's recorded
calls (``CachedOp.record``, a ``graphs.CapturedPair`` taped as one node)
and the ``FusedUpdater``'s captured update, driven through a stand-in for
``graphs.CapturedGraph`` (nothing captures on the CPU) with
``graphs.captures`` answering yes for the CPU. The stand-in runs the
function once when it is built, as the real graph's warm-up does, and
each replay runs it again on its static inputs while the optimizer's
``lr``, ``wd``, ``rescale_grad`` and update counts are NaN: a rule that
bakes them in, or reads them in place of its static tensors, gives NaN
weights.

Held to ``mxtpu`` hybridized, three steps in lockstep (the tolerances of
tests/test_torch_trainer.py: per-sample losses rtol=atol=1e-4; weights,
optimizer states and BatchNorm running statistics after the third step
within 1e-4 of max(1, max|ref|)): a narrow bottleneck ResNet v1 with BatchNorm under
SGD-momentum with wd, and a 2-layer narrow TransformerLM under Adam.
Also: input gradients (the reference's ``test_hybrid_grad_parity``), an
lr change and a batch-size change with no new build at ``cached_op`` or
``fused_optimizer``, two recorded forwards before one backward, a
``set_data`` between steps, tied parameters updated per item, and
``record(train_mode=False)`` keyed apart.
"""
import math

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon.model_zoo import transformer as jtr
from mxtpu.gluon.model_zoo.vision import resnet as jres
from mxtpu_torch import convert, graphs
from mxtpu_torch import optimizer_fused as tof
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.gluon.model_zoo import transformer as ttr
from mxtpu_torch.gluon.model_zoo.vision import resnet as tres

TOL = 1e-4
CHANNELS = [8, 16, 32, 48, 64]
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
ADAM = {"learning_rate": 1e-3, "wd": 1e-4}
LM = dict(vocab_size=97, dim=64, num_heads=2, num_layers=2, max_len=64,
          causal=False)
STEPS, BATCH, B, T = 3, 4, 2, 32


class FakeGraph:
    """``CapturedGraph`` on the CPU (module docstring)."""

    made = []
    poisoned = []    # optimizers whose moving values are NaN in a replay

    def __init__(self, fn, static_inputs, pool=None, device=None,
                 generators=()):
        self.static_inputs = list(static_inputs)
        self._fn = fn
        self._training = mt.autograd.is_training()
        self.outputs = [o.detach().clone() if isinstance(o, torch.Tensor)
                        else o for o in self._run()]
        FakeGraph.made.append(self)

    def _run(self):
        """``fn`` on the static inputs as the real graph's capture sees
        it: ``graphs.capturing()`` is true (a hybridized child runs eagerly
        into its parent's graph)."""
        graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
        try:
            return self._fn(*self.static_inputs)
        finally:
            graphs._STATE.depth -= 1

    def replay(self):
        saved = [(o, o.lr, o.wd, o.rescale_grad, o.num_update,
                  o._index_update_count) for o in FakeGraph.poisoned]
        for o in FakeGraph.poisoned:
            o.lr = o.wd = o.rescale_grad = o.num_update = math.nan
            o._index_update_count = {k: math.nan
                                     for k in o._index_update_count}
        prev = mt.autograd.set_training(self._training)
        try:
            outs = self._run()
        finally:
            mt.autograd.set_training(prev)
            for o, *vals in saved:
                (o.lr, o.wd, o.rescale_grad, o.num_update,
                 o._index_update_count) = vals
        with torch.no_grad():
            for static, o in zip(self.outputs, outs):
                if isinstance(o, torch.Tensor):
                    static.copy_(o)
        return self.outputs


@pytest.fixture(autouse=True)
def _stand_in(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL", "MXTPU_BN_ONEPASS",
                "MXTPU_FLASH_INTERPRET", "MXTPU_MESH",
                "MXTPU_FUSED_OPTIMIZER"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made, FakeGraph.poisoned = [], []
    ttel.reset()
    tof.reset()
    yield
    FakeGraph.made, FakeGraph.poisoned = [], []
    tof.set_enabled(True)


def _keyed(params):
    return {k.partition("_")[2]: p for k, p in params.items()}


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s]


def _builds(site):
    st = ttel.retrace_stats(site)
    return 0 if st is None else st["compiles"]


def _close_scaled(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


# ------------------------------------------------------------------ models
def _resnet(arrays=None):
    with mt.layout("NHWC"):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                            classes=10, thumbnail=True)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=3)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def _jax_resnet(arrays):
    with mx.layout("NHWC"):
        jnet = jres.ResNetV1(jres.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, thumbnail=True)
    ours = convert._strip_top(list(arrays))
    for key, p in _keyed(jnet.collect_params()).items():
        p.set_data(mx.nd.array(arrays[ours[key]]))
    jnet.hybridize()
    return jnet


def _lm(arrays=None):
    net = ttr.TransformerLM(**LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=4)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def _jax_lm(arrays):
    jnet = jtr.TransformerLM(**LM)
    ours = convert._strip_top(list(arrays))
    for key, p in _keyed(jnet.collect_params()).items():
        p.set_data(mx.nd.array(arrays[ours[key]]))
    jnet.hybridize()
    return jnet


def _arr(pkg, a, **kw):
    return mt.nd.array(a, ctx=mt.cpu(), **kw) if pkg is mt \
        else mx.nd.array(a, **kw)


def _step(pkg, net, trainer, loss_fn, x, y, reshape=None, batch=None):
    """The user's step (train_cifar10.py): record, net, loss, backward,
    trainer.step. Returns the per-sample losses."""
    xa = _arr(pkg, x, dtype="int32") if x.dtype.kind == "i" \
        else _arr(pkg, x)
    with pkg.autograd.record():
        out = net(xa)
        if reshape is not None:
            out = out.reshape((-1, reshape))
        loss = loss_fn(out, _arr(pkg, y).reshape((-1,)))
    loss.backward()
    trainer.step(batch or y.size)
    return loss.asnumpy()


def _setup(pkg, net, optimizer, params):
    trainer = pkg.gluon.Trainer(net.collect_params(), optimizer, dict(params))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    if pkg is mt:
        net.hybridize()
        loss_fn.hybridize()
        FakeGraph.poisoned.append(trainer.optimizer)
    return trainer, loss_fn


def _resnet_data(steps, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, BATCH).astype(np.float32))
            for _ in range(steps)]


def _lm_data(steps, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 97, (B, T)).astype(np.int32),
             rng.randint(0, 97, (B, T)).astype(np.float32))
            for _ in range(steps)]


def _check_against_mxtpu(net, jnet, tt, jt, tlosses, jlosses):
    for got, ref in zip(tlosses, jlosses):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    ours, theirs = _keyed(net.collect_params()), \
        _keyed(jnet.collect_params())
    assert ours.keys() == theirs.keys()
    for k in ours:
        _close_scaled(ours[k].data().asnumpy(), theirs[k].data().asnumpy(),
                      k)
    tstates = tt._updaters[0].states
    jstates = jt._updaters[0].states
    assert tstates.keys() == jstates.keys()
    for i in tstates:
        for a, b in zip(_leaves(tstates[i]), _leaves(jstates[i])):
            _close_scaled(a.asnumpy(), b.asnumpy(), "state %d" % i)


@pytest.fixture(scope="module")
def resnet_arrays():
    return _resnet()[1]


@pytest.fixture(scope="module")
def lm_arrays():
    return _lm()[1]


# ---------------------------------------------------------------- lockstep
def test_captured_resnet_matches_mxtpu_hybridized(resnet_arrays):
    """Three SGD-momentum steps: losses, weights, momenta and BatchNorm
    running statistics (moved once a forward) against mxtpu hybridized;
    one pair per hybridized block and one update graph."""
    net, _ = _resnet(resnet_arrays)
    jnet = _jax_resnet(resnet_arrays)
    tt, tl = _setup(mt, net, "sgd", SGD)
    jt, jl = _setup(mx, jnet, "sgd", SGD)
    data = _resnet_data(STEPS)
    tlosses = [_step(mt, net, tt, tl, x, y) for x, y in data]
    jlosses = [_step(mx, jnet, jt, jl, x, y) for x, y in data]
    _check_against_mxtpu(net, jnet, tt, jt, tlosses, jlosses)
    assert len(net._cached_op._pairs) == 1
    assert _builds("cached_op") == 2           # the net and the loss
    assert _builds("fused_optimizer") == tof.cache_size() == 1
    assert tof.FUSED_STATS["fused_steps"] == STEPS
    assert tof.FUSED_STATS["eager_updates"] == 0
    stats = [p for k, p in _keyed(net.collect_params()).items()
             if k.endswith("running_mean")]
    assert stats and all(np.abs(p.data().asnumpy()).max() > 0
                         for p in stats)


def test_captured_lm_matches_mxtpu_hybridized(lm_arrays):
    """Three Adam steps of the 2-layer TransformerLM: losses, weights and
    both moments against mxtpu hybridized."""
    net, _ = _lm(lm_arrays)
    jnet = _jax_lm(lm_arrays)
    tt, tl = _setup(mt, net, "adam", ADAM)
    jt, jl = _setup(mx, jnet, "adam", ADAM)
    data = _lm_data(STEPS)
    vocab = LM["vocab_size"]
    tlosses = [_step(mt, net, tt, tl, x, y, vocab) for x, y in data]
    jlosses = [_step(mx, jnet, jt, jl, x, y, vocab) for x, y in data]
    _check_against_mxtpu(net, jnet, tt, jt, tlosses, jlosses)
    assert _builds("cached_op") == 2
    assert _builds("fused_optimizer") == 1


def test_captured_step_equals_eager_step(resnet_arrays):
    """The captured step and the port's eager step (no hybridize, the
    fused step off) give the same weights and states."""
    data = _resnet_data(2, seed=5)
    runs = []
    for captured in (True, False):
        tof.set_enabled(captured)
        net, _ = _resnet(resnet_arrays)
        tt, tl = _setup(mt, net, "sgd", SGD)
        if not captured:
            net.hybridize(False)
            tl.hybridize(False)
        losses = [_step(mt, net, tt, tl, x, y) for x, y in data]
        runs.append((net, tt, losses))
    (net, tt, losses), (enet, ett, elosses) = runs
    for a, b in zip(losses, elosses):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for (k, p), q in zip(net.collect_params().items(),
                         enet.collect_params().values()):
        np.testing.assert_allclose(p.data().asnumpy(), q.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert tof.FUSED_STATS["eager_updates"] == 2 * sum(
        p.grad_req != "null" for p in tt._params)


# ----------------------------------------------------- schedules and batch
def test_lr_and_batch_change_do_not_rebuild(resnet_arrays):
    """The reference's two recompile tests: an lr change and a new
    batch size in ``step`` replay the same graphs, and the weights follow
    the new values (the stand-in's replays see NaN for the Python ones)."""
    data = _resnet_data(3, seed=7)
    out = []
    for captured in (True, False):
        tof.set_enabled(captured)
        net, _ = _resnet(resnet_arrays)
        tt, tl = _setup(mt, net, "sgd", SGD)
        if not captured:
            net.hybridize(False)
            tl.hybridize(False)
        _step(mt, net, tt, tl, *data[0])
        builds = (_builds("cached_op"), _builds("fused_optimizer"))
        tt.set_learning_rate(0.05)
        _step(mt, net, tt, tl, *data[1])
        _step(mt, net, tt, tl, *data[2], batch=2 * BATCH)
        if captured:
            assert (_builds("cached_op"), _builds("fused_optimizer")) == \
                builds == (2, 1)
            assert tof.cache_size() == 1
        out.append([p.data().asnumpy() for p in
                    net.collect_params().values()])
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_adam_bias_correction_follows_the_update_count(lm_arrays):
    """Adam's bias-corrected lr moves every step (the update count), with
    one update graph; its weights follow mxtpu's for four steps."""
    net, _ = _lm(lm_arrays)
    jnet = _jax_lm(lm_arrays)
    tt, tl = _setup(mt, net, "adam", ADAM)
    jt, jl = _setup(mx, jnet, "adam", ADAM)
    vocab = LM["vocab_size"]
    for x, y in _lm_data(4, seed=9):
        _step(mt, net, tt, tl, x, y, vocab)
        _step(mx, jnet, jt, jl, x, y, vocab)
    for k, p in _keyed(net.collect_params()).items():
        _close_scaled(p.data().asnumpy(),
                      _keyed(jnet.collect_params())[k].data().asnumpy(), k)
    assert _builds("fused_optimizer") == 1


# ------------------------------------------------- two forwards, set_data
def test_two_forwards_before_one_backward_give_eager_gradients(
        resnet_arrays):
    """Gradient accumulation over micro-batches: two recorded forwards of
    one signature before one backward. The second finds the first pair
    holding its activations and captures another; the gradients equal
    the eager ones, and a step after it reuses the first pair."""
    (x1, y1), (x2, y2), (x3, y3) = _resnet_data(3, seed=11)
    grads = []
    for captured in (True, False):
        net, _ = _resnet(resnet_arrays)
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        if captured:
            net.hybridize()
        with mt.autograd.record():
            l1 = loss_fn(net(_arr(mt, x1)), _arr(mt, y1))
            l2 = loss_fn(net(_arr(mt, x2)), _arr(mt, y2))
            total = l1 + l2
        total.backward()
        grads.append([p.grad().asnumpy() for p in
                      net.collect_params().values() if p.grad_req != "null"])
        if captured:
            assert len(net._cached_op._pairs) == 1
            (pairs,) = net._cached_op._pairs.values()
            assert len(pairs) == 2 and _builds("cached_op") == 2
            with mt.autograd.record():
                loss_fn(net(_arr(mt, x3)), _arr(mt, y3)).backward()
            assert len(pairs) == 2 and _builds("cached_op") == 2
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_set_data_between_steps_is_seen_by_both_graphs(resnet_arrays):
    """A weight replaced by ``set_data`` after a step: the next recorded
    forward and the next captured update both read the new value."""
    data = _resnet_data(2, seed=13)
    out = []
    for captured in (True, False):
        tof.set_enabled(captured)
        net, _ = _resnet(resnet_arrays)
        tt, tl = _setup(mt, net, "sgd", SGD)
        if not captured:
            net.hybridize(False)
            tl.hybridize(False)
        _step(mt, net, tt, tl, *data[0])
        for p in list(net.collect_params().values())[:3]:
            p.set_data(p.data().asnumpy() * 0.5)
        losses = _step(mt, net, tt, tl, *data[1])
        out.append((losses, [p.data().asnumpy() for p in
                             net.collect_params().values()]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_set_data_source_survives_fused_step():
    """The reference's test: ``set_data`` copies, so the caller's array
    survives the captured update, and the update reads the new value."""
    p = mt.gluon.Parameter("sd", shape=(5,), dtype="float32")
    p.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer([p], "sgd", {"learning_rate": 0.1}, kvstore=None)
    p.grad()[:] = mt.nd.array(np.ones(5, np.float32), ctx=mt.cpu())
    tr.step(1)
    src = mt.nd.array(np.full(5, 2.0, np.float32), ctx=mt.cpu())
    p.set_data(src)
    assert p.data()._data.data_ptr() != src._data.data_ptr()
    p.grad()[:] = mt.nd.array(np.ones(5, np.float32), ctx=mt.cpu())
    tr.step(1)
    np.testing.assert_allclose(src.asnumpy(), 2.0)
    np.testing.assert_allclose(p.data().asnumpy(), 1.9, rtol=1e-6)
    assert tof.FUSED_STATS["fused_steps"] == 2 and tof.cache_size() == 1


# ------------------------------------------------------------ per-item path
def test_tied_parameters_fall_back_per_item():
    """Two weights over one buffer are updated per item, in index order;
    the rest of the batch runs the captured update."""
    o = mt.optimizer.SGD(learning_rate=0.1)
    upd = mt.optimizer.get_updater(o)
    rng = np.random.RandomState(5)
    w0 = mt.nd.array(rng.randn(3).astype(np.float32), ctx=mt.cpu())
    w_tied = mt.nd.NDArray(w0._data)
    w1 = mt.nd.array(rng.randn(3).astype(np.float32), ctx=mt.cpu())
    gs = [mt.nd.array(rng.randn(3).astype(np.float32), ctx=mt.cpu())
          for _ in range(3)]
    want = w0.asnumpy() - 0.1 * gs[0].asnumpy() - 0.1 * gs[1].asnumpy()
    want1 = w1.asnumpy() - 0.1 * gs[2].asnumpy()
    upd.update_batch([0, 1, 2], gs, [w0, w_tied, w1])
    assert tof.FUSED_STATS["fused_steps"] == 1
    assert tof.FUSED_STATS["eager_updates"] == 2
    np.testing.assert_allclose(w0.asnumpy(), want, rtol=1e-6)
    np.testing.assert_allclose(w1.asnumpy(), want1, rtol=1e-6)


def test_set_enabled_false_updates_per_item():
    """The setter that takes the place of MXTPU_FUSED_OPTIMIZER=0."""
    prev = tof.set_enabled(False)
    assert prev is True and not tof.fused_enabled()
    params = [mt.gluon.Parameter("p%d" % i, shape=(4,)) for i in range(4)]
    for p in params:
        p.initialize(ctx=mt.cpu())
    mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                     kvstore=None).step(1)
    assert tof.FUSED_STATS["fused_steps"] == 0
    assert tof.FUSED_STATS["eager_updates"] == 4
    assert tof.cache_size() == 0


# ------------------------------------------------------ grads, train mode
def test_hybrid_grad_parity():
    """The reference's test_hybrid_grad_parity: input and weight
    gradients of a hybridized Dense under record()."""
    x_np = np.random.RandomState(0).randn(4, 5).astype("float32")

    def run(pkg):
        net = pkg.gluon.nn.Dense(3, in_units=5)
        if pkg is mt:
            net.initialize(init="one", ctx=mt.cpu())
        else:
            net.initialize(init="one")
        net.hybridize()
        x = _arr(pkg, x_np)
        x.attach_grad()
        with pkg.autograd.record():
            out = net(x)
            loss = (out * out).sum()
        loss.backward()
        return x.grad.asnumpy(), net.weight.grad().asnumpy()

    for got, ref in zip(run(mt), run(mx)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert _builds("cached_op") == 1


def test_predict_mode_recording_is_keyed_apart():
    """``record(train_mode=False)`` gets a pair of its own: BatchNorm
    normalizes by its running statistics and leaves them be, and the
    gradients are those of the eager call."""
    rng = np.random.RandomState(2)
    x_np = rng.randn(6, 4).astype(np.float32)

    def build():
        net = mt.gluon.nn.HybridSequential(prefix="net_")
        with net.name_scope():
            dense = mt.gluon.nn.Dense(5, in_units=4)
            bn = mt.gluon.nn.BatchNorm(in_channels=5)
            net.add(dense, bn)
        net.initialize(ctx=mt.cpu())
        return net, dense, bn

    got = []
    for captured in (True, False):
        net, dense, bn = build()
        if captured:
            net.hybridize()
        for train in (True, False):
            x = _arr(mt, x_np)
            with mt.autograd.record(train_mode=train):
                y = net(x)
                loss = (y * y).sum()
            loss.backward()
            got.append((y.asnumpy(), dense.weight.grad().asnumpy(),
                        bn.running_mean.data().asnumpy()))
        if captured:
            keys = sorted(k[:2] for k in net._cached_op._pairs)
            assert keys == [(True, False), (True, True)]
    for a, b in zip(got[:2], got[2:]):
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-6)
    # the predict-mode call left the statistics where the train call put
    # them
    np.testing.assert_array_equal(got[0][2], got[1][2])


def test_batchnorm_statistics_move_once_per_recorded_forward():
    """The reference's test_batchnorm_moving_stats_update_hybrid: one
    recorded forward moves the running mean once (the capture's warm-up
    and first replay give theirs back)."""
    x_np = (np.random.RandomState(3).randn(8, 3, 4, 4) * 3 + 1).astype(
        np.float32)
    res = []
    for pkg in (mt, mx):
        bn = pkg.gluon.nn.BatchNorm(axis=1, in_channels=3)
        if pkg is mt:
            bn.initialize(ctx=mt.cpu())
        else:
            bn.initialize()
        bn.hybridize()
        with pkg.autograd.record():
            y = bn(_arr(pkg, x_np))
        y.backward()
        res.append(bn.running_mean.data().asnumpy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-5, atol=1e-6)


def test_a_draw_inside_a_capture_raises():
    """A port generator drawn from while this thread captures raises: the
    replay would repeat the captured draw."""
    gen = mt.random.generator("cpu")
    graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
    try:
        with pytest.raises(mt.MXNetError, match="register the generator"):
            mt.random.generator("cpu")
        graphs._STATE.generators = {id(gen)}
        assert mt.random.generator("cpu") is gen
    finally:
        graphs._STATE.depth -= 1
        graphs._STATE.generators = ()


class DrawingGraph(FakeGraph):
    """``FakeGraph`` whose runs may draw from the generators it is given,
    as a graph that registered them may on the card; records them."""

    given = []

    def __init__(self, fn, static_inputs, pool=None, device=None,
                 generators=()):
        self._gens = {id(g) for g in generators}
        DrawingGraph.given.append(tuple(generators))
        super().__init__(fn, static_inputs, pool, device, generators)

    def _run(self):
        prev = getattr(graphs._STATE, "generators", ())
        graphs._STATE.generators = set(prev) | self._gens
        try:
            return super()._run()
        finally:
            graphs._STATE.generators = prev


def _dropout_net():
    nn = mt.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, in_units=8, activation="relu"), nn.Dropout(0.5),
                nn.Dense(3, in_units=32))
    net.initialize(ctx=mt.cpu())
    return net


def _dropout_step(net, x):
    xa = mt.nd.array(x, ctx=mt.cpu())
    xa.attach_grad()
    with mt.autograd.record():
        out = net(xa)
    out.backward(mt.nd.array(np.ones(out.shape, np.float32), ctx=mt.cpu()))
    return out.asnumpy(), xa.grad.asnumpy()


def test_record_hands_the_generator_to_the_pair_of_a_dropout_block(
        monkeypatch):
    """``CachedOp.record`` registers the device's generator with both
    graphs of the pair of a block that holds a Dropout (none for a block
    without one); the pair's warm-up and its forward replay give the
    generator's state back, so the first recorded call draws the mask
    one eager call draws from the same seed, its backward reads that
    mask, and the next call draws a new one."""
    monkeypatch.setattr(graphs, "CapturedGraph", DrawingGraph)
    DrawingGraph.given = []
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    eager = _dropout_net()
    net = _dropout_net()
    for (k, p), q in zip(eager.collect_params().items(),
                         net.collect_params().values()):
        q.set_data(p.data().asnumpy())
    mt.random.seed(3)
    ref = [_dropout_step(eager, x) for _ in range(2)]
    net.hybridize()
    mt.random.seed(3)
    got = [_dropout_step(net, x) for _ in range(2)]
    gen = mt.random.generator("cpu")
    assert len(DrawingGraph.given) == 2        # one pair: its two graphs
    assert all(g == (gen,) for g in DrawingGraph.given)
    for (o, g), (ro, rg) in zip(got, ref):
        np.testing.assert_array_equal(o, ro)
        np.testing.assert_array_equal(g, rg)
    assert not np.array_equal(got[0][0], got[1][0])   # a fresh mask
    # a block that draws nothing registers no generator
    DrawingGraph.given = []
    plain, _ = _resnet()
    plain.hybridize()
    with mt.autograd.record():
        out = plain(mt.nd.array(np.zeros((1, 32, 32, 3), np.float32),
                                ctx=mt.cpu()))
    out.backward(mt.nd.array(np.ones(out.shape, np.float32), ctx=mt.cpu()))
    assert DrawingGraph.given and all(g == () for g in DrawingGraph.given)
