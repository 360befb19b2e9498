"""Training through ``gluon.Trainer`` in the port against the JAX package,
on the CPU: a narrow ResNet v1 of bottleneck blocks (``ResNetV1(
BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 48, 64])``, NHWC, 32x32, 10
classes, seeded weights) trained 3 steps of batch 4 with SGD-momentum (lr
0.1, momentum 0.9, wd 1e-4) and ``SoftmaxCrossEntropyLoss`` in both
packages, by the loop of ``examples/image_classification/
train_cifar10.py``: ``record()``, ``loss.backward()``, ``trainer.step``.
Every conv of the narrow net passes the fused conv's gate, so on the
port's side each runs the plain forward and the ported backward. The JAX
side runs its plain XLA path (hybridized), with training-mode BatchNorm.

Tolerances: per-sample losses of every step rtol=atol=1e-4; weights,
momenta and BatchNorm running statistics after the third step within 1e-4
of max(1, max|ref|) (three steps at lr 0.1 carry the two packages' 1e-6
differences in float32 summation order forward).

Also the Trainer's own contract on one device: the refusals that name
their ROADMAP items, ``rescale_grad = scale / batch``, ``grad_req='null'``
skipped, in-place updates that keep each parameter's leaf, and
``save_states``/``load_states``.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon.model_zoo.vision import resnet as jres
from mxtpu_torch import convert
from mxtpu_torch.gluon.model_zoo.vision import resnet as tres
from mxtpu_torch.ops.pallas import conv as tpc

CHANNELS = [8, 16, 32, 48, 64]
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
STEPS, BATCH = 3, 4
TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL", "MXTPU_BN_ONEPASS",
                "MXTPU_MESH"):
        monkeypatch.delenv(var, raising=False)


def _keyed(params):
    """{name without the top-level prefix: Parameter}."""
    return {k.partition("_")[2]: p for k, p in params.items()}


def _port_net():
    with mt.layout("NHWC"):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                            classes=10, thumbnail=True)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3))
    return net


def _jax_net(arrays):
    """The JAX package's net with the same weights, loaded by name (which
    settles its shapes without a forward) and hybridized."""
    with mx.layout("NHWC"):
        jnet = jres.ResNetV1(jres.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, thumbnail=True)
    ours = convert._strip_top(list(arrays))
    for key, p in _keyed(jnet.collect_params()).items():
        p.set_data(mx.nd.array(arrays[ours[key]]))
    jnet.hybridize()
    return jnet


def _train(pkg, net, data, ctx=None):
    arr = (lambda a: mt.nd.array(a, ctx=mt.cpu())) if pkg is mt \
        else mx.nd.array
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in data:
        with pkg.autograd.record():
            loss = loss_fn(net(arr(x)), arr(y))
        loss.backward()
        trainer.step(BATCH)
        losses.append(loss.asnumpy())
    return trainer, losses


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s]


@pytest.fixture(scope="module")
def runs():
    net = _port_net()
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=3)
    convert.load_mxtpu_params(net, arrays)
    jnet = _jax_net(arrays)
    rng = np.random.RandomState(0)
    data = [(rng.randn(BATCH, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, BATCH).astype(np.float32))
            for _ in range(STEPS)]
    calls = []
    real = tpc.fused_conv_backward

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    tpc.fused_conv_backward = spy
    try:
        ttr, tlosses = _train(mt, net, data)
    finally:
        tpc.fused_conv_backward = real
    jtr, jlosses = _train(mx, jnet, data)
    return dict(net=net, jnet=jnet, ttr=ttr, jtr=jtr, tlosses=tlosses,
                jlosses=jlosses, bwd_calls=len(calls))


def test_resnet_losses_match_mxtpu(runs):
    assert len(runs["tlosses"]) == STEPS
    for got, ref in zip(runs["tlosses"], runs["jlosses"]):
        assert got.shape == (BATCH,)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert runs["tlosses"][-1].mean() != runs["tlosses"][0].mean()


def test_resnet_weights_and_bn_statistics_match_mxtpu(runs):
    ours = _keyed(runs["net"].collect_params())
    theirs = _keyed(runs["jnet"].collect_params())
    assert ours.keys() == theirs.keys()
    stats = 0
    for k in ours:
        got, ref = ours[k].data().asnumpy(), theirs[k].data().asnumpy()
        stats += k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=TOL * max(1.0, np.abs(ref).max()),
            err_msg=k)
    assert stats == 2 * 16      # every BatchNorm's two statistics


def test_resnet_momentum_matches_mxtpu(runs):
    ts = runs["ttr"]._updaters[0].states
    js = runs["jtr"]._updaters[0].states
    assert sorted(ts) == sorted(js) and len(ts) > 0
    for i in ts:
        for a, b in zip(_leaves(ts[i]), _leaves(js[i])):
            ref = b.asnumpy()
            np.testing.assert_allclose(
                a.asnumpy(), ref, rtol=0,
                atol=TOL * max(1.0, np.abs(ref).max()), err_msg=str(i))
    assert runs["ttr"].optimizer.num_update == STEPS
    assert runs["ttr"].optimizer._index_update_count == \
        runs["jtr"].optimizer._index_update_count


def test_resnet_convs_ran_the_ported_backward(runs):
    convs = [p for k, p in runs["net"].collect_params().items()
             if "conv" in k and k.endswith("weight")]
    assert runs["bwd_calls"] == STEPS * len(convs) == STEPS * 17


# --------------------------------------------------------- Trainer contract
def _mlp(seed=0):
    net = mt.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(6, in_units=4, activation="relu"),
                mt.gluon.nn.Dense(3, in_units=6))
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(
        seed))
    return net


def _step(net, trainer, x, y, batch=None):
    loss_fn = mt.gluon.loss.L2Loss()
    with mt.autograd.record():
        loss = loss_fn(net(mt.nd.array(x, ctx=mt.cpu())),
                       mt.nd.array(y, ctx=mt.cpu()))
    loss.backward()
    trainer.step(batch or x.shape[0])
    return loss


@pytest.mark.parametrize("kwargs,item", [
    ({"kvstore": "dist_sync"}, "distributed.init"),
    ({"kvstore": "dist_async"}, "dist_async"),
    ({"mesh": object()}, "parallel.Mesh"),
    ({"loss_scaler": object()}, "ROADMAP A9")])
def test_trainer_refusals_name_their_roadmap_item(kwargs, item):
    """What still raises: the numerics guard (A9); a distributed store
    outside a process group (at the first step, where the store binds);
    a mesh that is not one; dist_async, as the reference's."""
    with pytest.raises(mt.MXNetError, match=item):
        trainer = mt.gluon.Trainer(_mlp().collect_params(), "sgd", **kwargs)
        trainer.step(1)


@pytest.mark.parametrize("kvstore", [None, "device", "local", "nccl"])
def test_trainer_local_stores_equal_no_store(kvstore):
    r = np.random.RandomState(1)
    x, y = r.randn(5, 4).astype(np.float32), r.randn(5, 3)
    a, b = _mlp(), _mlp()
    ta = mt.gluon.Trainer(a.collect_params(), "sgd", {"learning_rate": 0.1},
                          kvstore=kvstore)
    tb = mt.gluon.Trainer(b.collect_params(), "sgd", {"learning_rate": 0.1},
                          kvstore=None)
    for _ in range(2):
        _step(a, ta, x, y)
        _step(b, tb, x, y)
    for pa, pb in zip(a.collect_params().values(),
                      b.collect_params().values()):
        assert torch.equal(pa.data().to_torch(), pb.data().to_torch())


def test_trainer_step_rescales_by_batch_and_updates_in_place():
    r = np.random.RandomState(2)
    net = _mlp()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5, "rescale_grad": 3.0})
    p = net.collect_params()["mlp_dense0_weight"]
    arr, leaf = p.data(), p.data().to_torch()
    before = arr.asnumpy().copy()
    x, y = r.randn(8, 4).astype(np.float32), r.randn(8, 3)
    _step(net, trainer, x, y, batch=8)
    assert trainer.optimizer.rescale_grad == 3.0 / 8
    # the same NDArray, over the same nn.Parameter leaf, shows the step
    assert p.data() is arr and arr.to_torch() is leaf
    assert isinstance(leaf, torch.nn.Parameter) and leaf.requires_grad
    assert leaf._mx_owner() is arr
    np.testing.assert_allclose(arr.asnumpy(),
                               before - 0.5 * 3.0 / 8 * p.grad().asnumpy(),
                               rtol=1e-6, atol=1e-7)
    # and the next recorded step still fills its gradient
    p.zero_grad()
    _step(net, trainer, x, y, batch=8)
    assert np.abs(p.grad().asnumpy()).max() > 0


def test_trainer_skips_null_and_refuses_uninitialized():
    net = _mlp()
    params = net.collect_params()
    frozen = params["mlp_dense1_bias"]
    frozen.grad_req = "null"
    before = frozen.data().asnumpy().copy()
    trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 1.0})
    r = np.random.RandomState(3)
    _step(net, trainer, r.randn(2, 4).astype(np.float32), r.randn(2, 3))
    np.testing.assert_array_equal(frozen.data().asnumpy(), before)
    assert 3 not in trainer._updaters[0].states      # never updated
    lazy = mt.gluon.nn.Dense(2)
    lazy.initialize(ctx=mt.cpu())
    t2 = mt.gluon.Trainer(lazy.collect_params(), "sgd")
    with pytest.raises(mt.MXNetError, match="was not initialized"):
        t2.step(1)
    with pytest.raises(mt.MXNetError, match="list or dict of Parameters"):
        mt.gluon.Trainer([1], "sgd")


def test_trainer_learning_rate_update_and_allreduce():
    net = _mlp()
    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.4, "lr_scheduler": sched})
    assert trainer.learning_rate == 0.4
    trainer.set_learning_rate(0.2)
    assert trainer.optimizer.lr == 0.2 and sched.base_lr == 0.2
    r = np.random.RandomState(4)
    x, y = r.randn(3, 4).astype(np.float32), r.randn(3, 3)
    loss_fn = mt.gluon.loss.L2Loss()
    with mt.autograd.record():
        loss = loss_fn(net(mt.nd.array(x, ctx=mt.cpu())),
                       mt.nd.array(y, ctx=mt.cpu()))
    loss.backward()
    g = {k: p.grad().asnumpy().copy()
         for k, p in net.collect_params().items()}
    trainer.allreduce_grads()          # one device: the identity
    for k, p in net.collect_params().items():
        np.testing.assert_array_equal(p.grad().asnumpy(), g[k])
    trainer.update(3)
    assert trainer.optimizer.num_update == 1
    assert trainer.optimizer.rescale_grad == 1.0 / 3
    assert isinstance(trainer.optimizer, mt.optimizer.SGD)


def test_trainer_save_and_load_states_resume_the_same_step(tmp_path):
    r = np.random.RandomState(5)
    batches = [(r.randn(4, 4).astype(np.float32), r.randn(4, 3))
               for _ in range(3)]
    a = _mlp()
    ta = mt.gluon.Trainer(a.collect_params(), "adam",
                          {"learning_rate": 0.01})
    for x, y in batches[:2]:
        _step(a, ta, x, y)
    ta.save_states(str(tmp_path / "t.states"))
    weights = convert.params_to_numpy(a)
    _step(a, ta, *batches[2])
    b = _mlp(seed=1)
    convert.load_mxtpu_params(b, weights)
    tb = mt.gluon.Trainer(b.collect_params(), "adam",
                          {"learning_rate": 0.01})
    tb.load_states(str(tmp_path / "t.states"))
    tb.optimizer._index_update_count = {i: 2 for i in range(4)}
    tb.optimizer.num_update = 2
    _step(b, tb, *batches[2])
    for pa, pb in zip(a.collect_params().values(),
                      b.collect_params().values()):
        assert torch.equal(pa.data().to_torch(), pb.data().to_torch())


def test_asnumpy_is_a_copy_that_a_step_does_not_change():
    net = _mlp()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 1.0})
    p = net.collect_params()["mlp_dense1_bias"]
    before = p.data().asnumpy()
    r = np.random.RandomState(6)
    _step(net, trainer, r.randn(2, 4).astype(np.float32), r.randn(2, 3))
    after = p.data().asnumpy()
    # the step moved the weight by -lr * grad, and the earlier copy kept
    # the old values
    np.testing.assert_allclose(after, before - p.grad().asnumpy() / 2,
                               rtol=1e-6, atol=1e-7)
