"""The numerics guard in the port against the JAX package's, on the CPU.

A narrow bottleneck ResNet (tests/test_torch_trainer.py's, SGD-momentum)
and a 2-layer TransformerLM (tests/test_torch_trainer_lm.py's, Adam)
train 3 steps through ``gluon.Trainer`` with a ``DynamicLossScaler``
(scale 2^10, growth every 2 good steps) and the fault ``nan_grad@1``
in both packages; a symbolic MLP does the same through ``Module``. After
every step the port's weights and optimizer states are held to the
reference's (1e-4 of max(1, max|ref|), as the unguarded training tests),
and the verdict, the scale and the device count ``t`` exactly: the
skipped step leaves them all as they were. The port runs eagerly and
through the capture stand-in of tests/test_torch_train_graph.py (one
captured guarded update). Four gloo ranks of a mesh Trainer (ZeRO-1)
with a NaN gradient on one rank only: every rank skips.
"""
import numpy as np
import pytest
import torch

import _torch_ranks
import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import optimizer_fused as jof
from mxtpu import resilience as jres
from mxtpu_torch import graphs
from mxtpu_torch import optimizer_fused as tof
from mxtpu_torch import resilience as tres
import test_torch_trainer as rt
import test_torch_trainer_lm as lt
from test_torch_train_graph import FakeGraph

SCALER = dict(init_scale=2.0 ** 10, growth_interval=2)
STEPS = 3
NAN_AT = 1
TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_FAULT_INJECT", "MXTPU_NUMERICS_GUARD",
                "MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_MESH", "MXTPU_FLASH_INTERPRET",
                "MXTPU_DIVERGENCE_EVERY"):
        monkeypatch.delenv(var, raising=False)
    jres.reset_faults()
    tres.reset_faults()
    yield
    jres.reset_faults()
    tres.reset_faults()
    tof.reset()
    jof.reset()


def _capture(monkeypatch):
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made = []


def _record(trainer, net, verdict):
    upd = trainer._updaters[0]
    params = {k.partition("_")[2]: p.data().asnumpy()
              for k, p in net.collect_params().items()}
    states = {i: [x.asnumpy() for x in rt._leaves(upd.states[i])]
              for i in sorted(upd.states)}
    return dict(params=params, states=states,
                ok=bool(np.asarray(verdict.asnumpy())),
                scale=float(upd.scaler.scale_value()),
                t=int(np.asarray(upd._t_good)))


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _hold(port, ref):
    """Each step's record of the port against the reference's."""
    assert len(port) == len(ref) == STEPS
    for s, (a, b) in enumerate(zip(port, ref)):
        assert (a["ok"], a["scale"], a["t"]) == \
            (b["ok"], b["scale"], b["t"]), s
        assert a["params"].keys() == b["params"].keys()
        for k in a["params"]:
            _close(a["params"][k], b["params"][k], "step %d %s" % (s, k))
        assert sorted(a["states"]) == sorted(b["states"])
        for i in a["states"]:
            for x, y in zip(a["states"][i], b["states"][i]):
                _close(x, y, "step %d state %d" % (s, i))
    skipped = port[NAN_AT]
    before = port[NAN_AT - 1]
    assert not skipped["ok"] and skipped["scale"] == before["scale"] / 2
    assert skipped["t"] == before["t"]
    for i in skipped["states"]:   # the momentum and moments untouched
        for x, y in zip(skipped["states"][i], before["states"][i]):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- ResNet
def _resnet_data():
    rng = np.random.RandomState(0)
    return [(rng.randn(rt.BATCH, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, rt.BATCH).astype(np.float32))
            for _ in range(STEPS)]


def _train_resnet(pkg, net, data):
    res = jres if pkg is mx else tres
    arr = (lambda a: mt.nd.array(a, ctx=mt.cpu())) if pkg is mt \
        else mx.nd.array
    scaler = res.DynamicLossScaler(**SCALER)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(rt.OPT),
                                loss_scaler=scaler)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for x, y in data:
        with pkg.autograd.record():
            loss = scaler.scale(loss_fn(net(arr(x)), arr(y)))
        loss.backward()
        out.append(_record(trainer, net, trainer.step(rt.BATCH)))
    return out


@pytest.fixture(scope="module")
def resnet_ref():
    net = rt._port_net()
    from mxtpu_torch import convert
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=3)
    jnet = rt._jax_net(arrays)
    import os
    os.environ["MXTPU_FAULT_INJECT"] = "nan_grad@%d" % NAN_AT
    try:
        jres.reset_faults()
        ref = _train_resnet(mx, jnet, _resnet_data())
    finally:
        del os.environ["MXTPU_FAULT_INJECT"]
        jres.reset_faults()
    return arrays, ref


@pytest.mark.parametrize("captured", [False, True])
def test_resnet_guarded_sgd_matches_mxtpu(resnet_ref, captured,
                                          monkeypatch):
    arrays, ref = resnet_ref
    if captured:
        _capture(monkeypatch)
    from mxtpu_torch import convert
    net = rt._port_net()
    convert.load_mxtpu_params(net, arrays)
    if captured:
        net.hybridize()
    tres.set_faults("nan_grad@%d" % NAN_AT)
    port = _train_resnet(mt, net, _resnet_data())
    _hold(port, ref)
    if captured:   # the guarded update ran as one captured graph
        assert tof.FUSED_STATS["compiles"] == 1


# --------------------------------------------------------- TransformerLM
def _lm_data():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 97, (lt.B, lt.T)).astype(np.int32),
             rng.randint(0, 97, (lt.B, lt.T)).astype(np.float32))
            for _ in range(STEPS)]


def _train_lm(pkg, net, data):
    res = jres if pkg is mx else tres
    arr = (lambda a, **k: mt.nd.array(a, ctx=mt.cpu(), **k)) \
        if pkg is mt else mx.nd.array
    scaler = res.DynamicLossScaler(**SCALER)
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                dict(lt.OPT), loss_scaler=scaler)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for tokens, labels in data:
        with pkg.autograd.record():
            logits = net(arr(tokens, dtype="int32"))
            loss = scaler.scale(loss_fn(
                logits.reshape((-1, lt.LM["vocab_size"])),
                arr(labels).reshape((-1,))))
        loss.backward()
        out.append(_record(trainer, net, trainer.step(lt.B * lt.T)))
    return out


@pytest.fixture(scope="module")
def lm_ref():
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo import transformer as ttr
    net = ttr.TransformerLM(**lt.LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=4)
    import os
    os.environ["MXTPU_FAULT_INJECT"] = "nan_grad@%d" % NAN_AT
    try:
        jres.reset_faults()
        ref = _train_lm(mx, lt._jax_net(arrays), _lm_data())
    finally:
        del os.environ["MXTPU_FAULT_INJECT"]
        jres.reset_faults()
    return arrays, ref


@pytest.mark.parametrize("captured", [False, True])
def test_lm_guarded_adam_matches_mxtpu(lm_ref, captured, monkeypatch):
    """Adam's bias correction runs off the device count ``t``, which the
    skipped step does not move (the reference's [1, 1, 2])."""
    arrays, ref = lm_ref
    if captured:
        _capture(monkeypatch)
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo import transformer as ttr
    net = ttr.TransformerLM(**lt.LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    convert.load_mxtpu_params(net, arrays)
    if captured:
        net.hybridize()
    tres.set_faults("nan_grad@%d" % NAN_AT)
    port = _train_lm(mt, net, _lm_data())
    _hold(port, ref)
    assert [r["t"] for r in port] == [1, 1, 2]


# ------------------------------------------------------------------ Module
def _mlp_sym(pkg):
    s = pkg.sym
    data = s.var("data")
    h = s.Activation(s.FullyConnected(data, num_hidden=8, name="fc1"),
                     act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=3, name="fc2"),
                           name="softmax")


def _train_module(pkg, args):
    res = jres if pkg is mx else tres
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    mod = pkg.mod.Module(_mlp_sym(pkg), context=ctx)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in args.items()},
                    aux_params={}, allow_missing=False)
    scaler = res.DynamicLossScaler(**SCALER)
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)), loss_scaler=scaler)
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        x = rng.randn(4, 5).astype(np.float32)
        y = rng.randint(0, 3, 4).astype(np.float32)
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        arg, _ = mod.get_params()
        out.append(({k: v.asnumpy() for k, v in arg.items()},
                    float(scaler.scale_value()),
                    int(np.asarray(mod._updater._t_good))))
    return out


def test_module_guarded_update_matches_mxtpu(monkeypatch):
    rng = np.random.RandomState(2)
    args = {"fc1_weight": rng.randn(8, 5).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "nan_grad@%d" % NAN_AT)
    ref = _train_module(mx, args)
    tres.set_faults("nan_grad@%d" % NAN_AT)
    port = _train_module(mt, args)
    for s, ((pa, ps, pt), (ra, rs, rt_)) in enumerate(zip(port, ref)):
        assert (ps, pt) == (rs, rt_), s
        for k in ra:
            _close(pa[k], ra[k], "step %d %s" % (s, k))
    for k in args:   # the skipped step left the weights as they were
        np.testing.assert_array_equal(port[NAN_AT][0][k],
                                      port[NAN_AT - 1][0][k])
    assert [p[1] for p in port] == [1024.0, 512.0, 512.0]


# ------------------------------------------------------- four gloo ranks
WORLD = 4


def _mesh_ranks(rank, world, out):
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch import resilience
    mesh = par.make_mesh({"data": world})
    net = mt.gluon.nn.Dense(8, in_units=4)   # dim 0 divides the axis
    net.initialize(ctx=mt.cpu(), generator=torch.Generator().manual_seed(0))
    scaler = resilience.DynamicLossScaler(init_scale=8.0)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          mesh=mesh, zero1=True, loss_scaler=scaler)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    oks, ws = [], []
    for step in range(3):
        if step == 1 and rank == 2:   # a NaN on this rank only
            resilience.set_faults("nan_grad@1")
        xs = tr.shard_batch(mt.nd.array(x))
        with mt.autograd.record():
            loss = scaler.scale((net(xs) ** 2).sum())
        loss.backward()
        oks.append(bool(tr.step(8).asnumpy()))
        ws.append(np.concatenate([p.data().asnumpy().ravel()
                                  for p in net.collect_params().values()]))
    _torch_ranks.save(out, rank, oks=np.array(oks), ws=np.array(ws),
                      scale=scaler.scale_value())


def test_a_nan_on_one_rank_skips_every_rank(tmp_path):
    ranks = _torch_ranks.run(_mesh_ranks, WORLD, tmp_path)
    for r in ranks:
        assert list(r["oks"]) == [True, False, True]
        np.testing.assert_array_equal(r["ws"][1], r["ws"][0])
        np.testing.assert_array_equal(r["ws"], ranks[0]["ws"])
        assert float(r["scale"]) == 4.0
    assert not np.array_equal(ranks[0]["ws"][2], ranks[0]["ws"][1])
