"""The port's tensor- and expert-parallel ``ShardedTrainStep``
(``param_specs``), the expert-parallel Switch layer and ``pipeline_apply``
against the JAX package's, on the CPU.

The port runs as four gloo ranks spawned once (``_torch_ranks``), every
rank passing its data shard of the same global batch; the reference runs
on four of its eight virtual CPU devices with the same numpy-seeded
weights and batch (``tests/test_parallel.py``'s cases). Tolerances are the
reference's: losses rtol 1e-4, atol 1e-6 (TP, 3 steps), parameters after
the steps rtol 1e-4, atol 1e-5, the pipeline's output and gradients
rtol 1e-5/1e-4, atol 1e-5.

On a ``model``, ``expert`` or ``pipe`` axis every rank computes the same
loss, so a replicated parameter's gradient is whole there and summed over
the data axis only: each rank's numbers are held to the world of one's,
not a multiple of them, and a planted ``psum`` in place of
``reduce_from`` (which counts the expert axis's gradients twice) is shown
to fail the comparison. So is a pipeline whose ``copy_to`` is planted
away (an embedding before it then trains on the first stage only).
"""
import re

import numpy as np
import pytest

import _torch_ranks

WORLD = 4
LM = dict(vocab_size=50, dim=16, num_heads=2, num_layers=2, max_len=32)
MOE_TOKENS = (4, 16)
TP_LM_TOKENS = (4, 16)
PIPE = dict(layers=8, d=16, batch=32, micro=8)
PIPE_NET = dict(vocab=20, tokens=(4, 8), lr=0.5)   # layers, d of PIPE


def _tp_data():
    r = np.random.RandomState(0)
    x = r.uniform(size=(8, 16)).astype(np.float32)
    y = r.randint(0, 8, size=(8,)).astype(np.float32)
    return x, y


def _tp_weights():
    r = np.random.RandomState(1)
    shapes = [(64, 16), (64,), (8, 64), (8,)]
    return [r.uniform(-0.3, 0.3, s).astype(np.float32) for s in shapes]


def _lm_batch(shape, seed):
    r = np.random.RandomState(seed)
    return (r.randint(0, LM["vocab_size"], shape).astype(np.int32),
            r.randint(0, LM["vocab_size"], shape).astype(np.float32))


def _pipe_arrays():
    r = np.random.RandomState(0)
    n, d = PIPE["layers"], PIPE["d"]
    return ({"w": (r.randn(n, d, d) * 0.2).astype(np.float32),
             "b": (r.randn(n, d) * 0.1).astype(np.float32)},
            r.randn(PIPE["batch"], d).astype(np.float32))


def _pipe_net_arrays():
    r = np.random.RandomState(5)
    n, d, v = PIPE["layers"], PIPE["d"], PIPE_NET["vocab"]
    stacked, _ = _pipe_arrays()
    weights = {"embedding0_weight": (r.randn(v, d) * 0.5).astype(np.float32),
               "stack_w": stacked["w"], "stack_b": stacked["b"],
               "dense0_weight": (r.randn(v, d) * 0.3).astype(np.float32),
               "dense0_bias": np.zeros(v, np.float32)}
    tokens = r.randint(0, v, PIPE_NET["tokens"]).astype(np.int32)
    labels = r.randint(0, v, PIPE_NET["tokens"]).astype(np.float32)
    return weights, tokens, labels


def _port_pipe_net(mt, mesh):
    """An embedding, the ``tanh(h @ w + b)`` stack through
    ``pipeline_apply`` over ``mesh``'s pipe axis, and a Dense head."""
    from mxtpu_torch import parallel as par
    n, d, v = PIPE["layers"], PIPE["d"], PIPE_NET["vocab"]

    def layer(p, h):
        import torch
        return torch.tanh(h @ p["w"] + p["b"])

    class PipeNet(mt.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = mt.gluon.nn.Embedding(v, d)
                self.stack_w = self.params.get("stack_w", shape=(n, d, d))
                self.stack_b = self.params.get("stack_b", shape=(n, d))
                self.head = mt.gluon.nn.Dense(v, in_units=d)

        def hybrid_forward(self, F, tokens, stack_w, stack_b):
            h = self.embed(tokens).reshape(-1, d)
            h = par.pipeline_apply(layer, {"w": stack_w, "b": stack_b}, h,
                                   mesh, axis="pipe",
                                   num_microbatches=PIPE["micro"])
            return self.head(h)
    net = PipeNet(prefix="pipenet_")
    net.initialize(ctx=mt.cpu())
    for name, p in net.collect_params().items():
        w = _pipe_net_arrays()[0][name[len("pipenet_"):]]
        p.set_data(mt.nd.array(w, ctx=mt.cpu()))
    return net


def _lm_shapes(experts):
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(num_experts=experts, **LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    return {k: p.shape for k, p in net.collect_params().items()}


# ----------------------------------------------------------------- the ranks
def _port_tp_mlp(mt):
    net = mt.gluon.nn.HybridSequential(prefix="tp_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(64, activation="relu", in_units=16),
                mt.gluon.nn.Dense(8, in_units=64))
    net.initialize(ctx=mt.cpu())
    for p, w in zip(net.collect_params().values(), _tp_weights()):
        p.set_data(mt.nd.array(w, ctx=mt.cpu()))
    return net


def _port_lm(mt, experts, arrays):
    import torch
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(num_experts=experts, **LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    convert.load_mxtpu_params(net, arrays)
    return net


def _lm_forward(mt, alpha):
    loss_blk = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(block, tokens, labels):
        ce = loss_blk(block(tokens).reshape((-1, LM["vocab_size"])),
                      labels.reshape((-1,)))
        return ce + alpha * block.aux_loss() if alpha else ce
    return forward


def _whole(p, mesh):
    """A parameter's whole value (its shard gathered)."""
    from mxtpu_torch.parallel import host_value, train
    pl = train.placement(p)
    return host_value(p.data(), pl)


def _ranks(rank, world, out):
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch import parallel as par
    from mxtpu_torch.gluon.model_zoo.transformer import (
        expert_parallel_rules, tensor_parallel_rules)
    from mxtpu_torch.parallel import collectives as col
    save = lambda **kw: _torch_ranks.save(out, rank, **kw)  # noqa: E731
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    # TP: tests/test_parallel.py::test_sharded_train_step_tp on data 2 x
    # model 2, each rank its data rows
    tp = par.make_mesh({"data": 2, "model": 2})
    d = tp.axis("data")
    x, y = _tp_data()
    rows = slice(d.index * 4, (d.index + 1) * 4)
    for name, specs in (("repl", ()),
                        ("tp", [(r".*dense0_weight", par.P("model", None)),
                                (r".*dense0_bias", par.P("model"))])):
        net = _port_tp_mlp(mt)
        step = par.ShardedTrainStep(net, loss, tp,
                                    optimizer_params={"learning_rate": 0.05},
                                    param_specs=specs)
        losses = [float(step(mt.nd.array(x[rows]), mt.nd.array(y[rows]))
                        .asnumpy()) for _ in range(3)]
        save(**{name + "_loss": np.array(losses)})
        # a forward outside the step reads the shards whole too
        save(**{name + "_eval": net(mt.nd.array(x)).asnumpy()})
        save(**{"%s_shape%d" % (name, i): np.array(p.data().shape)
                for i, p in enumerate(net.collect_params().values())})
        save(**{"%s_p%d" % (name, i): _whole(p, tp)
                for i, p in enumerate(net.collect_params().values())})

    # TP of the TransformerLM with its rules, 3 SGD steps
    tokens, labels = _lm_batch(TP_LM_TOKENS, 11)
    arrays = convert.seeded_params(_lm_shapes(0), seed=3)
    net = _port_lm(mt, 0, arrays)
    step = par.ShardedTrainStep(net, None, tp, optimizer="sgd",
                                optimizer_params={"learning_rate": 0.5},
                                param_specs=tensor_parallel_rules("model"),
                                forward=_lm_forward(mt, 0))
    b = TP_LM_TOKENS[0] // 2
    r2 = slice(d.index * b, (d.index + 1) * b)
    save(tplm_loss=np.array([float(step(
        mt.nd.array(tokens[r2], dtype="int32"),
        mt.nd.array(labels[r2])).asnumpy()) for _ in range(3)]))
    save(tplm_sharded=np.array(sorted(
        n for n, p in net.collect_params().items()
        if par.train.placement(p) is not None)))
    save(**{"tplm_p_" + n: _whole(p, tp)
            for n, p in net.collect_params().items()})

    # EP: test_moe_transformer_lm_trains_expert_parallel on data 2 x
    # expert 2, Adam, CE + 0.01 aux; then the same with psum planted in
    # place of reduce_from
    ep = par.make_mesh({"data": 2, "expert": 2})
    de = ep.axis("data")
    tokens, labels = _lm_batch(MOE_TOKENS, 12)
    arrays = convert.seeded_params(_lm_shapes(4), seed=4)
    b = MOE_TOKENS[0] // 2
    r2 = slice(de.index * b, (de.index + 1) * b)
    from mxtpu_torch.parallel import moe as tmoe
    for name in ("ep", "planted"):
        if name == "planted":
            tmoe.reduce_from = col.psum
        net = _port_lm(mt, 4, arrays)
        step = par.ShardedTrainStep(
            net, None, ep, optimizer="adam",
            optimizer_params={"learning_rate": 1e-3},
            param_specs=expert_parallel_rules("expert"),
            forward=_lm_forward(mt, 0.01))
        try:
            losses = [float(step(mt.nd.array(tokens[r2], dtype="int32"),
                                 mt.nd.array(labels[r2])).asnumpy())
                      for _ in range(2)]
        finally:
            tmoe.reduce_from = col.reduce_from
        aux = net.aux_loss()
        save(**{name + "_loss": np.array(losses),
                name + "_aux": float(aux.asnumpy() if hasattr(aux, "asnumpy")
                                     else aux)})
        save(**{"%s_p_%s" % (name, n): _whole(p, ep)
                for n, p in net.collect_params().items()})
        if name == "ep":
            save(ep_local_rows=np.array(sorted(
                p.data().shape[0] for n, p in net.collect_params().items()
                if "moe_w" in n or "moe_b" in n)))

    # pipeline: 8 layers over pipe 4, 8 microbatches; and pipe 2 x data 2
    stacked, xp = _pipe_arrays()

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    for name, axes, batch_axis in (("pipe4", {"pipe": 4}, None),
                                   ("pipe2", {"pipe": 2, "data": 2},
                                    "data")):
        mesh = par.make_mesh(axes)
        leaves = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in stacked.items()}
        o = par.pipeline_apply(layer, leaves, torch.from_numpy(xp), mesh,
                               axis="pipe", num_microbatches=PIPE["micro"],
                               batch_axis=batch_axis)
        (o ** 2).sum().backward()
        save(**{name + "_out": o.detach().numpy()})
        save(**{"%s_g%s" % (name, k): v.grad.numpy()
                for k, v in leaves.items()})
        if batch_axis is not None:
            g = [v.grad for v in leaves.values()]
            for t in g:
                col.all_reduce_(t, mesh.axis(batch_axis))
            save(**{"%s_gsum%s" % (name, k): t.numpy()
                    for k, t in zip(leaves, g)})
    # ShardedTrainStep over data 1 x pipe 4, one SGD step of an embedding,
    # the pipelined stack and a head: the stack replicated, then held as
    # pipe shards, then with the pipeline's copy_to planted away
    from mxtpu_torch.parallel import pipeline as tpipe
    pm = par.make_mesh({"data": 1, "pipe": 4})
    _, ptok, plab = _pipe_net_arrays()
    for name, specs in (("pstep", ()), ("pshard", [(r".*stack_", ("pipe",))]),
                        ("pplanted", ())):
        if name == "pplanted":
            tpipe.copy_to = lambda x, axis: x
        try:
            net = _port_pipe_net(mt, pm)
            step = par.ShardedTrainStep(
                net, loss, pm,
                optimizer_params={"learning_rate": PIPE_NET["lr"]},
                param_specs=specs)
            save(**{name + "_loss": float(step(
                mt.nd.array(ptok, dtype="int32"),
                mt.nd.array(plab.reshape(-1))).asnumpy())})
        finally:
            tpipe.copy_to = col.copy_to
        params = list(net.collect_params().values())
        save(**{"%s_p%d" % (name, i): _whole(p, pm)
                for i, p in enumerate(params)})
        save(**{name + "_rows": np.array([p.data().shape[0]
                                          for p in params])})

    errs = []
    for kw in ({"params": {"w": torch.zeros(6, 4, 4)},
                "x": torch.zeros(8, 4)},
               {"params": {"w": torch.zeros(4, 4, 4)},
                "x": torch.zeros(9, 4), "num_microbatches": 4}):
        try:
            par.pipeline_apply(lambda p, h: h, kw.pop("params"),
                               kw.pop("x"), par.make_mesh({"pipe": 4}), **kw)
            errs.append("")
        except mt.MXNetError as e:
            errs.append(str(e))
    save(pipe_errors=np.array(errs))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _torch_ranks.run(_ranks, WORLD, tmp_path_factory.mktemp("mp"))


# ---------------------------------------------------------- the reference
def _jmesh(axes):
    import jax
    from mxtpu.parallel import make_mesh
    return make_mesh(axes, jax.devices()[:WORLD])


def _mx_lm(experts, arrays):
    import mxtpu as mx
    from mxtpu.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(num_experts=experts, **LM)
    net.initialize()
    net(mx.nd.array(np.zeros((1, 8), np.int32), dtype="int32"))
    by_stem = {_stem(k): v for k, v in arrays.items()}
    for name, p in net.collect_params().items():
        p.set_data(mx.nd.array(by_stem[_stem(name)]))
    return net


def _stem(name):
    from mxtpu_torch import convert
    return convert._key(name, name.partition("_")[0] + "_")


def _check_params(got, prefix, net, rtol=1e-4, atol=1e-5):
    for name, p in net.collect_params().items():
        mine = [k for k in got if k.startswith(prefix)
                and _stem(k[len(prefix):]) == _stem(name)]
        assert len(mine) == 1, name
        np.testing.assert_allclose(got[mine[0]], p.data().asnumpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_tensor_parallel_matches_mxtpu(ranks):
    import mxtpu as mx
    from jax.sharding import PartitionSpec as JP
    from mxtpu.parallel import ShardedTrainStep
    x, y = _tp_data()

    def run(specs):
        net = mx.gluon.nn.HybridSequential(prefix="tp_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(64, activation="relu", in_units=16),
                    mx.gluon.nn.Dense(8, in_units=64))
        net.initialize()
        for p, w in zip(net.collect_params().values(), _tp_weights()):
            p.set_data(mx.nd.array(w))
        step = ShardedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                _jmesh({"data": 2, "model": 2}),
                                optimizer_params={"learning_rate": 0.05},
                                param_specs=specs)
        losses = [float(step(mx.nd.array(x), mx.nd.array(y)).asnumpy())
                  for _ in range(3)]
        return losses, [p.data().asnumpy()
                        for p in net.collect_params().values()]
    ref_loss, ref_p = run([(r".*dense0_weight", JP("model", None)),
                           (r".*dense0_bias", JP("model"))])
    for got in ranks:
        for name in ("repl", "tp"):
            np.testing.assert_allclose(got[name + "_loss"], ref_loss,
                                       rtol=1e-4, atol=1e-6)
            for i, w in enumerate(ref_p):
                np.testing.assert_allclose(got["%s_p%d" % (name, i)], w,
                                           rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["tp_eval"], got["repl_eval"],
                                   rtol=1e-5, atol=1e-6)
        # each rank holds half of the sharded weight and bias
        assert list(got["tp_shape0"]) == [32, 16]
        assert list(got["tp_shape1"]) == [32]
        assert list(got["tp_shape2"]) == [8, 64]
        assert list(got["repl_shape0"]) == [64, 16]


def test_transformer_tensor_parallel_rules_match_mxtpu(ranks):
    import mxtpu as mx
    from mxtpu.gluon.model_zoo.transformer import tensor_parallel_rules
    from mxtpu.parallel import ShardedTrainStep
    from jax.sharding import PartitionSpec as JP
    from mxtpu_torch import convert
    tokens, labels = _lm_batch(TP_LM_TOKENS, 11)
    arrays = convert.seeded_params(_lm_shapes(0), seed=3)
    net = _mx_lm(0, arrays)
    loss_blk = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(block, tok, lab):
        return loss_blk(block(tok).reshape((-1, LM["vocab_size"])),
                        lab.reshape((-1,)))
    step = ShardedTrainStep(net, None, _jmesh({"data": 2, "model": 2}),
                            optimizer="sgd",
                            optimizer_params={"learning_rate": 0.5},
                            param_specs=tensor_parallel_rules("model"),
                            batch_specs=[JP("data"), JP("data")],
                            forward=forward)
    ref = [float(step(mx.nd.array(tokens, dtype="int32"),
                      mx.nd.array(labels)).asnumpy()) for _ in range(3)]
    # the rules' weights that divide model 2 (all six patterns here)
    want = sorted(n for n in arrays if re.match(
        r".*(qkv|proj|mlp1|mlp2|head|wte)_weight", n))
    for got in ranks:
        np.testing.assert_allclose(got["tplm_loss"], ref, rtol=1e-4,
                                   atol=1e-6)
        assert [_stem(n) for n in got["tplm_sharded"]] == \
            [_stem(n) for n in want]
        _check_params(got, "tplm_p_", net)


def _mx_ep_run(arrays, tokens, labels):
    import mxtpu as mx
    from jax.sharding import PartitionSpec as JP
    from mxtpu.gluon.model_zoo.transformer import expert_parallel_rules
    from mxtpu.parallel import ShardedTrainStep
    net = _mx_lm(4, arrays)
    loss_blk = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(block, tok, lab):
        ce = loss_blk(block(tok).reshape((-1, LM["vocab_size"])),
                      lab.reshape((-1,)))
        return ce + 0.01 * block.aux_loss()
    step = ShardedTrainStep(net, None, _jmesh({"data": 2, "expert": 2}),
                            optimizer="adam",
                            optimizer_params={"learning_rate": 1e-3},
                            param_specs=expert_parallel_rules("expert"),
                            batch_specs=[JP("data"), JP("data")],
                            forward=forward)
    losses = [float(step(mx.nd.array(tokens, dtype="int32"),
                         mx.nd.array(labels)).asnumpy()) for _ in range(2)]
    return net, losses


@pytest.fixture(scope="module")
def ep_reference():
    from mxtpu_torch import convert
    tokens, labels = _lm_batch(MOE_TOKENS, 12)
    arrays = convert.seeded_params(_lm_shapes(4), seed=4)
    return _mx_ep_run(arrays, tokens, labels)


def test_expert_parallel_matches_mxtpu(ranks, ep_reference):
    net, ref = ep_reference
    for got in ranks:
        np.testing.assert_allclose(got["ep_loss"], ref, rtol=1e-4,
                                   atol=1e-6)
        assert ref[1] < ref[0] and got["ep_loss"][1] < got["ep_loss"][0]
        assert float(got["ep_aux"]) >= 1.0
        _check_params(got, "ep_p_", net)
        # each rank holds 2 of the 4 experts of each expert weight
        assert set(got["ep_local_rows"]) == {2}


def test_planted_psum_counts_the_expert_axis_twice(ranks, ep_reference):
    net, ref = ep_reference
    for got in ranks:
        worst = 0.0
        for name, p in net.collect_params().items():
            mine = [k for k in got if k.startswith("planted_p_")
                    and _stem(k[10:]) == _stem(name)][0]
            w = p.data().asnumpy()
            worst = max(worst, float(np.abs(got[mine] - w).max()))
        assert worst > 1e-4   # the comparison above would fail it


def test_pipeline_matches_the_sequential_stack(ranks):
    import jax
    import jax.numpy as jnp
    stacked, x = _pipe_arrays()
    params = {k: jnp.asarray(v) for k, v in stacked.items()}

    def seq(p, x):
        h, _ = jax.lax.scan(lambda h, q: (jnp.tanh(h @ q["w"] + q["b"]),
                                          None), x, p)
        return h
    out = np.asarray(seq(params, jnp.asarray(x)))
    grads = jax.grad(lambda p: jnp.sum(seq(p, jnp.asarray(x)) ** 2))(params)
    per = PIPE["layers"] // 4
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["pipe4_out"], out, rtol=1e-5,
                                   atol=1e-5)
        for k in stacked:
            # every rank's gradient is the whole stack's, every row
            np.testing.assert_allclose(got["pipe4_g" + k],
                                       np.asarray(grads[k]), rtol=1e-4,
                                       atol=1e-5)
        # pipe 2 x data 2: summed over the data axis, the whole stack's
        np.testing.assert_allclose(got["pipe2_out"], out, rtol=1e-5,
                                   atol=1e-5)
        for k in stacked:
            np.testing.assert_allclose(got["pipe2_gsum" + k],
                                       np.asarray(grads[k]), rtol=1e-4,
                                       atol=1e-5)


def _pipe_world_of_one():
    """One SGD step of ``_port_pipe_net`` in a world of one (the stack run
    in order on one process): its loss and parameters after the step."""
    import torch
    import mxtpu_torch as mt
    _, tok, lab = _pipe_net_arrays()
    net = _port_pipe_net(mt, _Mesh(pipe=1))
    loss_blk = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        loss = loss_blk(net(mt.nd.array(tok, ctx=mt.cpu(), dtype="int32")),
                        mt.nd.array(lab.reshape(-1), ctx=mt.cpu())).mean()
    loss.backward()
    with torch.no_grad():
        return float(loss.asnumpy()), [
            p.data().asnumpy() - PIPE_NET["lr"] * p.grad().asnumpy()
            for p in net.collect_params().values()]


def test_pipeline_in_a_train_step_matches_a_world_of_one(ranks):
    """The embedding before the pipeline and every row of the stack take
    the whole gradient on every pipe rank, replicated or held as pipe
    shards; with the pipeline's copy_to planted away they do not."""
    loss, want = _pipe_world_of_one()
    for r, got in enumerate(ranks):
        for name in ("pstep", "pshard"):
            np.testing.assert_allclose(float(got[name + "_loss"]), loss,
                                       rtol=1e-5, atol=1e-6)
            for i, w in enumerate(want):
                np.testing.assert_allclose(got["%s_p%d" % (name, i)], w,
                                           rtol=1e-4, atol=1e-5,
                                           err_msg="%s %d" % (name, i))
        # each rank holds 2 of the 8 rows of the stack as its shard
        assert list(got["pshard_rows"]) == [2, 2, 20, 20, 20]
        assert list(got["pstep_rows"]) == [8, 8, 20, 20, 20]
        if r:   # the embedding trains on the first stage only
            assert np.abs(got["pplanted_p2"] - want[2]).max() > 1e-3


def test_pipeline_errors_are_the_references(ranks):
    import jax
    import jax.numpy as jnp
    import mxtpu as mx
    from jax.sharding import Mesh
    from mxtpu.parallel import pipeline_apply
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    want = []
    for params, x, kw in (({"w": jnp.zeros((6, 4, 4))}, jnp.zeros((8, 4)),
                           {}),
                          ({"w": jnp.zeros((4, 4, 4))}, jnp.zeros((9, 4)),
                           {"num_microbatches": 4})):
        with pytest.raises(mx.MXNetError) as e:
            pipeline_apply(lambda p, h: h, params, x, mesh, **kw)
        want.append(str(e.value))
    for got in ranks:
        assert [str(m) for m in got["pipe_errors"]] == want


class _Mesh:
    def __init__(self, **shape):
        self.shape = shape


def test_spec_for_falls_back_and_raises_like_mxtpu():
    import jax
    from jax.sharding import PartitionSpec as JP
    from mxtpu.parallel import make_mesh
    from mxtpu.parallel.train import ShardedTrainStep as JStep
    import mxtpu as mx
    import mxtpu_torch as mt
    from mxtpu_torch.parallel.train import _spec_for

    class _Param:
        def __init__(self, name, shape):
            self.name, self.shape = name, shape
    jstep = JStep.__new__(JStep)
    jstep._mesh = make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    mesh = _Mesh(data=2, model=2)
    rules = [(r".*w$", ("model", None)), (r".*v$", ("model", None)),
             (r".*", (None, "model"))]
    for name, shape in (("a_w", (4, 3)), ("a_v", (3, 4)), ("b", (4, 6)),
                        ("c", (5, 5))):
        jspec = jstep._spec_for(
            _Param(name, shape),
            [(re.compile(p), JP(*s)) for p, s in rules])
        got = _spec_for(name, shape, [(re.compile(p), s) for p, s in rules],
                        mesh)
        assert (tuple(got) if got is not None else ()) == tuple(jspec), name
    with pytest.raises(mx.MXNetError) as je:
        jstep._spec_for(_Param("w", (4, 4)),
                        [(re.compile(".*"), JP("expert"))])
    with pytest.raises(mt.MXNetError) as te:
        _spec_for("w", (4, 4), [(re.compile(".*"), ("expert",))], mesh)
    assert str(te.value).split(" -> ")[0] == str(je.value).split(" -> ")[0]
    assert str(te.value).split("names axis")[1] == \
        str(je.value).split("names axis")[1]
