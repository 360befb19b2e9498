"""The port's mesh, collectives, ring attention and ``ShardedTrainStep``
(``mxtpu_torch/parallel``, ``mxtpu_torch/distributed.py``) against the
JAX package's ``mxtpu.parallel``, on the CPU.

The port runs as four gloo ranks spawned on the CPU (``_torch_ranks``),
each holding its shard; the reference runs on four of the eight virtual
CPU devices (``tests/conftest.py``) with the same numpy-seeded inputs.
One spawn runs every check of the port and saves its numbers; the tests
read them. Tolerances are the reference's (``tests/test_parallel.py``):
ring against dense attention, outputs and gradients, 2e-4/2e-5; the
data-parallel step against one device 1e-4/1e-5; ZeRO-1 on against off
2e-6 absolute (the reference asserts bit equality on its mesh; gloo's
ring all-reduce sums each element in an order set by its position in the
buffer, and the ZeRO-1 bucket lays the rows out rank-major, so the two
round apart by an ulp: 2e-6 is the reference's own bound for summation
order, ``tests/test_mesh_trainer.py``). The flash body of
the ring runs B2's plain version on the CPU, as the reference's runs its
XLA fallback.
"""
import numpy as np
import pytest

import _torch_ranks

WORLD = 4
RING_SHAPE = (2, 4, 32, 8)
GRAD_SHAPE = (1, 2, 16, 4)
LM = dict(vocab_size=50, dim=16, num_heads=2, num_layers=2, max_len=32)
LM_TOKENS = (2, 32)


def _ring_inputs(shape, seed):
    r = np.random.RandomState(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(3)]


def _mlp_params(seed=0):
    r = np.random.RandomState(seed)
    shapes = [(32, 10), (32,), (16, 32), (16,), (4, 16), (4,)]
    return [r.uniform(-0.3, 0.3, s).astype(np.float32) for s in shapes]


def _dp_data():
    r = np.random.RandomState(0)
    x = r.uniform(size=(16, 10)).astype(np.float32)
    y = r.randint(0, 4, size=(16,)).astype(np.float32)
    return x, y


def _lm_arrays():
    r = np.random.RandomState(5)
    tokens = r.randint(0, LM["vocab_size"], LM_TOKENS).astype(np.int32)
    labels = r.randint(0, LM["vocab_size"], LM_TOKENS).astype(np.float32)
    return tokens, labels


# ----------------------------------------------------------------- the ranks
def _port_mlp(mt, weights):
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(32, activation="relu", in_units=10),
            mt.gluon.nn.Dense(16, activation="relu", in_units=32),
            mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mt.cpu())
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(mt.nd.array(w, ctx=mt.cpu()))
    return net


def _port_lm(mt, mesh, causal):
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(mesh=mesh, causal=causal, **LM)
    net.initialize(ctx=mt.cpu())
    import torch
    with torch.no_grad():
        TransformerLM(causal=causal, **LM)
        net(torch.zeros(1, 8 if mesh is not None else 8, dtype=torch.int32))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=3)
    convert.load_mxtpu_params(net, arrays)
    return net


def _ranks(rank, world, out):
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.parallel import collectives as col
    save = lambda **kw: _torch_ranks.save(out, rank, **kw)  # noqa: E731

    # meshes
    mesh = par.make_mesh({"data": 2, "sp": 2})
    dp = par.data_parallel_mesh()
    try:
        par.make_mesh({"data": 16})
        too_big = 0
    except ValueError:
        too_big = 1
    whole = np.arange(24, dtype=np.float32).reshape(8, 3)
    sh = par.Sharding(dp, ("data",))
    mine = par.place_global(whole, sh)
    save(placed=mine.numpy(), gathered=par.host_value(mine, sh),
         multi=int(par.is_multiprocess_mesh(dp)))
    save(mesh_shape=np.array(list(mesh.shape.values())),
         dp_size=dp.shape["data"], too_big=too_big,
         coord=np.array([mesh.axis("data").index, mesh.axis("sp").index]))

    # collectives over the data axis of the 4-rank mesh, and their grads
    d = dp.axis("data")
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 10 * rank
    xs = [x.clone().requires_grad_() for _ in range(5)]
    outs = [col.psum(xs[0], d), col.pmean(xs[1], d),
            col.all_gather(xs[2], d, dim=1),
            col.reduce_scatter(xs[3], d, dim=0),
            col.ppermute(xs[4], d, [(j, (j + 1) % world)
                                    for j in range(world)])]
    sum(((o * o).sum() for o in outs)).backward()
    save(**{"coll%d" % i: o.detach().numpy() for i, o in enumerate(outs)})
    save(**{"collg%d" % i: t.grad.numpy() for i, t in enumerate(xs)})
    save(axis_index=col.axis_index(d))

    # ring attention: sequence over sp, batch over data
    def block(a, b_ax, s_ax):
        bsz, t = a.shape[0] // b_ax.size, a.shape[2] // s_ax.size
        return a[b_ax.index * bsz:(b_ax.index + 1) * bsz, :,
                 s_ax.index * t:(s_ax.index + 1) * t]

    q, k, v = [torch.from_numpy(a) for a in _ring_inputs(RING_SHAPE, 0)]
    bx, sx = mesh.axis("data"), mesh.axis("sp")
    qb, kb, vb = [block(a, bx, sx) for a in (q, k, v)]
    for flash in (False, True):
        par.set_ring_flash(flash)
        for causal in (False, True):
            o = par.ring_self_attention(qb, kb, vb, mesh=mesh, seq_axis="sp",
                                        batch_axis="data", causal=causal)
            save(**{"ring_f%d_c%d" % (flash, causal): o.numpy()})
    par.set_ring_flash(False)
    sp4 = par.make_mesh({"sp": 4})
    ax = sp4.axis("sp")
    q, k, v = [torch.from_numpy(a) for a in _ring_inputs(GRAD_SHAPE, 1)]
    t = GRAD_SHAPE[2] // world
    for flash in (False, True):
        par.set_ring_flash(flash)
        qb, kb, vb = [a[:, :, rank * t:(rank + 1) * t].clone()
                      .requires_grad_() for a in (q, k, v)]
        o = par.ring_self_attention(qb, kb, vb, mesh=sp4, seq_axis="sp",
                                    causal=True)
        (o ** 2).sum().backward()
        save(**{"ringgrad_f%d_%s" % (flash, n): a.grad.numpy()
                for n, a in zip("qkv", (qb, kb, vb))})
    par.set_ring_flash(False)
    save(registered=int("_contrib_ring_attention" in mt.ops.REGISTRY))

    # the sequence-sharded TransformerLM against the unsharded one
    tokens, labels = _lm_arrays()
    tl = LM_TOKENS[1] // world
    mine = torch.from_numpy(tokens[:, rank * tl:(rank + 1) * tl].copy())
    for flash in (False, True):
        par.set_ring_flash(flash)
        for causal in (False, True):
            net = _port_lm(mt, sp4, causal)
            with torch.no_grad():
                save(**{"lm_f%d_c%d" % (flash, causal):
                        net(mine).numpy()})
    par.set_ring_flash(False)

    # ShardedTrainStep: 4 data ranks against one device, ZeRO-1 on/off
    x, y = _dp_data()
    xs_, ys_ = x[rank * 4:(rank + 1) * 4], y[rank * 4:(rank + 1) * 4]
    loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for opt, params in (("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                        ("adam", {"learning_rate": 0.01})):
        for zero in (False, True):
            net = _port_mlp(mt, _mlp_params())
            step = par.ShardedTrainStep(net, loss, dp, optimizer=opt,
                                        optimizer_params=dict(params),
                                        shard_weight_update=zero)
            losses = [float(step(mt.nd.array(xs_), mt.nd.array(ys_))
                            .asnumpy()) for _ in range(3)]
            key = "dp_%s_z%d" % (opt, zero)
            save(**{key + "_loss": np.array(losses)})
            save(**{key + "_p%d" % i: p.data().asnumpy() for i, p in
                    enumerate(net.collect_params().values())})
            if zero:
                st = step._updater.states
                save(**{key + "_state_rows": np.array(
                    [st[i][0].shape[0] if isinstance(st[i], tuple)
                     else st[i].shape[0] for i in sorted(st)])})
    step.set_learning_rate(0.5)
    save(lr_after=step.learning_rate)

    # BatchNorm's moving statistics move (and agree across ranks)
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(16, in_units=8), mt.gluon.nn.BatchNorm(),
            mt.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mt.cpu())
    r = np.random.RandomState(rank)
    xb = mt.nd.array(r.uniform(size=(4, 8)).astype(np.float32))
    net(xb)
    rm = [p for n, p in net.collect_params().items()
          if "running_mean" in n][0]
    before = rm.data().asnumpy().copy()
    par.ShardedTrainStep(net, loss, dp)(xb, mt.nd.zeros((4,)))
    save(bn_before=before, bn_after=rm.data().asnumpy())

    # data x sequence parallel: one SGD step of the TransformerLM
    mesh2 = par.make_mesh({"data": 2, "sp": 2})
    bxx, sxx = mesh2.axis("data"), mesh2.axis("sp")
    net = _port_lm(mt, mesh2, True)
    tb = LM_TOKENS[1] // 2
    rows = slice(bxx.index, bxx.index + 1)
    cols = slice(sxx.index * tb, (sxx.index + 1) * tb)
    lm_loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def forward(block, tok, lab):
        return lm_loss(block(tok).reshape((-1, LM["vocab_size"])),
                       lab.reshape((-1,)))

    step = par.ShardedTrainStep(net, None, mesh2, optimizer="sgd",
                                optimizer_params={"learning_rate": 0.5},
                                forward=forward)
    lv = step(mt.nd.array(tokens[rows, cols]), mt.nd.array(labels[rows,
                                                                  cols]))
    save(sp_loss=float(lv.asnumpy()))
    save(**{"sp_p_" + n: p.data().asnumpy()
            for n, p in net.collect_params().items()})

    # Dropout masks differ across ranks: the seed plus the rank, however
    # many steps were built before
    gen = mt.random.generator(torch.device("cpu"))
    save(mask=(torch.rand(64, generator=gen) > 0.5).numpy(),
         seed_after_steps=gen.initial_seed())
    mt.random.seed(7)
    save(seed_after_reseed=gen.initial_seed())
    mt.random.seed(0)

    # refusals
    msgs = []
    for kw in ({"param_specs": [(".*", ("model",))]},
               {"optimizer": "nadam"},
               {"optimizer": "sgd",
                "optimizer_params": {"multi_precision": True}}):
        try:
            par.ShardedTrainStep(_port_mlp(mt, _mlp_params()), loss, dp,
                                 **kw)
            msgs.append("")
        except mt.MXNetError as e:
            msgs.append(str(e))
    save(refusals=np.array(msgs))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _torch_ranks.run(_ranks, WORLD, tmp_path_factory.mktemp("par"))


# ---------------------------------------------------------- the reference
@pytest.fixture(scope="module")
def jmesh():
    import jax
    from mxtpu.parallel import make_mesh
    return make_mesh({"data": 2, "sp": 2}, jax.devices()[:WORLD])


def _join(blocks, b_ax, s_ax):
    """Whole [B, H, T, D] from the (data, sp) blocks in rank order."""
    rows = []
    for bi in range(b_ax):
        rows.append(np.concatenate([blocks[bi * s_ax + si]
                                    for si in range(s_ax)], axis=2))
    return np.concatenate(rows, axis=0)


def test_meshes_lay_out_the_ranks(ranks):
    for r, got in enumerate(ranks):
        assert list(got["mesh_shape"]) == [2, 2]
        assert int(got["dp_size"]) == WORLD and int(got["too_big"]) == 1
        assert list(got["coord"]) == [r // 2, r % 2]


def test_place_global_and_host_value(ranks):
    whole = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["placed"], whole[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["gathered"], whole)
        assert int(got["multi"]) == 1


def test_collectives_and_their_gradients(ranks):
    xs = [np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * r
          for r in range(WORLD)]
    total = sum(xs)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["coll0"], total)
        np.testing.assert_allclose(got["coll1"], total / WORLD, rtol=1e-6)
        np.testing.assert_array_equal(got["coll2"],
                                      np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(got["coll3"], total[r:r + 1])
        np.testing.assert_array_equal(got["coll4"], xs[(r - 1) % WORLD])
        assert int(got["axis_index"]) == r
        # d/dx_r of sum over ranks of |op(x)|^2
        np.testing.assert_allclose(got["collg0"], WORLD * 2 * total,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["collg1"], 2 * total / WORLD,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["collg2"], WORLD * 2 * xs[r],
                                   rtol=1e-6)
        # reduce_scatter's backward all-gathers every rank's 2*row
        np.testing.assert_allclose(got["collg3"], 2 * total, rtol=1e-6)
        np.testing.assert_allclose(got["collg4"], 2 * xs[r], rtol=1e-6)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_mxtpu(ranks, jmesh, flash, causal):
    import jax.numpy as jnp
    from mxtpu.parallel import ring_self_attention
    q, k, v = [jnp.asarray(a) for a in _ring_inputs(RING_SHAPE, 0)]
    ref = np.asarray(ring_self_attention(q, k, v, mesh=jmesh, seq_axis="sp",
                                         batch_axis="data", causal=causal))
    got = _join([g["ring_f%d_c%d" % (flash, causal)] for g in ranks], 2, 2)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_ring_attention_grads_match_mxtpu(ranks, flash):
    import jax
    import jax.numpy as jnp
    from mxtpu.parallel import make_mesh, ring_self_attention
    mesh = make_mesh({"sp": 4}, jax.devices()[:WORLD])
    q, k, v = [jnp.asarray(a) for a in _ring_inputs(GRAD_SHAPE, 1)]

    def loss(q, k, v):
        return jnp.sum(ring_self_attention(q, k, v, mesh=mesh, seq_axis="sp",
                                           causal=True) ** 2)

    refs = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for n, ref in zip("qkv", refs):
        got = np.concatenate([g["ringgrad_f%d_%s" % (flash, n)]
                              for g in ranks], axis=2)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4,
                                   atol=2e-5)


def test_contrib_ring_attention_is_registered(ranks):
    import mxtpu_torch as mt
    assert all(int(g["registered"]) for g in ranks)
    assert mt.ops.get_op("_contrib_ring_attention").name == \
        "_contrib_ring_attention"


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_sharded_transformer_matches_mxtpu(ranks, flash, causal):
    import mxtpu as mx
    from mxtpu.gluon.model_zoo.transformer import TransformerLM
    from mxtpu_torch import convert
    tokens, _ = _lm_arrays()
    net = TransformerLM(causal=causal, **LM)
    net.initialize()
    net(mx.nd.array(tokens[:, :8], dtype="int32"))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=3)
    for name, p in net.collect_params().items():
        p.set_data(mx.nd.array(arrays[name]))
    ref = net(mx.nd.array(tokens, dtype="int32")).asnumpy()
    got = np.concatenate([g["lm_f%d_c%d" % (flash, causal)] for g in ranks],
                         axis=1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _mx_mlp(mx, weights):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu", in_units=10),
            mx.gluon.nn.Dense(16, activation="relu", in_units=32),
            mx.gluon.nn.Dense(4, in_units=16))
    net.initialize()
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(mx.nd.array(w))
    return net


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_sharded_step_data_parallel_matches_mxtpu(ranks, opt):
    import jax
    import mxtpu as mx
    from mxtpu.parallel import ShardedTrainStep, make_mesh
    params = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
              "adam": {"learning_rate": 0.01}}[opt]
    x, y = _dp_data()
    net = _mx_mlp(mx, _mlp_params())
    step = ShardedTrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            make_mesh({"data": 4}, jax.devices()[:WORLD]),
                            optimizer=opt, optimizer_params=dict(params))
    ref_loss = [float(step(mx.nd.array(x), mx.nd.array(y)).asnumpy())
                for _ in range(3)]
    key = "dp_%s_z0" % opt
    for got in ranks:
        np.testing.assert_allclose(got[key + "_loss"], ref_loss, rtol=1e-4,
                                   atol=1e-5)
        for i, p in enumerate(net.collect_params().values()):
            np.testing.assert_allclose(got[key + "_p%d" % i],
                                       p.data().asnumpy(), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero1_on_equals_off_and_shards_the_state(ranks, opt):
    for got in ranks:
        for key in ["_loss"] + ["_p%d" % i for i in range(6)]:
            np.testing.assert_allclose(got["dp_%s_z1" % opt + key],
                                       got["dp_%s_z0" % opt + key],
                                       rtol=0, atol=2e-6)
        # weights (32, 10), (32,), (16, 32), (16,), (4, 16), (4,): rows / 4
        assert list(got["dp_%s_z1_state_rows" % opt]) == [8, 8, 4, 4, 1, 1]
    for key in ["_p%d" % i for i in range(6)]:   # one replicated copy
        for got in ranks[1:]:
            np.testing.assert_array_equal(got["dp_%s_z1" % opt + key],
                                          ranks[0]["dp_%s_z1" % opt + key])


def test_set_learning_rate_without_a_rebuild(ranks):
    assert all(float(g["lr_after"]) == 0.5 for g in ranks)


def test_batchnorm_moving_statistics_move_and_agree(ranks):
    for got in ranks:
        assert not np.allclose(got["bn_before"], got["bn_after"])
        np.testing.assert_array_equal(got["bn_after"], ranks[0]["bn_after"])


def test_data_and_sequence_parallel_step_matches_mxtpu(ranks):
    """Mesh data 2 x sp 2, one SGD step of the causal TransformerLM on the
    global mean loss, against the reference's plain step on the whole
    batch (autograd, mean loss, Trainer.step(1))."""
    import mxtpu as mx
    from mxtpu.gluon.model_zoo.transformer import TransformerLM
    from mxtpu_torch import convert
    tokens, labels = _lm_arrays()
    net = TransformerLM(causal=True, **LM)
    net.initialize()
    net(mx.nd.array(tokens[:, :8], dtype="int32"))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=3)
    for name, p in net.collect_params().items():
        p.set_data(mx.nd.array(arrays[name]))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        out = net(mx.nd.array(tokens, dtype="int32"))
        loss = loss_fn(out.reshape((-1, LM["vocab_size"])),
                       mx.nd.array(labels).reshape((-1,))).mean()
    loss.backward()
    tr.step(1)
    for got in ranks:
        np.testing.assert_allclose(got["sp_loss"], float(loss.asnumpy()),
                                   rtol=1e-5, atol=1e-6)
        for name, p in net.collect_params().items():
            mine = [k for k in got if k.startswith("sp_p_")
                    and _stem(k[5:]) == _stem(name)]
            assert len(mine) == 1, name
            np.testing.assert_allclose(got[mine[0]], p.data().asnumpy(),
                                       rtol=1e-4, atol=1e-5)


def _stem(name):
    from mxtpu_torch import convert
    return convert._key(name, name.partition("_")[0] + "_")


def test_dropout_masks_differ_across_ranks(ranks):
    masks = [g["mask"] for g in ranks]
    assert len({m.tobytes() for m in masks}) == WORLD


def test_generators_take_the_seed_plus_the_rank(ranks):
    assert [int(g["seed_after_steps"]) for g in ranks] == list(range(WORLD))
    assert [int(g["seed_after_reseed"]) for g in ranks] == \
        [7 + r for r in range(WORLD)]


def test_refusals_name_what_waits(ranks):
    for got in ranks:
        tp, nadam, mp = [str(m) for m in got["refusals"]]
        # a rule naming an axis the mesh lacks: the reference's error
        assert tp == ("param_specs rule '.*' -> P('model',) names axis "
                      "'model' not in mesh axes ('data',)")
        assert "nadam" in nadam.lower()
        assert "multi-precision" in mp


def test_pure_forward_matches_eager_like_mxtpu():
    import mxtpu as mx
    import mxtpu_torch as mt
    import torch
    from mxtpu.parallel import pure_forward as jpure
    from mxtpu_torch.parallel import pure_forward
    weights = _mlp_params()
    x = np.random.RandomState(4).uniform(size=(8, 10)).astype(np.float32)
    net = _port_mlp(mt, weights)
    eager = net(mt.nd.array(x, ctx=mt.cpu())).asnumpy()
    fn, datas = pure_forward(net)
    got = fn(datas, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, eager)
    # other parameter values through the same function, as the reference's
    doubled = fn([d * 2 for d in datas], torch.from_numpy(x)).detach()
    jnet = _mx_mlp(mx, [w * 2 for w in weights])
    jfn, jdatas = jpure(jnet)
    np.testing.assert_allclose(doubled.numpy(),
                               np.asarray(jfn(jdatas, mx.nd.array(x)._data)),
                               rtol=1e-5, atol=1e-5)
