"""The port's mesh Trainer (``gluon.Trainer(mesh=, zero1=)``,
``optimizer_fused.MeshPlan``/``FusedUpdater.set_mesh``), ``shard_batch``/
``batch_sharding`` with the prefetcher, and ``SyncBatchNorm``, against the
JAX package on the CPU.

The port runs as four gloo ranks spawned on the CPU (``_torch_ranks``),
each training on its quarter of the batch with the reference's loop
(``l = loss(net(x), y).mean(); l.backward(); trainer.step(1)``; the step
divides the summed gradients by the four ranks, so the update is the
global batch's). The reference runs the same loop on one device, as its
``tests/test_mesh_trainer.py`` compares its data-sharded mesh run:
2e-6 absolute (summation order). ZeRO-1 on against off: 2e-6 too, since
gloo's all-reduce sums each element in an order set by its position and
the ZeRO-1 bucket lays the rows out rank-major (the reference asserts
bit equality on its mesh). ``SyncBatchNorm`` over four ranks' quarters
against the reference's BatchNorm over the whole batch: 1e-5.
"""
import numpy as np
import pytest

import _torch_ranks

WORLD = 4
OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
        "adam": {"learning_rate": 0.01}}
STEPS = 6


def _weights():
    r = np.random.RandomState(11)
    return [r.uniform(-0.3, 0.3, s).astype(np.float32)
            for s in [(32, 16), (32,), (8, 32), (8,)]]


def _data():
    x = np.random.RandomState(0).randn(16, 16).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 8, (16,)).astype(np.float32)
    return x, y


def _bn_data():
    r = np.random.RandomState(2)
    return (r.randn(8, 3, 4, 4).astype(np.float32),
            r.randn(8, 3, 4, 4).astype(np.float32))


def _net(pkg, ctx):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=16),
            pkg.gluon.nn.Dense(8, in_units=32))
    net.initialize(**ctx)
    for p, w in zip(net.collect_params().values(), _weights()):
        p.set_data(pkg.nd.array(w, **ctx))
    return net


def _ranks(rank, world, out):
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    save = lambda **kw: _torch_ranks.save(out, rank, **kw)  # noqa: E731
    mesh = par.make_mesh({"data": world})
    x, y = _data()
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    for opt, params in OPTS.items():
        for zero in (False, True):
            net = _net(mt, {"ctx": mt.cpu()})
            tr = mt.gluon.Trainer(net.collect_params(), opt, dict(params),
                                  mesh=mesh, zero1=zero)
            losses = []
            for _ in range(STEPS):
                xs, ys = tr.shard_batch(mt.nd.array(x), y)
                with mt.autograd.record():
                    l = loss_fn(net(xs), ys).mean()
                l.backward()
                tr.step(1)
                losses.append(float(l.asnumpy()))
            key = "%s_z%d" % (opt, zero)
            save(**{key + "_loss": np.array(losses)})
            save(**{key + "_p%d" % i: p.data().asnumpy()
                    for i, p in enumerate(net.collect_params().values())})
            st = tr._updaters[0].states
            save(**{key + "_rows": np.array([
                s[0].shape[0] if isinstance(s, tuple) else s.shape[0]
                for s in (st[i] for i in sorted(st))])})
            blob = tr._updaters[0].get_states()
            save(**{key + "_blob": np.frombuffer(blob, np.uint8)})
            # the whole states load back onto this rank's rows: one more
            # step from them equals one more step of the trainer itself
            net2 = _net(mt, {"ctx": mt.cpu()})
            for p, q in zip(net2.collect_params().values(),
                            net.collect_params().values()):
                p.set_data(q.data())
            tr2 = mt.gluon.Trainer(net2.collect_params(), opt, dict(params),
                                   mesh=mesh, zero1=zero)
            tr2._updaters[0].set_states(blob)
            tr2.optimizer._index_update_count = dict(
                tr.optimizer._index_update_count)
            for n_, t_ in ((net, tr), (net2, tr2)):
                xs, ys = t_.shard_batch(mt.nd.array(x), y)
                with mt.autograd.record():
                    l = loss_fn(n_(xs), ys).mean()
                l.backward()
                t_.step(1)
            save(**{key + "_resumed": max(
                float(np.abs(a.data().asnumpy() - b.data().asnumpy()).max())
                for a, b in zip(net.collect_params().values(),
                                net2.collect_params().values()))})
    # shard_batch refuses a batch that does not divide the axis
    try:
        tr.shard_batch(np.zeros((6, 2), np.float32))
        save(odd="")
    except mt.MXNetError as e:
        save(odd=str(e))
    # the prefetcher takes this rank's rows of each whole batch
    sh = tr.batch_sharding
    pf = mt.io.DevicePrefetcher(iter([(x, y)]), sharding=tr)
    bx, by = next(iter(pf))
    pf.close()
    save(spec=np.array(sh.spec), pf_x=bx.asnumpy(), pf_y=by.asnumpy())
    # SyncBatchNorm over the four ranks' quarters
    from mxtpu_torch.gluon.contrib.nn import SyncBatchNorm
    xb, wb = _bn_data()
    bn = SyncBatchNorm(in_channels=3)
    bn.initialize(ctx=mt.cpu())
    xr = mt.nd.array(xb[2 * rank:2 * rank + 2])
    xr.attach_grad()
    with mt.autograd.record():
        o = bn(xr)
        s = (o * mt.nd.array(wb[2 * rank:2 * rank + 2])).sum()
    s.backward()
    save(bn_out=o.asnumpy(), bn_dx=xr.grad.asnumpy(),
         **{"bn_" + n.split("_")[-1]: (p.grad() if p.grad_req != "null"
                                       else p.data()).asnumpy()
            for n, p in bn.collect_params().items()})
    torch.manual_seed(0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _torch_ranks.run(_ranks, WORLD, tmp_path_factory.mktemp("mesh"))


def _mx_run(opt):
    import mxtpu as mx
    net = _net(mx, {})
    x, y = _data()
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(OPTS[opt]))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(STEPS):
        with mx.autograd.record():
            l = loss_fn(net(mx.nd.array(x)), mx.nd.array(y)).mean()
        l.backward()
        tr.step(1)
        losses.append(float(l.asnumpy()))
    return losses, [p.data().asnumpy() for p in net.collect_params().values()]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("zero1", [False, True])
def test_mesh_trainer_tracks_one_device_like_mxtpu(ranks, opt, zero1):
    ref_l, ref_p = _mx_run(opt)
    key = "%s_z%d" % (opt, zero1)
    local = np.mean([g[key + "_loss"] for g in ranks], axis=0)
    np.testing.assert_allclose(local, ref_l, rtol=0, atol=2e-6)
    for got in ranks:
        for i, ref in enumerate(ref_p):
            np.testing.assert_allclose(got[key + "_p%d" % i], ref, rtol=0,
                                       atol=2e-6)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero1_on_equals_off(ranks, opt):
    for got in ranks:
        for i in range(4):
            np.testing.assert_allclose(got["%s_z1_p%d" % (opt, i)],
                                       got["%s_z0_p%d" % (opt, i)],
                                       rtol=0, atol=2e-6)
        for i in range(4):   # one replicated copy on every rank
            np.testing.assert_array_equal(got["%s_z1_p%d" % (opt, i)],
                                          ranks[0]["%s_z1_p%d" % (opt, i)])


def test_zero1_state_rows_are_a_quarter_and_save_whole(ranks):
    import pickle
    for got in ranks:
        # weights (32, 16), (32,), (8, 32), (8,): each state's rows / 4
        assert list(got["adam_z1_rows"]) == [8, 8, 2, 2]
        assert list(got["adam_z0_rows"]) == [32, 32, 8, 8]
        whole = pickle.loads(got["adam_z1_blob"].tobytes())
        plain = pickle.loads(got["adam_z0_blob"].tobytes())
        for i in plain:
            for a, b in zip(whole[i], plain[i]):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


def test_saved_states_resume_on_this_ranks_rows(ranks):
    for got in ranks:
        for key in ("sgd_z0", "sgd_z1", "adam_z0", "adam_z1"):
            assert float(got[key + "_resumed"]) == 0.0, key


def test_shard_batch_and_the_prefetcher_take_this_ranks_rows(ranks):
    x, y = _data()
    for r, got in enumerate(ranks):
        assert "does not divide" in str(got["odd"])
        assert list(got["spec"]) == ["data"]
        np.testing.assert_array_equal(got["pf_x"], x[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["pf_y"], y[4 * r:4 * r + 4])


def test_sync_batchnorm_matches_mxtpu_batchnorm_over_the_whole_batch(ranks):
    import mxtpu as mx
    xb, wb = _bn_data()
    bn = mx.gluon.contrib.nn.SyncBatchNorm(in_channels=3)
    bn.initialize()
    x = mx.nd.array(xb)
    x.attach_grad()
    with mx.autograd.record():
        o = bn(x)
        s = (o * mx.nd.array(wb)).sum()
    s.backward()
    got_o = np.concatenate([g["bn_out"] for g in ranks])
    got_dx = np.concatenate([g["bn_dx"] for g in ranks])
    np.testing.assert_allclose(got_o, o.asnumpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx, x.grad.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    ref = {n.split("_")[-1]: (p.grad() if p.grad_req != "null"
                              else p.data()).asnumpy()
           for n, p in bn.collect_params().items()}
    for got in ranks:
        for n in ("mean", "var"):   # the moving statistics
            np.testing.assert_allclose(got["bn_" + n], ref[n], rtol=1e-5,
                                       atol=1e-6)
        # each rank's gamma/beta gradient is its quarter's; their sum is
        # the whole batch's
    for n in ("gamma", "beta"):
        np.testing.assert_allclose(sum(g["bn_" + n] for g in ranks), ref[n],
                                   rtol=1e-5, atol=1e-5)


def test_mesh_refusals_and_no_environment(monkeypatch):
    import mxtpu_torch as mt
    monkeypatch.setenv("MXTPU_MESH", "1")
    monkeypatch.setenv("MXTPU_ZERO1", "0")
    net = mt.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd")
    assert tr._mesh is None and tr.batch_sharding is None
    assert tr.shard_batch(np.ones(2)) is not None

    class FakeMesh:
        shape = {"data": 2}

        def axis(self, name):
            raise AssertionError("a refused mesh is not read")

    with pytest.raises(mt.MXNetError, match="update_on_kvstore"):
        mt.gluon.Trainer(net.collect_params(), "sgd", mesh=FakeMesh(),
                         update_on_kvstore=True)
    with pytest.raises(mt.MXNetError, match="no 'batch' axis"):
        mt.gluon.Trainer(net.collect_params(), "sgd", mesh=FakeMesh(),
                         data_axis="batch")
