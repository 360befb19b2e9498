"""``contrib.async_checkpoint`` of the port against the JAX package's, on
the CPU. The same sequence of trainer saves and faults runs through both
packages (each its own format: the port cannot read the reference's orbax
directories, ROADMAP §C), and what the reference's rules decide is held
equal: the latest step, the finalized steps after the retention GC, the
tombstones, the fallback's order and the steps it restores; the restored
arrays equal the saved ones bit for bit. Also the block and
ShardedTrainStep round trips, the refusals, the asynchronous save's
error at the next save, and ``ResilientLoop``'s resume."""
import os

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import resilience as jres
from mxtpu.contrib import async_checkpoint as jck
from mxtpu.gluon.parameter import Parameter as JParameter
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.contrib import async_checkpoint as tck


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_FAULT_INJECT", "MXTPU_CKPT_KEEP", "MXTPU_MESH"):
        monkeypatch.delenv(var, raising=False)
    jres.reset_faults()
    tres.reset_faults()
    ttel.reset()
    yield
    jres.reset_faults()
    tres.reset_faults()
    tres.set_ckpt_keep(0)


def _trainer(pkg, seed=3, scaler=False):
    """Three parameters of shape (5,) with seeded values, Adam."""
    rng = np.random.RandomState(seed)
    params = []
    for j in range(3):
        if pkg is mx:
            p = JParameter("rp%d" % j, shape=(5,), dtype="float32")
            p.initialize()
            p.data()._set_data(mx.nd.array(
                rng.uniform(-1, 1, 5).astype(np.float32))._data)
        else:
            p = mt.gluon.Parameter("rp%d" % j, shape=(5,), dtype="float32")
            p.initialize(ctx=mt.cpu())
            p.set_data(rng.uniform(-1, 1, 5).astype(np.float32))
        params.append(p)
    res = jres if pkg is mx else tres
    sc = res.DynamicLossScaler(init_scale=4.0) if scaler else None
    tr = pkg.gluon.Trainer(params, "adam", {"learning_rate": 0.05},
                           kvstore=None, loss_scaler=sc)
    return tr, params


def _step(pkg, tr, params, rng):
    for p in params:
        g = rng.randn(5).astype(np.float32)
        if pkg is mx:
            p.grad()[:] = mx.nd.array(g)
        else:
            p.grad()._set_data(torch.from_numpy(g))
    tr.step(1)


def _scenario(pkg, d, saves, faults):
    """Train and save at ``saves`` (a fault spec per save index in
    ``faults``); returns the snapshots by step and the directory's view."""
    ck = jck if pkg is mx else tck
    res = jres if pkg is mx else tres
    tr, params = _trainer(pkg)
    rng = np.random.RandomState(17)
    snaps, step = {}, 0
    for k, at in enumerate(saves):
        while step < at:
            _step(pkg, tr, params, rng)
            step += 1
        spec = faults.get(k, "")
        if pkg is mx:
            os.environ["MXTPU_FAULT_INJECT"] = spec
        else:
            res.set_faults(spec)
        ck.save_trainer(tr, d, step=at)
        snaps[at] = [p.data().asnumpy().copy() for p in params]
    os.environ.pop("MXTPU_FAULT_INJECT", None)
    res.reset_faults()
    return snaps


def _view(pkg, d):
    ck = jck if pkg is mx else tck
    tombs = sorted(n for n in os.listdir(d) if n.endswith(".corrupt.json"))
    return ck._finalized_steps(d), ck.latest_step(d), tombs


@pytest.mark.parametrize("saves,faults,keep", [
    ([1, 3, 5, 7], {}, 2),                      # retention: the newest 2
    ([1, 3], {1: "ckpt_corrupt@0"}, 0),         # corrupt newest: fallback
    ([2], {0: "ckpt_corrupt@0"}, 0),            # nothing intact
    ([1, 3, 5], {2: "ckpt_corrupt@0"}, 1),      # keep 1 keeps the intact
], ids=["gc_keep2", "corrupt_newest", "nothing_intact", "keep1_corrupt"])
def test_saves_faults_and_fallback_like_mxtpu(tmp_path, monkeypatch, saves,
                                              faults, keep):
    if keep:
        monkeypatch.setenv("MXTPU_CKPT_KEEP", str(keep))
        tres.set_ckpt_keep(keep)
    out = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        d = str(tmp_path / name)
        snaps = _scenario(pkg, d, saves, faults)
        before = _view(pkg, d)
        tr2, params2 = _trainer(pkg, seed=9)
        ck = jck if pkg is mx else tck
        got = ck.load_trainer_fallback(tr2, d)
        restored = [p.data().asnumpy() for p in params2]
        out[name] = (before, got, _view(pkg, d),
                     ttel.tagged("checkpoint.restore_fallbacks")
                     if pkg is mt else None)
        if got is not None:
            for a, b in zip(snaps[got], restored):
                np.testing.assert_array_equal(a, b)
    (jb, jgot, jafter, _), (tb, tgot, tafter, tfall) = out["jax"], \
        out["port"]
    assert (tb, tgot, tafter) == (jb, jgot, jafter)
    if faults:
        assert tfall == {"checksum": 1}


def test_resume_is_bit_exact_with_the_scaler_and_the_optimizer(tmp_path):
    d = str(tmp_path)
    with mt.cpu():
        tr, params = _trainer(mt, scaler=True)
        rng = np.random.RandomState(4)
        for _ in range(3):
            _step(mt, tr, params, rng)
        tres.set_faults("nan_grad@3")
        _step(mt, tr, params, rng)   # skipped: the scale halves
        tres.reset_faults()
        w = tck.save_trainer(tr, d, step=4, async_save=True)
        w.wait_until_finished()
        state = np.random.RandomState(5)
        cont = []
        for _ in range(2):
            _step(mt, tr, params, state)
        cont = [p.data().asnumpy() for p in params]
        tr2, params2 = _trainer(mt, seed=9, scaler=True)
        loop = tres.ResilientLoop(tr2, tres.CheckpointPolicy(d))
        assert loop.resume() == 5
        assert tr2._updaters[0].scaler.scale_value() == 2.0
        assert tr2.optimizer._index_update_count == \
            {0: 4, 1: 4, 2: 4}
        state = np.random.RandomState(5)
        for _ in range(2):
            _step(mt, tr2, params2, state)
        for a, b in zip(cont, [p.data().asnumpy() for p in params2]):
            np.testing.assert_array_equal(a, b)
        # t: 3 good steps of 4, then 2 more on both sides
        assert int(tr2._updaters[0]._t_good) == \
            int(tr._updaters[0]._t_good) == 5


def test_refusals_and_the_async_error_at_the_next_save(tmp_path,
                                                        monkeypatch):
    d = str(tmp_path)
    tr, params = _trainer(mt)
    tck.save_trainer(tr, d, step=1)
    with pytest.raises(mt.MXNetError, match="force=True"):
        tck.save_trainer(tr, d, step=1)
    tck.save_trainer(tr, d, step=1, force=True)
    tres.set_faults("ckpt_io@0")
    with pytest.raises(OSError, match="injected"):
        tck.save_trainer(tr, d, step=2)
    # a write that fails on its thread raises at the next save
    real = tck._write_rank

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(tck, "_write_rank", broken)
    w = tck.save_trainer(tr, d, step=3, async_save=True)
    monkeypatch.setattr(tck, "_write_rank", real)
    with pytest.raises(OSError, match="disk full"):
        tck.save_trainer(tr, d, step=4)
    assert tck.latest_step(d) == 1 and w.write_s is not None
    # a checkpoint of other parameters is refused before anything moves
    other = mt.gluon.Parameter("x", shape=(5,))
    other.initialize(ctx=mt.cpu())
    tr3 = mt.gluon.Trainer([other], "adam", kvstore=None)
    with pytest.raises(mt.MXNetError, match="holds 3 parameters"):
        tck.load_trainer(tr3, d, step=1)


def test_a_rank_that_does_not_write_never_meets_the_writers_step(
        tmp_path, monkeypatch):
    """On a mesh the first rank writes and may finalize the step before
    another rank reaches its save (the two-rank test below lost a rank to
    that race): a rank that does not write neither guards nor writes."""
    d = str(tmp_path)
    tr, params = _trainer(mt)
    tck.save_trainer(tr, d, step=1)
    monkeypatch.setattr(tck, "_rank", lambda: 1)
    before = sorted(os.listdir(d))
    w = tck.save_trainer(tr, d, step=1)
    assert w.wait_until_finished() is w and w.write_s is None
    assert sorted(os.listdir(d)) == before
    monkeypatch.setattr(tck, "_rank", lambda: 0)
    with pytest.raises(mt.MXNetError, match="force=True"):
        tck.save_trainer(tr, d, step=1)


def test_the_reference_cannot_read_the_ports_format(tmp_path):
    """A deliberate difference (ROADMAP §C): each package reads its own
    format only."""
    tr, _ = _trainer(mt)
    tck.save_trainer(tr, str(tmp_path / "port"), step=1)
    jtr, _ = _trainer(mx)
    jck.save_trainer(jtr, str(tmp_path / "jax"), step=1)
    assert tck.latest_step(str(tmp_path / "port")) == 1
    tr2, _ = _trainer(mt, seed=9)
    with pytest.raises(Exception):
        tck.load_trainer(tr2, str(tmp_path / "jax"), step=1)
    assert tck.load_trainer_fallback(tr2, str(tmp_path / "jax")) is None


def test_block_round_trip_and_serving_restore(tmp_path):
    d = str(tmp_path)
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    saved = [p.data().asnumpy().copy() for p in net.collect_params().values()]
    w = tck.save_block(net, d, step=0, async_save=True)
    w.wait_until_finished()
    for p in net.collect_params().values():
        p.set_data(np.zeros(p.shape, np.float32))
    tck.load_block(net, d, step=0)
    for a, p in zip(saved, net.collect_params().values()):
        np.testing.assert_array_equal(a, p.data().asnumpy())
    # the serving restore takes only the parameters of a trainer's step
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    tck.save_trainer(tr, str(tmp_path / "tr"), step=5)
    fresh = mt.gluon.nn.Dense(3, in_units=4)
    fresh.initialize(ctx=mt.cpu())
    assert tck.load_trainer_params_into_block(
        fresh, str(tmp_path / "tr")) == 5
    for a, p in zip(saved, fresh.collect_params().values()):
        np.testing.assert_array_equal(a, p.data().asnumpy())
    with pytest.raises(mt.MXNetError, match="no finalized"):
        tck.load_trainer_params_into_block(fresh, str(tmp_path / "none"))


def test_predictor_from_trainer_checkpoint(tmp_path):
    from mxtpu_torch.serving import BucketSpec, Predictor
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    tck.save_trainer(tr, str(tmp_path), step=2)
    block = mt.gluon.nn.Dense(3, in_units=4)
    block.initialize(ctx=mt.cpu())
    pred = Predictor.from_trainer_checkpoint(block, str(tmp_path),
                                             BucketSpec([2]), device="cpu")
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pred.predict(x).asnumpy(), want, rtol=1e-6,
                               atol=1e-6)


WORLD = 2


def _train_step_ranks(rank, world, out):
    import _torch_ranks
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    from mxtpu_torch.contrib import async_checkpoint as ck
    mesh = par.make_mesh({"data": world})

    def make():
        net = mt.gluon.nn.Dense(4, in_units=3)
        net.initialize(ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(1))
        net(torch.zeros(1, 3))
        return net, par.ShardedTrainStep(
            net, mt.gluon.loss.L2Loss(), mesh, "sgd",
            {"learning_rate": 0.1, "momentum": 0.9},
            shard_weight_update=True)
    net, step = make()
    x = np.random.RandomState(rank).randn(2, 3).astype(np.float32)
    y = np.zeros((2, 4), np.float32)
    step(mt.nd.array(x), mt.nd.array(y))
    d = os.path.join(out, "ckpt")
    ck.save_train_step(step, d, step=1)
    step(mt.nd.array(x), mt.nd.array(y))
    cont = [p.data().asnumpy() for p in net.collect_params().values()]
    net2, step2 = make()
    ck.load_train_step(step2, d, step=1)
    step2(mt.nd.array(x), mt.nd.array(y))
    got = [p.data().asnumpy() for p in net2.collect_params().values()]
    # a mesh Trainer (ZeRO-1, a loss scaler): every rank saves, the
    # first writes the whole states, a new Trainer resumes bit-exact
    from mxtpu_torch import resilience

    def trainer():
        net = mt.gluon.nn.Dense(4, in_units=3)
        net.initialize(ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(2))
        sc = resilience.DynamicLossScaler(init_scale=8.0)
        return net, sc, mt.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh, zero1=True,
            loss_scaler=sc)

    def mstep(net, sc, tr):
        xs = tr.shard_batch(mt.nd.array(np.ones((4, 3), np.float32)
                                        * (1 + rank)))
        with mt.autograd.record():
            loss = sc.scale((net(xs) ** 2).sum())
        loss.backward()
        tr.step(4)
    net, sc, tr = trainer()
    mstep(net, sc, tr)
    md = os.path.join(out, "mesh_ckpt")
    ck.save_trainer(tr, md, step=1)
    mstep(net, sc, tr)
    mcont = [p.data().asnumpy() for p in net.collect_params().values()]
    net2, sc2, tr2 = trainer()
    ck.load_trainer(tr2, md, step=1)
    mstep(net2, sc2, tr2)
    mgot = [p.data().asnumpy() for p in net2.collect_params().values()]
    _torch_ranks.save(out, rank, diff=max(float(np.abs(a - b).max())
                                          for a, b in zip(cont, got)),
                      files=" ".join(sorted(os.listdir(
                          os.path.join(d, "step_1")))),
                      mesh_diff=max(float(np.abs(a - b).max())
                                    for a, b in zip(mcont, mgot)),
                      mesh_files=" ".join(sorted(os.listdir(
                          os.path.join(md, "step_1")))))


def test_train_step_and_mesh_trainer_round_trips_on_two_ranks(tmp_path):
    import _torch_ranks
    ranks = _torch_ranks.run(_train_step_ranks, WORLD, tmp_path)
    for r in ranks:
        assert float(r["diff"]) == 0.0
        assert str(r["files"]) == \
            "rank0.json rank0.npz rank1.json rank1.npz"
        assert float(r["mesh_diff"]) == 0.0
        assert str(r["mesh_files"]) == "rank0.json rank0.npz"
