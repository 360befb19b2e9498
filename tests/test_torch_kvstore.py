"""The port's ``kvstore``, ``kvstore_server``, ``gradient_compression`` and
``distributed`` against the JAX package's, on the CPU.

Local stores run in this process beside the reference's. ``dist_sync``
runs as four gloo ranks spawned on the CPU (``_torch_ranks``): each rank
pushes its own values, and the pulled sums are held to the sums the
reference's local store computes over the four ranks' values (1e-6; gloo
sums in its own order). The 2-bit packing is the reference's bit for
bit, and a compressed push equals the sum of the reference's dequantized
codes of each rank exactly. A Trainer over ``dist_sync`` (the store
updates, as the reference's default) takes two SGD steps and is held to
the reference's Trainer on the concatenated batch (sum loss): 1e-5.
"""
import numpy as np
import pytest

import _torch_ranks

WORLD = 4
SHAPES = [(3, 4), (5,), (2, 3)]


def _values(rank, seed=0):
    r = np.random.RandomState(seed + 7 * rank)
    return [r.randn(*s).astype(np.float32) for s in SHAPES]


def _batch(rank):
    r = np.random.RandomState(40 + rank)
    return (r.randn(3, 4).astype(np.float32),
            r.randn(3, 2).astype(np.float32))


def _dense(pkg, ctx):
    net = pkg.gluon.nn.Dense(2, in_units=4)
    net.initialize(**ctx)
    r = np.random.RandomState(5)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(r.randn(*p.shape).astype(np.float32), **ctx))
    return net


def _ranks(rank, world, out_dir):
    import mxtpu_torch as mt
    save = lambda **kw: _torch_ranks.save(out_dir, rank, **kw)  # noqa: E731
    arr = lambda a: mt.nd.array(a, ctx=mt.cpu())  # noqa: E731
    kv = mt.kv.create("dist_sync")
    save(kv_rank=kv.rank, workers=kv.num_workers, type=kv.type)
    vals = _values(rank)
    kv.init(list(range(3)), [arr(v) for v in vals])
    outs = [arr(np.zeros(s, np.float32)) for s in SHAPES]
    kv.pull(list(range(3)), outs)
    save(**{"init%d" % i: o.asnumpy() for i, o in enumerate(outs)})
    # grouped push of two values a key (tree-sum), then the world's sum
    kv.push(list(range(3)), [[arr(v), arr(2 * v)] for v in vals])
    kv.pull(list(range(3)), outs)
    save(**{"push%d" % i: o.asnumpy() for i, o in enumerate(outs)})
    out = arr(np.zeros(SHAPES[0], np.float32))
    kv.pushpull(0, arr(vals[0]), out=out)
    save(pushpull=out.asnumpy())
    kv.barrier()
    # 2-bit compression: the packed codes of each rank, summed
    ckv = mt.kv.create("dist_sync")
    ckv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    ckv.init("w", arr(np.zeros(SHAPES[0], np.float32)))
    for step in range(2):
        ckv.push("w", arr(_values(rank, seed=step + 1)[0]))
        got = arr(np.zeros(SHAPES[0], np.float32))
        ckv.pull("w", out=got)
        save(**{"comp%d" % step: got.asnumpy()})
    # the store's own optimizer (update_on_kvstore), states saved
    okv = mt.kv.create("dist_sync")
    okv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=0.9))
    okv.init(0, arr(np.ones(SHAPES[0], np.float32)))
    okv.push(0, arr(vals[0]))
    okv.push(0, arr(vals[0]))
    w = arr(np.zeros(SHAPES[0], np.float32))
    okv.pull(0, out=w)
    path = "%s/opt%d.states" % (out_dir, rank)
    okv.save_optimizer_states(path)
    okv.load_optimizer_states(path)
    save(opt_w=w.asnumpy())
    # a Trainer over dist_sync with 2-bit compression off and on
    for comp in (None, {"type": "2bit", "threshold": 0.01}):
        net = _dense(mt, {"ctx": mt.cpu()})
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="dist_sync",
                              compression_params=comp)
        x, y = _batch(rank)
        for _ in range(2):
            with mt.autograd.record():
                loss = mt.gluon.loss.L2Loss()(net(arr(x)), arr(y))
            loss.backward()
            tr.step(3)
        save(**{"tr%d_%s" % (comp is not None, n.split("_")[-1]):
                p.data().asnumpy()
                for n, p in net.collect_params().items()})
    try:
        kv.row_sparse_pull(0, out=outs[0], row_ids=arr(np.zeros(1)))
        save(rsp="")
    except mt.MXNetError as e:
        save(rsp=str(e))
    save(host_sum=mt.distributed.allreduce_host(np.full(3, rank + 1.0)),
         host_all=mt.distributed.allgather_host(np.full(2, rank)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _torch_ranks.run(_ranks, WORLD, tmp_path_factory.mktemp("kv"))


def _mx_sum(values):
    """The sum the reference's local store computes for a list of
    values pushed under one key."""
    import mxtpu as mx
    kv = mx.kv.create("local")
    kv.init(0, mx.nd.array(np.zeros_like(values[0])))
    kv.push(0, [mx.nd.array(v) for v in values])
    out = mx.nd.array(np.zeros_like(values[0]))
    kv.pull(0, out=out)
    return out.asnumpy()


def test_dist_sync_init_push_pull_sum_over_ranks(ranks):
    for r, got in enumerate(ranks):
        assert int(got["kv_rank"]) == r and int(got["workers"]) == WORLD
        assert str(got["type"]) == "dist_sync"
        for i in range(3):   # init: the first rank's value
            np.testing.assert_array_equal(got["init%d" % i],
                                          _values(0)[i])
            ref = _mx_sum([m * v[i] for v in map(_values, range(WORLD))
                           for m in (1, 2)])
            np.testing.assert_allclose(got["push%d" % i], ref, rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(
            got["pushpull"], _mx_sum([_values(q)[0] for q in range(WORLD)]),
            rtol=1e-6, atol=1e-6)


def test_two_bit_packing_is_the_references():
    from mxtpu.gradient_compression import GradientCompression as J
    from mxtpu_torch.gradient_compression import GradientCompression as T
    j, t = J(threshold=0.5), T(threshold=0.5)
    for step in range(3):
        g = np.random.RandomState(step).randn(37).astype(np.float32)
        pj, nj = j.quantize("k", g)
        pt, nt = t.quantize("k", g)
        assert nj == nt and np.array_equal(np.asarray(pj), pt)
        np.testing.assert_array_equal(t._residuals["k"],
                                      np.asarray(j._residuals["k"]))
        np.testing.assert_array_equal(t.dequantize(pt, nt, (37,)),
                                      np.asarray(j.dequantize(pj, nj,
                                                              (37,))))
    assert t.get_compression_factor() == j.get_compression_factor() == 16


def test_compressed_push_sums_every_ranks_codes(ranks):
    from mxtpu.gradient_compression import GradientCompression
    comps = [GradientCompression(threshold=0.5) for _ in range(WORLD)]
    for step in range(2):
        ref = np.zeros(SHAPES[0], np.float32)
        for r, c in enumerate(comps):
            g = _values(r, seed=step + 1)[0]
            packed, n = c.quantize("w", g)
            ref += np.asarray(c.dequantize(packed, n, SHAPES[0]))
        for got in ranks:
            np.testing.assert_array_equal(got["comp%d" % step], ref)


def test_store_side_optimizer_like_mxtpu(ranks):
    import mxtpu as mx
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                         momentum=0.9))
    kv.init(0, mx.nd.array(np.ones(SHAPES[0], np.float32)))
    total = _mx_sum([_values(q)[0] for q in range(WORLD)])
    kv.push(0, mx.nd.array(total))
    kv.push(0, mx.nd.array(total))
    w = mx.nd.array(np.zeros(SHAPES[0], np.float32))
    kv.pull(0, out=w)
    for got in ranks:
        np.testing.assert_allclose(got["opt_w"], w.asnumpy(), rtol=1e-5,
                                   atol=1e-6)


def test_dist_trainer_matches_mxtpu_on_the_whole_batch(ranks):
    import mxtpu as mx
    net = _dense(mx, {})
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    xs, ys = zip(*[_batch(r) for r in range(WORLD)])
    x, y = np.concatenate(xs), np.concatenate(ys)
    for _ in range(2):
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(net(mx.nd.array(x)),
                                          mx.nd.array(y))
        loss.backward()
        tr.step(3)   # each rank's batch size, as the store sums
    for got in ranks:
        for n, p in net.collect_params().items():
            np.testing.assert_allclose(got["tr0_" + n.split("_")[-1]],
                                       p.data().asnumpy(), rtol=1e-5,
                                       atol=1e-5)
        for n in ("weight", "bias"):   # compressed: one copy on every rank
            np.testing.assert_array_equal(got["tr1_" + n],
                                          ranks[0]["tr1_" + n])


def test_host_collectives_and_refusals(ranks):
    import mxtpu_torch as mt
    for got in ranks:
        assert "ROADMAP A10" in str(got["rsp"])
        np.testing.assert_array_equal(got["host_sum"], np.full(3, 10.0))
        np.testing.assert_array_equal(got["host_all"],
                                      np.repeat(np.arange(4)[:, None], 2, 1))
    with pytest.raises(mt.MXNetError, match="dist_async"):
        mt.kv.create("dist_async")
    with pytest.raises(mt.MXNetError, match="distributed.init"):
        mt.kv.create("dist_sync")
    with pytest.raises(mt.MXNetError, match="unknown KVStore"):
        mt.kv.create("nope")
    with pytest.raises(mt.MXNetError, match="Parameter-server"):
        mt.kvstore_server.KVStoreServer().run()
    mt.kvstore_server._init_kvstore_server_module("worker")
    assert mt.distributed.rank() == 0 and mt.distributed.num_workers() == 1
    assert mt.distributed.allreduce_host(3) == 3


def test_local_store_like_mxtpu():
    import mxtpu as mx
    import mxtpu_torch as mt
    vals = _values(1)
    for kind in ("local", "device", "nccl"):
        tkv, jkv = mt.kv.create(kind), mx.kv.create(kind)
        assert tkv.type == jkv.type == kind
        tkv.init([0, 1], [mt.nd.array(v, ctx=mt.cpu()) for v in vals[:2]])
        jkv.init([0, 1], [mx.nd.array(v) for v in vals[:2]])
        tkv.push(0, [mt.nd.array(v, ctx=mt.cpu()) for v in (vals[0],
                                                            vals[0] * 3)])
        jkv.push(0, [mx.nd.array(v) for v in (vals[0], vals[0] * 3)])
        for key in (0, 1):
            a = mt.nd.array(np.zeros_like(vals[key]), ctx=mt.cpu())
            b = mx.nd.array(np.zeros_like(vals[key]))
            tkv.pull(key, out=a)
            jkv.pull(key, out=b)
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
        assert tkv.rank == jkv.rank == 0
        assert tkv.num_workers == jkv.num_workers == 1
        assert tkv.get_num_dead_node() == 0


def test_nccl_without_a_card_raises_and_gloo_is_only_asked_for():
    import torch
    import mxtpu_torch as mt
    if torch.cuda.is_available():   # pragma: no cover - CPU tests
        pytest.skip("this host has a card")
    with pytest.raises(mt.MXNetError, match="NCCL needs a CUDA device"):
        mt.distributed.init("localhost:1", num_processes=1, process_id=0)
    assert not mt.distributed.is_initialized()
    assert mt.distributed.global_compute_supported()
