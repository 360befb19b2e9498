"""``Module``, ``BucketingModule`` and the ``Executor`` on a
``parallel.Mesh`` context, and ``Module`` over a ``dist_sync`` store,
against the JAX package's, on the CPU.

The port runs as four gloo ranks spawned once (``_torch_ranks``). On the
mesh every rank binds the global shapes and passes the same global
batch; the executor runs its rows and sums the gradients over the data
axis. The reference is ``tests/test_module.py``'s
``test_module_on_mesh_matches_single_device`` (4 SGD steps of an MLP,
outputs against ``context=None``), here with seeded weights in both
packages. Over ``dist_sync`` each rank binds its quarter of the batch
with ``rescale_grad`` 1 / global batch, so the store's sum is the
reference's one-process step. Tolerances rtol 1e-4, atol 1e-5 (the
reference's).
"""
import logging

import numpy as np
import pytest

import _torch_ranks

WORLD = 4
BATCH, IN, HIDDEN, CLASSES = 32, 8, 32, 4
STEPS = 4


def _toy(n=BATCH * STEPS, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.normal(scale=3.0, size=(CLASSES, IN))
    y = rng.randint(0, CLASSES, size=(n,))
    x = centers[y] + rng.normal(scale=0.5, size=(n, IN))
    return x.astype(np.float32), y.astype(np.float32)


def _weights(seed=1):
    r = np.random.RandomState(seed)
    return {"fc1_weight": (r.randn(HIDDEN, IN) * 0.3).astype(np.float32),
            "fc1_bias": np.zeros(HIDDEN, np.float32),
            "fc2_weight": (r.randn(CLASSES, HIDDEN) * 0.3).astype(
                np.float32),
            "fc2_bias": np.zeros(CLASSES, np.float32)}


def _symbol(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), s.var("fc1_weight"),
                           s.var("fc1_bias"), num_hidden=HIDDEN, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, s.var("fc2_weight"), s.var("fc2_bias"),
                           num_hidden=CLASSES, name="fc2")
    return s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")


def _run(pkg, context, kvstore=None, rows=slice(None), rescale=None,
         batch=BATCH):
    """4 SGD steps; the outputs of each and the parameters after."""
    kw = {} if context is None else {"context": context}
    mod = pkg.mod.Module(_symbol(pkg), **kw)
    n = len(range(batch)[rows])
    mod.bind(data_shapes=[("data", (n, IN))],
             label_shapes=[("softmax_label", (n,))])
    nd = {k: pkg.nd.array(v) for k, v in _weights().items()}
    mod.init_params(arg_params=nd)
    opt = {"learning_rate": 0.1}
    if rescale is not None:
        opt["rescale_grad"] = rescale
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=opt)
    x, y = _toy()
    outs = []
    for i in range(STEPS):
        xb, yb = x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch]
        b = pkg.io.DataBatch(data=[pkg.nd.array(xb[rows])],
                             label=[pkg.nd.array(yb[rows])])
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    return mod, np.stack(outs), {k: v.asnumpy()
                                 for k, v in mod.get_params()[0].items()}


# ----------------------------------------------------------------- the ranks
def _ranks(rank, world, out):
    import mxtpu_torch as mt
    from mxtpu_torch import parallel as par
    save = lambda **kw: _torch_ranks.save(out, rank, **kw)  # noqa: E731
    mesh = par.make_mesh({"data": 4})

    # Module on the mesh against context None (this rank's CPU)
    _, o_mesh, p_mesh = _run(mt, mesh)
    mod, o_one, p_one = _run(mt, None)
    save(mesh_out=o_mesh, one_out=o_one,
         **{"mesh_" + k: v for k, v in p_mesh.items()},
         **{"one_" + k: v for k, v in p_one.items()})
    exe = mod._exec
    save(one_device=str(exe._device))

    # the Executor alone: gradients summed over the data axis; a batch
    # that does not divide the axis runs whole, warned once
    sym = _symbol(mt)
    x, y = _toy()
    grads = {}
    for name, ctx, n in (("mesh", mesh, BATCH), ("cpu", mt.cpu(), BATCH),
                         ("odd", mesh, 30), ("odd_cpu", mt.cpu(), 30)):
        exe = sym.simple_bind(ctx, grad_req="write", data=(n, IN),
                              softmax_label=(n,))
        exe.copy_params_from({k: mt.nd.array(v) for k, v in
                              _weights().items()})
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logging.getLogger("mxtpu_torch.symbol.executor").addHandler(handler)
        try:
            for _ in range(2):
                exe.forward(is_train=True, data=mt.nd.array(x[:n]),
                            softmax_label=mt.nd.array(y[:n]))
                exe.backward()
        finally:
            logging.getLogger("mxtpu_torch.symbol.executor") \
                .removeHandler(handler)
        grads[name] = {k: exe.grad_dict[k].asnumpy() for k in _weights()}
        save(**{"exe_%s_%s" % (name, k): v for k, v in grads[name].items()})
        save(**{"exe_%s_out" % name: exe.outputs[0].asnumpy(),
                "exe_%s_warnings" % name: len(records)})

    # BucketingModule passes the mesh to its Modules
    def sym_gen(key):
        return _symbol(mt), ("data",), ("softmax_label",)
    bm = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                context=mesh)
    bm.bind(data_shapes=[("data", (BATCH, IN))],
            label_shapes=[("softmax_label", (BATCH,))])
    bm.init_params(arg_params={k: mt.nd.array(v)
                               for k, v in _weights().items()})
    bm.forward(mt.io.DataBatch(data=[mt.nd.array(x[:BATCH])],
                               label=[mt.nd.array(y[:BATCH])]),
               is_train=False)
    save(bucket_out=bm.get_outputs()[0].asnumpy())

    # dist_sync over the four ranks: each rank its quarter, rescale 1/32
    q = BATCH // world
    for kv in ("dist_sync", "dist_device_sync"):
        m, _, p = _run(mt, None, kvstore=kv,
                       rows=slice(rank * q, (rank + 1) * q),
                       rescale=1.0 / BATCH)
        save(**{"%s_%s" % (kv, k): v for k, v in p.items()},
             **{kv + "_on_store": int(m._update_on_kvstore)})


def _world_of_one(rank, world, out):
    import mxtpu_torch as mt
    save = lambda **kw: _torch_ranks.save(out, rank, **kw)  # noqa: E731
    for name, kv in (("dist_sync", "dist_sync"),
                     ("dist_device_sync", "dist_device_sync"),
                     ("object", mt.kvstore.create("dist_sync"))):
        mod, outs, p = _run(mt, None, kvstore=kv)
        save(**{"%s_%s" % (name, k): v for k, v in p.items()},
             **{name + "_out": outs,
                name + "_on_store": int(mod._update_on_kvstore),
                name + "_keys": len(mod._kvstore._store)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _torch_ranks.run(_ranks, WORLD, tmp_path_factory.mktemp("mm"))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return _torch_ranks.run(_world_of_one, 1,
                            tmp_path_factory.mktemp("m1"))[0]


@pytest.fixture(scope="module")
def reference():
    import jax
    import mxtpu as mx
    from mxtpu.parallel import make_mesh
    plain = _run(mx, None)
    on_mesh = _run(mx, make_mesh({"data": 4}, jax.devices()[:WORLD]))
    store = _run(mx, None, kvstore=mx.kvstore.KVStore("dist_sync"))
    return {"plain": plain, "mesh": on_mesh, "store": store}


def test_module_on_mesh_matches_mxtpu(ranks, reference):
    _, ref_out, ref_p = reference["mesh"]
    _, plain_out, plain_p = reference["plain"]
    np.testing.assert_allclose(ref_out, plain_out, rtol=1e-4, atol=1e-5)
    for got in ranks:
        assert got["mesh_out"].shape == (STEPS, BATCH, CLASSES)
        np.testing.assert_allclose(got["mesh_out"], ref_out, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["mesh_out"], got["one_out"],
                                   rtol=1e-4, atol=1e-5)
        for k, v in ref_p.items():
            np.testing.assert_allclose(got["mesh_" + k], v, rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got["one_" + k], plain_p[k],
                                       rtol=1e-4, atol=1e-5)
        assert str(got["one_device"]) == "cpu"


def test_executor_on_mesh_sums_over_the_data_axis(ranks):
    for got in ranks:
        for k in _weights():
            # SoftmaxOutput's gradients are sums over the rows: the four
            # ranks' rows summed are the whole batch's
            np.testing.assert_allclose(got["exe_mesh_" + k],
                                       got["exe_cpu_" + k], rtol=1e-4,
                                       atol=1e-5)
            # a batch of 30 runs whole on every rank, not summed
            np.testing.assert_allclose(got["exe_odd_" + k],
                                       got["exe_odd_cpu_" + k], rtol=1e-6,
                                       atol=1e-7)
        np.testing.assert_allclose(got["exe_mesh_out"], got["exe_cpu_out"],
                                   rtol=1e-5, atol=1e-6)
        # one warning per (input, shape): data and label, over two forwards
        assert int(got["exe_odd_warnings"]) == 2
        assert int(got["exe_mesh_warnings"]) == 0


def test_bucketing_module_passes_the_mesh(ranks):
    for got in ranks:
        assert got["bucket_out"].shape == (BATCH, CLASSES)
        np.testing.assert_allclose(got["bucket_out"].sum(1), np.ones(BATCH),
                                   rtol=1e-5)


@pytest.mark.parametrize("kv", ["dist_sync", "dist_device_sync"])
def test_dist_sync_over_four_ranks_matches_mxtpu(ranks, reference, kv):
    _, _, ref_p = reference["store"]
    for got in ranks:
        assert int(got[kv + "_on_store"]) == 1
        for k, v in ref_p.items():
            np.testing.assert_allclose(got["%s_%s" % (kv, k)], v, rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync", "object"])
def test_dist_sync_world_of_one_matches_mxtpu(one, reference, name):
    mod, ref_out, ref_p = reference["store"]
    assert mod._update_on_kvstore
    assert int(one[name + "_on_store"]) == 1
    assert int(one[name + "_keys"]) == len(ref_p) == len(mod._kvstore._store)
    np.testing.assert_allclose(one[name + "_out"], ref_out, rtol=1e-4,
                               atol=1e-5)
    for k, v in ref_p.items():
        np.testing.assert_allclose(one["%s_%s" % (name, k)], v, rtol=1e-4,
                                   atol=1e-5)
