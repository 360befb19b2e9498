"""``mx.mod`` of the port (``mxtpu_torch/module/``, ``model``,
``callback``) against the JAX package's on the CPU, on the same seeded
numpy inputs.

``Module``: three SGD-momentum steps in lockstep with ``mxtpu``'s, both
with ``kvstore="local"`` (outputs, weights, BatchNorm statistics and
momenta within 1e-4 after each step); input gradients; ``fit`` to high
accuracy on a separable toy set; ``save_checkpoint``/``Module.load`` with
optimizer states; ``predict`` over a ragged last batch, padded to the
bound batch so one predict graph serves the epoch (through the stand-in
for ``graphs.CapturedGraph`` of tests/test_torch_train_graph.py).
``BucketingModule`` on an unseen bucket (composed symbols; the sentence
iterator is ROADMAP A6), ``SequentialModule``, ``PythonLossModule``,
``FeedForward`` and the callbacks. The refusals: a ``dist_*`` store
outside a process group and ``group2ctxs`` raise as the reference's do,
several contexts run on the first; a loss scaler that is not a
``DynamicLossScaler`` and ``TrainingHealthMonitor``'s unknown
``on_poison`` raise.
"""
import logging

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.symbol import symbol as jsym
from mxtpu_torch import graphs
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.symbol import symbol as tsym

TOL = 1e-4
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
BATCH = 4


@pytest.fixture(autouse=True)
def _reset_counters():
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    yield


def _convnet(pkg):
    s = pkg.sym
    h = s.Convolution(s.var("data"), kernel=(3, 3), num_filter=6,
                      pad=(1, 1), layout="NHWC", name="conv0")
    h = s.BatchNorm(h, axis=-1, fix_gamma=False, name="bn0")
    h = s.Activation(h, act_type="relu")
    h = s.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                  layout="NHWC")
    h = s.FullyConnected(h, num_hidden=5, name="fc")
    return s.SoftmaxOutput(h, name="softmax")


def _params(sym, data_shape, seed=0):
    shapes = sym.infer_shape(data=data_shape, softmax_label=(BATCH,))
    r = np.random.RandomState(seed)
    args = {n: (r.standard_normal(s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes[0])
            if n not in ("data", "softmax_label")}
    aux = {n: r.uniform(0.5, 1.5, s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), shapes[2])}
    return args, aux


def _nd(pkg, d):
    if pkg is mt:
        with mt.cpu():
            return {k: mt.nd.array(v) for k, v in d.items()}
    return {k: mx.nd.array(v) for k, v in d.items()}


def _batch(pkg, x, y):
    if pkg is mt:
        with mt.cpu():
            return mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
    return mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])


def _module(pkg, sym, args, aux, data_shape, **bind_kw):
    kw = {"context": mt.cpu()} if pkg is mt else {}
    mod = pkg.mod.Module(sym, **kw)
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (data_shape[0],))], **bind_kw)
    mod.init_params(arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux))
    return mod


def _data(seed, shape=(BATCH, 6, 6, 3), classes=5):
    r = np.random.RandomState(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.randint(0, classes, shape[0]).astype(np.float32))


def _close(got, ref, tol=TOL):
    assert sorted(got) == sorted(ref)
    for k in ref:
        a = ref[k].asnumpy()
        np.testing.assert_allclose(got[k].asnumpy(), a, rtol=tol,
                                   atol=tol * max(1.0, np.abs(a).max()),
                                   err_msg=k)


def test_module_lockstep_with_reference():
    shape = (BATCH, 6, 6, 3)
    mods = {}
    for pkg in (mx, mt):
        sym = _convnet(pkg)
        args, aux = _params(_convnet(mt), shape)
        mods[pkg] = _module(pkg, sym, args, aux, shape)
        mods[pkg].init_optimizer(kvstore="local", optimizer="sgd",
                                 optimizer_params=dict(OPT))
    for step in range(3):
        x, y = _data(10 + step)
        for pkg, mod in mods.items():
            mod.forward_backward(_batch(pkg, x, y))
            mod.update()
        np.testing.assert_allclose(mods[mt].get_outputs()[0].asnumpy(),
                                   mods[mx].get_outputs()[0].asnumpy(),
                                   rtol=TOL, atol=TOL)
        for got, ref in zip(mods[mt].get_params(), mods[mx].get_params()):
            _close(got, ref)
    ju, tu = mods[mx]._updater, mods[mt]._updater
    for i in tu.states:
        np.testing.assert_allclose(tu.states[i].asnumpy(),
                                   ju.states[i].asnumpy(), rtol=TOL,
                                   atol=TOL)
    assert mods[mt].output_shapes == [("softmax_output", (BATCH, 5))]


def test_input_gradients():
    shape = (BATCH, 6, 6, 3)
    grads = []
    for pkg in (mx, mt):
        args, aux = _params(_convnet(mt), shape)
        mod = _module(pkg, _convnet(pkg), args, aux, shape,
                      inputs_need_grad=True)
        x, y = _data(3)
        mod.forward_backward(_batch(pkg, x, y))
        grads.append(mod.get_input_grads()[0].asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=TOL, atol=TOL)


def _toy(n=64, seed=0):
    r = np.random.RandomState(seed)
    x = r.standard_normal((n, 4)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    return x, y


def _mlp(pkg):
    s = pkg.sym
    h = s.Activation(s.FullyConnected(s.var("data"), num_hidden=8,
                                      name="fc1"), act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=2, name="fc2"),
                           name="softmax")


def test_fit_score_checkpoint_and_load(tmp_path):
    x, y = _toy()
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, 16, shuffle=False)
        seen = []
        mod.fit(it, num_epoch=8, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
                initializer=mt.init.Xavier(),
                batch_end_callback=[lambda p: seen.append(p.nbatch),
                                    mt.callback.Speedometer(16, 2)],
                epoch_end_callback=mt.callback.do_checkpoint(
                    str(tmp_path / "toy"), period=4))
        acc = dict(mod.score(it, "acc"))["accuracy"]
    assert acc >= 0.9 and seen[:4] == [0, 1, 2, 3] and len(seen) == 32
    assert (tmp_path / "toy-0004.params").exists()
    assert (tmp_path / "toy-0008.params").exists()
    mod.save_checkpoint(str(tmp_path / "m"), 8, save_optimizer_states=True)
    loaded = mt.mod.Module.load(str(tmp_path / "m"), 8,
                                load_optimizer_states=True,
                                context=mt.cpu())
    loaded.bind(data_shapes=[("data", (16, 4))],
                label_shapes=[("softmax_label", (16,))])
    loaded.init_params()
    loaded.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.5,
                                            "momentum": 0.9})
    for a, b in zip(mod.get_params(), loaded.get_params()):
        _close(a, b, 0)
    for i, s in mod._updater.states.items():
        np.testing.assert_array_equal(loaded._updater.states[i].asnumpy(),
                                      s.asnumpy())
    with mt.cpu():
        batch = mt.io.DataBatch([mt.nd.array(x[:16])], [mt.nd.array(y[:16])])
    outs = []
    for m in (mod, loaded):
        m.forward(batch, is_train=False)
        outs.append(m.get_outputs()[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    # the checkpoint reads back in the reference too
    sym, args, auxs = mx.model.load_checkpoint(str(tmp_path / "m"), 8)
    assert sym.list_arguments() == mod.symbol.list_arguments()
    np.testing.assert_array_equal(args["fc1_weight"].asnumpy(),
                                  mod.get_params()[0]["fc1_weight"]
                                  .asnumpy())


class _Ragged:
    """Batches of 4, 4 and 2 rows (the last one ragged)."""

    def __init__(self, x, y):
        self.x, self.y = x, y
        self.provide_data = [("data", (4, x.shape[1]))]
        self.provide_label = [("softmax_label", (4,))]

    def reset(self):
        pass

    def __iter__(self):
        for lo in range(0, len(self.x), 4):
            with mt.cpu():
                yield mt.io.DataBatch([mt.nd.array(self.x[lo:lo + 4])],
                                      [mt.nd.array(self.y[lo:lo + 4])])


def test_predict_pads_a_ragged_tail_to_one_graph(monkeypatch):
    from test_torch_train_graph import FakeGraph
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made = []
    ttel.reset()
    x, y = _toy(10, seed=2)
    args = {"fc1_weight": np.full((8, 4), 0.1, np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": np.linspace(-1, 1, 16).reshape(2, 8).astype(
                np.float32),
            "fc2_bias": np.zeros(2, np.float32)}
    mod = _module(mt, _mlp(mt), args, {}, (4, 4), for_training=False)
    out = mod.predict(_Ragged(x, y))
    assert out.shape == (10, 2)
    assert ttel.retrace_stats("executor")["compiles"] == 1
    ref = _module(mx, _mlp(mx), args, {}, (10, 4), for_training=False)
    ref.forward(_batch(mx, x, y), is_train=False)
    np.testing.assert_allclose(out.asnumpy(),
                               ref.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-5)
    FakeGraph.made = []


def _bucket_gen(pkg):
    def sym_gen(key):
        s = pkg.sym
        h = s.FullyConnected(s.var("data"), num_hidden=6, flatten=False,
                             name="proj")
        h = s.mean(s.Activation(h, act_type="tanh"), axis=1)
        h = s.FullyConnected(h, num_hidden=3, name="cls")
        return s.SoftmaxOutput(h, name="softmax"), ("data",), \
            ("softmax_label",)
    return sym_gen


def test_bucketing_module_unseen_bucket():
    default, unseen = 5, 3
    r = np.random.RandomState(8)
    args = {"proj_weight": r.randn(6, 4).astype(np.float32) * 0.5,
            "proj_bias": np.zeros(6, np.float32),
            "cls_weight": r.randn(3, 6).astype(np.float32) * 0.5,
            "cls_bias": np.zeros(3, np.float32)}
    mods = {}
    for pkg in (mx, mt):
        kw = {"context": mt.cpu()} if pkg is mt else {}
        mod = pkg.mod.BucketingModule(_bucket_gen(pkg),
                                      default_bucket_key=default, **kw)
        mod.bind(data_shapes=[("data", (BATCH, default, 4))],
                 label_shapes=[("softmax_label", (BATCH,))])
        mod.init_params(arg_params=_nd(pkg, args))
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params=dict(OPT))
        mods[pkg] = mod
    for key in (default, unseen, unseen, default):
        x = r.randn(BATCH, key, 4).astype(np.float32)
        y = r.randint(0, 3, BATCH).astype(np.float32)
        for pkg, mod in mods.items():
            b = _batch(pkg, x, y)
            b.bucket_key = key
            b.provide_data = [("data", (BATCH, key, 4))]
            b.provide_label = [("softmax_label", (BATCH,))]
            mod.forward_backward(b)
            mod.update()
        np.testing.assert_allclose(mods[mt].get_outputs()[0].asnumpy(),
                                   mods[mx].get_outputs()[0].asnumpy(),
                                   rtol=TOL, atol=TOL)
    assert sorted(mods[mt]._buckets) == [unseen, default]
    _close(mods[mt].get_params()[0], mods[mx].get_params()[0])


def _seq(pkg, with_loss):
    s = pkg.sym
    kw = {"context": mt.cpu()} if pkg is mt else {}
    first = pkg.mod.Module(
        s.Activation(s.FullyConnected(s.var("data"), num_hidden=6,
                                      name="fc1"), act_type="relu"),
        label_names=None, **kw)
    seq = pkg.mod.SequentialModule().add(first)
    if with_loss:
        second = pkg.mod.Module(s.FullyConnected(s.var("data"), num_hidden=3,
                                                 name="fc2"),
                                label_names=None, **kw)

        def grad(scores, labels):
            p = np.exp(scores.asnumpy())
            p /= p.sum(axis=1, keepdims=True)
            p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1
            return p
        seq.add(second, auto_wiring=True).add(
            pkg.mod.PythonLossModule(grad_func=grad), take_labels=True,
            auto_wiring=True)
    else:
        second = pkg.mod.Module(s.SoftmaxOutput(
            s.FullyConnected(s.var("data"), num_hidden=3, name="fc2"),
            name="softmax"), **kw)
        seq.add(second, take_labels=True, auto_wiring=True)
    return seq


@pytest.mark.parametrize("with_loss", [False, True])
def test_sequential_and_python_loss_modules(with_loss):
    r = np.random.RandomState(9)
    args = {"fc1_weight": r.randn(6, 4).astype(np.float32) * 0.5,
            "fc1_bias": np.zeros(6, np.float32),
            "fc2_weight": r.randn(3, 6).astype(np.float32) * 0.5,
            "fc2_bias": np.zeros(3, np.float32)}
    seqs = {}
    for pkg in (mx, mt):
        seq = _seq(pkg, with_loss)
        seq.bind(data_shapes=[("data", (BATCH, 4))],
                 label_shapes=[("softmax_label", (BATCH,))])
        seq.init_params(arg_params=_nd(pkg, args), allow_missing=True)
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "rescale_grad": 1.0})
        seqs[pkg] = seq
    for step in range(2):
        x = r.randn(BATCH, 4).astype(np.float32)
        y = r.randint(0, 3, BATCH).astype(np.float32)
        for pkg, seq in seqs.items():
            seq.forward_backward(_batch(pkg, x, y))
            seq.update()
        np.testing.assert_allclose(seqs[mt].get_outputs()[0].asnumpy(),
                                   seqs[mx].get_outputs()[0].asnumpy(),
                                   rtol=TOL, atol=TOL)
    _close(seqs[mt].get_params()[0], seqs[mx].get_params()[0])


def test_feedforward_and_callbacks(tmp_path, caplog):
    x, y = _toy(48, seed=4)
    with mt.cpu():
        ff = mt.model.FeedForward.create(
            _mlp(mt), x, y, ctx=mt.cpu(), num_epoch=6,
            numpy_batch_size=16, learning_rate=0.5, momentum=0.9,
            initializer=mt.init.Xavier())
        pred = ff.predict(x)
    assert pred.shape == (48, 2)
    assert ((pred.argmax(axis=1) == y).mean()) >= 0.85
    ff.save(str(tmp_path / "ff"))
    with mt.cpu():
        again = mt.model.FeedForward.load(str(tmp_path / "ff"), 6,
                                          ctx=mt.cpu())
        np.testing.assert_array_equal(again.predict(x), pred)
    # callbacks
    caplog.set_level(logging.INFO)
    param = mt.model.BatchEndParam(epoch=1, nbatch=0, eval_metric=None,
                                   locals=None)
    bar = mt.callback.ProgressBar(total=4)
    bar(param)
    metric = mt.metric.Accuracy()
    metric.update([mt.nd.array(np.array([1.0]), ctx=mt.cpu())],
                  [mt.nd.array(np.array([[0.2, 0.8]]), ctx=mt.cpu())])
    mt.callback.LogValidationMetricsCallback()(
        mt.model.BatchEndParam(epoch=2, nbatch=0, eval_metric=metric,
                               locals=None))
    assert "Validation-accuracy=1.000000" in caplog.text
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (16, 4))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(initializer=mt.init.Xavier())
    mod.init_optimizer()
    mt.callback.module_checkpoint(mod, str(tmp_path / "cb"), period=2,
                                  save_optimizer_states=True)(1)
    assert (tmp_path / "cb-0002.params").exists()
    assert (tmp_path / "cb-0002.states").exists()


def test_refusals_name_their_roadmap_items(monkeypatch):
    sym = _mlp(mt)
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[("data", (16, 4))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(initializer=mt.init.Xavier())
    # a dist store outside a process group raises in both packages; one
    # joined is held to mxtpu in tests/test_torch_module_mesh.py
    jmod = mx.mod.Module(_mlp(mx))
    jmod.bind(data_shapes=[("data", (16, 4))],
              label_shapes=[("softmax_label", (16,))])
    jmod.init_params(initializer=mx.init.Xavier())
    for store in ("dist_sync", "dist_device_sync"):
        with pytest.raises(mt.MXNetError, match="process group"):
            mod.init_optimizer(kvstore=store, force_init=True)
        with pytest.raises(mx.MXNetError):
            jmod.init_optimizer(kvstore=store, force_init=True)
    with pytest.raises(mt.MXNetError, match="neither a store's name"):
        mod.init_optimizer(kvstore=object(), force_init=True)
    with pytest.raises(mt.MXNetError, match="DynamicLossScaler"):
        mod.init_optimizer(loss_scaler=object(), force_init=True)
    for kv in ("local", "device", None):
        mod.init_optimizer(kvstore=kv, force_init=True)
        assert mod._kvstore is None and not mod._update_on_kvstore
    # several contexts run on the first, as the reference's executor does
    several = mt.mod.Module(sym, context=[mt.cpu(), mt.cpu(1)])
    several.bind(data_shapes=[("data", (16, 4))],
                 label_shapes=[("softmax_label", (16,))])
    assert several._exec._device == torch.device("cpu")
    # group2ctxs raises in the reference's words, naming the port's mesh
    with pytest.raises(mt.MXNetError) as te:
        mt.mod.Module(sym, context=mt.cpu(), group2ctxs={"a": mt.cpu()})
    with pytest.raises(mx.MXNetError) as je:
        mx.mod.Module(_mlp(mx), group2ctxs={"a": mx.cpu()})
    assert str(te.value).split(":")[0] == str(je.value).split(":")[0] == \
        "group2ctxs manual device placement is not supported"
    assert "parallel.Mesh context plus ShardedTrainStep param_specs" in \
        str(te.value)
    with pytest.raises(ValueError, match="on_poison"):
        mt.monitor.TrainingHealthMonitor(on_poison="ignore")
    with pytest.raises(ValueError, match="on_poison"):
        mx.monitor.TrainingHealthMonitor(on_poison="ignore")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.mod.Module(sym)
