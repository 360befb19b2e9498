"""``mx.rnn`` of the port against the JAX package's, on the CPU: each
symbolic cell's unrolled graph (its ``-symbol.json`` text, with both
packages' node counters reset), ``FusedRNNCell``'s weight unpack, pack
and unfuse, ``BucketSentenceIter``'s batches, the checkpoint helpers, and
a narrow ``examples/rnn/lstm_bucketing.py`` (the mx.rnn LSTM stack under
``BucketingModule``, three buckets) trained two steps in lockstep with
``mxtpu`` (outputs and parameters within 1e-4 of max(1, max|ref|)). The
fused cell's packed blob comes from ``convert.seeded_params``, as the
Gluon tests' weights do.
"""
import random
import warnings

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.symbol import symbol as jsym
from mxtpu_torch import convert, graphs
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.symbol import symbol as tsym

TOL = 1e-4
B, T, E, H, V = 4, 5, 6, 8, 20


@pytest.fixture(autouse=True)
def _reset_counters():
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    yield


def _both(build):
    """``build(package)`` in each package with the node counters reset."""
    out = {}
    for pkg, mod in ((mx, jsym), (mt, tsym)):
        mod._Counter._counts.clear()
        out[pkg] = build(pkg)
    return out


def _nd(pkg, a):
    if pkg is mt:
        with mt.cpu():
            return mt.nd.array(a)
    return mx.nd.array(a)


CELLS = {
    "rnn": lambda p: p.rnn.RNNCell(H, prefix="rnn_"),
    "rnn_relu": lambda p: p.rnn.RNNCell(H, activation="relu", prefix="r_"),
    "lstm": lambda p: p.rnn.LSTMCell(H, prefix="lstm_"),
    "gru": lambda p: p.rnn.GRUCell(H, prefix="gru_"),
    "fused_lstm": lambda p: p.rnn.FusedRNNCell(H, num_layers=2,
                                               prefix="f_"),
    "fused_gru_bi": lambda p: p.rnn.FusedRNNCell(
        H, num_layers=2, mode="gru", bidirectional=True,
        get_next_state=True, prefix="g_"),
    "zoneout": lambda p: p.rnn.ZoneoutCell(p.rnn.LSTMCell(H, prefix="z_"),
                                           0.3, 0.2),
    "residual": lambda p: p.rnn.ResidualCell(p.rnn.GRUCell(E, prefix="q_")),
    "bidirectional": lambda p: p.rnn.BidirectionalCell(
        p.rnn.LSTMCell(H, prefix="bl_"), p.rnn.GRUCell(H, prefix="br_")),
}


def _stack(p):
    stack = p.rnn.SequentialRNNCell()
    stack.add(p.rnn.LSTMCell(H, prefix="s0_"))
    stack.add(p.rnn.DropoutCell(0.5, prefix="sd_"))
    stack.add(p.rnn.GRUCell(H, prefix="s1_"))
    return stack


CELLS["sequential"] = _stack


def _unrolled(name, layout="NTC", merge=True):
    def build(p):
        cell = CELLS[name](p)
        data = p.sym.var("data")
        out, states = cell.unroll(T, data, begin_state=cell.begin_state(
            batch_size=B), layout=layout, merge_outputs=merge)
        heads = (out if isinstance(out, list) else [out]) + list(states)
        return p.sym.Group(heads), cell
    return _both(build)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_unrolled_symbol_json_matches_the_reference(name, layout):
    built = _unrolled(name, layout, merge=name != "rnn")
    assert built[mt][0].tojson() == built[mx][0].tojson()
    args = built[mt][0].list_arguments()
    assert args == built[mx][0].list_arguments()
    shape = (B, T, E) if layout == "NTC" else (T, B, E)
    assert built[mt][0].infer_shape(data=shape) == \
        built[mx][0].infer_shape(data=shape)


@pytest.mark.parametrize("name", ["lstm", "fused_gru_bi", "sequential",
                                  "bidirectional"])
def test_unrolled_symbol_runs_as_the_reference(name):
    """The unrolled graph bound and run forward and backward (predict
    mode: the stack's Dropout passes), seeded arguments for both."""
    built = _unrolled(name)
    shape = (B, T, E)
    arg_shapes, _, _ = built[mt][0].infer_shape(data=shape)
    names = built[mt][0].list_arguments()
    rng = np.random.RandomState(3)
    args = {n: (rng.randn(*s) * 0.4).astype(np.float32)
            for n, s in zip(names, arg_shapes)}
    outs, grads = {}, {}
    for pkg in (mx, mt):
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        ex = built[pkg][0].simple_bind(grad_req="write", data=shape, **kw)
        for n, a in args.items():
            ex.arg_dict[n][:] = _nd(pkg, a)
        out = ex.forward(is_train=False)
        ex.backward([_nd(pkg, np.ones(o.shape, np.float32)) for o in out])
        outs[pkg] = [o.asnumpy() for o in out]
        grads[pkg] = {n: ex.grad_dict[n].asnumpy() for n in names}
    for g, r in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(g, r, rtol=1e-5,
                                   atol=1e-5 * max(1, np.abs(r).max()))
    for n in names:
        r = grads[mx][n]
        np.testing.assert_allclose(grads[mt][n], r, rtol=TOL,
                                   atol=TOL * max(1, np.abs(r).max()),
                                   err_msg=n)


@pytest.mark.parametrize("mode,bi", [("lstm", False), ("gru", True),
                                     ("rnn_tanh", False)])
def test_fused_cell_pack_unpack_unfuse(mode, bi):
    cells = _both(lambda p: p.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                               bidirectional=bi,
                                               prefix="f_"))
    size = mt.ops.rnn_ops.rnn_param_size(mode, 2, E, H, bi)
    blob = convert.seeded_params({"f_parameters": (size,)},
                                 seed=1)["f_parameters"]
    unpacked = {}
    for pkg, cell in cells.items():
        u = cell.unpack_weights({"f_parameters": _nd(pkg, blob),
                                 "other": _nd(pkg, np.ones(2, np.float32))})
        unpacked[pkg] = {k: v.asnumpy() for k, v in u.items()}
        packed = cell.pack_weights(u)
        np.testing.assert_array_equal(packed["f_parameters"].asnumpy(),
                                      blob)
        assert sorted(packed) == ["f_parameters", "other"]
    assert sorted(unpacked[mt]) == sorted(unpacked[mx])
    for k, v in unpacked[mx].items():
        np.testing.assert_array_equal(unpacked[mt][k], v)
    # the unfused stack computes what the fused op does, on the port
    tsym._Counter._counts.clear()
    fused = cells[mt]
    stack = fused.unfuse()
    data = mt.sym.var("data")
    outs = []
    for cell, feed in ((fused, {"f_parameters": blob}),
                       (stack, {k: v for k, v in unpacked[mt].items()
                                if k != "other"})):
        out, _ = cell.unroll(T, data, begin_state=cell.begin_state(
            batch_size=B), merge_outputs=True)
        x = np.random.RandomState(2).randn(B, T, E).astype(np.float32)
        with mt.cpu():
            res = out.eval(data=mt.nd.array(x), **{
                k: mt.nd.array(v) for k, v in feed.items()})
        outs.append(res[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_bucket_sentence_iter_matches_the_reference():
    sentences, vocab = {}, {}
    words = [["w%d" % ((i * 7 + j) % 13) for j in range(3 + i % 9)]
             for i in range(60)]
    for pkg in (mx, mt):
        sentences[pkg], vocab[pkg] = pkg.rnn.encode_sentences(
            words, invalid_label=0, start_label=1)
    assert sentences[mt] == sentences[mx] and vocab[mt] == vocab[mx]
    with pytest.raises(mt.MXNetError, match="Unknown token"):
        mt.rnn.encode_sentences([["zzz"]], vocab=dict(vocab[mt]))
    batches = {}
    for pkg in (mx, mt):
        np.random.seed(4)
        random.seed(4)
        with mt.cpu():
            it = pkg.rnn.BucketSentenceIter(sentences[pkg], 5,
                                            buckets=[4, 8, 12],
                                            invalid_label=0)
            batches[pkg] = [(b.bucket_key, b.data[0].asnumpy(),
                             b.label[0].asnumpy(), b.provide_data[0][1])
                            for b in it]
        assert it.default_bucket_key == 12
        assert it.provide_data[0][1] == (5, 12)
    assert len(batches[mt]) == len(batches[mx]) > 3
    for g, r in zip(batches[mt], batches[mx]):
        assert g[0] == r[0] and tuple(g[3]) == tuple(r[3])
        np.testing.assert_array_equal(g[1], r[1])
        np.testing.assert_array_equal(g[2], r[2])


def test_rnn_checkpoint_helpers_round_trip(tmp_path):
    """The port saves a fused cell's blob unpacked (per-gate arrays) and
    loads it packed again; each package reads the other's files."""
    cells = _both(lambda p: p.rnn.FusedRNNCell(H, num_layers=1,
                                               prefix="f_"))
    size = mt.ops.rnn_ops.rnn_param_size("lstm", 1, E, H)
    blob = np.random.RandomState(5).randn(size).astype(np.float32)
    for pkg, other in ((mt, mx), (mx, mt)):
        cell = cells[pkg]
        data = pkg.sym.var("data")
        out, _ = cell.unroll(T, data, begin_state=cell.begin_state(
            batch_size=B))
        prefix = str(tmp_path / ("from_" + pkg.__name__))
        with mt.cpu():
            pkg.rnn.save_rnn_checkpoint(cell, prefix, 3, out,
                                        {"f_parameters": _nd(pkg, blob)}, {})
            saved = pkg.nd.load(prefix + "-0003.params")
            assert "arg:f_l0_i2h_weight" in saved
            assert "arg:f_parameters" not in saved
            sym, arg, aux = other.rnn.load_rnn_checkpoint(cells[other],
                                                          prefix, 3)
        np.testing.assert_array_equal(arg["f_parameters"].asnumpy(), blob)
        assert sym.list_arguments() == out.list_arguments() and aux == {}
    callback = mt.rnn.do_rnn_checkpoint(cells[mt], str(tmp_path / "cb"),
                                        period=2)
    with mt.cpu():
        callback(0, out, {"f_parameters": _nd(mt, blob)}, {})
        callback(1, out, {"f_parameters": _nd(mt, blob)}, {})
    assert (tmp_path / "cb-0002.params").exists()
    assert not (tmp_path / "cb-0001.params").exists()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mt.rnn.rnn_unroll(mt.rnn.LSTMCell(H, prefix="u_"), T,
                          inputs=mt.sym.var("data"),
                          begin_state=mt.rnn.LSTMCell(
                              H, prefix="u_").begin_state(batch_size=B))
    assert "deprecated" in str(caught[0].message)


def _bucketing(pkg, stack_cells):
    """examples/rnn/lstm_bucketing.py's sym_gen, narrow."""
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(num_hidden=H, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.var("data")
        label = pkg.sym.var("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed,
                                  begin_state=stack.begin_state(
                                      batch_size=B), merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, H))
        pred = pkg.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _train_bucketing(pkg, args, batches):
    kw = {"context": mt.cpu()} if pkg is mt else {}
    mod = pkg.mod.BucketingModule(_bucketing(pkg, None),
                                  default_bucket_key=max(
                                      b[0] for b in batches), **kw)
    default = mod._default_bucket_key
    mod.bind(data_shapes=[("data", (B, default))],
             label_shapes=[("softmax_label", (B, default))])
    mod.init_params(arg_params={k: _nd(pkg, v) for k, v in args.items()})
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    outs = []
    for key, x, y in batches:
        if pkg is mt:
            with mt.cpu():
                b = mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)])
        else:
            b = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
        b.bucket_key = key
        b.provide_data = [("data", (B, key))]
        b.provide_label = [("softmax_label", (B, key))]
        mod.forward_backward(b)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs


def _bucket_batches(seed, keys):
    rng = np.random.RandomState(seed)
    out = []
    for key in keys:
        x = rng.randint(1, V, (B, key)).astype(np.float32)
        y = np.concatenate([x[:, 1:], np.zeros((B, 1), np.float32)], 1)
        out.append((key, x, y))
    return out


def test_lstm_bucketing_trains_in_lockstep_with_the_reference():
    """Two SGD steps on each of the buckets 3, 5 and 7 (the default 7
    bound first; 3 and 5 share its parameters)."""
    tsym._Counter._counts.clear()
    sym, _, _ = _bucketing(mt, None)(7)
    shapes, _, _ = sym.infer_shape(data=(B, 7), softmax_label=(B, 7))
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    batches = _bucket_batches(1, [7, 3, 5, 7, 3, 5])
    mods, outs = {}, {}
    for pkg in (mx, mt):
        (jsym if pkg is mx else tsym)._Counter._counts.clear()
        mods[pkg], outs[pkg] = _train_bucketing(pkg, args, batches)
    for g, r in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
    got, ref = mods[mt].get_params()[0], mods[mx].get_params()[0]
    assert sorted(got) == sorted(ref)
    for k in ref:
        r = ref[k].asnumpy()
        np.testing.assert_allclose(got[k].asnumpy(), r, rtol=TOL,
                                   atol=TOL * max(1, np.abs(r).max()),
                                   err_msg=k)
    assert sorted(mods[mt]._buckets) == [3, 5, 7]


def test_bucketing_captures_one_pair_per_bucket(monkeypatch):
    """Through the stand-in graph (tests/test_torch_train_graph.py): one
    captured pair per bucket, none after the first pass."""
    from test_torch_train_graph import FakeGraph
    flag = [False]
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: flag[0])
    FakeGraph.made = []
    sym, _, _ = _bucketing(mt, None)(7)
    shapes, _, _ = sym.infer_shape(data=(B, 7), softmax_label=(B, 7))
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    eager = _train_bucketing(mt, args, _bucket_batches(2, [7, 3]))[1]
    flag[0] = True
    ttel.reset()
    batches = _bucket_batches(2, [7, 3, 7, 3])
    _, outs = _train_bucketing(mt, args, batches)
    builds = ttel.retrace_stats("executor")["compiles"]
    for g, r in zip(outs[:2], eager):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    assert builds == 2
    FakeGraph.made = []
