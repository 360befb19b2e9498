"""The port's Executor (``mxtpu_torch/symbol/executor.py``) against the JAX
package's on the CPU, on the same seeded numpy inputs: ``simple_bind``,
forward and backward with ``grad_req`` ``write``/``add``/``null``,
training-mode BatchNorm's moving statistics, the monitor callback's node
names and values, ``reshape``, ``copy_params_from``, and
``SoftmaxOutput``'s fused gradient under each of its options.
Tolerances are the reference's: float32 1e-5 forward, 1e-4 gradients.

Then the port's own contract: the captured path (driven through the
stand-in for ``graphs.CapturedGraph`` that tests/test_torch_train_graph.py
uses, with ``graphs.captures`` answering yes for the CPU) gives the eager
numbers, reads an array written through ``NDArray.__setitem__`` after the
capture, and keeps one graph per (mode, signature); two training forwards
before one backward give the second's gradients (the reference's rule:
its backward recomputes the last forward); the device defaults to the
CUDA device and raises without one, and a context list of several devices
names ROADMAP A8.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.symbol import symbol as jsym
from mxtpu_torch import graphs
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.symbol import symbol as tsym

FWD, GRAD = 1e-5, 1e-4
BATCH, IN = 6, 5


@pytest.fixture(autouse=True)
def _reset_counters():
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    yield


def _net(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.var("data"), num_hidden=8, name="fc1")
    h = s.BatchNorm(h, fix_gamma=False, momentum=0.8, name="bn1")
    h = s.Activation(h, act_type="tanh", name="act1")
    h = s.FullyConnected(h, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def _state(sym, seed=0):
    shapes = sym.infer_shape(data=(BATCH, IN), softmax_label=(BATCH,))
    r = np.random.RandomState(seed)
    args = {n: r.uniform(-1, 1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes[0])}
    args["softmax_label"] = r.randint(0, 3, BATCH).astype(np.float32)
    aux = {n: r.uniform(0.5, 1.5, s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), shapes[2])}
    return args, aux


def _bind(pkg, sym, args, aux, grad_req="write", ctx=None):
    if pkg is mt:
        with mt.cpu():
            return sym.bind(mt.cpu() if ctx is None else ctx,
                            args={k: mt.nd.array(v) for k, v in args.items()},
                            aux_states={k: mt.nd.array(v)
                                        for k, v in aux.items()},
                            grad_req=grad_req)
    return sym.bind(args={k: mx.nd.array(v) for k, v in args.items()},
                    aux_states={k: mx.nd.array(v) for k, v in aux.items()},
                    grad_req=grad_req)


def _np(d):
    return {k: v.asnumpy() for k, v in d.items() if v is not None}


def _close(got, ref, tol):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol,
                                   err_msg=k)


def _pair(grad_req="write"):
    jsy, tsy = _net(mx), _net(mt)
    args, aux = _state(tsy)
    return (_bind(mx, jsy, args, aux, grad_req),
            _bind(mt, tsy, args, aux, grad_req), args, aux)


@pytest.mark.parametrize("is_train", [False, True])
def test_forward_and_backward_match(is_train):
    je, te, _, _ = _pair()
    for e in (je, te):
        e.forward(is_train=is_train)
        e.backward()
    np.testing.assert_allclose(te.outputs[0].asnumpy(),
                               je.outputs[0].asnumpy(), rtol=FWD, atol=FWD)
    _close(_np(te.grad_dict), _np(je.grad_dict), GRAD)
    _close(_np(te.aux_dict), _np(je.aux_dict), FWD)
    assert te.output_dict.keys() == je.output_dict.keys()


def test_batchnorm_moving_statistics_move_in_training_forwards():
    je, te, _, aux = _pair()
    for _ in range(2):
        for e in (je, te):
            e.forward(is_train=True)
    _close(_np(te.aux_dict), _np(je.aux_dict), FWD)
    moved = _np(te.aux_dict)
    assert not np.allclose(moved["bn1_moving_mean"], aux["bn1_moving_mean"])
    for e in (je, te):
        e.forward(is_train=False)
    _close(_np(te.aux_dict), moved, 0)


def test_grad_req_add_and_null():
    req = {"data": "null", "fc1_weight": "add", "fc1_bias": "add",
           "bn1_gamma": "write", "bn1_beta": "null", "fc2_weight": "write",
           "fc2_bias": "add", "softmax_label": "null"}
    je, te, _, _ = _pair(req)
    for _ in range(2):
        for e in (je, te):
            e.forward(is_train=True)
            e.backward()
    assert sorted(te.grad_dict) == sorted(je.grad_dict) == sorted(
        k for k, v in req.items() if v != "null")
    _close(_np(te.grad_dict), _np(je.grad_dict), GRAD)
    # "add" accumulated the two backwards, "write" holds the last
    once = _pair(req)[1]
    once.forward(is_train=True)
    once.backward()
    g1, g2 = _np(once.grad_dict), _np(te.grad_dict)
    np.testing.assert_allclose(g2["fc2_bias"], 2 * g1["fc2_bias"],
                               rtol=GRAD, atol=GRAD)
    np.testing.assert_allclose(g2["fc2_weight"], g1["fc2_weight"],
                               rtol=GRAD, atol=GRAD)


def test_input_gradient_and_out_grads():
    jsy = mx.sym.FullyConnected(mx.sym.var("x"), mx.sym.var("w"),
                                no_bias=True, num_hidden=4)
    tsy = mt.sym.FullyConnected(mt.sym.var("x"), mt.sym.var("w"),
                                no_bias=True, num_hidden=4)
    r = np.random.RandomState(1)
    args = {"x": r.randn(3, 5).astype(np.float32),
            "w": r.randn(4, 5).astype(np.float32)}
    head = r.randn(3, 4).astype(np.float32)
    je, te = _bind(mx, jsy, args, {}), _bind(mt, tsy, args, {})
    je.forward(is_train=True)
    je.backward(mx.nd.array(head))
    te.forward(is_train=True)
    with mt.cpu():
        te.backward(mt.nd.array(head))
    _close(_np(te.grad_dict), _np(je.grad_dict), GRAD)
    np.testing.assert_allclose(te.grad_dict["x"].asnumpy(),
                               head @ args["w"], rtol=GRAD, atol=GRAD)


def test_monitor_callback_sees_every_node():
    je, te, _, _ = _pair()
    seen = {}
    for name, e in (("j", je), ("t", te)):
        rows = seen[name] = []
        e.set_monitor_callback(
            lambda n, arr, rows=rows: rows.append((n, arr.asnumpy())))
        e.forward(is_train=True)
    assert [n for n, _ in seen["t"]] == [n for n, _ in seen["j"]] == [
        "fc1_output", "bn1_output", "act1_output", "fc2_output",
        "softmax_output"]
    for (_, got), (_, ref) in zip(seen["t"], seen["j"]):
        np.testing.assert_allclose(got, ref, rtol=FWD, atol=FWD)
    mon = mt.Monitor(1, pattern="fc.*")
    mon.install(te)
    mon.tic()
    te.forward()
    names = [k for _, k, _ in mon.toc()]
    assert names == ["fc1_output", "fc2_output"]


def test_reshape_and_copy_params_from():
    je, te, args, aux = _pair()
    je2 = je.reshape(data=(2 * BATCH, IN), softmax_label=(2 * BATCH,))
    te2 = te.reshape(data=(2 * BATCH, IN), softmax_label=(2 * BATCH,))
    assert te2.arg_dict["fc1_weight"] is te.arg_dict["fc1_weight"]
    assert te2.arg_dict["data"].shape == (2 * BATCH, IN)
    r = np.random.RandomState(7)
    x = r.randn(2 * BATCH, IN).astype(np.float32)
    new_w = {"fc2_weight": r.randn(3, 8).astype(np.float32)}
    je2.copy_params_from({k: mx.nd.array(v) for k, v in new_w.items()})
    with mt.cpu():
        te2.copy_params_from({k: mt.nd.array(v) for k, v in new_w.items()})
        got = te2.forward(data=mt.nd.array(x))[0].asnumpy()
    ref = je2.forward(data=mx.nd.array(x))[0].asnumpy()
    np.testing.assert_allclose(got, ref, rtol=FWD, atol=FWD)
    np.testing.assert_array_equal(te.arg_dict["fc2_weight"].asnumpy(),
                                  new_w["fc2_weight"])
    with pytest.raises(mt.MXNetError, match="not in"):
        te2.copy_params_from({"nope": mt.nd.array(x, ctx=mt.cpu())})
    te2.copy_params_from({"nope": mt.nd.array(x, ctx=mt.cpu())},
                         allow_extra_params=True)


@pytest.mark.parametrize("opts", [
    {}, {"grad_scale": 0.5}, {"use_ignore": True, "ignore_label": 1.0},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"normalization": "batch"}, {"smooth_alpha": 0.1}])
def test_softmax_output_fused_gradient(opts):
    r = np.random.RandomState(3)
    x = r.randn(5, 4).astype(np.float32)
    lab = np.array([0, 1, 2, 1, 3], np.float32)
    grads = []
    for pkg in (mx, mt):
        sym = pkg.sym.SoftmaxOutput(pkg.sym.var("x"), pkg.sym.var("y"),
                                    **opts)
        e = _bind(pkg, sym, {"x": x, "y": lab}, {},
                  {"x": "write", "y": "null"})
        e.forward(is_train=True)
        e.backward()
        grads.append((e.outputs[0].asnumpy(), e.grad_dict["x"].asnumpy()))
    np.testing.assert_allclose(grads[1][0], grads[0][0], rtol=FWD, atol=FWD)
    np.testing.assert_allclose(grads[1][1], grads[0][1], rtol=GRAD,
                               atol=GRAD)


def test_softmax_output_multi_output():
    r = np.random.RandomState(4)
    x = r.randn(2, 3, 4).astype(np.float32)
    lab = r.randint(0, 3, (2, 4)).astype(np.float32)
    got = []
    for pkg in (mx, mt):
        sym = pkg.sym.SoftmaxOutput(pkg.sym.var("x"), pkg.sym.var("y"),
                                    multi_output=True)
        e = _bind(pkg, sym, {"x": x, "y": lab}, {},
                  {"x": "write", "y": "null"})
        e.forward(is_train=True)
        e.backward()
        got.append(e.grad_dict["x"].asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=GRAD, atol=GRAD)


def test_two_training_forwards_before_one_backward():
    """The executor's rule (the reference's: backward recomputes the last
    forward): the gradients are the second forward's."""
    _, te, args, aux = _pair()
    x2 = args["data"] * 2.0
    te.forward(is_train=True)
    with mt.cpu():
        te.forward(is_train=True, data=mt.nd.array(x2))
    te.backward()
    fresh = _bind(mt, _net(mt), dict(args, data=x2), aux)
    fresh.forward(is_train=True)
    fresh.backward()
    _close(_np(te.grad_dict), _np(fresh.grad_dict), 0)


@pytest.fixture
def captured(monkeypatch):
    """The stand-in graph; ``graphs.captures`` answers ``flag[0]``."""
    from test_torch_train_graph import FakeGraph
    flag = [True]
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: flag[0])
    FakeGraph.made = []
    ttel.reset()
    yield FakeGraph, flag
    FakeGraph.made = []


def test_captured_path_matches_eager(captured):
    """Through the stand-in: a predict graph, then a forward/backward pair,
    each captured once per (mode, signature), give the eager numbers; an
    array replaced through ``__setitem__`` after the capture is read."""
    fake, flag = captured
    _, eager, args, aux = _pair()
    _, cap, _, _ = _pair()

    def run(e, fn):
        flag[0] = e is cap
        fn(e)
    for step in range(2):
        for e in (eager, cap):
            run(e, lambda e: e.forward(is_train=False))
        np.testing.assert_array_equal(cap.outputs[0].asnumpy(),
                                      eager.outputs[0].asnumpy())
        for e in (eager, cap):
            run(e, lambda e: (e.forward(is_train=True), e.backward()))
        _close(_np(cap.grad_dict), _np(eager.grad_dict), 1e-6)
        _close(_np(cap.aux_dict), _np(eager.aux_dict), 1e-6)
    # one predict graph and the pair's two, each built once
    assert len(fake.made) == 3
    assert ttel.retrace_stats("executor")["compiles"] == 2
    w = np.full((3, 8), 0.25, np.float32)
    for e in (eager, cap):
        with mt.cpu():
            e.arg_dict["fc2_weight"][:] = mt.nd.array(w)
        run(e, lambda e: e.forward())
    np.testing.assert_array_equal(cap.outputs[0].asnumpy(),
                                  eager.outputs[0].asnumpy())
    assert len(fake.made) == 3
    np.testing.assert_array_equal(
        list(cap._entries.values())[0].tensors["fc2_weight"].numpy(), w)


def test_device_defaults_and_refusals(monkeypatch):
    sym = _net(mt)
    args, aux = _state(sym)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        sym.simple_bind(data=(BATCH, IN), softmax_label=(BATCH,))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        sym.simple_bind(mt.gpu(0), data=(BATCH, IN), softmax_label=(BATCH,))
    # a list of contexts binds on its first, as the reference's executor
    # keeps the list and runs on one device
    exe = sym.simple_bind([mt.cpu(), mt.cpu(1)], data=(BATCH, IN),
                          softmax_label=(BATCH,))
    assert all(a.context == torch.device("cpu")
               for a in exe.arg_arrays + exe.aux_arrays)
    with pytest.raises(mt.MXNetError, match="nor a parallel.Mesh"):
        sym.simple_bind(object(), data=(BATCH, IN), softmax_label=(BATCH,))
    exe = sym.simple_bind([mt.cpu()], data=(BATCH, IN),
                          softmax_label=(BATCH,))
    assert all(a.context == torch.device("cpu")
               for a in exe.arg_arrays + exe.aux_arrays)
    with mt.cpu():
        exe = sym.simple_bind(data=(BATCH, IN), softmax_label=(BATCH,))
    assert exe.arg_dict["fc1_weight"].context == torch.device("cpu")
    with pytest.raises(mt.MXNetError, match="forward before backward"):
        exe.backward()


def test_captured_entries_resolve_through_the_compile_service(captured):
    """The captured executor's graphs are compile-service entries at site
    ``executor``, keyed by the symbol's JSON digest and this executor's
    nonce; the LRU bound evicts them from ``_entries`` too, and the next
    forward captures again (an evicted graph is never replayed)."""
    from mxtpu_torch import compile_service
    fake, flag = captured
    _, cap, _, _ = _pair()
    cap.forward(is_train=False)
    keys = [k for k in compile_service._STORE if k.nonce == cap._nonce]
    assert [k.site for k in keys] == ["executor"]
    assert keys[0].fn_id.startswith("executor:") and \
        keys[0].signature[-1] is False
    assert len(cap._entries) == 1 and len(fake.made) == 1
    cap.forward(is_train=False)
    assert len(fake.made) == 1
    compile_service.drop(nonce=cap._nonce)
    assert len(cap._entries) == 0
    cap.forward(is_train=False)
    assert len(fake.made) == 2 and len(cap._entries) == 1
    assert ttel.retrace_stats("executor")["compiles"] == 2
