"""The port's subgraph/partition framework (``mxtpu_torch/symbol/
subgraph.py``, ``ops/subgraph_ops.py``) against the JAX package's on the
CPU, on the same seeded numpy inputs (the cases of tests/test_subgraph.py,
held to ``mxtpu``'s results).

The default property (single node, a zoo model), the original symbol left
intact, a custom property, training-mode batch statistics inside a region;
``FlashAttentionProperty``: the port partitions exactly the symbols that
``mxtpu``'s does (the canonical chain and its near misses), and
``_sg_flash_attention`` gives ``mxtpu``'s output at 1e-5, with the JAX
side's Pallas kernel run by its interpreter (``MXTPU_FLASH_INTERPRET=1``,
T and Tk multiples of 128), as tests/test_torch_flash_attention.py runs
it. The port's deliberate difference: a region runs inline in predict
mode too (inside the executor's captured graph on the card, where a
capture cannot nest); only its parsed sub-symbol is cached.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.symbol import symbol as jsym
from mxtpu_torch.ops import subgraph_ops
from mxtpu_torch.symbol import symbol as tsym

FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    yield


def _ops(sym, mod):
    return [n.op for n in mod._topo(sym._heads) if not n.is_var()]


def _mlp(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.var("data"), weight=s.var("w1"),
                         bias=s.var("b1"), num_hidden=8, name="fc1")
    h = s.Activation(h, act_type="relu")
    return s.FullyConnected(h, weight=s.var("w2"), bias=s.var("b2"),
                            num_hidden=4, name="fc2")


def _feed(sym, shapes, seed=0):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    r = np.random.RandomState(seed)
    args = {n: r.uniform(-1, 1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: r.uniform(0.1, 1, s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _run(pkg, sym, args, aux=None, is_train=False, grad_req="null",
         head=None):
    """(outputs, gradients) of one forward (+ backward with ``head``)."""
    aux = aux or {}
    if pkg is mt:
        with mt.cpu():
            exe = sym.bind(mt.cpu(), args={k: mt.nd.array(v)
                                           for k, v in args.items()},
                           aux_states={k: mt.nd.array(v)
                                       for k, v in aux.items()},
                           grad_req=grad_req)
            outs = exe.forward(is_train=is_train)
            if head is not None:
                exe.backward(mt.nd.array(head))
    else:
        exe = sym.bind(args={k: mx.nd.array(v) for k, v in args.items()},
                       aux_states={k: mx.nd.array(v) for k, v in aux.items()},
                       grad_req=grad_req)
        outs = exe.forward(is_train=is_train)
        if head is not None:
            exe.backward(mx.nd.array(head))
    return ([o.asnumpy() for o in outs],
            {k: v.asnumpy() for k, v in exe.grad_dict.items()})


def test_default_property_single_node_and_outputs():
    syms = {pkg: _mlp(pkg) for pkg in (mx, mt)}
    parts = {pkg: pkg.sym.partition(s, "default") for pkg, s in syms.items()}
    assert _ops(parts[mt], tsym) == _ops(parts[mx], jsym) == [
        "_subgraph_exec"]
    assert sorted(parts[mt].list_arguments()) == sorted(
        syms[mt].list_arguments())
    args, aux = _feed(syms[mt], {"data": (3, 6)})
    ref = _run(mx, parts[mx], args, aux)[0][0]
    for sym in (syms[mt], parts[mt]):
        np.testing.assert_allclose(_run(mt, sym, args, aux)[0][0], ref,
                                   rtol=FWD, atol=FWD)


def test_default_property_zoo_model():
    from mxtpu_torch.gluon.model_zoo import vision
    net = vision.get_model("squeezenet1_0", classes=10)
    net.initialize(ctx=mt.cpu())
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ref = net(x).numpy()
    sym, _ = mt.sym.trace_block(net)
    args, aux = {"data": x.numpy()}, {}
    for name, p in net.collect_params().items():
        (aux if p.grad_req == "null" else args)[name] = \
            p._tensor().detach().numpy()
    part = mt.sym.partition(sym, "default")
    assert _ops(part, tsym) == ["_subgraph_exec"]
    np.testing.assert_allclose(_run(mt, part, args, aux)[0][0], ref,
                               rtol=FWD, atol=FWD)


def test_partition_leaves_original_intact():
    sym = _mlp(mt)
    before = sym.tojson()
    mt.sym.partition(sym, "default")
    mt.sym.partition(sym, "flash_attention")
    assert sym.tojson() == before


def _attention(pkg, scale=("mul", 0.25), transpose_b=True, softmax_axis=-1,
               pv_transpose_b=False, transpose_a=False, second_scale=None):
    s = pkg.sym
    q, k, v = s.var("q"), s.var("k"), s.var("v")
    scores = s.batch_dot(q, k, transpose_b=transpose_b,
                         transpose_a=transpose_a)
    for op in (scale, second_scale):
        if op is None:
            continue
        kind, val = op
        scores = {"mul": lambda x: x * val, "div": lambda x: x / val,
                  "rdiv": lambda x: val / x}[kind](scores)
    probs = s.softmax(scores, axis=softmax_axis)
    return s.batch_dot(probs, v, transpose_b=pv_transpose_b)


CASES = {
    "canonical": {},
    "div_scale": {"scale": ("div", 4.0)},
    "no_scale": {"scale": None},
    "two_scales": {"second_scale": ("mul", 0.5)},
    "k_not_transposed": {"transpose_b": False},
    "reciprocal_scale": {"scale": ("rdiv", 4.0)},
    "softmax_axis_1": {"softmax_axis": 1},
    "probs_v_transposed": {"pv_transpose_b": True},
    "q_transposed": {"transpose_a": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_property_partitions_what_the_reference_does(case):
    parts = {pkg: pkg.sym.partition(_attention(pkg, **CASES[case]),
                                    "flash_attention")
             for pkg in (mx, mt)}
    assert _ops(parts[mt], tsym) == _ops(parts[mx], jsym)
    fused = _ops(parts[mt], tsym) == ["_sg_flash_attention"]
    assert fused == (case in ("canonical", "div_scale", "no_scale",
                              "two_scales", "k_not_transposed"))
    if fused:
        node = tsym._topo(parts[mt]._heads)[-1]
        jnode = jsym._topo(parts[mx]._heads)[-1]
        assert node.attrs == jnode.attrs


def test_flash_property_no_false_positive():
    for pkg in (mx, mt):
        x = pkg.sym.var("x")
        out = pkg.sym.softmax(x, axis=-1)
        part = pkg.sym.partition(out, "flash_attention")
        assert _ops(part, tsym if pkg is mt else jsym) == ["softmax"]
    x = {"x": np.random.RandomState(0).uniform(-1, 1, (2, 5)).astype(
        np.float32)}
    np.testing.assert_allclose(_run(mt, part, x)[0][0],
                               _run(mx, mx.sym.softmax(mx.sym.var("x")),
                                    x)[0][0], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("transpose_b", [True, False])
def test_sg_flash_attention_against_reference(transpose_b):
    """Forward against ``mxtpu``'s partitioned graph (its Pallas kernel by
    the interpreter) at 1e-5; gradients through the Executor against the
    port's unpartitioned graph at 1e-4."""
    b, t, d = 2, 128, 16
    r = np.random.RandomState(1)
    feed = {"q": r.randn(b, t, d).astype(np.float32),
            "k": (r.randn(b, t, d) if transpose_b
                  else r.randn(b, d, t)).astype(np.float32),
            "v": r.randn(b, t, d).astype(np.float32)}
    head = r.randn(b, t, d).astype(np.float32)
    case = {"scale": ("mul", d ** -0.5), "transpose_b": transpose_b}
    jpart = mx.sym.partition(_attention(mx, **case), "flash_attention")
    tsyms = {"part": mt.sym.partition(_attention(mt, **case),
                                      "flash_attention"),
             "plain": _attention(mt, **case)}
    assert _ops(tsyms["part"], tsym) == ["_sg_flash_attention"]
    ref = _run(mx, jpart, feed)[0][0]
    got = {k: _run(mt, s, feed, is_train=True, grad_req="write",
                   head=head) for k, s in tsyms.items()}
    np.testing.assert_allclose(got["part"][0][0], ref, rtol=FWD, atol=FWD)
    np.testing.assert_allclose(got["plain"][0][0], ref, rtol=FWD, atol=FWD)
    for n in "qkv":
        np.testing.assert_allclose(got["part"][1][n], got["plain"][1][n],
                                   rtol=GRAD, atol=GRAD)


def test_custom_property_registration():
    for pkg, mod in ((mx, jsym), (mt, tsym)):
        s = pkg.sym

        class _FCSel(s.SubgraphSelector):
            def select(self, node):
                return node.op == "FullyConnected"

            def select_output(self, node, output_node):
                return output_node.op == "Activation"

        class FCActProperty(s.SubgraphProperty):
            name = "test_fc_act"

            def create_selector(self):
                return _FCSel()

        s.register_subgraph_property(FCActProperty())
    parts = {pkg: pkg.sym.partition(_mlp(pkg), "test_fc_act")
             for pkg in (mx, mt)}
    assert _ops(parts[mt], tsym) == _ops(parts[mx], jsym) == [
        "_subgraph_exec"] * 2
    args, aux = _feed(_mlp(mt), {"data": (3, 6)})
    np.testing.assert_allclose(_run(mt, parts[mt], args, aux)[0][0],
                               _run(mx, parts[mx], args, aux)[0][0],
                               rtol=FWD, atol=FWD)
    with pytest.raises(mt.MXNetError, match="unknown subgraph property"):
        mt.sym.partition(_mlp(mt), "nope")


def test_region_runs_inline_with_training_mode_batch_statistics():
    """Training-mode BatchNorm inside a region normalizes by the batch's
    statistics (mode read at call time) and does not move the moving ones
    (the reference's blind spot, kept); the region runs inline in both
    modes, only its parsed sub-symbol cached."""
    subgraph_ops._SUBGRAPH_CACHE.clear()
    outs = {}
    for pkg in (mx, mt):
        s = pkg.sym
        out = s.BatchNorm(s.var("data"), gamma=s.var("g"), beta=s.var("b"),
                          moving_mean=s.var("mm_moving_mean"),
                          moving_var=s.var("mv_moving_var"),
                          fix_gamma=False)
        part = pkg.sym.partition(out, "default")
        x = np.random.RandomState(0).uniform(5, 6, (8, 3)).astype(
            np.float32)
        args = {"data": x, "g": np.ones(3, np.float32),
                "b": np.zeros(3, np.float32)}
        aux = {"mm_moving_mean": np.zeros(3, np.float32),
               "mv_moving_var": np.ones(3, np.float32)}
        outs[pkg] = (_run(pkg, part, args, aux, is_train=True)[0][0],
                     _run(pkg, part, args, aux, is_train=False)[0][0])
    for got, ref in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(got, ref, rtol=FWD, atol=FWD)
    assert abs(outs[mt][0].mean()) < 0.1
    assert abs(outs[mt][1].mean() - x.mean()) < 0.1
    assert len(subgraph_ops._SUBGRAPH_CACHE) == 1
