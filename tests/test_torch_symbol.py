"""The port's symbol layer (``mxtpu_torch.symbol``, ``name``,
``attribute``, the registry's parameter-shape rules) against the JAX
package's on the CPU, on the same seeded numpy inputs.

Composition and listing, ``infer_shape``/``infer_type`` with the parameter
rules (conv NCHW and NHWC, FC, BN, auto-created variables), arithmetic and
the scalar ops, ``Group`` and slicing, ``AttrScope``/``NameManager``, and
the JSON: the same text for the same composed symbol (both packages'
node-name counters reset first), each package loading the other's text,
``eval`` equal. ``eval`` is held at the reference's tolerance (float32
1e-5). Also: shape inference runs on meta tensors, the fused conv's and
flash attention's wrappers give meta outputs for meta inputs and count no
launch, and ``trace_block`` refuses an output no registered op made.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.ops import registry as jreg
from mxtpu.symbol import symbol as jsym
from mxtpu_torch.ops import registry as treg
from mxtpu_torch.ops.pallas import conv as tconv
from mxtpu_torch.ops.pallas import flash_attention as tflash
from mxtpu_torch.symbol import symbol as tsym

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_counters():
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    yield


def _both(build):
    """``build(pkg)`` for each package, counters reset before each."""
    out = []
    for pkg, mod in ((mx, jsym), (mt, tsym)):
        mod._Counter._counts.clear()
        out.append(build(pkg))
    return out


def _mlp(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), s.var("fc1_weight"),
                           s.var("fc1_bias"), num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    return s.FullyConnected(net, s.var("fc2_weight"), s.var("fc2_bias"),
                            num_hidden=4, name="fc2")


def _arrays(shapes, seed=0):
    r = np.random.RandomState(seed)
    return {n: r.uniform(-1, 1, s).astype(np.float32)
            for n, s in shapes.items()}


def _eval(pkg, sym, feed):
    if pkg is mt:
        with mt.cpu():
            outs = sym.eval(**{k: mt.nd.array(v) for k, v in feed.items()})
    else:
        outs = sym.eval(**{k: mx.nd.array(v) for k, v in feed.items()})
    return [o.asnumpy() for o in outs]


def test_compose_and_listing():
    j, t = _both(_mlp)
    assert t.list_arguments() == j.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
    assert t.list_outputs() == j.list_outputs() == ["fc2_output"]
    assert t.name == j.name == "fc2"
    assert t.list_auxiliary_states() == []
    # positional composition substitutes the free variables in order
    j2, t2 = _both(lambda pkg: pkg.sym.Activation(pkg.sym.var("x"),
                                                  act_type="tanh")(
        pkg.sym.var("y") * 2.0))
    assert t2.list_arguments() == j2.list_arguments() == ["y"]
    assert t2.tojson() == j2.tojson()


def _conv_bn_fc(layout):
    def build(pkg):
        s = pkg.sym
        x = s.var("data")
        h = s.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                          layout=layout, name="conv0")
        h = s.BatchNorm(h, axis=-1 if layout == "NHWC" else 1,
                        fix_gamma=False, name="bn0")
        h = s.Activation(h, act_type="relu")
        h = s.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      layout=layout)
        h = s.FullyConnected(h, num_hidden=5, name="fc")
        return s.SoftmaxOutput(h, name="softmax")
    return build


@pytest.mark.parametrize("layout,data", [("NCHW", (2, 3, 8, 8)),
                                         ("NHWC", (2, 8, 8, 3))])
def test_infer_shape_with_parameter_rules(layout, data):
    j, t = _both(_conv_bn_fc(layout))
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == [
        "bn0_moving_mean", "bn0_moving_var"]
    assert "softmax_label" in t.list_arguments()
    got = t.infer_shape(data=data, softmax_label=(2,))
    ref = j.infer_shape(data=data, softmax_label=(2,))
    assert got == ref
    args = dict(zip(t.list_arguments(), got[0]))
    assert args["conv0_weight"] == ((8, 3, 3, 3) if layout == "NCHW"
                                    else (3, 3, 3, 8))
    assert args["fc_weight"] == (5, 128) and got[1] == [(2, 5)]
    # partial knowledge: an unknown input leaves its dependents unknown
    assert t.infer_shape(softmax_label=(2,)) == \
        j.infer_shape(softmax_label=(2,))


def test_infer_type():
    j, t = _both(_conv_bn_fc("NHWC"))
    got = t.infer_type(data="float32", softmax_label="float32")
    ref = j.infer_type(data="float32", softmax_label="float32")
    assert [np.dtype(x) if x is not None else None for x in got[1]] == \
        [np.dtype(x) if x is not None else None for x in ref[1]]
    j2, t2 = _both(lambda pkg: pkg.sym.var("x", shape=(2, 3)) * 2.0)
    assert t2.infer_type(x="bfloat16")[1] == [torch.bfloat16]
    assert t2.infer_type(x="float32")[1] == [np.float32]
    assert np.dtype(j2.infer_type(x="float32")[1][0]) == np.float32


@pytest.mark.parametrize("op,shapes,attrs", [
    ("FullyConnected", [(4, 3, 5), None, None], {"num_hidden": 7}),
    ("FullyConnected", [(4, 3, 5), None, None],
     {"num_hidden": 7, "flatten": False}),
    ("Convolution", [(2, 3, 9, 9), None, None],
     {"kernel": (3, 3), "num_filter": 6, "num_group": 3}),
    ("Convolution", [(2, 9, 9, 4), None], {"kernel": (1, 1),
                                           "num_filter": 6, "no_bias": True,
                                           "layout": "NHWC"}),
    ("Deconvolution", [(2, 3, 9, 9), None, None],
     {"kernel": (2, 2), "num_filter": 4, "no_bias": False}),
    ("BatchNorm", [(2, 5, 3), None, None, None, None], {}),
    ("BatchNorm", [(2, 5, 3), None, None, None, None], {"axis": -1}),
    ("InstanceNorm", [(2, 5, 3), None, None], {}),
    ("LayerNorm", [(2, 5, 3), None, None], {}),
    ("LeakyReLU", [(2, 5, 3), None], {"act_type": "prelu"}),
    ("LeakyReLU", [(2, 5, 3), None], {"act_type": "leaky"}),
    ("Embedding", [(2, 5), None], {"input_dim": 11, "output_dim": 4}),
])
def test_parameter_shape_rules_match(op, shapes, attrs):
    assert treg.get_param_shape_rule(op)(shapes, attrs) == \
        jreg.get_param_shape_rule(op)(shapes, attrs)
    # every rule of the reference's (RNN's came with the RNN slice)
    assert set(treg.PARAM_SHAPE_RULES) == set(jreg.PARAM_SHAPE_RULES)


def test_eval_matches_ndarray():
    feed = _arrays({"x": (3, 5), "w": (7, 5), "b": (7,)})
    j, t = _both(lambda pkg: pkg.sym.FullyConnected(
        pkg.sym.var("x"), pkg.sym.var("w"), pkg.sym.var("b"), num_hidden=7))
    got, ref = _eval(mt, t, feed)[0], _eval(mx, j, feed)[0]
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    with mt.cpu():
        nd = mt.nd.FullyConnected(*(mt.nd.array(feed[k]) for k in "xwb"),
                                  num_hidden=7).asnumpy()
    np.testing.assert_array_equal(got, nd)


def test_arithmetic_and_scalar_ops():
    def build(pkg):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        return pkg.sym.Group([(a + b) * 2.0 - a / b, 3.0 - a, 1.0 / b,
                              a ** 2.0, -b, 2.0 + a * b])
    j, t = _both(build)
    assert t.tojson() == j.tojson()
    feed = {"a": np.array([[2.0, 4.0]], np.float32),
            "b": np.array([[1.0, 2.0]], np.float32)}
    for got, ref in zip(_eval(mt, t, feed), _eval(mx, j, feed)):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_eval(mt, t, feed)[0], [[4.0, 10.0]])


def test_group_slicing_and_internals():
    j, t = _both(lambda pkg: pkg.sym.Group(
        [_mlp(pkg), pkg.sym.var("z") * 3.0]))
    assert t.list_outputs() == j.list_outputs()
    assert t[0].name == "fc2" and t["fc2_output"].name == "fc2"
    assert t[1].list_outputs() == j[1].list_outputs()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert [s.name for s in t] == [s.name for s in j]
    with pytest.raises(mt.MXNetError, match="Cannot find output"):
        t["nope"]


def test_attr_scope_and_name_manager():
    def build(pkg):
        with pkg.AttrScope(ctx_group="dev1", lr_mult="0.5"):
            x = pkg.sym.var("x")
            with pkg.name.Prefix("stage1_"):
                h = pkg.sym.FullyConnected(x, num_hidden=4)
                h = pkg.sym.Activation(h, act_type="relu")
            with pkg.AttrScope(ctx_group="dev2"):
                out = pkg.sym.FullyConnected(h, num_hidden=2, name="head")
        return out
    j, t = _both(build)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert "stage1_fullyconnected0_weight" in t.list_arguments()
    assert t.attr("__ctx_group__") == "dev2"
    assert t.list_attr() == j.list_attr()
    # scope attrs are graph annotations: eval ignores them
    feed = _arrays(dict(zip(t.list_arguments(),
                            t.infer_shape(x=(3, 6))[0])))
    np.testing.assert_allclose(_eval(mt, t, feed)[0], _eval(mx, j, feed)[0],
                               rtol=TOL, atol=TOL)


def test_json_same_text_and_cross_load(tmp_path):
    j, t = _both(_conv_bn_fc("NHWC"))
    assert t.tojson() == j.tojson()
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    from_j = mt.sym.load(str(tmp_path / "j.json"))
    from_t = mx.sym.load(str(tmp_path / "t.json"))
    assert from_j.tojson() == j.tojson() and from_t.tojson() == t.tojson()
    shapes = t.infer_shape(data=(2, 8, 8, 3), softmax_label=(2,))
    names = t.list_arguments() + t.list_auxiliary_states()
    feed = _arrays(dict(zip(names, shapes[0] + shapes[2])))
    feed["bn0_moving_var"] = np.abs(feed["bn0_moving_var"]) + 0.5
    feed["softmax_label"] = np.array([1, 3], np.float32)
    got = _eval(mt, from_j, feed)[0]
    ref = _eval(mx, from_t, feed)[0]
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_eval(mt, t, feed)[0], ref, rtol=TOL,
                               atol=TOL)


def test_infer_shape_runs_on_meta_without_launches():
    """Shape inference computes nothing: every node runs on meta tensors,
    and the fused conv's and flash attention's wrappers give meta outputs
    of the right shape and dtype without counting a launch."""
    j, t = _both(_conv_bn_fc("NHWC"))
    before = (tconv.fused_conv.launches, tflash.flash_attention.launches)
    assert t.infer_shape(data=(2, 8, 8, 3), softmax_label=(2,))[1] == \
        [(2, 5)]
    x = torch.empty(2, 8, 8, 4, device="meta")
    w = torch.empty(3, 3, 4, 16, device="meta")
    out = tconv.fused_conv(x, w, padding=((1, 1), (1, 1)))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 8, 8, 16)
    out, craw = tconv.fused_conv_with_raw(
        x, w, strides=(2, 2), scale=torch.empty(16, device="meta"))
    assert tuple(out.shape) == (2, 3, 3, 16) and craw.dtype == torch.float32
    q = torch.empty(2, 3, 5, 8, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 3, 7, 8, device="meta", dtype=torch.bfloat16)
    o, lse = tflash.flash_attention_with_lse(q, k, k)
    assert (tuple(o.shape), o.dtype, tuple(lse.shape), lse.dtype) == (
        (2, 3, 5, 8), torch.bfloat16, (2, 3, 5), torch.float32)
    assert (tconv.fused_conv.launches,
            tflash.flash_attention.launches) == before


def test_flatten_and_softmax_output_registered():
    names = {op.name for op in treg.REGISTRY.values()}
    assert {"Flatten", "SoftmaxOutput", "_subgraph_exec",
            "_sg_flash_attention"} <= names
    # 166 after the symbolic slice; the RNN slice added SliceChannel, the
    # three Sequence* ops, RNN, CTCLoss, foreach, while_loop and cond, the
    # multi-device slice _contrib_ring_attention, its second part
    # _contrib_switch_moe, and A10.1 and A10.2 the 57 dense, random and
    # linear-algebra ops
    assert len(names) == 234
    x = np.random.RandomState(3).standard_normal((2, 3, 4)).astype(
        np.float32)
    j, t = _both(lambda pkg: pkg.sym.Flatten(pkg.sym.var("x")))
    np.testing.assert_array_equal(_eval(mt, t, {"x": x})[0],
                                  _eval(mx, j, {"x": x})[0])


class _NotOps(mt.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return torch.zeros_like(x) + 1.0


class _Residual(mt.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.fc = mt.gluon.nn.Dense(4, in_units=4)

    def hybrid_forward(self, F, x):
        return F.Activation(self.fc(x) + x, act_type="relu") * 0.5


def test_trace_block_records_tensor_arithmetic_and_refuses_foreign_output():
    net = _Residual()
    net.initialize(ctx=mt.cpu())
    x = torch.from_numpy(_arrays({"x": (3, 4)})["x"])
    with torch.no_grad():
        ref = net(x)
    sym, args = mt.sym.trace_block(net)
    ops = [n.op for n in tsym._topo(sym._heads) if not n.is_var()]
    assert ops == ["FullyConnected", "broadcast_add", "Activation",
                   "broadcast_mul"]
    assert args == ["data"] + list(net.collect_params())
    feed = {"data": x}
    feed.update((k, p._tensor().detach())
                for k, p in net.collect_params().items())
    got = sym.eval(**feed)[0].to_torch()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(mt.MXNetError, match="registered ops"):
        bad = _NotOps()
        bad.initialize(ctx=mt.cpu())
        mt.sym.trace_block(bad, x)
    with pytest.raises(mt.MXNetError, match="run at least once"):
        fresh = _Residual()
        fresh.initialize(ctx=mt.cpu())
        mt.sym.trace_block(fresh)
