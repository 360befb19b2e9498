"""``HybridBlock.export``, ``SymbolBlock`` and the serving load paths of the
port against the JAX package's, on the CPU: a narrow ResNet v1
(``resnet18_v1``, ``classes=10``, 32x32 inputs, seeded weights) built in
both packages with both packages' name counters reset.

* The port writes the ``-symbol.json`` text of ``mxtpu``'s export but for
  one node kind: ``mxtpu``'s BatchNorm op records no attrs when traced
  (it is registered ``wrap=False`` and hands ``_apply`` its arrays alone),
  so its exported BatchNorm nodes run with the op's defaults (eps 1e-3,
  fix_gamma, axis 1: an NHWC export does not load back). The port records
  the layer's kwargs there (ROADMAP C13). Everything else, the ``.params``
  bytes included, is equal.
* ``mxtpu``'s ``SymbolBlock.imports`` of the port's files gives
  ``mxtpu``'s Gluon logits, and the port's of ``mxtpu``'s files (NCHW,
  where its defaults still run) gives ``mxtpu``'s SymbolBlock's: float32
  within 1e-5.
* ``Predictor.from_checkpoint`` and a zoo version that names a checkpoint
  serve the files on the CPU.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon import block as jblock
from mxtpu.gluon.model_zoo import vision as jvision
from mxtpu.symbol import symbol as jsym
from mxtpu_torch import convert
from mxtpu_torch.gluon import block as tblock
from mxtpu_torch.gluon.model_zoo import vision as tvision
from mxtpu_torch.serving import BucketSpec, ModelZoo, Predictor
from mxtpu_torch.symbol import symbol as tsym

TOL = 1e-5


def _reset():
    for mod in (jsym, tsym):
        mod._Counter._counts.clear()
    for mod in (jblock, tblock):
        mod._NameManager._counts.clear()


def _x(layout, n=2, seed=0):
    shape = (n, 32, 32, 3) if layout == "NHWC" else (n, 3, 32, 32)
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _nets(layout):
    """(port net, mxtpu net, seeded arrays), each run once on the same
    b2 input (export traces at the last call's signature)."""
    _reset()
    with mt.layout(layout):
        tnet = tvision.resnet18_v1(classes=10)
    tnet.initialize(ctx=mt.cpu())
    with torch.no_grad():
        tnet(torch.zeros((1,) + _x(layout).shape[1:]))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in tnet.collect_params().items()}, seed=5)
    convert.load_mxtpu_params(tnet, arrays)
    with mx.layout(layout):
        jnet = jvision.resnet18_v1(classes=10)
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))
    x = _x(layout)
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x)).numpy()
    jout = jnet(mx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)
    return tnet, jnet, x, tout, jout


@pytest.fixture(scope="module")
def nhwc(tmp_path_factory):
    root = tmp_path_factory.mktemp("nhwc")
    tnet, jnet, x, tout, jout = _nets("NHWC")
    for mod in (jsym, tsym):
        mod._Counter._counts.clear()
    tnet.export(str(root / "t"))
    jnet.export(str(root / "j"))
    return dict(root=root, tnet=tnet, x=x, tout=tout, jout=jout)


def _bn_attrs_apart(text):
    import json
    doc = json.loads(text)
    bn = [n.pop("attrs") for n in doc["nodes"] if n["op"] == "BatchNorm"]
    return doc, bn


def test_export_writes_the_reference_text_and_bytes(nhwc):
    root = nhwc["root"]
    tdoc, tbn = _bn_attrs_apart((root / "t-symbol.json").read_text())
    jdoc, jbn = _bn_attrs_apart((root / "j-symbol.json").read_text())
    assert tdoc == jdoc
    assert len(tbn) == 20 and jbn == [{}] * 20
    assert tbn[0] == {"output_mean_var": "False", "axis": "-1",
                      "eps": "1e-05", "momentum": "0.9",
                      "fix_gamma": "False", "use_global_stats": "False"}
    assert (root / "t-0000.params").read_bytes() == \
        (root / "j-0000.params").read_bytes()
    nodes = tdoc["nodes"]
    assert nodes[0]["name"] == "data" and nodes[0]["attrs"] == {
        "__shape__": "(2, 32, 32, 3)", "__dtype__": "'float32'"}
    assert [n["op"] for n in nodes].count("broadcast_add") == 8


def test_symbolblock_imports_both_ways(nhwc):
    root = str(nhwc["root"])
    tsb = mt.gluon.SymbolBlock.imports(root + "/t-symbol.json", "data",
                                       root + "/t-0000.params", ctx=mt.cpu())
    with torch.no_grad():
        got = tsb(torch.from_numpy(nhwc["x"])).numpy()
    np.testing.assert_allclose(got, nhwc["tout"], rtol=TOL, atol=TOL)
    jsb = mx.gluon.SymbolBlock.imports(root + "/t-symbol.json", "data",
                                       root + "/t-0000.params")
    np.testing.assert_allclose(jsb(mx.nd.array(nhwc["x"])).asnumpy(),
                               nhwc["jout"], rtol=TOL, atol=TOL)
    assert sorted(tsb.collect_params()) == sorted(
        nhwc["tnet"].collect_params())
    assert tsb.collect_params()[
        "resnetv10_batchnorm0_running_mean"].grad_req == "null"


def test_port_loads_reference_files_nchw(tmp_path):
    tnet, jnet, x, _, _ = _nets("NCHW")
    jsym._Counter._counts.clear()
    jnet.export(str(tmp_path / "j"))
    prefix = str(tmp_path / "j")
    jsb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                       prefix + "-0000.params")
    tsb = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                       prefix + "-0000.params", ctx=mt.cpu())
    ref = jsb(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tsb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_predictor_from_checkpoint_and_zoo_version(nhwc):
    # the builds counted at "serving.predict" are process-wide: earlier
    # Predictors of this process must not count toward this one's three
    mt.telemetry.reset()
    prefix = str(nhwc["root"] / "t")
    spec = BucketSpec([1, 2, 4])
    pred = Predictor.from_checkpoint(prefix, 0, spec, device="cpu",
                                     example=torch.zeros(1, 32, 32, 3),
                                     warmup=True)
    got = pred.predict(nhwc["x"]).asnumpy()
    np.testing.assert_allclose(got, nhwc["tout"], rtol=TOL, atol=TOL)
    three = np.concatenate([nhwc["x"], nhwc["x"][:1]])
    np.testing.assert_allclose(pred.predict(three).asnumpy()[:2], got,
                               rtol=TOL, atol=TOL)
    assert pred.compile_stats()["compiles"] == 3
    # bf16: BatchNorm's parameters stay float32, as the Gluon layer's
    p16 = Predictor.from_checkpoint(prefix, 0, spec, device="cpu",
                                    dtype="bfloat16")
    dts = {k: p._tensor().dtype
           for k, p in p16._block.collect_params().items()}
    assert dts["resnetv10_conv2d0_weight"] == torch.bfloat16
    assert dts["resnetv10_batchnorm0_gamma"] == torch.float32
    assert dts["resnetv10_batchnorm0_running_var"] == torch.float32
    x16 = torch.from_numpy(nhwc["x"]).to(torch.bfloat16)
    out16 = p16.predict(x16).to_torch().float().numpy()
    assert np.abs(out16 - got).max() <= 5e-2 * np.abs(got).max()
    # a zoo version that names the checkpoint: loaded on first apply
    sb = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                      ctx=mt.cpu())
    zoo = ModelZoo()
    zoo.register("r18", sb, spec, example=torch.zeros(1, 32, 32, 3),
                 checkpoint=(prefix, 0))
    ver = zoo.apply_version("r18", "v1")
    assert sorted(ver.params) == sorted(sb.collect_params())
    zp = Predictor(sb, spec, device="cpu")
    np.testing.assert_allclose(zp.predict(nhwc["x"]).asnumpy(), got,
                               rtol=TOL, atol=TOL)


def test_symbolblock_deferred_shapes_and_export_needs_a_call(tmp_path):
    data = mt.sym.var("data")
    out = mt.sym.FullyConnected(
        mt.sym.Activation(mt.sym.FullyConnected(data, num_hidden=6,
                                                name="a"),
                          act_type="relu"), num_hidden=3, name="b")
    sb = mt.gluon.SymbolBlock(out, data)
    sb.initialize(ctx=mt.cpu())
    x = torch.from_numpy(_x("NHWC")[:, :2, :2, 0].reshape(2, 2, 2))
    with torch.no_grad():
        y = sb(x)
    assert tuple(y.shape) == (2, 3)
    assert sb.collect_params()["a_weight"].shape == (6, 4)
    fresh = mt.gluon.nn.Dense(3, in_units=4)
    fresh.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="run at least once"):
        fresh.export(str(tmp_path / "f"))
