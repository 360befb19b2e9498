"""NDArray and parameter files between the port and the JAX package, on
the CPU: each file written by one package loads in the other to the same
arrays, and the same arrays give the same bytes. ``mx.nd.save``/``load``
with a dict and a list; float32, float16, int32, int8, uint8 in the
reference format (0x112), int64 records, bfloat16 in the native format
(``MXTPU001``); ``Block.save_parameters``/``load_parameters`` (with
``allow_missing``/``ignore_extra``) on a narrow ResNet v1 and a narrow
TransformerLM; ``ParameterDict.save(strip_prefix=)``/``load``; hand-written
V2, V1 and legacy records (copied from tests/test_mxnet_format.py, which
builds them byte by byte from the C++ serializer's layout); a truncated
file raises in both. A sparse record raises in the port, naming ROADMAP
A10 (sparse arrays are not ported): a deliberate difference.
"""
import struct

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon.model_zoo import transformer as jtr
from mxtpu.gluon.model_zoo.vision import resnet as jres
from mxtpu_torch import convert
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.model_zoo import transformer as ttr
from mxtpu_torch.gluon.model_zoo.vision import resnet as tres
from mxtpu_torch.ndarray import mxnet_format as tfmt

V2 = 0xF993FAC9
V1 = 0xF993FAC8


def _tshape(*dims):
    return struct.pack("<I", len(dims)) + np.asarray(dims, "<i8").tobytes()


def _dense_v2(a, dev_type=1):
    flag = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
            np.dtype(np.uint8): 3, np.dtype(np.int32): 4,
            np.dtype(np.int64): 6}[a.dtype]
    return (struct.pack("<I", V2) + struct.pack("<i", 0)
            + _tshape(*a.shape) + struct.pack("<ii", dev_type, 0)
            + struct.pack("<i", flag) + a.tobytes())


def _file(records, names):
    blob = struct.pack("<QQ", 0x112, 0)
    blob += struct.pack("<Q", len(records)) + b"".join(records)
    blob += struct.pack("<Q", len(names))
    for n in names:
        blob += struct.pack("<Q", len(n)) + n.encode()
    return blob


def _t(a, dtype=None):
    return mt.nd.array(a, ctx=mt.cpu(), dtype=dtype)


def _load_mt(path):
    with mt.cpu():
        return mt.nd.load(str(path))


def _np(a):
    return a.astype("float32").asnumpy() if str(a.dtype) == "bfloat16" \
        else a.asnumpy()


def _same(got, ref):
    """Two loads (a dict or a list of NDArrays) hold the same arrays."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref)
        pairs = [(got[k], ref[k]) for k in ref]
    else:
        assert isinstance(got, list) and len(got) == len(ref)
        pairs = list(zip(got, ref))
    for g, r in pairs:
        assert str(g.dtype) == str(r.dtype) and g.shape == r.shape
        np.testing.assert_array_equal(_np(g), _np(r))


# ---------------------------------------------------------- nd.save / load
@pytest.mark.parametrize("container", ["dict", "list"])
def test_nd_save_load_both_ways(tmp_path, container):
    r = np.random.RandomState(0)
    arrays = [r.randn(3, 4).astype(np.float32),
              (r.randn(5) * 9).astype(np.int32),
              r.randn(2, 2, 2).astype(np.float32)]
    names = ["arg:w", "aux:s", "b"]

    def pack(mk):
        items = [mk(a) for a in arrays]
        return dict(zip(names, items)) if container == "dict" else items
    mx.nd.save(str(tmp_path / "ref"), pack(lambda a: mx.nd.array(
        a, dtype=a.dtype)))
    mt.nd.save(str(tmp_path / "port"), pack(lambda a: _t(a, a.dtype)))
    assert (tmp_path / "ref").read_bytes() == (tmp_path / "port").read_bytes()
    _same(_load_mt(tmp_path / "ref"), mx.nd.load(str(tmp_path / "ref")))
    _same(_load_mt(tmp_path / "port"), mx.nd.load(str(tmp_path / "port")))


DTYPES = ["float32", "float16", "int32", "int8", "uint8"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_dtypes_interchange(tmp_path, dtype):
    a = (np.random.RandomState(1).randn(4, 3) * 50).astype(dtype)
    mx.nd.save(str(tmp_path / "ref"), [mx.nd.array(a, dtype=dtype)])
    mt.nd.save(str(tmp_path / "port"), [_t(a, dtype)])
    raw = (tmp_path / "port").read_bytes()
    assert struct.unpack("<Q", raw[:8])[0] == 0x112
    assert raw == (tmp_path / "ref").read_bytes()
    got = _load_mt(tmp_path / "ref")[0]
    back = mx.nd.load(str(tmp_path / "port"))[0]
    assert str(got.dtype) == str(back.dtype) == dtype
    np.testing.assert_array_equal(got.asnumpy(), a)
    np.testing.assert_array_equal(back.asnumpy(), a)


def test_int64_records_load_alike(tmp_path):
    """An int64 record (the reference writes int64 indices) loads as
    int32 in both packages (x64 off), with its values."""
    b = np.array([7, -8, 9], np.int64)
    blob = tfmt.dumps([("default", b)], ["i"])
    from mxtpu.ndarray import mxnet_format as jfmt
    assert blob == jfmt.dumps([("default", b)], ["i"])
    (tmp_path / "i64").write_bytes(blob)
    got, ref = _load_mt(tmp_path / "i64")["i"], mx.nd.load(
        str(tmp_path / "i64"))["i"]
    assert str(got.dtype) == str(ref.dtype) == "int32"
    np.testing.assert_array_equal(got.asnumpy(), b)


def test_bfloat16_goes_native_both_ways(tmp_path):
    a = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    mx.nd.save(str(tmp_path / "ref"),
               {"w": mx.nd.array(a).astype("bfloat16")})
    mt.nd.save(str(tmp_path / "port"), {"w": _t(a).astype("bfloat16")})
    raw = (tmp_path / "port").read_bytes()
    assert raw[:8] == b"MXTPU001" and raw == (tmp_path / "ref").read_bytes()
    got = _load_mt(tmp_path / "ref")["w"]
    back = mx.nd.load(str(tmp_path / "port"))["w"]
    assert got.to_torch().dtype == torch.bfloat16
    assert str(back.dtype) == "bfloat16"
    np.testing.assert_array_equal(_np(got), _np(back))
    # rank 0 goes native too
    mt.nd.save(str(tmp_path / "s"), {"s": _t(np.float32(3.0))})
    assert (tmp_path / "s").read_bytes()[:8] == b"MXTPU001"
    assert mx.nd.load(str(tmp_path / "s"))["s"].shape == ()


def test_load_lands_on_the_current_context(tmp_path):
    mt.nd.save(str(tmp_path / "f"), [_t(np.ones(2, np.float32))])
    with mt.cpu():
        assert mt.nd.load(str(tmp_path / "f"))[0].context.type == "cpu"
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.load(str(tmp_path / "f"))   # cuda:0 outside a scope


# -------------------------------------------------- hand-written records
def test_handwritten_v2_v1_and_legacy_records_load_like_mxtpu(tmp_path):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.array([7, 8, 9], dtype=np.int64)
    sq = np.arange(4, dtype=np.float32).reshape(2, 2)
    v1 = (struct.pack("<I", V1) + _tshape(2, 2)
          + struct.pack("<ii", 1, 0) + struct.pack("<i", 0) + sq.tobytes())
    pre = (struct.pack("<I", 2) + np.asarray([2, 2], "<u4").tobytes()
           + struct.pack("<ii", 1, 0) + struct.pack("<i", 0) + sq.tobytes())
    files = {
        "dict": _file([_dense_v2(a, dev_type=2), _dense_v2(b)],
                      ["arg:w", "aux:s"]),
        "list": _file([_dense_v2(np.random.RandomState(0).rand(4).astype(
            np.float32))], []),
        "legacy": _file([v1, pre], ["v1", "pre"]),
    }
    for name, blob in files.items():
        (tmp_path / name).write_bytes(blob)
        _same(_load_mt(tmp_path / name), mx.nd.load(str(tmp_path / name)))
    out = _load_mt(tmp_path / "legacy")
    np.testing.assert_array_equal(out["pre"].asnumpy(), sq)


def test_truncated_file_raises_in_both(tmp_path):
    blob = _file([_dense_v2(np.zeros((2, 2), np.float32))], ["w"])
    (tmp_path / "t").write_bytes(blob[:len(blob) // 2])
    for load in (mx.nd.load, _load_mt):
        with pytest.raises(Exception, match="truncated"):
            load(str(tmp_path / "t"))
    mt.nd.save(str(tmp_path / "n"), [_t(np.ones(64, np.float32))
                                     .astype("bfloat16")])
    raw = (tmp_path / "n").read_bytes()
    (tmp_path / "n").write_bytes(raw[:-8])
    with pytest.raises(MXNetError, match="truncated"):
        _load_mt(tmp_path / "n")


@pytest.mark.parametrize("fmt", ["mxnet", "mxtpu"])
def test_sparse_records_round_trip_like_mxtpu(tmp_path, fmt):
    """A csr and a row_sparse array: the port's file is byte for byte the
    JAX package's, and each package loads the other's file to the same
    parts; a handwritten csr record loads alike."""
    rng = np.random.RandomState(5)
    dense = rng.standard_normal((6, 4)).astype(np.float32)
    dense[[0, 2, 5]] = 0
    dense[dense < -0.5] = 0
    j = {"rs": mx.nd.array(dense).tostype("row_sparse"),
         "csr": mx.nd.array(dense).tostype("csr")}
    with mt.cpu():
        t = {"rs": mt.nd.array(dense).tostype("row_sparse"),
             "csr": mt.nd.array(dense).tostype("csr")}
    mx.nd.save(str(tmp_path / "j"), j, format=fmt)
    mt.nd.save(str(tmp_path / "t"), t, format=fmt)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    for got, ref in ((_load_mt(tmp_path / "j"), mx.nd.load(
            str(tmp_path / "t"))), (_load_mt(tmp_path / "t"), j)):
        for k in ("rs", "csr"):
            assert got[k].stype == ref[k].stype and got[k].shape == \
                ref[k].shape
            np.testing.assert_array_equal(got[k].asnumpy(), dense)
            np.testing.assert_array_equal(got[k].indices.asnumpy(),
                                          np.asarray(ref[k].indices.asnumpy()))
            np.testing.assert_array_equal(got[k].data.asnumpy(),
                                          np.asarray(ref[k].data.asnumpy()))
        np.testing.assert_array_equal(got["csr"].indptr.asnumpy(),
                                      np.asarray(ref["csr"].indptr.asnumpy()))
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    indptr = np.array([0, 2, 3], np.int64)
    idx = np.array([0, 3, 1], np.int64)
    rec = (struct.pack("<I", V2) + struct.pack("<i", 2) + _tshape(3)
           + _tshape(2, 4) + struct.pack("<ii", 1, 0) + struct.pack("<i", 0)
           + struct.pack("<i", 6) + _tshape(3) + struct.pack("<i", 6)
           + _tshape(3) + vals.tobytes() + indptr.tobytes() + idx.tobytes())
    (tmp_path / "csr").write_bytes(_file([rec], ["w"]))
    ref, got = mx.nd.load(str(tmp_path / "csr"))["w"], \
        _load_mt(tmp_path / "csr")["w"]
    assert got.stype == ref.stype == "csr"
    np.testing.assert_array_equal(got.asnumpy(), np.asarray(ref.asnumpy()))


# ------------------------------------------------------ gluon parameters
CHANNELS = [8, 16, 32, 48, 64]
LM = dict(vocab_size=97, dim=64, num_heads=2, num_layers=2, max_len=64,
          causal=False)


def _resnets():
    with mt.layout("NHWC"):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                            classes=10, thumbnail=True)
    with mx.layout("NHWC"):
        jnet = jres.ResNetV1(jres.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                             classes=10, thumbnail=True)
    net.initialize(ctx=mt.cpu())
    jnet.initialize()
    zeros = np.zeros((1, 32, 32, 3), np.float32)
    with torch.no_grad():
        net(torch.from_numpy(zeros))
    jnet(mx.nd.array(zeros))
    return net, jnet


def _lms():
    net, jnet = ttr.TransformerLM(**LM), jtr.TransformerLM(**LM)
    net.initialize(ctx=mt.cpu())
    jnet.initialize()
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    jnet(mx.nd.array(np.zeros((1, 8), np.int32), dtype="int32"))
    return net, jnet


def _by_path(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.mark.parametrize("model", ["resnet", "transformer"])
def test_save_parameters_interchange(tmp_path, model):
    """Each package's file loads into the other's net by attribute path
    (``features.0.weight``); the same weights give the same bytes."""
    net, jnet = _resnets() if model == "resnet" else _lms()
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=5)
    convert.load_mxtpu_params(net, arrays)
    ours, theirs = net._collect_params_with_prefix(), \
        jnet._collect_params_with_prefix()
    assert list(ours) == list(theirs)
    assert any(k.count(".") >= 2 for k in ours)
    net.save_parameters(str(tmp_path / "port.params"))
    jnet.load_parameters(str(tmp_path / "port.params"))
    jnet.save_parameters(str(tmp_path / "ref.params"))
    assert (tmp_path / "port.params").read_bytes() == \
        (tmp_path / "ref.params").read_bytes()
    want = _by_path(net)
    for k, v in _by_path(jnet).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    fresh, _ = _resnets() if model == "resnet" else _lms()
    fresh.load_params(str(tmp_path / "ref.params"))
    for k, v in _by_path(fresh).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_load_parameters_missing_and_extra_like_mxtpu(tmp_path):
    """allow_missing / ignore_extra: both packages refuse a file that
    lacks a parameter or holds one the block lacks, unless told."""
    for pkg in (mt, mx):
        big = pkg.gluon.nn.HybridSequential()
        with big.name_scope():
            big.add(pkg.gluon.nn.Dense(4, in_units=3),
                    pkg.gluon.nn.Dense(2, in_units=4))
        small = pkg.gluon.nn.HybridSequential()
        with small.name_scope():
            small.add(pkg.gluon.nn.Dense(4, in_units=3))
        for b in (big, small):
            if pkg is mt:
                b.initialize(ctx=mt.cpu())
            else:
                b.initialize()
        big.save_parameters(str(tmp_path / "big"))
        small.save_parameters(str(tmp_path / "small"))
        big_w = _by_path(big)["0.weight"]
        small_w = _by_path(small)["0.weight"]
        err = MXNetError if pkg is mt else mx.MXNetError
        with pytest.raises(err):
            small.load_parameters(str(tmp_path / "big"))
        with pytest.raises(err):
            big.load_parameters(str(tmp_path / "small"))
        small.load_parameters(str(tmp_path / "big"), ignore_extra=True)
        big.load_parameters(str(tmp_path / "small"), allow_missing=True)
        np.testing.assert_array_equal(_by_path(small)["0.weight"], big_w)
        np.testing.assert_array_equal(_by_path(big)["0.weight"], small_w)


def test_parameter_dict_save_strip_prefix_interchange(tmp_path):
    r = np.random.RandomState(6)
    w, b = r.randn(4, 3).astype(np.float32), r.randn(4).astype(np.float32)
    for pkg, path in ((mt, "port"), (mx, "ref")):
        d = pkg.gluon.nn.Dense(4, in_units=3, prefix="fc_")
        if pkg is mt:
            d.initialize(ctx=mt.cpu())
        else:
            d.initialize()
        d.weight.set_data(w)
        d.bias.set_data(b)
        d.collect_params().save(str(tmp_path / path), strip_prefix="fc_")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    assert set(mx.nd.load(str(tmp_path / "port"))) == {"weight", "bias"}
    for pkg, path in ((mt, "ref"), (mx, "port")):
        d = pkg.gluon.nn.Dense(4, in_units=3, prefix="dense_")
        if pkg is mt:
            d.initialize(ctx=mt.cpu())
        else:
            d.initialize()
        d.collect_params().load(str(tmp_path / path),
                                restore_prefix="dense_")
        np.testing.assert_array_equal(d.weight.data().asnumpy(), w)
        np.testing.assert_array_equal(d.bias.data().asnumpy(), b)
