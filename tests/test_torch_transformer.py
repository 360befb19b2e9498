"""The port's transformer path against the JAX package's: the LayerNorm,
Embedding, reshape/transpose/arange ops and layers, ``Dense`` with an
activation, and a small ``TransformerLM`` (mxtpu_torch/gluon/model_zoo/
transformer.py against mxtpu/gluon/model_zoo/transformer.py).

Same seeded numpy inputs through both. The JAX model runs its flash
attention through the Pallas interpreter (MXTPU_FLASH_INTERPRET=1, T=128);
the port runs on the CPU, where its flash wrapper takes the plain version.
Weights come from ``convert.seeded_params`` and are loaded into both nets.

Tolerances: float32 ops rtol=atol=1e-5; bfloat16 ops one bf16 spacing of
the output's largest magnitude (both sides compute in float32 and round
once per op); lookups and shape ops exactly. The model: float32 logits
within 1e-4 max|logit| (two layers of float32 matmuls, softmax and
LayerNorm summed in other orders); bfloat16 logits within four bf16
spacings at max|logit|, 4 * 2^-7 max|logit| (every op rounds to bf16, the
two frameworks round at other places, and the Pallas kernel rounds p to
bf16 where the plain version does not: measured 1.1-1.3e-2 max|logit|,
0.3-0.7e-2 when the JAX side takes its XLA attention instead).
"""
import importlib

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.gluon.model_zoo import transformer as jtr
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.gluon.model_zoo import transformer as ttr
from mxtpu_torch.ops import init_ops as tinit
from mxtpu_torch.ops import matrix as tmat
from mxtpu_torch.ops import nn as tnn
# the module (``parallel.ring_attention`` is the function, as the
# reference's package exports it)
tring = importlib.import_module("mxtpu_torch.parallel.ring_attention")

jfa = importlib.import_module("mxtpu.ops.pallas.flash_attention")
SMALL = dict(vocab_size=97, dim=64, num_heads=2, num_layers=2, max_len=256)


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")
    jfa.reset_dispatch_stats()


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulp(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_layernorm_op_matches_mxtpu(axis, dtype):
    r = np.random.RandomState(0)
    x = (r.randn(2, 6, 5) * 3 + 1).astype(np.float32)
    n = x.shape[axis]
    g, b = r.rand(n) + 0.5, r.randn(n) * 0.1
    ref = mx.nd.LayerNorm(*(mx.nd.array(a).astype(dtype) for a in (x, g, b)),
                          axis=axis, eps=1e-5)
    got = tnn.LayerNorm(*(_t(a, getattr(torch, dtype)) for a in (x, g, b)),
                        axis=axis, eps=1e-5)
    assert str(got.dtype).endswith(dtype) and ref.dtype == dtype
    _close(_np(got), ref.astype("float32").asnumpy(), dtype)


def test_layernorm_layer_matches_mxtpu_and_casts():
    x = np.random.RandomState(1).randn(2, 3, 8).astype(np.float32)
    ln, mln = mt.gluon.nn.LayerNorm(), mx.gluon.nn.LayerNorm()
    ln.initialize(ctx=mt.cpu())
    mln.initialize()
    _close(_np(ln(_t(x))), mln(mx.nd.array(x)).asnumpy(), "float32")
    ln.cast("bfloat16")
    mln.cast("bfloat16")
    assert all(p.data().to_torch().dtype == torch.bfloat16
               for p in ln.collect_params().values())
    ref = mln(mx.nd.array(x).astype("bfloat16")).astype("float32").asnumpy()
    _close(_np(ln(_t(x, torch.bfloat16))), ref, "bfloat16")


def test_embedding_clips_ids_like_mxtpu():
    r = np.random.RandomState(2)
    w = r.randn(11, 4).astype(np.float32)
    ids = np.array([[0, 3, 10, 11, 50], [-1, -7, 5, 2, 9]], np.int32)
    ref = mx.nd.Embedding(mx.nd.array(ids, dtype="int32"), mx.nd.array(w),
                          input_dim=11, output_dim=4).asnumpy()
    got = tmat.Embedding(torch.from_numpy(ids), _t(w), input_dim=11,
                         output_dim=4)
    np.testing.assert_array_equal(_np(got), ref)
    np.testing.assert_array_equal(ref[0, 3], w[10])   # clipped high
    np.testing.assert_array_equal(ref[1, 0], w[0])    # clipped low
    # float ids truncate to int32 first, as the JAX package's astype does
    fids = np.array([[1.7, 9.2]], np.float32)
    np.testing.assert_array_equal(
        _np(tmat.Embedding(_t(fids), _t(w))),
        mx.nd.Embedding(mx.nd.array(fids), mx.nd.array(w), input_dim=11,
                        output_dim=4).asnumpy())


def test_embedding_layer_matches_mxtpu_and_casts_its_weight():
    w = np.random.RandomState(3).randn(13, 6).astype(np.float32)
    ids = np.array([[1, 12, 0], [4, 4, 7]], np.int32)
    emb, memb = mt.gluon.nn.Embedding(13, 6), mx.gluon.nn.Embedding(13, 6)
    memb.initialize()
    memb.weight.set_data(mx.nd.array(w))
    emb.weight.set_data(w)
    assert emb.weight.shape == memb.weight.shape == (13, 6)
    ref = memb(mx.nd.array(ids, dtype="int32")).asnumpy()
    np.testing.assert_array_equal(_np(emb(torch.from_numpy(ids))), ref)
    emb.cast("bfloat16")
    tokens = torch.from_numpy(ids)
    out = emb(tokens)
    assert emb.weight.data().to_torch().dtype == torch.bfloat16
    assert out.dtype == torch.bfloat16 and tokens.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_relu_no_flatten_matches_mxtpu(dtype):
    r = np.random.RandomState(4)
    x = r.randn(2, 5, 16).astype(np.float32)
    w, b = r.randn(24, 16).astype(np.float32), r.randn(24).astype(np.float32)
    net = mt.gluon.nn.Dense(24, flatten=False, activation="relu")
    mnet = mx.gluon.nn.Dense(24, flatten=False, activation="relu")
    mnet.initialize()
    mnet(mx.nd.zeros((1, 1, 16)))
    mnet.weight.set_data(mx.nd.array(w))
    mnet.bias.set_data(mx.nd.array(b))
    net.weight.set_data(w)
    net.bias.set_data(b)
    net.cast(dtype)
    mnet.cast(dtype)
    ref = mnet(mx.nd.array(x).astype(dtype)).astype("float32").asnumpy()
    got = net(_t(x, getattr(torch, dtype)))
    assert got.shape == (2, 5, 24) and (ref >= 0).all() and (ref == 0).any()
    _close(_np(got), ref, dtype)
    assert isinstance(net.act, mt.gluon.nn.Activation)


def test_shape_ops_and_arange_match_mxtpu():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for shape in [(0, -1), (-3, -2), (0, 0, -4, 2, -1, 0), (6, 20),
                  (-1, 5)]:
        ref = mx.nd.reshape(mx.nd.array(x), shape=shape).asnumpy()
        np.testing.assert_array_equal(_np(tmat.reshape(_t(x), shape)), ref)
    for axes in [(2, 0, 3, 1), None]:
        ref = mx.nd.transpose(mx.nd.array(x), axes=axes).asnumpy()
        np.testing.assert_array_equal(_np(tmat.transpose(_t(x), axes)), ref)
    got = tinit.arange(0, 7, dtype="int32", ctx=mt.cpu())
    ref = mx.nd.arange(0, 7, dtype="int32").asnumpy()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tinit.arange(2, 11, 3, ctx=mt.cpu()),
                                  mx.nd.arange(2, 11, 3).asnumpy())


def _jax_net(causal):
    jnet = jtr.TransformerLM(causal=causal, **SMALL)
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 8)), dtype="int32"))
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=5)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    return jnet, arrays


def _port_net(arrays, causal):
    net = ttr.TransformerLM(causal=causal, **SMALL)
    convert.load_mxtpu_params(net, arrays)
    return net


def _tokens(seed, b, t):
    return np.random.RandomState(seed).randint(0, 97, (b, t)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_transformer_lm_matches_mxtpu(causal, dtype):
    jnet, arrays = _jax_net(causal)
    net = _port_net(arrays, causal)
    if dtype == "bfloat16":
        jnet.cast("bfloat16")
        net.cast("bfloat16")
    tokens = _tokens(6, 2, 128)
    ref = jnet(mx.nd.array(tokens, dtype="int32"))
    assert jfa.DISPATCH_STATS["pallas"] == 2   # one kernel per layer
    assert ref.dtype == dtype
    ref = ref.astype("float32").asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(tokens))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 128, 97)
    assert np.abs(ref).max() > 1.0                  # real signal
    tol = 1e-4 if dtype == "float32" else 4 * 2.0 ** -7
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_transformer_names_and_shapes_equal_mxtpu():
    jnet, arrays = _jax_net(False)
    net = _port_net(arrays, False)
    mine = [(k.partition("_")[2], tuple(p.shape))
            for k, p in net.collect_params().items()]
    ref = [(k.partition("_")[2], tuple(p.shape))
           for k, p in jnet.collect_params().items()]
    assert mine == ref and len(mine) == 25
    back = convert.params_to_numpy(net)
    for k, v in back.items():
        np.testing.assert_array_equal(
            v, arrays[next(a for a in arrays
                           if a.partition("_")[2] == k.partition("_")[2])])


class _Mesh:
    """A mesh as the JAX package passes it: ``.shape`` maps axis names to
    sizes."""

    def __init__(self, **axes):
        self.shape = axes


def test_transformer_refuses_what_is_not_ported():
    # the MoE blocks are the reference's (held to mxtpu in
    # tests/test_torch_moe.py)
    moe = ttr.TransformerLM(num_experts=4, **SMALL)
    ref = jtr.TransformerLM(num_experts=4, **SMALL)
    assert [type(b.moe).__name__ for b in moe.blocks] == \
        [type(b.moe).__name__ for b in ref.blocks] == ["SwitchMoE"] * 2
    q = torch.randn(1, 2, 8, 16)
    # a split sequence runs the ring over the mesh's ranks (held to mxtpu
    # in tests/test_torch_parallel.py); its collectives never go inside a
    # captured graph
    from mxtpu_torch import graphs
    graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
    try:
        with pytest.raises(mt.MXNetError, match="captured graph"):
            tring.ring_self_attention(q, q, q, mesh=_Mesh(data=2, sp=2))
        attn = ttr.MultiHeadSelfAttention(64, 2, mesh=_Mesh(sp=4))
        attn.initialize(ctx=mt.cpu())
        with pytest.raises(mt.MXNetError, match="captured graph"):
            attn(torch.randn(1, 8, 64))
    finally:
        graphs._STATE.depth -= 1
    # a mesh without a sequence axis, or with one of size 1, is one device
    for mesh in (None, _Mesh(data=2), _Mesh(sp=1)):
        torch.testing.assert_close(
            tring.ring_self_attention(q, q, q, mesh=mesh, causal=True),
            tring._dense_attention(q, q, q, causal=True), rtol=0, atol=0)
    net = ttr.TransformerLM(**SMALL)
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="exceeds max_len 256"):
        net(torch.zeros(1, 257, dtype=torch.int32))
