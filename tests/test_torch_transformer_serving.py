"""The transformer slice end to end: a small TransformerLM served through
the JAX package's sequence-bucketed Predictor and through the port's, with
the same weights (``convert.seeded_params``), in float32 and bfloat16.

Both predictors pad a request's batch and its sequence axis up to the
buckets of ``BucketSpec((1, 2, 4), seq_lens=(128, 256))`` with token 0,
chunk a batch past 4, slice the outputs back on the batch axis only (the
logits keep the sequence bucket's length) and refuse a sequence past
256. The model has no attention mask, so with ``causal=False`` real
tokens attend to the padding and a request's logits depend on its
bucket: that is the reference's behaviour, and the port keeps it. The JAX
side runs its flash attention through the Pallas interpreter
(MXTPU_FLASH_INTERPRET=1; both sequence buckets are multiples of 128);
the port runs on the CPU.

Tolerances, as in test_torch_transformer.py: float32 logits within 1e-4
max|logit|, bfloat16 within four bf16 spacings at max|logit| (4 * 2^-7).
"""
import importlib

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.gluon.model_zoo import transformer as jtr
from mxtpu.serving import BucketSpec as JBucketSpec
from mxtpu.serving import Predictor as JPredictor
from mxtpu.serving.engine import pad_nd as j_pad_nd
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.gluon.model_zoo import transformer as ttr
from mxtpu_torch.serving import BucketSpec, Predictor
from mxtpu_torch.serving.engine import pad_nd

jfa = importlib.import_module("mxtpu.ops.pallas.flash_attention")
SMALL = dict(vocab_size=97, dim=64, num_heads=2, num_layers=2, max_len=256,
             causal=False)
SPEC = dict(batch_sizes=(1, 2, 4), seq_lens=(128, 256))
TOL = {"float32": 1e-4, "bfloat16": 4 * 2.0 ** -7}


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_INTERPRET", "1")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request):
    """(dtype, mxtpu Predictor, port Predictor) over the same weights."""
    dtype = request.param
    jnet = jtr.TransformerLM(**SMALL)
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 8)), dtype="int32"))
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=7)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    net = ttr.TransformerLM(**SMALL)
    convert.load_mxtpu_params(net, arrays)
    jnet.cast(dtype)
    net.cast(dtype)
    jpred = JPredictor(jnet, JBucketSpec(**SPEC))
    with pytest.MonkeyPatch.context() as mp:   # bucket (1, 128) traces here
        mp.setenv("MXTPU_FLASH_INTERPRET", "1")
        jfa.reset_dispatch_stats()
        _jax_predict(jpred, np.zeros((1, 128), np.int32))
        assert jfa.DISPATCH_STATS["pallas"] == 2   # the kernel, per layer
    return dtype, jpred, Predictor(net, BucketSpec(**SPEC), device="cpu")


def _tokens(seed, b, t):
    return np.random.RandomState(seed).randint(0, 97, (b, t)).astype(np.int32)


def _jax_predict(jpred, x):
    return jpred.predict(mx.nd.array(x, dtype="int32")).astype(
        "float32").asnumpy()


def _check(dtype, got, ref, n, seq):
    assert isinstance(got, mt.nd.NDArray)
    assert tuple(got.shape) == (n, seq, 97) and ref.shape == got.shape
    assert got.to_torch().dtype == getattr(torch, dtype)
    assert got.context.type == "cpu"
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("n,t,seq", [(3, 50, 128), (1, 200, 256),
                                     (2, 128, 128), (4, 256, 256)])
def test_padded_requests_match_mxtpu_predictor(served, n, t, seq):
    dtype, jpred, pred = served
    x = _tokens(n * t, n, t)
    ref = _jax_predict(jpred, x)
    got = pred.predict(x)
    _check(dtype, got, ref, n, seq)


def test_chunked_request_matches_mxtpu_predictor(served):
    """6 requests through a largest bucket of 4: two dispatches at (4, 128)."""
    dtype, jpred, pred = served
    x = _tokens(11, 6, 100)
    ref = _jax_predict(jpred, x)
    calls = []
    real = pred._dispatch_one
    pred._dispatch_one = lambda datas, seq, bucket: calls.append(
        (bucket, seq)) or real(datas, seq, bucket)
    try:
        got = pred.predict(torch.from_numpy(x))
    finally:
        del pred._dispatch_one
    assert calls == [(4, 128), (4, 128)]
    _check(dtype, got, ref, 6, 128)


def test_sequence_past_the_largest_bucket_raises_in_both(served):
    _, jpred, pred = served
    x = _tokens(3, 2, 300)
    with pytest.raises(mx.base.MXNetError, match="exceeds the largest"):
        _jax_predict(jpred, x)
    with pytest.raises(mt.MXNetError, match="exceeds the largest"):
        pred.predict(x)


def test_logits_depend_on_the_bucket_as_in_mxtpu(served):
    """No attention mask: the same 50 tokens padded to 128 or served at
    bucket 256 alongside a longer row give other logits, in both."""
    dtype, jpred, pred = served
    x = _tokens(13, 1, 50)
    long = np.zeros((2, 200), np.int32)
    long[0, :50] = x[0]
    long[1] = _tokens(14, 1, 200)[0]
    short_port = pred.predict(x).asnumpy()[0, :50]
    long_port = pred.predict(long).asnumpy()[0, :50]
    short_ref = _jax_predict(jpred, x)[0, :50]
    long_ref = _jax_predict(jpred, long)[0, :50]
    assert np.abs(short_ref - long_ref).max() > 0.1
    tol = TOL[dtype] * np.abs(short_ref).max()
    np.testing.assert_allclose(short_port, short_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(long_port, long_ref, rtol=0, atol=tol)


def test_bucket_spec_with_seq_lens_matches_mxtpu():
    mine, ref = BucketSpec(**SPEC), JBucketSpec(**SPEC)
    assert mine.buckets() == ref.buckets() and len(mine) == len(ref) == 6
    assert repr(mine) == repr(ref)
    for s in (1, 128, 129, 256):
        assert mine.seq_bucket(s) == ref.seq_bucket(s)
    with pytest.raises(mt.MXNetError, match="cannot be chunked"):
        mine.seq_bucket(257)
    p2, jp2 = BucketSpec.pow2(8, seq_lens=(512, 128)), JBucketSpec.pow2(
        8, seq_lens=(512, 128))
    assert p2.buckets() == jp2.buckets() and p2.seq_lens == (128, 512)
    assert BucketSpec([3]).buckets() == JBucketSpec([3]).buckets()
    assert BucketSpec([3]).seq_bucket(7) is None


@pytest.mark.parametrize("shape,batch,seq,axis", [
    ((3, 50), 4, 128, 1), ((2, 5, 7), 2, 9, 2), ((1, 6), 1, None, 1),
    ((2,), 4, 16, 1)])
def test_pad_nd_matches_mxtpu(shape, batch, seq, axis):
    x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape) + 1
    ref = j_pad_nd(x, batch, seq_len=seq, seq_axis=axis,
                   pad_value=-3).asnumpy()
    got = pad_nd(torch.from_numpy(x), batch, seq_len=seq, seq_axis=axis,
                 pad_value=-3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(mt.MXNetError, match="exceeds bucket"):
        pad_nd(torch.from_numpy(x), shape[0] - 1)


def test_warmup_runs_every_batch_and_seq_bucket():
    net = ttr.TransformerLM(**SMALL)
    net.initialize(ctx=mt.cpu())
    pred = Predictor(net, BucketSpec(**SPEC), device="cpu",
                     example=np.zeros((1, 40), np.int32),
                     site="test.warmup_buckets")
    assert pred.input_templates == [((40,), torch.int32)]
    seen = []
    real = pred.run_bucket
    pred.run_bucket = lambda b, s=None: seen.append(
        [(tuple(t.shape), t.dtype) for t in
         pred._buckets[pred._bucket_key(b, s)].static_inputs]) or real(b, s)
    pred.warmup()
    assert seen == [[((b, s), torch.int32)] for b in (1, 2, 4)
                    for s in (128, 256)]
    assert pred.compile_stats()["compiles"] == 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_160_serves_like_mxtpu(dtype):
    """dim / heads = 160, past the 128 the port's kernel once took: the JAX
    package pads D to 256 for its kernel, the port runs D = 160."""
    cfg = dict(vocab_size=97, dim=320, num_heads=2, num_layers=1,
               max_len=128, causal=False)
    spec = dict(batch_sizes=(1, 2), seq_lens=(128,))
    jnet = jtr.TransformerLM(**cfg)
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, 8)), dtype="int32"))
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=9)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    net = ttr.TransformerLM(**cfg)
    convert.load_mxtpu_params(net, arrays)
    jnet.cast(dtype)
    net.cast(dtype)
    x = _tokens(5, 2, 90)
    jfa.reset_dispatch_stats()
    ref = _jax_predict(JPredictor(jnet, JBucketSpec(**spec)), x)
    assert jfa.DISPATCH_STATS["pallas"] == 1
    got = Predictor(net, BucketSpec(**spec), device="cpu").predict(x)
    _check(dtype, got, ref, 2, 128)
