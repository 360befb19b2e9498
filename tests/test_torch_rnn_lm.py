"""The PTB language model of ``bench.py:bench_lstm_ptb`` (Embedding, a
2-layer LSTM over NTC, a Dense decoder over the vocabulary), narrow, in
the port against the JAX package on the CPU, seeded weights loaded by
name into both:

* served through ``Predictor(device="cpu")`` with int32 token buckets
  against the JAX package's hybridized net (float32 within 1e-5 of
  max|logit|);
* trained 3 SGD steps (lr 1.0) through ``gluon.Trainer`` with
  ``SoftmaxCrossEntropyLoss`` over ``(-1, vocab)``, as bench.py's step
  computes it: per-token losses rtol=atol=1e-4, weights after the third
  step within 1e-4 of max(1, max|ref|);
* the same 3 steps hybridized, through the stand-in graph of
  tests/test_torch_train_graph.py (one captured pair, no build after the
  first step), against the JAX package hybridized.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon import block as jblock
from mxtpu_torch import convert, graphs
from mxtpu_torch import optimizer_fused as tof
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.gluon import block as tblock
from mxtpu_torch.serving import BucketSpec, Predictor

VOCAB, HID, LAYERS, B, T = 50, 16, 2, 4, 7
STEPS, TOL = 3, 1e-4


def lm(pkg):
    """bench.py's RNNModel in ``pkg``'s Gluon, narrow."""
    gluon = pkg.gluon

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embed = gluon.nn.Embedding(VOCAB, HID)
                self.lstm = gluon.rnn.LSTM(HID, num_layers=LAYERS,
                                           layout="NTC")
                self.decoder = gluon.nn.Dense(VOCAB, flatten=False)

        def hybrid_forward(self, F, tokens):
            return self.decoder(self.lstm(self.embed(tokens)))
    return RNNModel()


def _pair(seed=3):
    """(port net, JAX net, arrays): the same seeded weights by name."""
    for mod in (jblock, tblock):
        mod._NameManager._counts.clear()
    net = lm(mt)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, T, dtype=torch.int32))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=seed)
    convert.load_mxtpu_params(net, arrays)
    for mod in (jblock,):
        mod._NameManager._counts.clear()
    jnet = lm(mx)
    jnet.initialize()
    jnet(mx.nd.array(np.zeros((1, T)), dtype="int32"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))
    jnet.hybridize()
    return net, jnet, arrays


def _tokens(seed, b=B):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, T)).astype(
        np.int32)


def test_served_logits_match_mxtpu():
    ttel.reset()   # the site's count starts here, whatever ran before
    net, jnet, _ = _pair()
    pred = Predictor(net, BucketSpec(batch_sizes=(1, 4)), device="cpu",
                     example=np.zeros((1, T), np.int32), warmup=True)
    assert pred.compile_stats()["compiles"] == 2
    for b in (1, 3, 4):
        x = _tokens(b, b)
        got = pred.predict(x).asnumpy()
        ref = jnet(mx.nd.array(x, dtype="int32")).asnumpy()
        assert got.shape == (b, T, VOCAB)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert pred.compile_stats()["compiles"] == 2


def _train(pkg, net, batches):
    arr = (lambda a, **k: mt.nd.array(a, ctx=mt.cpu(), **k)) \
        if pkg is mt else mx.nd.array
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 1.0})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for tokens, labels in batches:
        with pkg.autograd.record():
            logits = net(arr(tokens, dtype="int32"))
            loss = loss_fn(logits.reshape((-1, VOCAB)),
                           arr(labels).reshape((-1,)))
        loss.backward()
        trainer.step(B * T)
        losses.append(loss.asnumpy())
    return losses


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, VOCAB, (B, T)).astype(np.int32),
             rng.randint(0, VOCAB, (B, T)).astype(np.float32))
            for _ in range(STEPS)]


def _compare(net, jnet, got, ref):
    for g, r in zip(got, ref):
        assert g.shape == (B * T,)
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)
    ours = {k.partition("_")[2]: p for k, p in net.collect_params().items()}
    theirs = {k.partition("_")[2]: p
              for k, p in jnet.collect_params().items()}
    assert ours.keys() == theirs.keys()
    for k in ours:
        r = theirs[k].data().asnumpy()
        np.testing.assert_allclose(ours[k].data().asnumpy(), r, rtol=0,
                                   atol=TOL * max(1.0, np.abs(r).max()),
                                   err_msg=k)


def test_trained_three_sgd_steps_match_mxtpu():
    net, jnet, _ = _pair(seed=5)
    batches = _batches(1)
    got = _train(mt, net, batches)
    ref = _train(mx, jnet, batches)
    _compare(net, jnet, got, ref)
    # the losses moved: the steps trained something
    assert not np.allclose(got[0], got[-1])


@pytest.fixture
def captured(monkeypatch):
    from test_torch_train_graph import FakeGraph
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made = []
    ttel.reset()
    tof.reset()
    yield FakeGraph
    FakeGraph.made = []
    tof.set_enabled(True)


def test_hybridized_training_matches_mxtpu(captured):
    net, jnet, _ = _pair(seed=6)
    net.hybridize()
    batches = _batches(2)
    got = _train(mt, net, batches)
    ref = _train(mx, jnet, batches)
    _compare(net, jnet, got, ref)
    # one pair for the one signature, captured at the first step
    assert len(net._cached_op._pairs) == 1
    assert ttel.retrace_stats("cached_op")["compiles"] == 1
