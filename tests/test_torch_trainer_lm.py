"""The transformer trained through ``gluon.Trainer`` in the port against
the JAX package, on the CPU: a 2-layer narrow ``TransformerLM`` (vocab 97,
dim 64, 2 heads, bidirectional as BERT is, seeded weights) trained 3 steps
of 2 x 32 tokens with Adam (lr 1e-3, wd 1e-4) and
``SoftmaxCrossEntropyLoss`` over the vocab, as ``bench.py``'s BERT-base
step computes it (logits reshaped to ``(-1, vocab)``, float labels). The
port's attention runs the flash wrapper's plain forward and its ported
backward; the JAX package its own XLA attention (hybridized).

Tolerances: per-token losses of every step rtol=atol=1e-4; weights and
both Adam moments after the third step within 1e-4 of max(1, max|ref|).

And a resume from the JAX package's optimizer states:
``Updater.get_states(dump_optimizer=False)`` read by
``convert.load_mxtpu_optimizer_states`` gives the step that the JAX
package takes from the same blob (within 1e-5 of max(1, max|ref|)); a
blob that holds a pickled ``mxtpu`` optimizer is refused.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon.model_zoo import transformer as jtr
from mxtpu_torch import convert
from mxtpu_torch.gluon.model_zoo import transformer as ttr
from mxtpu_torch.ops.pallas import flash_attention as tfa

LM = dict(vocab_size=97, dim=64, num_heads=2, num_layers=2, max_len=64,
          causal=False)
OPT = {"learning_rate": 1e-3, "wd": 1e-4}
STEPS, B, T = 3, 2, 32
TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_FLASH_INTERPRET", "MXTPU_MESH"):
        monkeypatch.delenv(var, raising=False)


def _keyed(params):
    return {k.partition("_")[2]: p for k, p in params.items()}


def _jax_net(arrays):
    jnet = jtr.TransformerLM(**LM)
    ours = convert._strip_top(list(arrays))
    for key, p in _keyed(jnet.collect_params()).items():
        p.set_data(mx.nd.array(arrays[ours[key]]))
    jnet.hybridize()
    return jnet


def _step(pkg, net, trainer, tokens, labels):
    arr = (lambda a, **k: mt.nd.array(a, ctx=mt.cpu(), **k)) \
        if pkg is mt else mx.nd.array
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        logits = net(arr(tokens, dtype="int32"))
        loss = loss_fn(logits.reshape((-1, LM["vocab_size"])),
                       arr(labels).reshape((-1,)))
    loss.backward()
    trainer.step(B * T)
    return loss.asnumpy()


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for v in s for x in _leaves(v)]
    return [s]


def _close_scaled(got, ref, tol, what):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def runs():
    net = ttr.TransformerLM(**LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    arrays = convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()}, seed=4)
    convert.load_mxtpu_params(net, arrays)
    jnet = _jax_net(arrays)
    rng = np.random.RandomState(1)
    data = [(rng.randint(0, 97, (B, T)).astype(np.int32),
             rng.randint(0, 97, (B, T)).astype(np.float32))
            for _ in range(STEPS + 1)]
    tt = mt.gluon.Trainer(net.collect_params(), "adam", dict(OPT))
    jt = mx.gluon.Trainer(jnet.collect_params(), "adam", dict(OPT))
    calls = []
    real = tfa.flash_attention_backward

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    tfa.flash_attention_backward = spy
    try:
        tlosses = [_step(mt, net, tt, *d) for d in data[:STEPS]]
    finally:
        tfa.flash_attention_backward = real
    jlosses = [_step(mx, jnet, jt, *d) for d in data[:STEPS]]
    return dict(net=net, jnet=jnet, tt=tt, jt=jt, tlosses=tlosses,
                jlosses=jlosses, data=data, bwd_calls=len(calls))


def test_lm_losses_match_mxtpu(runs):
    for got, ref in zip(runs["tlosses"], runs["jlosses"]):
        assert got.shape == (B * T,)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_lm_weights_match_mxtpu(runs):
    ours = _keyed(runs["net"].collect_params())
    theirs = _keyed(runs["jnet"].collect_params())
    assert ours.keys() == theirs.keys()
    for k in ours:
        _close_scaled(ours[k].data().asnumpy(), theirs[k].data().asnumpy(),
                      TOL, k)


def test_lm_adam_moments_match_mxtpu(runs):
    ts = runs["tt"]._updaters[0].states
    js = runs["jt"]._updaters[0].states
    assert sorted(ts) == sorted(js)
    for i in ts:
        tl, jl = _leaves(ts[i]), _leaves(js[i])
        assert len(tl) == len(jl) == 2
        for a, b in zip(tl, jl):
            _close_scaled(a.asnumpy(), b.asnumpy(), TOL, "state %d" % i)
    assert runs["tt"].optimizer._index_update_count == \
        runs["jt"].optimizer._index_update_count


def test_lm_attention_ran_the_ported_backward(runs):
    assert runs["bwd_calls"] == STEPS * LM["num_layers"]


def test_resume_from_mxtpu_optimizer_states(runs):
    """Both packages resume from one JAX-written blob and the JAX
    package's weights, and take the same next step."""
    jnet, net = runs["jnet"], runs["net"]
    blob = runs["jt"]._updaters[0].get_states(dump_optimizer=False)
    weights = {k: p.data().asnumpy() for k, p in
               jnet.collect_params().items()}
    convert.load_mxtpu_params(net, weights)
    tt = mt.gluon.Trainer(net.collect_params(), "adam", dict(OPT))
    convert.load_mxtpu_optimizer_states(tt, blob)
    jt = mx.gluon.Trainer(jnet.collect_params(), "adam", dict(OPT))
    jt._init_kvstore()
    jt._updaters[0].set_states(blob)
    tokens, labels = runs["data"][STEPS]
    got = _step(mt, net, tt, tokens, labels)
    ref = _step(mx, jnet, jt, tokens, labels)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    for k, p in _keyed(net.collect_params()).items():
        _close_scaled(p.data().asnumpy(),
                      _keyed(jnet.collect_params())[k].data().asnumpy(),
                      1e-5, k)
    # the restored states moved to the weights' device and type
    st = tt._updaters[0].states[0]
    assert st[0].to_torch().dtype == torch.float32
    with pytest.raises(mt.MXNetError, match="dump_optimizer=False"):
        convert.load_mxtpu_optimizer_states(
            tt, runs["jt"]._updaters[0].get_states(dump_optimizer=True))
