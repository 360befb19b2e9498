"""The training ops of the port against the JAX package's, on the CPU with
seeded numpy inputs: ``softmax``/``log_softmax`` and every Gluon loss
(float32 forward rtol=atol=1e-5, input gradients 1e-4, the reference's f32
conv tolerances), and where a recorded conv or flash call on CPU tensors
takes its gradients from: the port's own backwards
(``fused_conv_backward``, ``flash_attention_backward``, the ones the card
runs), never autograd through the plain forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch.ops.pallas import conv as tpc
from mxtpu_torch.ops.pallas import flash_attention as tfa

FWD, GRAD = 1e-5, 1e-4


def test_conv_cpu_gradients_come_from_the_ported_backward(monkeypatch):
    """A recorded conv on CPU tensors runs ``_FusedConv``: its backward is
    ``fused_conv_backward`` (the card's), and the plain forward is not
    taped."""
    calls = []
    real = tpc.fused_conv_backward

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(tpc, "fused_conv_backward", spy)
    x = torch.randn(1, 6, 6, 4, requires_grad=True)
    w = torch.randn(3, 3, 4, 8, requires_grad=True)
    out = tpc.fused_conv(x, w, (1, 1), ((1, 1), (1, 1)), relu=True)
    assert type(out.grad_fn).__name__ == "_FusedConvBackward"
    # what is saved: x, w and (under relu) out, no extra buffer
    saved = out.grad_fn.saved_tensors
    assert sum(t is not None for t in saved) == 3
    out.sum().backward()
    assert calls == [1] and x.grad is not None and w.grad is not None
    with torch.no_grad():
        plain = tpc.fused_conv(x, w, (1, 1), ((1, 1), (1, 1)))
    assert plain.grad_fn is None
    # craw carries no gradient and is saved only with a scale
    out, craw = tpc.fused_conv_with_raw(x, w, scale=torch.ones(8))
    assert craw is not None and not craw.requires_grad


def test_conv_through_conv_fast_on_ndarrays_trains():
    """A gated Conv2D on NDArrays under record(): p.grad() from the ported
    backward, equal to jax.grad of the JAX package's layer."""
    r = np.random.RandomState(3)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    w = (r.randn(3, 3, 3, 16) * 0.2).astype(np.float32)
    with mt.layout("NHWC"):
        conv = mt.gluon.nn.Conv2D(16, 3, padding=1, use_bias=False,
                                  in_channels=3)
    conv.initialize(ctx=mt.cpu())
    conv.weight.set_data(w)
    xa = mt.nd.array(x, ctx=mt.cpu())
    with mt.autograd.record():
        loss = (conv(xa) ** 2).sum()
    loss.backward()
    ref = jax.grad(lambda w_: jnp.sum(jax.lax.conv_general_dilated(
        jnp.asarray(x), w_, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) ** 2))(jnp.asarray(w))
    np.testing.assert_allclose(conv.weight.grad().asnumpy(), np.asarray(ref),
                               rtol=GRAD, atol=GRAD)


def test_flash_cpu_gradients_come_from_the_ported_backward(monkeypatch):
    calls = []
    real = tfa.flash_attention_backward

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(tfa, "flash_attention_backward", spy)
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    out = tfa.flash_attention(q, q, q, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashBackward"
    out.sum().backward()
    assert calls == [1] and q.grad.shape == q.shape


# ------------------------------------------------------- softmax and losses
@pytest.mark.parametrize("kw", [{}, {"axis": 0}, {"temperature": 2.5}])
def test_softmax_and_log_softmax_match_mxtpu(kw):
    x = np.random.RandomState(6).randn(4, 7).astype(np.float32)
    for name in ("softmax", "log_softmax"):
        got = getattr(mt.nd, name)(mt.nd.array(x, ctx=mt.cpu()), **kw)
        ref = getattr(mx.nd, name)(mx.nd.array(x), **kw)
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=FWD,
                                   atol=FWD, err_msg=name)
    method = mt.nd.array(x, ctx=mt.cpu()).log_softmax(**kw)
    np.testing.assert_allclose(method.asnumpy(), ref.asnumpy(), rtol=FWD,
                               atol=FWD)


def test_softmax_length_matches_mxtpu():
    x = np.random.RandomState(7).randn(3, 6).astype(np.float32)
    length = np.array([2, 6, 4], np.float32)
    got = mt.nd.softmax(mt.nd.array(x, ctx=mt.cpu()),
                        length=mt.nd.array(length, ctx=mt.cpu()))
    ref = mx.nd.softmax(mx.nd.array(x), length=mx.nd.array(length))
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=FWD,
                               atol=FWD)


def _loss_case(name, kw, r):
    pred = r.randn(4, 5).astype(np.float32)
    label = r.randn(4, 5).astype(np.float32)
    if name in ("SoftmaxCrossEntropyLoss", "SoftmaxCELoss") \
            and kw.get("sparse_label", True):
        label = r.randint(0, 5, 4).astype(np.float32)    # float class ids
    elif name == "SigmoidBinaryCrossEntropyLoss":
        label = (r.rand(4, 5) > 0.5).astype(np.float32)
    elif name in ("HingeLoss", "SquaredHingeLoss", "LogisticLoss"):
        label = np.sign(r.randn(4, 5)).astype(np.float32)
    elif name == "KLDivLoss":
        label = np.abs(label) / np.abs(label).sum(1, keepdims=True)
    elif name == "PoissonNLLLoss":
        label = np.abs(label) * 3
    return [pred, label]


LOSSES = [
    ("L2Loss", {}), ("L1Loss", {}), ("SigmoidBinaryCrossEntropyLoss", {}),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}),
    ("SoftmaxCrossEntropyLoss", {}), ("SoftmaxCELoss", {"weight": 0.5}),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}),
    ("KLDivLoss", {}), ("KLDivLoss", {"from_logits": False}),
    ("HuberLoss", {"rho": 0.7}), ("HingeLoss", {"margin": 0.5}),
    ("SquaredHingeLoss", {}), ("LogisticLoss", {}),
    ("LogisticLoss", {"label_format": "binary"}), ("TripletLoss", {}),
    ("PoissonNLLLoss", {}), ("PoissonNLLLoss", {"compute_full": True,
                                                "from_logits": False}),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name,kw", LOSSES,
                         ids=["%s%d" % (n, i) for i, (n, _) in
                              enumerate(LOSSES)])
def test_loss_and_gradient_match_mxtpu(name, kw, weighted):
    r = np.random.RandomState(len(name) + len(kw))
    args = _loss_case(name, kw, r)
    if name == "SoftmaxCrossEntropyLoss" and not kw.get("sparse_label", 1):
        args[1] = np.abs(args[1]) / np.abs(args[1]).sum(1, keepdims=True)
    if name == "PoissonNLLLoss" and not kw.get("from_logits", True):
        args[0] = np.abs(args[0]) + 0.1
    if name == "SigmoidBinaryCrossEntropyLoss" and kw.get("from_sigmoid"):
        args[0] = 1.0 / (1.0 + np.exp(-args[0]))
    if name == "TripletLoss":
        args.append(r.randn(4, 5).astype(np.float32))
    sw = r.rand(4, 1).astype(np.float32) if weighted else None
    tl = getattr(mt.gluon.loss, name)(**kw)
    jl = getattr(mx.gluon.loss, name)(**kw)
    targs = [mt.nd.array(a, ctx=mt.cpu()) for a in args]
    jargs = [mx.nd.array(a) for a in args]
    targs[0].attach_grad()
    jargs[0].attach_grad()
    tsw = None if sw is None else mt.nd.array(sw, ctx=mt.cpu())
    jsw = None if sw is None else mx.nd.array(sw)
    with mt.autograd.record():
        tout = tl(*targs, tsw) if sw is not None else tl(*targs)
    tout.backward()
    with mx.autograd.record():
        jout = jl(*jargs, jsw) if sw is not None else jl(*jargs)
    jout.backward()
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=FWD,
                               atol=FWD)
    np.testing.assert_allclose(targs[0].grad.asnumpy(),
                               jargs[0].grad.asnumpy(), rtol=GRAD, atol=GRAD)


def test_loss_sample_weight_tensors_and_refusals():
    r = np.random.RandomState(8)
    pred, label = r.randn(3, 4).astype(np.float32), r.randn(3, 4)
    sw = r.rand(3, 1).astype(np.float32)
    tl = mt.gluon.loss.L2Loss()
    a = tl(mt.nd.array(pred, ctx=mt.cpu()), mt.nd.array(label, ctx=mt.cpu()),
           mt.nd.array(sw, ctx=mt.cpu()))
    b = mx.gluon.loss.L2Loss()(mx.nd.array(pred), mx.nd.array(label),
                               mx.nd.array(sw))
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=FWD, atol=FWD)
    # tensors in, tensors out, as any block
    t = tl(torch.from_numpy(pred), torch.from_numpy(label.astype(np.float32)))
    assert isinstance(t, torch.Tensor) and t.shape == (3,)
    # CTCLoss is ported (tests/test_torch_rnn_ops.py); it refuses what the
    # reference's refuses
    with pytest.raises(mt.MXNetError, match="layouts are supported"):
        mt.gluon.loss.CTCLoss(layout="NCT")
    with pytest.raises(mt.MXNetError, match="weight must be a number"):
        mt.gluon.loss.L1Loss(weight="x")(torch.ones(2, 2), torch.ones(2, 2))
    with pytest.raises(mt.MXNetError, match="signed or binary"):
        mt.gluon.loss.LogisticLoss(label_format="other")
