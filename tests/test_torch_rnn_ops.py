"""The RNN slice's ops of the port against the JAX package's, on the CPU
with seeded numpy inputs: the fused ``RNN`` op (4 modes x one or two
directions x 1-2 layers x ``state_outputs``; outputs and the gradients of
data, parameters and states), its shape and output-count rules and the
ignored ``p``; ``SliceChannel``/``split``, the ``Sequence*`` ops,
``CTCLoss`` (both blank rules, with and without lengths; values and
gradients) and ``foreach``/``while_loop``/``cond``. float32 forward within
1e-5 and gradients within 1e-4 (the reference's f32 conv tolerances),
relative to max(1, max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.ops import registry as jreg
from mxtpu_torch import graphs
from mxtpu_torch.ops import registry as treg

FWD, GRAD = 1e-5, 1e-4
T, N, IN, H = 5, 3, 4, 6


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, "%s: %.3g > %.3g" % (what, err, tol * scale)


def _rnn_case(mode, bidirectional, layers, seed):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    size = mt.ops.rnn_ops.rnn_param_size(mode, layers, IN, H, bidirectional)
    arrays = [rng.randn(T, N, IN).astype(np.float32),
              (rng.randn(size) * 0.3).astype(np.float32),
              rng.randn(layers * dirs, N, H).astype(np.float32)]
    if mode == "lstm":
        arrays.append(rng.randn(layers * dirs, N, H).astype(np.float32))
    return arrays


def _vjp_jax(fn, arrays, cots):
    outs, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    grads = vjp(type(outs)(jnp.asarray(c) for c in cots)
                if len(cots) > 1 else jnp.asarray(cots[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _vjp_torch(fn, arrays, cots):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    grads = torch.autograd.grad(outs, ts, [torch.tensor(c) for c in cots],
                                allow_unused=True)
    return ([o.detach().numpy() for o in outs],
            [g.numpy() if g is not None else np.zeros_like(a)
             for g, a in zip(grads, arrays)])


@pytest.mark.parametrize("state_outputs", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_rnn_op_matches_the_reference(mode, bidirectional, layers,
                                      state_outputs):
    arrays = _rnn_case(mode, bidirectional, layers, seed=layers * 7 + 1)
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidirectional, state_outputs=state_outputs)
    jfn = jreg.get_op("RNN").fn
    tfn = treg.get_op("RNN").fn
    n_out = treg.NUM_OUTPUT_RULES["RNN"](kw)
    assert n_out == jreg.NUM_OUTPUT_RULES["RNN"](kw)
    dirs = 2 if bidirectional else 1
    shapes = [(T, N, H * dirs)] + [(layers * dirs, N, H)] * (n_out - 1)
    rng = np.random.RandomState(99)
    cots = [rng.randn(*s).astype(np.float32) for s in shapes]
    ref_out, ref_grads = _vjp_jax(lambda *a: jfn(*a, **kw), arrays, cots)
    got_out, got_grads = _vjp_torch(lambda *a: tfn(*a, **kw), arrays, cots)
    assert len(got_out) == n_out
    for k, (g, r) in enumerate(zip(got_out, ref_out)):
        _close(g, r, FWD, "output %d" % k)
    for name, g, r in zip(("data", "parameters", "state", "state_cell"),
                          got_grads, ref_grads):
        _close(g, r, GRAD, "d " + name)


def test_rnn_shape_rules_and_ignored_options():
    """The parameter-shape and output-count rules give the reference's
    shapes, a symbol infers them, and ``p``, ``projection_size`` and the
    state clips change nothing (the JAX package ignores them)."""
    for mode in ("rnn_tanh", "lstm", "gru"):
        for bi in (False, True):
            attrs = dict(state_size=H, num_layers=2, mode=mode,
                         bidirectional=bi)
            shapes = [(T, N, IN), None, None] + (
                [None] if mode == "lstm" else [])
            assert treg.PARAM_SHAPE_RULES["RNN"](shapes, attrs) == \
                jreg.PARAM_SHAPE_RULES["RNN"](shapes, attrs)
    data = mt.sym.var("data")
    out = mt.sym.RNN(data, mt.sym.var("p"), mt.sym.var("h"),
                     mt.sym.var("c"), state_size=H, num_layers=2,
                     mode="lstm", state_outputs=True, name="rnn")
    assert out.list_outputs() == ["rnn_output0", "rnn_output1",
                                  "rnn_output2"]
    args, outs, _ = out.infer_shape(data=(T, N, IN))
    assert args == [(T, N, IN),
                    (mt.ops.rnn_ops.rnn_param_size("lstm", 2, IN, H),),
                    (2, N, H), (2, N, H)]
    assert outs == [(T, N, H), (2, N, H), (2, N, H)]
    arrays = [torch.tensor(a) for a in _rnn_case("lstm", False, 2, 5)]
    base = mt.ops.RNN(*arrays, state_size=H, num_layers=2, mode="lstm")
    other = mt.ops.RNN(*arrays, state_size=H, num_layers=2, mode="lstm",
                       p=0.5, projection_size=3, lstm_state_clip_min=-0.1,
                       lstm_state_clip_max=0.1, lstm_state_clip_nan=True)
    with mt.autograd.record():
        recorded = mt.nd.RNN(*[mt.nd.array(a.numpy(), ctx=mt.cpu())
                               for a in arrays], state_size=H, num_layers=2,
                             mode="lstm", p=0.5)
    assert torch.equal(base, other)
    assert torch.equal(base, recorded.to_torch().detach())


def test_rnn_bfloat16_weights_with_float32_states_run_in_float32():
    """bf16 weights and data with f32 states: the products run in the
    operands' promoted type (float32), as ``contract_acc`` gives it."""
    data, params, h, c = _rnn_case("lstm", False, 1, 3)
    kw = dict(state_size=H, num_layers=1, mode="lstm", state_outputs=True)
    ref = jreg.get_op("RNN").fn(jnp.asarray(data, jnp.bfloat16),
                                jnp.asarray(params, jnp.bfloat16),
                                jnp.asarray(h), jnp.asarray(c), **kw)
    got = mt.ops.RNN(torch.tensor(data).bfloat16(),
                     torch.tensor(params).bfloat16(), torch.tensor(h),
                     torch.tensor(c), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        _close(g.numpy(), np.asarray(r), 1e-2)



@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_bfloat16_weights_cast_once_under_float32_states(mode):
    """bf16 weights with f32 data and states compute what the same weights
    cast to f32 compute, and their gradients sum over the steps in f32:
    the loop-invariant h2h weight and bias are cast once, not once a
    step (whose bf16 gradients would sum in bf16)."""
    arrays = _rnn_case(mode, True, 2, 5)
    kw = dict(state_size=H, num_layers=2, mode=mode, bidirectional=True,
              state_outputs=True)
    bf16 = torch.tensor(arrays[1]).bfloat16()
    got, want = {}, {}
    for key, params in (("bf16", bf16), ("f32", bf16.float())):
        ts = [torch.tensor(a, requires_grad=True) for a in arrays]
        p = params.detach().requires_grad_()
        outs = mt.ops.RNN(ts[0], p, *ts[2:], **kw)
        loss = sum((o * o).sum() for o in outs)
        loss.backward()
        (got if key == "bf16" else want)[key] = (
            [o.detach() for o in outs], p.grad)
    for g, w in zip(got["bf16"][0], want["f32"][0]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert got["bf16"][1].dtype == torch.bfloat16
    assert torch.equal(got["bf16"][1], want["f32"][1].bfloat16())

# ------------------------------------------------------------ SliceChannel
@pytest.mark.parametrize("name", ["SliceChannel", "split"])
def test_slice_channel(name):
    x = np.random.RandomState(0).randn(2, 6, 4).astype(np.float32)
    for kw in (dict(num_outputs=3, axis=1),
               dict(num_outputs=2, axis=-1, squeeze_axis=False),
               dict(num_outputs=2, axis=0, squeeze_axis=True),
               dict(num_outputs=1, axis=2)):
        ref = getattr(mx.nd, name)(mx.nd.array(x), **kw)
        with mt.cpu():
            got = getattr(mt.nd, name)(mt.nd.array(x), **kw)
        ref = ref if isinstance(ref, list) else [ref]
        got = got if isinstance(got, list) else [got]
        assert len(got) == len(ref) == kw["num_outputs"]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.asnumpy(), r.asnumpy())
    assert treg.NUM_OUTPUT_RULES["SliceChannel"]({"num_outputs": 4}) == 4
    s = mt.sym.SliceChannel(mt.sym.var("x"), num_outputs=3, axis=1,
                            name="sl")
    assert s.list_outputs() == ["sl_output0", "sl_output1", "sl_output2"]
    with pytest.raises(mt.MXNetError, match="equal parts"):
        mt.ops.SliceChannel(torch.zeros(2, 5), num_outputs=2, axis=1)


# ------------------------------------------------------------ Sequence ops
@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_ops(axis):
    rng = np.random.RandomState(axis)
    x = rng.randn(5, 3, 4).astype(np.float32)   # TNC (axis 0) or NTC
    if axis == 1:
        x = x.transpose(1, 0, 2).copy()
    lengths = np.array([2, 5, 1], np.float32)
    for name, kws in (("SequenceMask", [dict(), dict(value=-2.0)]),
                      ("SequenceLast", [dict()]),
                      ("SequenceReverse", [dict()])):
        if name == "SequenceReverse" and axis == 1:
            continue   # time is axis 0 there, as in the reference
        for kw in kws:
            for use in (False, True):
                args = dict(kw, use_sequence_length=use, axis=axis)
                ref = getattr(mx.nd, name)(
                    mx.nd.array(x), mx.nd.array(lengths), **args)
                with mt.cpu():
                    got = getattr(mt.nd, name)(
                        mt.nd.array(x), mt.nd.array(lengths), **args)
                np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    # gradients flow to the data, as the reference's
    xt = torch.tensor(x, requires_grad=True)
    mt.ops.SequenceLast(xt, torch.tensor(lengths), True, axis=axis).sum() \
        .backward()
    jg = jax.grad(lambda d: jreg.get_op("SequenceLast").fn(
        d, jnp.asarray(lengths), True, axis=axis).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


# ----------------------------------------------------------------- CTCLoss
def _ctc_inputs(blank_label, seed):
    rng = np.random.RandomState(seed)
    t, n, c, width = 7, 4, 5, 3
    data = rng.randn(t, n, c).astype(np.float32)
    pad = 0 if blank_label == "first" else -1
    lo, hi = (1, c) if blank_label == "first" else (0, c - 1)
    label = rng.randint(lo, hi, (n, width)).astype(np.float32)
    label[0, 2] = pad                    # length 2
    label[1, 1:] = pad                   # length 1
    label[2, 1] = label[2, 0]            # a repeat: no skip between them
    label[3, :] = pad                    # no label at all
    return data, label, np.array([7, 5, 6, 3], np.float32), \
        np.array([2, 1, 3, 0], np.float32)


@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("blank_label", ["first", "last"])
def test_ctc_loss_values_and_gradients(blank_label, lengths):
    data, label, dlen, llen = _ctc_inputs(blank_label, seed=int(lengths))
    kw = dict(use_data_lengths=lengths, use_label_lengths=lengths,
              blank_label=blank_label)
    jfn = jreg.get_op("CTCLoss").fn
    extra = [dlen, llen] if lengths else [None, None]

    def jf(d):
        return jfn(d, jnp.asarray(label), *[None if e is None else
                                            jnp.asarray(e) for e in extra],
                   **kw)
    cot = np.random.RandomState(4).rand(4).astype(np.float32)
    ref, vjp = jax.vjp(jf, jnp.asarray(data))
    (ref_grad,) = vjp(jnp.asarray(cot))
    dt = torch.tensor(data, requires_grad=True)
    got = mt.ops.CTCLoss(dt, torch.tensor(label),
                         *[None if e is None else torch.tensor(e)
                           for e in extra], **kw)
    (got_grad,) = torch.autograd.grad(got, dt, torch.tensor(cot))
    assert np.isfinite(np.asarray(ref)).all()
    _close(got.detach().numpy(), np.asarray(ref), FWD, "nll")
    _close(got_grad.numpy(), np.asarray(ref_grad), GRAD, "d data")
    for alias in ("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"):
        assert treg.get_op(alias).name == "CTCLoss"


def test_gluon_ctc_loss_matches_the_reference():
    data, label, dlen, llen = _ctc_inputs("last", seed=2)
    pred = data.transpose(1, 0, 2).copy()          # NTC
    ref = mx.gluon.loss.CTCLoss()(mx.nd.array(pred), mx.nd.array(label),
                                  mx.nd.array(dlen), mx.nd.array(llen))
    with mt.cpu():
        got = mt.gluon.loss.CTCLoss()(mt.nd.array(pred), mt.nd.array(label),
                                      mt.nd.array(dlen), mt.nd.array(llen))
        tnc = mt.gluon.loss.CTCLoss(layout="TNC", weight=0.5)(
            mt.nd.array(data), mt.nd.array(label))
    ref_tnc = mx.gluon.loss.CTCLoss(layout="TNC", weight=0.5)(
        mx.nd.array(data), mx.nd.array(label))
    _close(got.asnumpy(), ref.asnumpy(), FWD)
    _close(tnc.asnumpy(), ref_tnc.asnumpy(), FWD)
    with pytest.raises(mt.MXNetError, match="layout"):
        mt.gluon.loss.CTCLoss(layout="NCT")


# ------------------------------------------------------------ control flow
def _nd_pair(x):
    with mt.cpu():
        t = mt.nd.array(x)
    return mx.nd.array(x), t


def test_foreach_outputs_states_and_gradients():
    rng = np.random.RandomState(0)
    data = rng.randn(4, 2, 3).astype(np.float32)
    s0 = rng.randn(2, 3).astype(np.float32)

    def body(pkg):
        def step(x, states):
            h = pkg.nd.tanh(x * 2.0 + states[0])
            return [h, h * h], [h + states[1], states[1] * 0.5]
        return step

    got = {}
    for pkg in (mx, mt):
        d = pkg.nd.array(data) if pkg is mx else _nd_pair(data)[1]
        s = [pkg.nd.array(s0) if pkg is mx else _nd_pair(s0)[1]
             for _ in range(2)]
        for a in [d] + s:
            a.attach_grad()
        with pkg.autograd.record():
            outs, finals = pkg.nd.foreach(body(pkg), d, s)
            loss = (outs[0] * outs[1]).sum() + (finals[0] * 3.0).sum() + \
                finals[1].sum()
        loss.backward()
        got[pkg] = ([o.asnumpy() for o in outs + finals],
                    [a.grad.asnumpy() for a in [d] + s])
    for g, r in zip(got[mt][0], got[mx][0]):
        _close(g, r, FWD)
    for g, r in zip(got[mt][1], got[mx][1]):
        _close(g, r, GRAD)
    # one array and one state in: arrays out, not lists
    with mt.cpu():
        out, fin = mt.nd.foreach(lambda x, s: (x + s, x * s),
                                 mt.nd.array(data), mt.nd.array(s0))
    assert out.shape == (4, 2, 3) and fin.shape == (2, 3)


def test_while_loop_and_cond_match_the_reference():
    """Values of while_loop and of both branches of cond (the reference's
    fail under record(): its tape cannot take their tuple of outputs),
    then the port's gradients through both, recorded."""
    x0 = np.array([1.0, 2.0], np.float32)

    def run(pkg):
        i = pkg.nd.array(np.array([0.0], np.float32))
        x = pkg.nd.array(x0)
        outs, (i_f, x_f) = pkg.nd.while_loop(
            lambda i, x: i < 3, lambda i, x: (i + 1, x * 1.5 + 1), [i, x],
            max_iterations=10)
        y = pkg.nd.cond(pkg.nd.array(np.array([1.0], np.float32)),
                        lambda a: a * a, lambda a: -a, [x_f])
        z = pkg.nd.cond(pkg.nd.array(np.array([0.0], np.float32)),
                        lambda a: a * a, lambda a: -a, [x_f])
        assert outs == []
        return x, x_f, [i_f, x_f, y, z], (y * 2).sum() + z.sum()

    _, _, ref, _ = run(mx)
    with mt.cpu():
        _, _, got, _ = run(mt)
        for g, r in zip(got, ref):
            _close(g.asnumpy(), r.asnumpy(), FWD)
        x = mt.nd.array(x0)
        x.attach_grad()
        with mt.autograd.record():
            _, (_, x_f) = mt.nd.while_loop(
                lambda i, x: i < 3, lambda i, x: (i + 1, x * 1.5 + 1),
                [mt.nd.array(np.array([0.0], np.float32)), x])
            y = mt.nd.cond(mt.nd.array([1.0]), lambda a: a * a,
                           lambda a: -a, [x_f])
            z = mt.nd.cond(mt.nd.array([0.0]), lambda a: a * a,
                           lambda a: -a, [x_f])
            loss = (y * 2).sum() + z.sum()
        loss.backward()
    x_end = x_f.asnumpy()
    np.testing.assert_allclose(x.grad.asnumpy(),
                               (4 * x_end - 1) * 1.5 ** 3, rtol=1e-6)
    for name in ("_foreach", "_while_loop", "_cond"):
        assert treg.get_op(name).name == name[1:]


def test_control_flow_bodies_run_paused():
    """Inside a body (and a branch) is_recording() and is_training() are
    False, as under the reference's autograd.pause()."""
    seen = []

    def probe(*a):
        seen.append((mt.autograd.is_recording(), mt.autograd.is_training()))
        return a[0] * 1.0

    with mt.cpu():
        x = mt.nd.array(np.ones((2, 2), np.float32))
        with mt.autograd.record():
            mt.nd.foreach(lambda d, s: (probe(d), s), x, x)
            mt.nd.cond(mt.nd.array([1.0]), probe, probe, [x])
    assert seen and set(seen) == {(False, False)}


def test_while_loop_and_cond_refuse_a_capture_foreach_captures(monkeypatch):
    """``while_loop`` and ``cond`` read their predicate on the host: inside
    a capture they raise naming it. ``foreach`` reads nothing there."""
    monkeypatch.setattr(graphs._STATE, "depth", 1, raising=False)
    assert graphs.capturing()
    with mt.cpu():
        x = mt.nd.array(np.ones((3, 2), np.float32))
        with pytest.raises(mt.MXNetError, match="predicate on the host"):
            mt.nd.while_loop(lambda v: v.sum() < 10, lambda v: v * 2, x)
        with pytest.raises(mt.MXNetError, match="predicate on the host"):
            mt.nd.cond(mt.nd.array([1.0]), lambda v: v, lambda v: v, [x])
        out, fin = mt.nd.foreach(lambda d, s: (d + s, s), x,
                                 mt.nd.array(np.zeros(2, np.float32)))
    np.testing.assert_array_equal(out.asnumpy(), np.ones((3, 2)))


def test_control_flow_in_a_hybridized_block(monkeypatch):
    """In ``hybrid_forward`` (tensors): ``foreach`` captures (the stand-in
    graph of tests/test_torch_train_graph.py) and gives the eager numbers
    and gradients; ``while_loop`` raises inside the capture."""
    from test_torch_train_graph import FakeGraph
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made = []

    class Scan(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.proj = mt.gluon.nn.Dense(3, in_units=3, flatten=False)

        def hybrid_forward(self, F, x):
            def step(x_t, h):
                h = F.tanh(self.proj(x_t) + h)
                return h * 2, h
            outs, last = F.foreach(step, x, F.zeros_like(x[0]))
            return outs, last

    class Loop(mt.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.while_loop(lambda v: v.sum() < 100, lambda v: v * 2,
                                x)[1]

    net = Scan()
    net.initialize(ctx=mt.cpu())
    x = np.random.RandomState(0).randn(4, 2, 3).astype(np.float32)
    want = []
    for hybrid in (False, True):
        net.hybridize(hybrid)
        xa = _nd_pair(x)[1]
        xa.attach_grad()
        with mt.autograd.record():
            outs, last = net(xa)
            loss = (outs * outs).sum() + last.sum()
        loss.backward()
        got = [outs.asnumpy(), last.asnumpy(), xa.grad.asnumpy(),
               net.proj.weight.grad().asnumpy()]
        if not hybrid:
            want = got
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert len(net._cached_op._pairs) == 1 and FakeGraph.made
    loop = Loop()
    loop.hybridize()
    with pytest.raises(mt.MXNetError, match="predicate on the host"):
        loop(torch.ones(3))
    loop.hybridize(False)
    assert float(loop(torch.ones(3)).sum()) == 192.0
    FakeGraph.made = []
