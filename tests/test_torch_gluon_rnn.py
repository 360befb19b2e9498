"""``gluon.rnn`` and ``gluon.contrib.rnn`` of the port against the JAX
package's, on the CPU with seeded numpy inputs and weights loaded by name
(``convert.seeded_params`` into both): every cell's ``unroll`` (TNC and
NTC, merged or per step, ``valid_length``), the fused ``RNN``/``LSTM``/
``GRU`` layers (one or two directions, with and without states; outputs,
states and the gradients of input and weights), and the contrib cells.
float32 forward within 1e-5, gradients within 1e-4, relative to
max(1, max|ref|). The JAX side's layers are hybridized.

``unroll(valid_length=)``: the JAX package selects with a ``jnp.where``
whose (N,) condition broadcasts over the hidden axis (ROADMAP C), so the
port is held to the reference's per-step outputs and states with MXNet's
row selection applied to them. Dropout, Zoneout and VariationalDropout are
held to their moments and mask reuse on the port alone (their draws come
from torch's generator). A hybridized layer's ``(inputs, states)`` pair
goes through ``CachedOp`` (the stand-in graph of
tests/test_torch_train_graph.py) in predict mode and recorded.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.gluon import block as jblock
from mxtpu_torch import convert, graphs
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.gluon import block as tblock
from mxtpu_torch.gluon import rnn as trnn
from mxtpu_torch.gluon.contrib import rnn as tcrnn

FWD, GRAD = 1e-5, 1e-4
N, T, C, H = 3, 5, 4, 6


def _close(got, ref, tol, what=""):
    got = np.asarray(got.asnumpy() if hasattr(got, "asnumpy") else got,
                     np.float64)
    ref = np.asarray(ref.asnumpy() if hasattr(ref, "asnumpy") else ref,
                     np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, "%s: %.3g > %.3g" % (what, err, tol * scale)


def _reset():
    for mod in (jblock, tblock):
        mod._NameManager._counts.clear()


def _pair(build):
    """(port block, mxtpu block) built by ``build(package's module)`` with
    both name counters reset."""
    _reset()
    tb = build(mt)
    _reset()
    jb = build(mx)
    return tb, jb


def _load(tb, jb, seed):
    """Seeded weights by name into both (the port's shapes settled)."""
    arrays = convert.seeded_params(
        {n: p.shape for n, p in tb.collect_params().items()}, seed,
        prefix=tb.prefix)
    convert.load_mxtpu_params(tb, arrays)
    jparams = jb.collect_params()
    assert sorted(jparams) == sorted(arrays)
    for name, a in arrays.items():
        jparams[name].set_data(mx.nd.array(a))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tnd(x):
    with mt.cpu():
        return mt.nd.array(x)


# -------------------------------------------------------------- the cells
def _rnn(pkg):
    return (pkg.gluon.rnn, pkg.gluon.contrib.rnn)


CELLS = {
    "rnn_tanh": lambda m: _rnn(m)[0].RNNCell(H, input_size=C),
    "rnn_relu": lambda m: _rnn(m)[0].RNNCell(H, activation="relu",
                                             input_size=C),
    "lstm": lambda m: _rnn(m)[0].LSTMCell(H, input_size=C),
    "gru": lambda m: _rnn(m)[0].GRUCell(H, input_size=C),
    "lstmp": lambda m: _rnn(m)[1].LSTMPCell(H, 3, input_size=C),
    "residual": lambda m: _rnn(m)[0].ResidualCell(
        _rnn(m)[0].GRUCell(C, input_size=C)),
    "zoneout_predict": lambda m: _rnn(m)[0].ZoneoutCell(
        _rnn(m)[0].LSTMCell(H, input_size=C), 0.5, 0.5),
    "vardrop_predict": lambda m: _rnn(m)[1].VariationalDropoutCell(
        _rnn(m)[0].GRUCell(H, input_size=C), 0.5, 0.5, 0.5),
}


def _stack(m):
    stack = m.gluon.rnn.SequentialRNNCell()
    with stack.name_scope():
        stack.add(m.gluon.rnn.LSTMCell(H, input_size=C))
        stack.add(m.gluon.rnn.DropoutCell(0.5))
        stack.add(m.gluon.rnn.GRUCell(H, input_size=H))
    return stack


CELLS["sequential"] = _stack
CELLS["bidirectional"] = lambda m: m.gluon.rnn.BidirectionalCell(
    m.gluon.rnn.LSTMCell(H, input_size=C, prefix="l_"),
    m.gluon.rnn.GRUCell(H, input_size=C, prefix="r_"))


def _unroll_pair(name, layout, merge, seed):
    tc, jc = _pair(CELLS[name])
    tc.initialize(ctx=mt.cpu())
    jc.initialize()
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = _x(shape, seed)
    with torch.no_grad():
        tc.unroll(T, torch.tensor(x), layout=layout)   # settles shapes
    _load(tc, jc, seed)
    return tc, jc, x


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_the_reference(name, layout, merge):
    tc, jc, x = _unroll_pair(name, layout, merge, seed=len(name))
    ref_out, ref_states = jc.unroll(T, mx.nd.array(x), layout=layout,
                                    merge_outputs=merge)
    got_out, got_states = tc.unroll(T, _tnd(x), layout=layout,
                                    merge_outputs=merge)
    if merge:
        _close(got_out, ref_out, FWD, "outputs")
    else:
        assert len(got_out) == len(ref_out) == T
        for g, r in zip(got_out, ref_out):
            _close(g, r, FWD, "output")
    assert len(got_states) == len(ref_states)
    for g, r in zip(got_states, ref_states):
        _close(g, r, FWD, "state")
    # the same on tensors, with explicit begin states
    begin = tc.begin_state(batch_size=N, func=mt.ops.zeros, ctx="cpu")
    with torch.no_grad():
        t_out, t_states = tc.unroll(T, torch.tensor(x), begin_state=begin,
                                    layout=layout, merge_outputs=True)
    _close(t_out.numpy(), (ref_out if merge else
                           mx.nd.stack(*ref_out, axis=layout.find("T"))),
           FWD, "tensor outputs")


@pytest.mark.parametrize("name", ["lstm", "gru", "sequential",
                                  "bidirectional"])
def test_cell_unroll_valid_length(name):
    """Outputs past each sample's length are zero (whole rows), states are
    the ones at its last valid step; held to the reference's per-step
    unroll."""
    tc, jc, x = _unroll_pair(name, "NTC", True, seed=3)
    # the reference's unroll cannot take one step (its split of a length-1
    # sequence gives no list), which the bidirectional reference needs
    lengths = np.array([2, 5, 1 if name != "bidirectional" else 3],
                       np.float32)
    ref_steps, ref_states = [], []
    if name != "bidirectional":
        jc.reset()
        states = jc.begin_state(batch_size=N)
        for t in range(T):
            out, states = jc(mx.nd.array(x[:, t]), states)
            ref_steps.append(out.asnumpy())
            ref_states.append([s.asnumpy() for s in states])
    else:
        # each direction over each sample's own valid prefix
        for n in range(N):
            ln = int(lengths[n])
            o, s = jc.unroll(ln, mx.nd.array(x[n:n + 1, :ln]),
                             layout="NTC", merge_outputs=True)
            ref_steps.append(o.asnumpy()[0])
            ref_states.append([v.asnumpy()[0] for v in s])
    got_out, got_states = tc.unroll(T, _tnd(x), layout="NTC",
                                    merge_outputs=True,
                                    valid_length=_tnd(lengths))
    got_out = got_out.asnumpy()
    for n in range(N):
        ln = int(lengths[n])
        if name == "bidirectional":
            want = ref_steps[n]
            want_states = ref_states[n]
        else:
            want = np.stack([ref_steps[t][n] for t in range(ln)])
            want_states = [s[n] for s in ref_states[ln - 1]]
        _close(got_out[n, :ln], want, FWD, "valid outputs")
        assert not got_out[n, ln:].any()
        for g, w in zip(got_states, want_states):
            _close(g.asnumpy()[n], w, FWD, "state")


def test_cell_step_gradients_match_the_reference():
    """Gradients of input, states and weights through an LSTM stack's
    recorded unroll (predict mode: the stack's DropoutCell passes)."""
    tc, jc, x = _unroll_pair("sequential", "TNC", True, seed=5)
    got = {}
    for pkg, cell in ((mx, jc), (mt, tc)):
        xa = mx.nd.array(x) if pkg is mx else _tnd(x)
        xa.attach_grad()
        with pkg.autograd.record(train_mode=False):
            out, states = cell.unroll(T, xa, layout="TNC",
                                      merge_outputs=True)
            loss = (out * out).sum() + (states[1] * 2).sum()
        loss.backward()
        got[pkg] = [xa.grad.asnumpy()] + [
            p.grad().asnumpy() for _, p in sorted(
                cell.collect_params().items())]
    for g, r in zip(got[mt], got[mx]):
        _close(g, r, GRAD)


def test_cells_refuse_what_the_reference_refuses():
    _reset()
    cell = trnn.LSTMCell(H)
    zone = trnn.ZoneoutCell(cell, 0.1, 0.1)
    with pytest.raises(mt.MXNetError, match="modifier"):
        cell.begin_state(batch_size=2)
    assert len(zone.begin_state(batch_size=2, func=mt.ops.zeros,
                                ctx="cpu")) == 2
    bi = trnn.BidirectionalCell(trnn.LSTMCell(H), trnn.LSTMCell(H))
    with pytest.raises(mt.MXNetError, match="unroll"):
        bi(torch.zeros(2, C), [])
    with pytest.raises(mt.MXNetError, match="odd"):
        tcrnn.Conv2DRNNCell((2, 5, 5), 3, 3, 2)


# ------------------------------------------------------------ conv cells
CONV = [(d, kind) for d in (1, 2, 3) for kind in ("RNN", "LSTM", "GRU")]


@pytest.mark.parametrize("dims,kind", CONV)
def test_conv_cells_match_the_reference(dims, kind):
    spatial = {1: (7,), 2: (5, 6), 3: (4, 5, 3)}[dims]
    name = "Conv%dD%sCell" % (dims, kind)

    def build(m):
        return getattr(m.gluon.contrib.rnn, name)(
            (2,) + spatial, 3, i2h_kernel=3, h2h_kernel=3, i2h_pad=1,
            activation="leaky" if kind == "RNN" else "tanh")
    tc, jc = _pair(build)
    tc.initialize(ctx=mt.cpu())
    jc.initialize()
    _load(tc, jc, seed=dims)
    x = _x((N, 2) + (2,) + spatial, seed=dims)      # NTC...: T = 2
    ref_out, ref_states = jc.unroll(2, mx.nd.array(x), layout="NTC",
                                    merge_outputs=True)
    got_out, got_states = tc.unroll(2, _tnd(x), layout="NTC",
                                    merge_outputs=True)
    _close(got_out, ref_out, FWD, "outputs")
    for g, r in zip(got_states, ref_states):
        _close(g, r, FWD, "state")


# ------------------------------------------------------------ the layers
LAYERS = [(kind, bi) for kind in ("rnn_tanh", "rnn_relu", "lstm", "gru")
          for bi in (False, True)]


def _layer(kind, bi, layout):
    def build(m):
        if kind.startswith("rnn"):
            return m.gluon.rnn.RNN(H, num_layers=2, layout=layout,
                                   activation=kind[4:], bidirectional=bi)
        cls = m.gluon.rnn.LSTM if kind == "lstm" else m.gluon.rnn.GRU
        return cls(H, num_layers=2, layout=layout, bidirectional=bi)
    return build


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("kind,bi", LAYERS)
def test_layer_matches_the_reference(kind, bi, layout):
    tl, jl = _pair(_layer(kind, bi, layout))
    tl.initialize(ctx=mt.cpu())
    jl.initialize()
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    x = _x(shape, seed=len(kind))
    with torch.no_grad():
        tl(torch.tensor(x))
    _load(tl, jl, seed=7)
    jl.hybridize()
    names = [f"{d}{i}_{w}" for i in range(2) for d in "lr"[:1 + bi]
             for w in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")]
    assert sorted(n[len(tl.prefix):] for n in tl.collect_params()) == \
        sorted(names)
    n_states = 2 if kind == "lstm" else 1
    s0 = [_x((2 * (1 + bi), N, H), seed=20 + k) for k in range(n_states)]
    got = {}
    for pkg, layer in ((mx, jl), (mt, tl)):
        arr = (lambda a: mx.nd.array(a)) if pkg is mx else _tnd
        xa = arr(x)
        states = [arr(s) for s in s0]
        for a in [xa] + states:
            a.attach_grad()
        with pkg.autograd.record():
            out, new = layer(xa, states)
            plain = layer(xa)
            loss = (out * out).sum() + sum((s * 3).sum() for s in new) + \
                plain.sum()
        loss.backward()
        got[pkg] = ([out.asnumpy(), plain.asnumpy()] +
                    [s.asnumpy() for s in new],
                    [a.grad.asnumpy() for a in [xa] + states] +
                    [p.grad().asnumpy() for _, p in sorted(
                        layer.collect_params().items())])
    for g, r in zip(got[mt][0], got[mx][0]):
        _close(g, r, FWD, "forward")
    for g, r in zip(got[mt][1], got[mx][1]):
        _close(g, r, GRAD, "gradient")
    assert repr(tl) == repr(jl)


def test_layer_begin_state_follows_the_input_device():
    """Without states the layer makes float32 zeros on the input's device
    (bf16 weights with them run float32 products, as the reference's)."""
    _reset()
    layer = trnn.LSTM(H, layout="NTC")
    layer.initialize(ctx=mt.cpu())
    x = torch.tensor(_x((N, T, C), 1))
    layer(x)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in
               layer.begin_state(N, func=mt.ops.zeros, ctx="cpu"))
    layer.cast("bfloat16")
    out = layer(x.bfloat16())
    assert out.dtype == torch.float32 and out.shape == (N, T, H)
    with mt.cpu():
        states = layer.begin_state(batch_size=N)
    assert [s.shape for s in states] == [(1, N, H)] * 2


def test_hybridized_layer_captures_inputs_and_states(monkeypatch):
    """A hybridized LSTM called as ``layer(x, [h, c])`` goes through
    CachedOp: one graph in predict mode and one pair recorded, each keyed
    on the nested structure, with the eager numbers."""
    from test_torch_train_graph import FakeGraph
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made = []
    ttel.reset()
    _reset()
    layer = trnn.LSTM(H, num_layers=2, layout="NTC", input_size=C)
    layer.initialize(ctx=mt.cpu())
    x = torch.tensor(_x((N, T, C), 2))
    h0, c0 = (torch.tensor(_x((2, N, H), k)) for k in (3, 4))
    with torch.no_grad():
        want_out, want_states = layer(x, [h0, c0])
        want_plain = layer(x)
    layer.hybridize()
    with torch.no_grad():
        out, states = layer(x, [h0, c0])
        plain = layer(x)
        again, _ = layer(x, [h0, c0])
    assert isinstance(states, tuple) and len(states) == 2
    for g, w in ((out, want_out), (plain, want_plain), (again, want_out),
                 (states[0], want_states[0]), (states[1], want_states[1])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert len(layer._cached_op._graphs) == 2
    xa, ha = _tnd(x.numpy()), _tnd(h0.numpy())
    ca = _tnd(c0.numpy())
    for a in (xa, ha, ca):
        a.attach_grad()
    with mt.autograd.record():
        out, (h1, c1) = layer(xa, [ha, ca])
        loss = (out * out).sum() + h1.sum() + (c1 * 2).sum()
    loss.backward()
    grads = [a.grad.asnumpy() for a in (xa, ha, ca)]
    layer.hybridize(False)
    for a in (xa, ha, ca):
        a.attach_grad()
    with mt.autograd.record():
        out, (h1, c1) = layer(xa, [ha, ca])
        loss = (out * out).sum() + h1.sum() + (c1 * 2).sum()
    loss.backward()
    for g, a in zip(grads, (xa, ha, ca)):
        np.testing.assert_allclose(g, a.grad.asnumpy(), rtol=1e-6,
                                   atol=1e-6)
    assert ttel.retrace_stats("cached_op")["compiles"] == 3
    FakeGraph.made = []


# --------------------------------------------- draws, on the port alone
def test_dropout_cell_moments_and_mask_reuse():
    _reset()
    cell = trnn.DropoutCell(0.5)
    x = torch.ones(8, 4096, requires_grad=True)
    with mt.autograd.train_mode():
        y, states = cell(x, [])
        y.sum().backward()
    kept = (y != 0).float().mean().item()
    assert states == [] and abs(kept - 0.5) < 0.02
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 2.0))
    # the backward reuses the forward's mask
    torch.testing.assert_close(x.grad, y.detach())
    with mt.autograd.predict_mode():
        assert torch.equal(cell(x, [])[0], x)


def test_zoneout_cell_keeps_previous_values_at_its_rate():
    _reset()
    base = trnn.RNNCell(512, input_size=16)
    cell = trnn.ZoneoutCell(base, zoneout_outputs=0.3, zoneout_states=0.6)
    cell.initialize(ctx=mt.cpu())
    x = torch.tensor(_x((64, 3, 16), 0))
    with mt.autograd.train_mode():
        outs, _ = cell.unroll(3, x, layout="NTC", merge_outputs=False)
    # step 0 keeps the zero "previous output" where it zones out
    kept0 = (outs[0] == 0).float().mean().item()
    assert abs(kept0 - 0.3) < 0.02
    same = (outs[2] == outs[1]).float().mean().item()
    assert abs(same - 0.3) < 0.03
    with mt.autograd.predict_mode():
        out, _ = cell.unroll(3, x, layout="NTC", merge_outputs=True)
        cell.reset()
        base._modified = False
        ref, _ = base.unroll(3, x, layout="NTC", merge_outputs=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_variational_dropout_reuses_one_mask_per_unroll():
    _reset()
    base = trnn.RNNCell(256, activation="relu", input_size=256,
                        i2h_weight_initializer=mt.init.One(),
                        h2h_weight_initializer=mt.init.Zero())
    cell = tcrnn.VariationalDropoutCell(base, drop_inputs=0.5)
    cell.initialize(ctx=mt.cpu())
    x = torch.ones(4, 3, 256)
    with mt.autograd.train_mode():
        cell.reset()
        states = [torch.zeros(4, 256)]
        masks, outs = [], []
        for t in range(3):
            out, states = cell(x[:, t], states)
            masks.append(cell.drop_inputs_mask)
            outs.append(out)
        first = masks[0]
        cell.reset()
        assert cell.drop_inputs_mask is None
        cell.unroll(3, x, layout="NTC")
        second = cell.drop_inputs_mask
    assert all(m is first for m in masks)
    # relu(ones @ masked x): every step reads the same masked input
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    kept = (first != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.03 and not torch.equal(first, second)
    assert cell._draws and trnn.DropoutCell._draws and trnn.ZoneoutCell._draws


def test_contrib_nn_names():
    from mxtpu_torch.gluon.contrib import nn as cnn
    assert cnn.Identity is mt.gluon.nn.Identity
    assert cnn.HybridConcurrent is mt.gluon.nn.HybridConcurrent
    assert cnn.Concurrent is mt.gluon.nn.Concurrent
    # SparseEmbedding is ported (held to mxtpu in tests/test_torch_sparse.py)
    emb = cnn.SparseEmbedding(4, 4)
    assert emb.weight._grad_stype == "row_sparse"
    assert repr(emb) == "SparseEmbedding(4 -> 4, float32)"
    # SwitchMoE is ported (held to mxtpu in tests/test_torch_moe.py)
    moe = cnn.SwitchMoE(4, 8, 2)
    assert [tuple(p.shape) for p in moe.collect_params().values()] == \
        [(4, 2), (2, 4, 8), (2, 8), (2, 8, 4), (2, 4)]
    # SyncBatchNorm is ported (tests/test_torch_mesh_trainer.py): one
    # process is its own batch, as BatchNorm
    assert issubclass(cnn.SyncBatchNorm, mt.gluon.nn.BatchNorm)
