"""The port's Switch mixture of experts (``mxtpu_torch/parallel/moe.py``,
``gluon.contrib.nn.SwitchMoE``, the ``_contrib_switch_moe`` op and the MoE
``TransformerLM``) against the JAX package's, on the CPU, with the same
seeded numpy inputs.

Tolerances: float32 outputs, aux losses and gradients rtol 1e-5, atol
1e-6 (the reference's one-hot einsums against the port's bmm and
indexing: every sum has one nonzero term, only the experts' matmuls sum
in other orders); the 2-layer MoE LM's float32 logits 1e-4 of
max|logit| and its gradients rtol 1e-4, atol 1e-5 (two layers of
LayerNorm, attention and experts). bfloat16: 2e-2 of max|out| (each side
rounds to bf16 at other places). Slots are compared exactly.

The reference counts a token's slot in its expert's queue in the
input's dtype; in bfloat16 that is exact only up to 256 tokens an expert
(ROADMAP §C). The port counts in int32: ``test_bf16_slots_are_exact``
pins the difference at T 2048, E 2.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.parallel import moe as tmoe

LM = dict(vocab_size=50, dim=16, num_heads=2, num_layers=2, max_len=32)


def _inputs(t, d, h, e, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(t, d).astype(np.float32),
            (rng.randn(d, e) * 0.5).astype(np.float32),
            (rng.randn(e, d, h) * 0.2).astype(np.float32),
            (rng.randn(e, h) * 0.1).astype(np.float32),
            (rng.randn(e, h, d) * 0.2).astype(np.float32),
            (rng.randn(e, d) * 0.1).astype(np.float32)]


def _jax(arrays, dtype="float32"):
    import jax.numpy as jnp
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.25])
def test_switch_ffn_matches_mxtpu(cf):
    from mxtpu.parallel import switch_ffn as jswitch
    arrays = _inputs(32, 8, 16, 4)
    ref, ref_aux = jswitch(*_jax(arrays), capacity_factor=cf)
    out, aux = tmoe.switch_ffn(*_torch(arrays), capacity_factor=cf)
    dense, dense_aux = tmoe.switch_ffn_reference(*_torch(arrays),
                                                 capacity_factor=cf)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    np.testing.assert_allclose(_np(out), _np(dense), rtol=1e-5, atol=1e-6)
    assert float(aux) == float(dense_aux)
    dropped = int((np.abs(_np(out)).sum(1) == 0).sum())
    assert dropped == int((np.abs(np.asarray(ref)).sum(1) == 0).sum())
    if cf == 0.25:
        assert dropped > 0   # over-capacity tokens are zeroed
    if cf == 4.0:
        assert dropped == 0 and float(aux) >= 1.0


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_switch_ffn_gradients_match_mxtpu(cf):
    import jax
    from mxtpu.parallel import switch_ffn as jswitch
    arrays = _inputs(32, 8, 16, 4, seed=1)
    cot = np.random.RandomState(2).randn(32, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jswitch(*a, capacity_factor=cf),
                     *_jax(arrays))
    refs = vjp((cot, np.float32(0.3)))
    leaves = [t.requires_grad_() for t in _torch(arrays)]
    out, aux = tmoe.switch_ffn(*leaves, capacity_factor=cf)
    ((out * torch.from_numpy(cot)).sum() + 0.3 * aux).backward()
    for t, ref in zip(leaves, refs):
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_bf16_matches_mxtpu_within_256_tokens_an_expert():
    from mxtpu.parallel import switch_ffn as jswitch
    arrays = _inputs(512, 16, 32, 4, seed=3)   # ~128 tokens an expert
    ref, ref_aux = jswitch(*_jax(arrays, "bfloat16"))
    out, aux = tmoe.switch_ffn(*_torch(arrays, torch.bfloat16))
    ref = np.asarray(ref).astype(np.float32)
    scale = np.abs(ref).max()
    assert np.abs(_np(out) - ref).max() <= 2e-2 * scale
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=2e-2)


def test_bf16_slots_are_exact():
    """At T 2048, E 2 (about 1024 tokens an expert) the reference's
    bfloat16 cumulative sum rounds two tokens to one slot; its bf16 output
    departs from its f32 output, the port's stays with it."""
    from mxtpu.parallel import switch_ffn as jswitch
    arrays = _inputs(2048, 16, 32, 2, seed=4)
    ref32 = np.asarray(jswitch(*_jax(arrays))[0])
    ref16 = np.asarray(jswitch(*_jax(arrays, "bfloat16"))[0]).astype(
        np.float32)
    out16, _ = tmoe.switch_ffn(*_torch(arrays, torch.bfloat16))
    # rows whose routing bf16 leaves as float32 has it (a near tie of the
    # router's logits may flip; no token is dropped at this capacity)
    x, r = _torch(arrays[:2])
    same = (tmoe._route(x, r)[2] ==
            tmoe._route(x.bfloat16(), r.bfloat16())[2]).numpy()
    assert same.mean() > 0.99
    scale = np.abs(ref32).max()
    ref_rows = np.abs(ref16 - ref32).max(1)[same]
    port_rows = np.abs(_np(out16) - ref32).max(1)[same]
    assert (ref_rows > 0.2 * scale).sum() > 256   # the defect
    assert port_rows.max() <= 2e-2 * scale
    # slots: exact int32 queue positions, the same in both dtypes
    x, r = _torch(arrays[:2])
    _, _, e32 = tmoe._route(x, r)
    _, _, e16 = tmoe._route(x.bfloat16(), r.bfloat16())
    for e in (e32, e16):
        slot = tmoe.slots(e, 2).numpy()
        want = np.zeros(2048, np.int64)
        seen = [0, 0]
        for i, k in enumerate(e.numpy()):
            want[i] = seen[k]
            seen[k] += 1
        np.testing.assert_array_equal(slot, want)
        assert slot.dtype == np.int32 and min(seen) > 256


def _load(net_t, net_j, seed=3):
    shapes = {k: p.shape for k, p in net_j.collect_params().items()}
    arrays = convert.seeded_params(shapes, seed=seed)
    for name, p in net_j.collect_params().items():
        p.set_data(mx.nd.array(arrays[name]))
    convert.load_mxtpu_params(net_t, arrays)
    return arrays


def test_switch_moe_layer_matches_mxtpu():
    from mxtpu.gluon.contrib.nn import SwitchMoE as JMoE
    x = np.random.RandomState(5).randn(2, 12, 8).astype(np.float32)
    jnet = JMoE(8, 16, 4, capacity_factor=1.5, prefix="moe_")
    jnet.initialize()
    jnet(mx.nd.array(x))
    tnet = mt.gluon.contrib.nn.SwitchMoE(8, 16, 4, capacity_factor=1.5,
                                         prefix="moe_")
    tnet.initialize(ctx=mt.cpu())
    assert {k: tuple(p.shape) for k, p in tnet.collect_params().items()} \
        == {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    _load(tnet, jnet)
    with mx.autograd.record():
        jo, ja = jnet(mx.nd.array(x))
        jl = (jo * jo).sum() + 0.01 * ja
    jl.backward()
    xt = mt.nd.array(x, ctx=mt.cpu())
    with mt.autograd.record():
        to, ta = tnet(xt)
        tl = (to * to).sum() + 0.01 * ta
    tl.backward()
    assert to.shape == (2, 12, 8)
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta.asnumpy()), float(ja.asnumpy()),
                               rtol=1e-5)
    for (n, pj), pt in zip(jnet.collect_params().items(),
                           tnet.collect_params().values()):
        np.testing.assert_allclose(pt.grad().asnumpy(), pj.grad().asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="last axis 6"):
        tnet(mt.nd.array(np.zeros((2, 6), np.float32), ctx=mt.cpu()))
    with pytest.raises(ValueError, match="last axis 6"):
        jnet(mx.nd.array(np.zeros((2, 6), np.float32)))
    assert repr(tnet) == repr(jnet)


def test_contrib_switch_moe_on_nd_and_sym():
    from mxtpu.parallel import switch_ffn as jswitch
    arrays = _inputs(24, 8, 16, 4, seed=6)
    data = arrays[0].reshape(2, 12, 8)
    ref, ref_aux = jswitch(*_jax([arrays[0]] + arrays[1:]), 2.0)
    nd = [mt.nd.array(a, ctx=mt.cpu()) for a in [data] + arrays[1:]]
    out, aux = mt.nd._contrib_switch_moe(*nd, capacity_factor=2.0)
    out2, _ = mt.nd.switch_moe(*nd, capacity_factor=2.0)
    np.testing.assert_allclose(out.asnumpy().reshape(24, 8), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out.asnumpy(), out2.asnumpy())
    np.testing.assert_allclose(float(aux.asnumpy()), float(ref_aux),
                               rtol=1e-5)
    names = ["data", "router", "w1", "b1", "w2", "b2"]
    sym = mt.sym._contrib_switch_moe(*[mt.sym.var(n) for n in names],
                                     capacity_factor=2.0)
    assert len(sym.list_outputs()) == 2
    exe = sym.bind(mt.cpu(), args=dict(zip(names, nd)))
    got = exe.forward()
    np.testing.assert_allclose(got[0].asnumpy(), out.asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(got[1].asnumpy(), aux.asnumpy(), rtol=1e-6)
    assert mt.ops.get_op("switch_moe") is mt.ops.get_op("_contrib_switch_moe")


def _lms(hybrid, causal=True, experts=4):
    from mxtpu.gluon.model_zoo.transformer import TransformerLM as JLM
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM as TLM
    tokens = np.random.RandomState(7).randint(0, LM["vocab_size"], (2, 16))
    jnet = JLM(causal=causal, num_experts=experts, **LM)
    jnet.initialize()
    jnet(mx.nd.array(tokens, dtype="int32"))
    tnet = TLM(causal=causal, num_experts=experts, **LM)
    tnet.initialize(ctx=mt.cpu())
    with torch.no_grad():
        tnet(torch.zeros(1, 8, dtype=torch.int32))
    _load(tnet, jnet)
    if hybrid:
        tnet.hybridize()
    return jnet, tnet, tokens


def _lm_step(pkg, net, tokens, labels):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    ctx = {} if pkg is mx else {"ctx": mt.cpu()}
    with pkg.autograd.record():
        logits = net(pkg.nd.array(tokens, dtype="int32", **ctx))
        ce = loss_fn(logits.reshape((-1, LM["vocab_size"])),
                     pkg.nd.array(labels, **ctx).reshape((-1,)))
        aux = net.aux_loss()
        loss = (ce + 0.01 * aux).mean()
    loss.backward()
    return logits.asnumpy(), float(aux.asnumpy()), {
        n.partition("_")[2]: p.grad().asnumpy()
        for n, p in net.collect_params().items()}


@pytest.fixture
def captured(monkeypatch):
    """Captures on the CPU through the captured-training tests' stand-in
    for ``CapturedGraph``."""
    from mxtpu_torch import graphs
    from test_torch_train_graph import FakeGraph
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    monkeypatch.setattr(graphs, "captures", lambda device: True)
    FakeGraph.made = []
    yield FakeGraph
    FakeGraph.made = []


class _Axis:
    """A stand-in for a ``MeshAxis``: no collective runs before the checks
    these tests reach."""

    def __init__(self, size, index=0):
        self.size, self.index = size, index


def test_axes_of_one_rank_are_the_plain_switch_ffn():
    args = _torch(_inputs(32, 8, 16, 4))
    out, aux = tmoe.switch_ffn(*args)
    one, one_aux = tmoe.switch_ffn(*args, expert_axis=_Axis(1),
                                   data_axis=_Axis(1))
    assert torch.equal(out, one) and torch.equal(aux, one_aux)


def test_expert_parallel_refuses_a_capture(monkeypatch):
    """Its collectives run outside any captured graph, as the ring's and
    ``read_whole``'s do; the plain layer captures."""
    from mxtpu_torch import graphs
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    args = _torch(_inputs(32, 8, 16, 4))
    for axes in ({"expert_axis": _Axis(2)}, {"data_axis": _Axis(2)}):
        with pytest.raises(mt.MXNetError, match="captured graph"):
            tmoe.switch_ffn(*args, **axes)
    out, _ = tmoe.switch_ffn(*args, expert_axis=_Axis(1))
    assert out.shape == (32, 8)


@pytest.mark.parametrize("causal", [True, False])
def test_moe_transformer_matches_mxtpu_eager(causal):
    jnet, tnet, tokens = _lms(False, causal)
    labels = np.random.RandomState(8).randint(0, LM["vocab_size"], (2, 16))
    jl, ja, jg = _lm_step(mx, jnet, tokens, labels)
    tl, ta, tg = _lm_step(mt, tnet, tokens, labels)
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    assert ta >= 1.0
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_moe_router_gradient_captured_matches_mxtpu(captured):
    """A hybridized MoE LM records a captured pair whose second output is
    the aux loss, so 0.01 * aux reaches the router's gradient."""
    jnet, tnet, tokens = _lms(True)
    labels = np.random.RandomState(8).randint(0, LM["vocab_size"], (2, 16))
    jl, ja, jg = _lm_step(mx, jnet, tokens, labels)
    tl, ta, tg = _lm_step(mt, tnet, tokens, labels)
    assert len(captured.made) == 2   # the pair's forward and backward
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    routers = [k for k in jg if k.endswith("moe_router")]
    assert len(routers) == LM["num_layers"]
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # without the aux term the router's gradient is another one
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.autograd.record():
        logits = tnet(mt.nd.array(tokens, dtype="int32", ctx=mt.cpu()))
        loss_fn(logits.reshape((-1, LM["vocab_size"])),
                mt.nd.array(labels, ctx=mt.cpu()).reshape((-1,))).mean() \
            .backward()
    p = [p for n, p in tnet.collect_params().items()
         if n.endswith(routers[0].partition("_")[2])][0]
    assert np.abs(p.grad().asnumpy() - tg[routers[0]]).max() > 1e-6


def test_aux_loss_errors_and_the_dense_model():
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM as TLM
    net = TLM(num_experts=2, **LM)
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="before any forward"):
        net.aux_loss()
    from mxtpu.gluon.model_zoo.transformer import TransformerLM as JLM
    jnet = JLM(num_experts=2, **LM)
    jnet.initialize()
    with pytest.raises(mx.MXNetError, match="before any forward"):
        jnet.aux_loss()
    # read inside another block's capture: the capture's value, stale
    from mxtpu_torch import graphs
    graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
    try:
        with torch.no_grad():
            net(torch.zeros(1, 8, dtype=torch.int32))
    finally:
        graphs._STATE.depth -= 1
    with pytest.raises(mt.MXNetError, match="stale trace-time value"):
        net.aux_loss()
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    assert float(net.aux_loss()) >= 1.0
    dense = TLM(**LM)
    dense.initialize(ctx=mt.cpu())
    assert dense.aux_loss() == 0.0


def test_parallel_rules_are_the_references():
    from mxtpu.gluon.model_zoo import transformer as jtr
    from mxtpu_torch.gluon.model_zoo import transformer as ttr
    for fn, axis in (("tensor_parallel_rules", "m"),
                     ("expert_parallel_rules", "e")):
        got = getattr(ttr, fn)(axis)
        want = getattr(jtr, fn)(axis)
        assert [(p, tuple(s)) for p, s in got] == \
            [(p, tuple(s)) for p, s in want]
        assert all(isinstance(s, mt.parallel.P) for _, s in got)


class _Mesh:
    """A mesh as ``shard_experts`` reads it: ``.shape`` and ``axis``."""

    def __init__(self, index, **shape):
        self.shape = shape
        self._index = index

    def axis(self, name):
        from mxtpu_torch.parallel.mesh import MeshAxis
        return MeshAxis(name, self.shape[name], self._index, None, [])


def test_shard_experts_like_mxtpu():
    import jax
    from jax.sharding import Mesh
    from mxtpu.parallel import shard_experts as jshard
    arrays = _inputs(8, 8, 16, 4, seed=9)
    params = {"router": arrays[1], "w1": arrays[2], "b1": arrays[3],
              "w2": arrays[4], "b2": arrays[5]}
    jmesh = Mesh(np.array(jax.devices()[:2]), ("expert",))
    placed = jshard(dict(zip(params, _jax(list(params.values())))), jmesh,
                    num_experts=4)
    for index in (0, 1):
        got = tmoe.shard_experts(params, _Mesh(index, expert=2), 4)
        for k, v in got.items():
            shard = placed[k].addressable_shards[index]
            np.testing.assert_array_equal(v, np.asarray(shard.data))
    # a (D, E) router whose D divides the axis stays whole: the count is
    # explicit
    router = {"router": np.zeros((8, 4), np.float32)}
    assert tmoe.shard_experts(router, _Mesh(1, expert=2), 4)["router"] \
        .shape == (8, 4)
    with pytest.raises(mt.MXNetError, match="no 'expert' axis"):
        tmoe.shard_experts(params, _Mesh(0, data=2), 4)
    with pytest.raises(mt.MXNetError, match="must divide"):
        tmoe.shard_experts(params, _Mesh(0, expert=3), 4)


def test_seeded_moe_and_stacked_params_carry_by_name():
    from mxtpu_torch.gluon.model_zoo.transformer import TransformerLM as TLM
    net = TLM(num_experts=4, **LM)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 8, dtype=torch.int32))
    shapes = {k: p.shape for k, p in net.collect_params().items()}
    moe = sorted(k.rpartition("moe_")[2] for k in shapes if "moe_" in k)
    assert moe == sorted(["router", "w1", "b1", "w2", "b2"] * 2)
    arrays = convert.seeded_params(shapes, seed=1)
    convert.load_mxtpu_params(net, arrays)
    for k, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), arrays[k])
    w1 = [k for k in shapes if k.endswith("moe_w1")][0]
    assert tuple(shapes[w1]) == (4, LM["dim"], 4 * LM["dim"])
    stacked = convert.seeded_params({"w": (8, 16, 16), "b": (8, 16)}, seed=2)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in stacked.values())
    assert stacked["w"].shape == (8, 16, 16)
