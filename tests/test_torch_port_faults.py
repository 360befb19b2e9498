"""Places where the port once differed from the JAX package, each held to
``mxtpu`` on the same seeded numpy inputs:

* ``sign`` keeps NaN and the sign of zero (``jnp.sign``);
* the keywords the reference's ops accept (cuDNN tuning, ``output_mean_var``,
  Embedding's ``dtype``/``sparse_grad``, reshape's ``reverse`` and others);
* ``BatchNorm`` in autograd training mode normalizes by the batch
  statistics and the Gluon layer moves its running statistics;
* Gluon blocks take and return NDArrays, and ``Parameter.data()`` /
  ``grad()`` are NDArrays that ``autograd.backward`` fills;
* C8: the registry's lower-case aliases (``mx.nd.convolution`` ...);
* C9: the initializers, held by shapes and by moments against the
  reference's scale formulas (the draws differ from JAX's keys), and
  exactly where they are deterministic;
* C10: ``Context``, the ``with ctx:`` scope that ``current_context()`` and
  the array constructors read, and ``num_gpus()``;
* C11: ``Conv2D(activation=)``;
* C12: ``Block(params=)`` sharing another block's parameters,
  ``ParameterDict(shared=)``, ``get_constant`` and ``gluon.Constant``;
* C14: ``initialize(init, ctx, verbose, force_reinit, *, generator)``;
* C15: ``ParameterDict.setattr`` freezing layers (eager and captured) and
  scaling ``lr_mult``;
* C16: the reference's public names, ``dir()`` of ``mx``, ``mx.nd``,
  ``mx.gluon``, ``mx.ops``, ``mx.parallel`` and ``mx.kvstore`` against
  the port's, less the names still queued (ROADMAP A8's second part, A9,
  A10).

Tolerances: float32 forward rtol=atol=1e-5 and gradients 1e-4, the
reference's f32 conv tolerances (tests/test_pallas_conv.py). The JAX side
runs its plain XLA paths (no Pallas env levers are set); the port's
kernel wrappers run their plain versions on CPU tensors.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.base import MXNetError

FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL", "MXTPU_BN_ONEPASS"):
        monkeypatch.delenv(var, raising=False)


def _rng(seed):
    return np.random.RandomState(seed)


def _nd(a):
    return mt.nd.array(np.asarray(a, np.float32), ctx=mt.cpu())


def _close(got, ref, tol):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    ref = ref.asnumpy() if hasattr(ref, "asnumpy") else np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


# ------------------------------------------------------------------- sign
def test_sign_keeps_nan_and_signed_zero():
    x = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -2.5, 3.0, -1e-30],
                 np.float32)
    ref = mx.nd.sign(mx.nd.array(x)).asnumpy()
    got = mt.nd.sign(_nd(x)).asnumpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))
    np.testing.assert_array_equal(got[~np.isnan(ref)], ref[~np.isnan(ref)])


def test_sign_gradient_is_zero():
    x = _nd([-0.0, 0.0, 2.0, -3.0])
    x.attach_grad()
    with mt.autograd.record():
        y = mt.nd.sign(x)
    y.backward()
    np.testing.assert_array_equal(np.signbit(y.asnumpy()),
                                  [True, False, False, True])
    np.testing.assert_array_equal(x.grad.asnumpy(), np.zeros(4, np.float32))


# --------------------------------------------------------------- keywords
def _conv_args(seed):
    r = _rng(seed)
    return (r.randn(2, 3, 7, 7).astype(np.float32),
            r.randn(4, 3, 3, 3).astype(np.float32),
            r.randn(4).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(workspace=512),
                                dict(cudnn_tune="fastest"),
                                dict(cudnn_off=True)],
                         ids=["workspace", "cudnn_tune", "cudnn_off"])
def test_convolution_accepts_cudnn_keywords(kw):
    x, w, b = _conv_args(1)
    args = dict(kernel=(3, 3), pad=(1, 1), num_filter=4, **kw)
    ref = mx.nd.Convolution(*map(mx.nd.array, (x, w, b)), **args)
    got = mt.nd.Convolution(*map(_nd, (x, w, b)), **args)
    _close(got, ref, FWD)


@pytest.mark.parametrize("kw", [dict(cudnn_off=True), dict(p_value=2)],
                         ids=["cudnn_off", "p_value"])
def test_pooling_accepts_reference_keywords(kw):
    x = _rng(2).randn(2, 3, 8, 8).astype(np.float32)
    args = dict(kernel=(2, 2), stride=(2, 2), pool_type="max", **kw)
    _close(mt.nd.Pooling(_nd(x), **args),
           mx.nd.Pooling(mx.nd.array(x), **args), FWD)


def _bn_args(seed, c=6):
    r = _rng(seed)
    return (r.randn(4, c, 5, 5).astype(np.float32),
            (r.rand(c) + 0.5).astype(np.float32),
            (r.randn(c) * 0.1).astype(np.float32),
            (r.randn(c) * 0.1).astype(np.float32),
            (r.rand(c) + 0.5).astype(np.float32))


@pytest.mark.parametrize("training", [False, True], ids=["predict", "train"])
def test_batchnorm_output_mean_var_matches_mxtpu(training):
    arrays = _bn_args(3)
    kw = dict(eps=1e-3, fix_gamma=False, output_mean_var=True,
              cudnn_off=True)
    scope = (mx.autograd.train_mode, mt.autograd.train_mode) if training \
        else (mx.autograd.predict_mode, mt.autograd.predict_mode)
    with scope[0]():
        ref = mx.nd.BatchNorm(*map(mx.nd.array, arrays), **kw)
    with scope[1]():
        got = mt.nd.BatchNorm(*map(_nd, arrays), **kw)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _close(g, r, FWD)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layernorm_output_mean_var_matches_mxtpu(axis):
    r = _rng(4)
    x = r.randn(3, 5, 7).astype(np.float32)
    n = x.shape[axis]
    g, b = (r.rand(n) + 0.5).astype(np.float32), r.randn(n).astype(np.float32)
    ref = mx.nd.LayerNorm(*map(mx.nd.array, (x, g, b)), axis=axis,
                          output_mean_var=True)
    got = mt.nd.LayerNorm(*map(_nd, (x, g, b)), axis=axis,
                          output_mean_var=True)
    assert len(got) == len(ref) == 3
    assert got[1].shape == ref[1].shape == tuple(
        s for i, s in enumerate(x.shape) if i != axis % 3)
    for gt, rf in zip(got, ref):
        _close(gt, rf, FWD)


def test_embedding_accepts_dtype_and_sparse_grad():
    r = _rng(5)
    ids = r.randint(0, 10, (3, 4)).astype(np.float32)
    w = r.randn(10, 6).astype(np.float32)
    kw = dict(input_dim=10, output_dim=6, dtype="float32", sparse_grad=True)
    _close(mt.nd.Embedding(_nd(ids), _nd(w), **kw),
           mx.nd.Embedding(mx.nd.array(ids), mx.nd.array(w), **kw), 0)


@pytest.mark.parametrize("shape,reverse", [
    ((-3, 0), True), ((10, -1), True), ((0, 0, -1), True),
    ((-1, 0), False), ((-4, 2, -1, 0, 0), False)])
def test_reshape_reverse_and_extra_keywords_match_mxtpu(shape, reverse):
    x = _rng(6).randn(10, 5, 4).astype(np.float32)
    ref = mx.nd.reshape(mx.nd.array(x), shape=shape, reverse=reverse,
                        target_shape=None)
    got = mt.nd.reshape(_nd(x), shape=shape, reverse=reverse,
                        target_shape=None)
    _close(got, ref, 0)


@pytest.mark.parametrize("shape", [(-1, 0), (0, -1), (-4, 2, -1, 0, 0)])
def test_reshape_reverse_refuses_where_mxnet_reads_otherwise(shape):
    """MXNet reads the codes right to left under ``reverse``; the JAX
    package ignores it. Where the two readings differ the port raises."""
    with pytest.raises(MXNetError, match="reverse"):
        mt.nd.reshape(_nd(np.zeros((10, 5, 4))), shape=shape, reverse=True)


# -------------------------------------------------- BatchNorm batch stats
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_training_matches_mxtpu_with_gradients(fix_gamma):
    """Under record(): the batch statistics (one-pass form), the output
    and the input, gamma and beta gradients."""
    x, g, b, mm, mv = _bn_args(7)
    head = _rng(8).randn(*x.shape).astype(np.float32)

    def run(pkg, mk):
        xs, gs, bs = mk(x), mk(g), mk(b)
        for a in (xs, gs, bs):
            a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.BatchNorm(xs, gs, bs, mk(mm), mk(mv), eps=1e-3,
                                   fix_gamma=fix_gamma)
            loss = (out * mk(head)).sum()
        loss.backward()
        return out, xs.grad, gs.grad, bs.grad

    ref = run(mx, mx.nd.array)
    got = run(mt, _nd)
    _close(got[0], ref[0], FWD)
    for gt, rf in zip(got[1:], ref[1:]):
        _close(gt, rf, GRAD)
    # the batch statistics, not the moving ones
    moving = mt.nd.BatchNorm(*map(_nd, (x, g, b, mm, mv)), eps=1e-3,
                             fix_gamma=fix_gamma)
    assert np.abs(got[0].asnumpy() - moving.asnumpy()).max() > 0.1


def test_batchnorm_use_global_stats_keeps_moving_statistics():
    arrays = _bn_args(9)
    with mt.autograd.record():
        got = mt.nd.BatchNorm(*map(_nd, arrays), use_global_stats=True,
                              output_mean_var=True)
    with mx.autograd.record():
        ref = mx.nd.BatchNorm(*map(mx.nd.array, arrays),
                              use_global_stats=True, output_mean_var=True)
    for g, r in zip(got, ref):
        _close(g, r, FWD)
    _close(got[1], arrays[3], 0)     # the moving mean, as given
    with mt.autograd.predict_mode():
        _close(mt.nd.BatchNorm(*map(_nd, arrays)), ref[0], FWD)


def _bn_layers(seed):
    with mx.layout("NHWC"):
        jbn = mx.gluon.nn.BatchNorm(momentum=0.8, in_channels=6)
    with mt.layout("NHWC"):
        bn = mt.gluon.nn.BatchNorm(momentum=0.8, in_channels=6)
    jbn.initialize()
    bn.initialize(ctx=mt.cpu())
    r = _rng(seed)
    for jp, p in zip(jbn.collect_params().values(),
                     bn.collect_params().values()):
        a = (r.rand(6) + 0.5).astype(np.float32)
        jp.set_data(mx.nd.array(a))
        p.set_data(a)
    return jbn, bn


def test_batchnorm_layer_moving_statistics_after_two_steps():
    jbn, bn = _bn_layers(10)
    r = _rng(11)
    for step in range(2):
        x = (r.randn(4, 3, 3, 6) * (step + 1) + step).astype(np.float32)
        with mx.autograd.record():
            jout = jbn(mx.nd.array(x))
        with mt.autograd.record():
            out = bn(_nd(x))
        _close(out, jout, FWD)
    for name in ("running_mean", "running_var"):
        _close(getattr(bn, name).data(), getattr(jbn, name).data(), FWD)
    # a predict-mode call reads the moving statistics and moves nothing
    before = bn.running_mean.data().asnumpy().copy()
    x = r.randn(2, 3, 3, 6).astype(np.float32)
    _close(bn(_nd(x)), jbn(mx.nd.array(x)), FWD)
    np.testing.assert_array_equal(bn.running_mean.data().asnumpy(), before)


# ------------------------------------------------------ Gluon on NDArrays
def _load_same(jnet, net, seed):
    """Seeded weights into both nets (shapes settled already)."""
    params = jnet.collect_params()
    arrays = convert.seeded_params({k: p.shape for k, p in params.items()},
                                   seed=seed)
    for k, p in params.items():
        p.set_data(mx.nd.array(arrays[k]))
    convert.load_mxtpu_params(net, arrays)


def _train_step(pkg, net, x, head, mk):
    with pkg.autograd.record():
        out = net(mk(x))
        loss = (out * mk(head)).sum()
    loss.backward()
    return out


def _grads(net):
    return {k.partition("_")[2]: p.grad().asnumpy()
            for k, p in net.collect_params().items() if p.grad_req != "null"}


def _check_grads(net, jnet, tol=GRAD):
    got, ref = _grads(net), _grads(jnet)
    assert got.keys() == ref.keys() and got
    for k in ref:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol * scale,
                                   err_msg=k)


def _dense_pair():
    jnet = mx.gluon.nn.Dense(4, in_units=3)
    net = mt.gluon.nn.Dense(4, in_units=3)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load_same(jnet, net, 12)
    return jnet, net


def test_dense_on_ndarrays_matches_mxtpu():
    jnet, net = _dense_pair()
    r = _rng(13)
    x, head = r.randn(5, 3).astype(np.float32), r.randn(5, 4).astype(
        np.float32)
    jout = _train_step(mx, jnet, x, head, mx.nd.array)
    out = _train_step(mt, net, x, head, _nd)
    assert isinstance(out, mt.nd.NDArray) and out.shape == (5, 4)
    _close(out, jout, FWD)
    _check_grads(net, jnet)
    # outside record() nothing is taped and the grads stay as they are
    y = net(_nd(x))
    assert not y.to_torch().requires_grad
    _check_grads(net, jnet)


def test_grad_req_add_accumulates_and_zero_grad_clears():
    jnet, net = _dense_pair()
    r = _rng(14)
    for p in list(jnet.collect_params().values()):
        p.grad_req = "add"
    for p in net.collect_params().values():
        p.grad_req = "add"
    for _ in range(3):
        x, head = r.randn(5, 3).astype(np.float32), r.randn(5, 4).astype(
            np.float32)
        _train_step(mx, jnet, x, head, mx.nd.array)
        _train_step(mt, net, x, head, _nd)
    _check_grads(net, jnet)
    net.collect_params().zero_grad()
    assert all(not np.any(g) for g in _grads(net).values())
    net.weight.grad_req = "null"
    with pytest.raises(MXNetError, match="grad_req='null'"):
        net.weight.grad()


def test_parameter_data_is_the_module_tensor_across_set_data_and_cast():
    net = mt.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=mt.cpu())
    d = net.weight.data()
    assert d.to_torch() is dict(net.named_parameters())["weight"]
    assert net.weight.list_data()[0] is d
    net.weight.set_data(np.ones((4, 3), np.float32))
    assert net.weight.data() is d     # one NDArray, rebound
    assert d.to_torch() is dict(net.named_parameters())["weight"]
    np.testing.assert_array_equal(d.asnumpy(), np.ones((4, 3)))
    # a write through the array goes to the parameter
    d[:] = 2.0
    np.testing.assert_array_equal(
        dict(net.named_parameters())["weight"].detach().numpy(),
        np.full((4, 3), 2.0))
    net.cast("bfloat16")
    assert net.weight.grad().to_torch().dtype == torch.bfloat16
    x = _nd(np.ones((2, 3))).astype("bfloat16")
    with mt.autograd.record():
        y = net(x)
    y.backward()
    assert net.weight.grad().to_torch().dtype == torch.bfloat16
    np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                  np.full((4, 3), 2.0))
    net.collect_params().reset_ctx(mt.cpu())
    assert net.weight.data().to_torch() is \
        dict(net.named_parameters())["weight"]


def test_conv2d_on_ndarrays_matches_mxtpu():
    with mx.layout("NHWC"):
        jnet = mx.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3)
    with mt.layout("NHWC"):
        net = mt.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load_same(jnet, net, 15)
    r = _rng(16)
    x, head = r.randn(2, 9, 9, 3).astype(np.float32), r.randn(
        2, 9, 9, 8).astype(np.float32)
    jout = _train_step(mx, jnet, x, head, mx.nd.array)
    out = _train_step(mt, net, x, head, _nd)
    _close(out, jout, FWD)
    _check_grads(net, jnet)


def test_batchnorm_layer_on_ndarrays_gradients_match_mxtpu():
    jbn, bn = _bn_layers(17)
    r = _rng(18)
    x, head = r.randn(4, 3, 3, 6).astype(np.float32), r.randn(
        4, 3, 3, 6).astype(np.float32)
    _close(_train_step(mt, bn, x, head, _nd),
           _train_step(mx, jbn, x, head, mx.nd.array), FWD)
    _check_grads(bn, jbn)


@pytest.fixture(scope="module")
def resnet18_pair():
    from mxtpu.gluon.model_zoo import vision as jvision
    from mxtpu_torch.gluon.model_zoo import vision as tvision
    with mx.layout("NHWC"):
        jnet = jvision.resnet18_v1(classes=10, thumbnail=True)
    with mt.layout("NHWC"):
        net = tvision.resnet18_v1(classes=10, thumbnail=True)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    zeros = np.zeros((1, 32, 32, 3), np.float32)
    jnet(mx.nd.array(zeros))
    net(_nd(zeros))
    _load_same(jnet, net, 19)
    return jnet, net


def test_resnet18_thumbnail_trains_on_ndarrays_like_mxtpu(resnet18_pair):
    """One recorded forward and backward of a thumbnail resnet18_v1 (10
    classes, 32x32, NHWC, training-mode BatchNorm) through both packages:
    logits, every parameter's gradient and the moving statistics."""
    jnet, net = resnet18_pair
    r = _rng(20)
    x = r.randn(2, 32, 32, 3).astype(np.float32)
    head = r.randn(2, 10).astype(np.float32)
    jout = _train_step(mx, jnet, x, head, mx.nd.array)
    out = _train_step(mt, net, x, head, _nd)
    assert isinstance(out, mt.nd.NDArray) and out.shape == (2, 10)
    _close(out, jout, FWD)
    _check_grads(net, jnet)
    ours = {k.partition("_")[2]: p.data().asnumpy()
            for k, p in net.collect_params().items()
            if k.endswith(("running_mean", "running_var"))}
    theirs = {k.partition("_")[2]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()
              if k.endswith(("running_mean", "running_var"))}
    assert ours.keys() == theirs.keys() and ours
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=FWD, atol=FWD,
                                   err_msg=k)
    # the tensor path is untouched: a tensor in, a tensor out
    with torch.no_grad():
        t = net(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor)


# ------------------------------------------------------------ C8: aliases
def _alias_case(name, r):
    x4 = r.randn(2, 3, 6, 6).astype(np.float32)
    x2 = r.randn(4, 5).astype(np.float32)
    if name == "convolution":
        w, b = r.randn(4, 3, 3, 3).astype(np.float32), r.randn(4).astype(
            np.float32)
        return (x4, w, b), dict(kernel=(3, 3), num_filter=4, pad=(1, 1))
    if name == "fully_connected":
        w, b = r.randn(3, 5).astype(np.float32), r.randn(3).astype(
            np.float32)
        return (x2, w, b), dict(num_hidden=3)
    if name == "pooling":
        return (x4,), dict(kernel=(2, 2), stride=(2, 2), pool_type="max")
    if name == "activation":
        return (x2,), dict(act_type="tanh")
    if name == "batch_norm":
        c = [r.rand(3).astype(np.float32) + 0.5 for _ in range(4)]
        return (x4, *c), dict(fix_gamma=False, eps=1e-5)
    g, b = r.rand(5).astype(np.float32), r.randn(5).astype(np.float32)
    return (x2, g, b), dict(axis=-1)


@pytest.mark.parametrize("name", ["convolution", "fully_connected",
                                  "pooling", "activation", "batch_norm",
                                  "layer_norm"])
def test_lower_case_op_aliases_match_mxtpu(name):
    """C8: mx.nd's lower-case names of the six nn ops."""
    args, kw = _alias_case(name, _rng(30))
    ref = getattr(mx.nd, name)(*[mx.nd.array(a) for a in args], **kw)
    got = getattr(mt.nd, name)(*[_nd(a) for a in args], **kw)
    _close(got, ref, FWD)


# -------------------------------------------------------- C9: initializers
def _init_param(pkg, init, shape, name="fc_weight"):
    p = pkg.gluon.Parameter(name, shape=shape)
    if pkg is mt:
        p.initialize(init=init, ctx=mt.cpu())
    else:
        p.initialize(init=init)
    return p.data().asnumpy()


def _xavier_scale(shape, factor_type, magnitude):
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    factor = {"in": fan_in, "out": fan_out}.get(factor_type,
                                                (fan_in + fan_out) / 2.0)
    return np.sqrt(magnitude / factor)


XAVIER = [(rnd, fac) for rnd in ("uniform", "gaussian")
          for fac in ("in", "out", "avg")]


@pytest.mark.parametrize("rnd_type,factor_type", XAVIER,
                         ids=["%s-%s" % c for c in XAVIER])
def test_xavier_moments_match_mxtpu(rnd_type, factor_type):
    """C9: Xavier's scale sqrt(magnitude / factor) for every rnd_type and
    factor_type: both packages' draws have the formula's standard
    deviation (uniform: scale / sqrt(3)) and mean 0, within 4%."""
    shape = (64, 32, 3, 3)
    scale = _xavier_scale(shape, factor_type, 2.0)
    want = scale / np.sqrt(3.0) if rnd_type == "uniform" else scale
    for pkg in (mt, mx):
        a = _init_param(pkg, pkg.init.Xavier(rnd_type, factor_type, 2),
                        shape)
        assert a.shape == shape and a.dtype == np.float32
        assert abs(a.std() / want - 1) < 0.04, (pkg.__name__, a.std())
        assert abs(a.mean()) < 0.04 * want
        if rnd_type == "uniform":
            assert np.abs(a).max() <= scale * (1 + 1e-6)


@pytest.mark.parametrize("kind", ["normal", "msraprelu", "uniform",
                                  "xavier_1d", "orthogonal"])
def test_random_initializers_moments_match_mxtpu(kind):
    """C9: Normal(sigma), MSRAPrelu (gaussian Xavier of magnitude
    2 / (1 + slope^2)), Uniform, Xavier on a 1-D parameter (U(-0.07,
    0.07)) and Orthogonal (rows orthonormal times ``scale``): shapes and
    moments in both packages."""
    for pkg in (mt, mx):
        if kind == "normal":
            a = _init_param(pkg, pkg.init.Normal(0.02), (300, 200))
            assert abs(a.std() / 0.02 - 1) < 0.03 and abs(a.mean()) < 1e-3
        elif kind == "msraprelu":
            shape = (64, 48, 3, 3)
            want = _xavier_scale(shape, "avg", 2.0 / (1 + 0.25 ** 2))
            a = _init_param(pkg, pkg.init.MSRAPrelu(), shape)
            assert abs(a.std() / want - 1) < 0.04
        elif kind == "uniform":
            a = _init_param(pkg, pkg.init.Uniform(0.3), (400, 100))
            assert np.abs(a).max() <= 0.3 and \
                abs(a.std() / (0.3 / np.sqrt(3)) - 1) < 0.03
        elif kind == "xavier_1d":
            a = _init_param(pkg, pkg.init.Xavier(), (5000,), "fc_weight")
            assert np.abs(a).max() <= 0.07 and \
                abs(a.std() / (0.07 / np.sqrt(3)) - 1) < 0.05
        else:
            a = _init_param(pkg, pkg.init.Orthogonal(scale=1.5), (16, 40))
            np.testing.assert_allclose(a @ a.T, 2.25 * np.eye(16),
                                       atol=1e-4)
            b = _init_param(pkg, pkg.init.Orthogonal(rand_type="normal"),
                            (30, 3, 2, 2))
            assert b.shape == (30, 3, 2, 2)
            flat = b.reshape(30, 12)
            np.testing.assert_allclose(flat.T @ flat,
                                       1.414 ** 2 * np.eye(12), atol=1e-4)


def test_deterministic_initializers_equal_mxtpu():
    """C9: Constant, Bilinear, LSTMBias and Mixed's routing give the
    reference's values exactly; the name rules still send *bias to 0 and
    *gamma to 1."""
    cases = [(lambda pkg: pkg.init.Constant(0.25), (3, 4), "fc_weight"),
             (lambda pkg: pkg.init.Bilinear(), (2, 3, 4, 4), "up_weight"),
             (lambda pkg: pkg.init.Bilinear(), (1, 1, 5, 5), "up_weight"),
             (lambda pkg: pkg.init.LSTMBias(2.0), (16,), "lstm_i2h_bias")]
    for make, shape, name in cases:
        got = _init_param(mt, make(mt), shape, name)
        ref = _init_param(mx, make(mx), shape, name)
        np.testing.assert_array_equal(got, ref)
    mixed = [(pkg, pkg.init.Mixed([".*alpha", ".*"],
                                  [pkg.init.Constant(1.0),
                                   pkg.init.Constant(2.0)]))
             for pkg in (mt, mx)]
    for name, want in (("fc_alpha", 1.0), ("fc_weight", 2.0),
                       ("fc_bias", 0.0)):
        got = torch.zeros(2, 3)
        mixed[0][1](mt.init.InitDesc(name), got, torch.Generator())
        ref = mx.nd.zeros((2, 3))
        mixed[1][1](mx.init.InitDesc(name), ref)
        np.testing.assert_array_equal(got.numpy(), ref.asnumpy())
        np.testing.assert_array_equal(got.numpy(), np.full((2, 3), want))
    with pytest.raises(MXNetError, match="did not match"):
        mt.init.Mixed(["^w"], [mt.init.One()])(
            mt.init.InitDesc("bias"), torch.zeros(2), torch.Generator())
    for name, want in (("fc_bias", 0.0), ("bn_gamma", 1.0)):
        np.testing.assert_array_equal(
            _init_param(mt, mt.init.Constant(5.0), (3,), name),
            _init_param(mx, mx.init.Constant(5.0), (3,), name))


def test_initializer_registry_matches_mxtpu():
    """C9: create by name (with keywords) and from dumps(), and register
    for a user's class."""
    for name in ("zeros", "ones", "constant", "uniform", "normal", "xavier",
                 "msraprelu", "orthogonal", "bilinear", "lstmbias"):
        assert type(mt.init.create(name)).__name__ == \
            type(mx.init.create(name)).__name__
    x = mt.init.Xavier("gaussian", "in", 2.5)
    assert x.dumps() == mx.init.Xavier("gaussian", "in", 2.5).dumps()
    back = mt.init.create(x.dumps())
    assert isinstance(back, mt.init.Xavier) and back == x
    assert mt.init.create("normal", sigma=0.5).sigma == 0.5

    @mt.init.register
    class Halves(mt.init.Initializer):
        def _init_weight(self, desc, arr, gen):
            arr.fill_(0.5)
    np.testing.assert_array_equal(
        _init_param(mt, "halves", (2, 2)), np.full((2, 2), 0.5))
    with pytest.raises(MXNetError):
        mt.init.create("no_such_init")


# ---------------------------------------------------------- C10: contexts
def test_context_scope_matches_mxtpu():
    """C10: ``with mx.cpu():`` places arrays on the CPU and is what
    current_context() reads; contexts compare and print as the
    reference's; num_gpus() counts the cards (none on this host)."""
    with mx.cpu():
        ref = mx.nd.zeros((2,))
        jctx = mx.current_context()
    with mt.cpu():
        got = mt.nd.zeros((2,))
        ones = mt.nd.array(np.ones(3, np.float32))
        ctx = mt.current_context()
        with mt.Context("cpu", 1):
            assert mt.current_context() == mt.cpu(1)
        assert mt.current_context() == mt.cpu()
    assert got.context == torch.device("cpu") and ones.context.type == "cpu"
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    assert repr(ctx) == repr(jctx) == "cpu(0)"
    assert ctx == mt.cpu() and ctx.device_type == jctx.device_type
    assert mt.Context("gpu", 1) == mt.gpu(1) and \
        hash(mt.gpu(1)) == hash(mt.Context(mt.gpu(1)))
    assert mt.cpu() == torch.device("cpu") and \
        torch.device("cuda", 1) == mt.gpu(1)
    assert (mt.gpu(1).type, mt.gpu(1).index, mt.cpu().type) == \
        ("cuda", 1, "cpu")
    assert mt.num_gpus() == mx.num_gpus() == 0
    # outside any scope the default is the card; with none, it raises
    assert mt.current_context() == mt.gpu(0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))


# ------------------------------------------------- C11: Conv2D(activation)
def test_conv2d_activation_matches_mxtpu():
    """C11: Conv2D(activation=...) appends the activation."""
    with mx.layout("NHWC"):
        jnet = mx.gluon.nn.Conv2D(4, 3, padding=1, activation="relu",
                                  in_channels=2)
    with mt.layout("NHWC"):
        net = mt.gluon.nn.Conv2D(4, 3, padding=1, activation="relu",
                                 in_channels=2)
    jnet.initialize()
    net.initialize(ctx=mt.cpu())
    _load_same(jnet, net, 31)
    x = _rng(32).randn(2, 5, 5, 2).astype(np.float32)
    got, ref = net(_nd(x)), jnet(mx.nd.array(x))
    _close(got, ref, FWD)
    assert got.asnumpy().min() == 0.0 and got.asnumpy().max() > 0


# ----------------------------------------------------------- C12: sharing
def _shared_pair(pkg):
    d1 = pkg.gluon.nn.Dense(4, in_units=3)
    d2 = pkg.gluon.nn.Dense(4, in_units=3, params=d1.params)
    if pkg is mt:
        d1.initialize(ctx=mt.cpu())
        d2.initialize(ctx=mt.cpu())
    else:
        d1.initialize()
        d2.initialize()
    return d1, d2


def test_parameter_sharing_matches_mxtpu():
    """C12: a block made with another's ``params`` holds the same
    Parameters (one tensor): a step through one moves the other's
    weights, as in the reference."""
    res = {}
    for pkg in (mt, mx):
        d1, d2 = _shared_pair(pkg)
        assert d2.weight is d1.weight and d2.bias is d1.bias
        assert list(d2.collect_params().keys()) == \
            list(d1.collect_params().keys())
        w = np.arange(12, dtype=np.float32).reshape(4, 3) / 10
        d1.weight.set_data(w)
        d1.bias.set_data(np.zeros(4, np.float32))
        x = _arr_for(pkg, np.ones((2, 3), np.float32))
        tr = pkg.gluon.Trainer(d2.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        with pkg.autograd.record():
            loss = (d2(x) * d2(x)).sum()
        loss.backward()
        tr.step(1)
        res[pkg] = (d1.weight.data().asnumpy(), d1(x).asnumpy())
        assert not np.array_equal(res[pkg][0], w)
    _close(res[mt][0], res[mx][0], FWD)
    _close(res[mt][1], res[mx][1], FWD)


def _arr_for(pkg, a):
    return _nd(a) if pkg is mt else mx.nd.array(a)


def test_shared_parameter_dict_and_constants_match_mxtpu():
    """C12: ParameterDict(shared=) hands out the shared dict's parameters
    by name; get_constant and gluon.Constant hold a value with no
    gradient that a forward reads."""
    for pkg in (mt, mx):
        base = pkg.gluon.ParameterDict("m_")
        w = base.get("w", shape=(2, 2))
        child = pkg.gluon.ParameterDict("m_", shared=base)
        assert child.get("w") is w and child.get("v", shape=(3,)) is not w
        c = child.get_constant("c", [1.0, 2.0])
        assert c.grad_req == "null" and child.get_constant("c") is c
        assert isinstance(c, pkg.gluon.Constant)
    net = _ScaledDense(mt)
    jnet = _ScaledDense(mx)
    net.initialize(ctx=mt.cpu())
    jnet.initialize()
    jnet.dense.weight.set_data(mx.nd.array(np.eye(3, dtype=np.float32)))
    net.dense.weight.set_data(np.eye(3, dtype=np.float32))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    _close(net(_nd(x)), jnet(mx.nd.array(x)), FWD)
    np.testing.assert_array_equal(net(_nd(x)).asnumpy(), x * [1, 2, 3])


def _ScaledDense(pkg):
    class ScaledDense(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = pkg.gluon.nn.Dense(3, in_units=3,
                                                use_bias=False)
                self.scale = self.params.get_constant(
                    "scale", np.array([1.0, 2.0, 3.0], np.float32))

        def hybrid_forward(self, F, x, scale):
            return self.dense(x) * scale.reshape((1, 3))
    return ScaledDense()


# ------------------------------------------------------------------ C14-C16
def _c14_net(pkg, **kw):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=3), pkg.gluon.nn.Dense(2,
                                                                in_units=4))
    net.initialize(**kw)
    return net


def test_c14_initialize_takes_verbose_third():
    ref = _c14_net(mx, init=mx.init.Xavier(), verbose=False)
    net = _c14_net(mt, init=mt.init.Xavier(), ctx=mt.cpu(), verbose=True)
    assert [p.shape for p in net.collect_params().values()] == \
        [p.shape for p in ref.collect_params().values()]
    before = [p.data().asnumpy().copy()
              for p in net.collect_params().values()]
    # a third positional argument is verbose: no re-initialization
    net.initialize(mt.init.Zero(), mt.cpu(), True)
    net.collect_params().initialize(mt.init.Zero(), mt.cpu(), False)
    for b, p in zip(before, net.collect_params().values()):
        np.testing.assert_array_equal(p.data().asnumpy(), b)
    # force_reinit is the fourth, generator keyword-only
    net.initialize(mt.init.Zero(), mt.cpu(), False, True)
    assert all(not p.data().asnumpy().any()
               for p in net.collect_params().values())
    with pytest.raises(TypeError):
        net.initialize(None, mt.cpu(), False, True, None)
    net.initialize(mt.init.Uniform(), mt.cpu(), force_reinit=True,
                   generator=torch.Generator().manual_seed(1))
    assert any(p.data().asnumpy().any()
               for p in net.collect_params().values())


def _c15_train(pkg, hybrid, steps=2, freeze=".*dense0.*", **setattrs):
    ctx = {"ctx": mt.cpu()} if pkg is mt else {}
    net = pkg.gluon.nn.HybridSequential(prefix="c15_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(4, in_units=3),
                pkg.gluon.nn.Dense(2, in_units=4))
    net.initialize(**ctx)
    r = np.random.RandomState(0)
    for p in net.collect_params().values():
        p.set_data(pkg.nd.array(r.randn(*p.shape).astype(np.float32), **ctx))
    for name, value in setattrs.items():
        net.collect_params(freeze).setattr(name, value)
    if hybrid:
        net.hybridize()
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    before = {n: p.data().asnumpy().copy()
              for n, p in net.collect_params().items()}
    for _ in range(steps):
        x = pkg.nd.array(r.randn(5, 3).astype(np.float32), **ctx)
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(5)
    return before, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}


@pytest.mark.parametrize("hybrid", [False, True])
def test_c15_setattr_freezes_layers_like_mxtpu(hybrid, monkeypatch):
    if hybrid:   # the captured pair and update through the CPU stand-in
        from mxtpu_torch import graphs
        from test_torch_train_graph import FakeGraph
        monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
        monkeypatch.setattr(graphs, "captures", lambda device: True)
        FakeGraph.made = []
    before, after = _c15_train(mt, hybrid, grad_req="null")
    _, ref = _c15_train(mx, hybrid, grad_req="null")
    if hybrid:
        assert FakeGraph.made   # the step ran captured
    for n in before:
        frozen = "dense0" in n
        assert np.array_equal(after[n], before[n]) == frozen, n
        np.testing.assert_allclose(after[n], ref[n], rtol=FWD, atol=FWD)


def test_c15_setattr_lr_mult_reaches_the_update():
    before, half = _c15_train(mt, False, steps=1, lr_mult=0.5)
    _, whole = _c15_train(mt, False, steps=1)
    for n in before:
        if "dense0" in n:   # the first step: half the change
            np.testing.assert_allclose(half[n] - before[n],
                                       0.5 * (whole[n] - before[n]),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(half[n], whole[n])


# names of the reference still queued, by namespace (ROADMAP §A)
_QUEUED = {
    "": {"feature_list", "libinfo", "operator", "registry", "test_utils",
         "torch_interop", "tpu", "util", "visualization", "viz"},
    "parallel": set(),
    "ops": {"custom", "legacy_vision"},
    "kvstore": set(),
    "gluon": set(),
    # the reference's environment reader (a deliberate difference)
    "base": {"getenv"},
}
# mx.nd names still queued: A10.3's sparse arrays and dlpack, A10.4's
# detection, legacy vision and custom ops (ROADMAP §A)
_QUEUED_ND = {
    "RowSparseNDArray", "SparseEmbedding", "getnnz", "dlpack",
    "from_dlpack", "from_numpy", "to_dlpack_for_read", "to_dlpack_for_write",
    "AdaptiveAvgPooling2D", "BatchNorm_v1", "BilinearResize2D",
    "BilinearSampler", "Convolution_v1", "Correlation", "Crop", "Custom",
    "DeformableConvolution", "DeformablePSROIPooling", "GridGenerator",
    "IdentityAttachKLSparseReg", "MultiProposal", "PSROIPooling",
    "Pooling_v1", "Proposal", "ROIAlign", "ROIPooling", "SVMOutput",
    "SpatialTransformer", "batch_norm_v1", "bipartite_matching", "box_iou",
    "box_nms", "convolution_v1", "count_sketch", "div_sqrt_dim", "fft",
    "histogram", "ifft", "multibox_detection", "multibox_prior",
    "multibox_target", "pooling_v1", "quadratic", "svm_output"}
# JAX-only names (a deliberate difference)
_JAX_ONLY_ND = {"from_jax"}


def _public(mod):
    import types
    out = set()
    for n in dir(mod):
        if n.startswith("_") or n == "annotations":
            continue
        v = getattr(mod, n)
        if isinstance(v, types.ModuleType) and not v.__name__.startswith(
                mod.__name__.split(".")[0]):
            continue   # a library the module imports (jax, numpy, ...)
        out.add(n)
    return out


@pytest.mark.parametrize("path", ["", "ndarray", "gluon", "ops", "parallel",
                                  "kvstore", "base"])
def test_c16_public_names_are_the_references(path):
    import importlib
    ref = importlib.import_module("mxtpu" + ("." + path if path else ""))
    port = importlib.import_module("mxtpu_torch" + ("." + path if path
                                                    else ""))
    missing = _public(ref) - _public(port)
    if path == "ndarray":
        # a name the port registers later (switch_moe with the MoE
        # module) resolves through the namespace's __getattr__
        missing = {n for n in missing if getattr(port, n, None) is None}
        assert missing <= _QUEUED_ND | _JAX_ONLY_ND, sorted(
            missing - _QUEUED_ND - _JAX_ONLY_ND)
        assert {"imdecode", "NDArray", "random", "linalg"} <= _public(port)
        for sub in ("random", "linalg"):
            assert _public(getattr(ref, sub)) <= _public(getattr(port, sub))
        assert port.random.__all__ == ref.random.__all__
        # NDArray methods: A10.3's dlpack pair and JAX's own still missing
        methods = {n for n in dir(ref.NDArray) if not n.startswith("_")} \
            - {n for n in dir(port.NDArray) if not n.startswith("_")}
        assert methods == {"to_dlpack_for_read", "to_dlpack_for_write",
                           "to_jax"}, sorted(methods)
    else:   # a queued submodule is in dir() once any test imported it
        assert missing <= _QUEUED[path], sorted(missing - _QUEUED[path])
    for name in ("REGISTRY", "register", "get_op", "list_ops", "invoke",
                 "attach_methods"):
        assert getattr(mt.ops, name) is getattr(mt.ops.registry, name)


def test_c16_names_work_like_the_references():
    assert mt.NDArray is mt.nd.NDArray
    assert mt.gluon.split_and_load is mt.gluon.utils.split_and_load
    assert mt.gluon.split_data is mt.gluon.utils.split_data
    assert mt.gluon.clip_global_norm is mt.gluon.utils.clip_global_norm
    from mxtpu.gluon.model_zoo.vision import resnet as jres
    from mxtpu_torch.gluon.model_zoo.vision import resnet as tres
    assert [c.__name__ for c in tres.resnet_net_versions] == \
        [c.__name__ for c in jres.resnet_net_versions]
    assert [{k: c.__name__ for k, c in d.items()}
            for d in tres.resnet_block_versions] == \
        [{k: c.__name__ for k, c in d.items()}
         for d in jres.resnet_block_versions]
    x = mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu())
    out = mt.ops.invoke("relu", x)
    assert isinstance(out, mt.NDArray)
    assert "relu" in mt.ops.list_ops() and mt.ops.get_op("relu").name
    assert set(mt.ops.list_ops()) >= {"_contrib_ring_attention"}


# C17-C19: the Module's contexts, compression_params and dist stores
def _c17_net(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.var("data"), num_hidden=8, name="fc1")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def _c17_run(pkg, steps=2, **kw):
    """A Module's ``steps`` SGD steps on seeded weights and batches:
    (outputs of each step, parameters after, the Module)."""
    from mxtpu.symbol import symbol as jsym
    from mxtpu_torch.symbol import symbol as tsym
    jsym._Counter._counts.clear()
    tsym._Counter._counts.clear()
    init_kw = {k: kw.pop(k) for k in ("kvstore",) if k in kw}
    mod = pkg.mod.Module(_c17_net(pkg), **kw)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    r = np.random.RandomState(3)
    args = {"fc1_weight": r.randn(8, 5), "fc1_bias": r.randn(8) * 0.1,
            "fc2_weight": r.randn(3, 8), "fc2_bias": r.randn(3) * 0.1}
    ctx = {} if pkg is mx else {"ctx": mt.cpu()}
    mod.init_params(arg_params={k: pkg.nd.array(v.astype(np.float32),
                                                 **ctx)
                                for k, v in args.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1}, **init_kw)
    outs = []
    for _ in range(steps):
        x = r.randn(4, 5).astype(np.float32)
        y = r.randint(0, 3, 4).astype(np.float32)
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(x, **ctx)],
                                     label=[pkg.nd.array(y, **ctx)]),
                    is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    return outs, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
        mod


def _c17_close(got, want):
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k], v, rtol=1e-4, atol=1e-5)


def test_c17_context_list_runs_on_its_first_like_mxtpu():
    """mxtpu's executor keeps a context list and runs on one device: the
    port binds ``Module``, ``BucketingModule`` and ``simple_bind`` on the
    list's first context."""
    ref = _c17_run(mx, context=[mx.cpu(0), mx.cpu(1)])
    assert ref[0][0].shape == (4, 3)
    # one device: every array of the reference's executor lies on it
    devices = {d for a in ref[2]._exec.arg_arrays
               for d in a._data.devices()}
    assert len(devices) == 1
    got = _c17_run(mt, context=[mt.cpu(), mt.cpu(1)])
    assert got[2]._exec._device == torch.device("cpu")
    _c17_close(got, ref)
    exe = _c17_net(mt).simple_bind([mt.cpu(), mt.cpu(1)], data=(4, 5),
                                   softmax_label=(4,))
    assert exe.arg_dict["fc1_weight"].context == torch.device("cpu")

    def sym_gen(key):
        return _c17_net(mt), ("data",), ("softmax_label",)
    bm = mt.mod.BucketingModule(sym_gen, default_bucket_key=5,
                                context=[mt.cpu(), mt.cpu(1)])
    bm.bind(data_shapes=[("data", (4, 5))],
            label_shapes=[("softmax_label", (4,))])
    assert bm._curr_module._exec._device == torch.device("cpu")


def test_c18_compression_params_accepted_and_unused_like_mxtpu():
    comp = {"type": "2bit", "threshold": 0.5}
    ref = _c17_run(mx, compression_params=comp)
    _c17_close(ref, _c17_run(mx))
    got = _c17_run(mt, context=mt.cpu(), compression_params=comp)
    _c17_close(got, ref)
    _c17_close(got, _c17_run(mt, context=mt.cpu()))


def test_c19_dist_store_object_updates_on_the_store_like_mxtpu():
    """A store object whose type holds "dist": every parameter ``init``-ed
    on it, the update run on the store (push the gradients, pull the
    weights), as mxtpu's Module does; a store of one process sums
    nothing. The named ``dist_*`` stores, which need the process group,
    are held to mxtpu in tests/test_torch_module_mesh.py."""
    ref = _c17_run(mx, kvstore=mx.kvstore.KVStore("dist_sync"))
    assert ref[2]._update_on_kvstore
    store = mt.kvstore.KVStore("dist_sync")
    got = _c17_run(mt, context=mt.cpu(), kvstore=store)
    mod = got[2]
    assert mod._kvstore is store and mod._update_on_kvstore
    assert sorted(store._store) == sorted(ref[2]._kvstore._store)
    _c17_close(got, ref)
    # a local store object: pushed and pulled, the update on the Module
    local = _c17_run(mt, context=mt.cpu(), kvstore=mt.kvstore.KVStore())
    assert not local[2]._update_on_kvstore
    _c17_close(local, _c17_run(mx, kvstore=mx.kvstore.KVStore()))


# --------------------------------------------- C22: B1's dispatch statistics
def _c22_conv_args(r, shape_x, shape_w):
    return (r.randn(*shape_x).astype(np.float32),
            (0.1 * r.randn(*shape_w)).astype(np.float32))


_GATED = ((2, 8, 8, 3), (3, 3, 3, 16), ((1, 1), (1, 1)))     # K = 27
_REFUSED = ((1, 4, 4, 128), (1, 1, 128, 128), ((0, 0), (0, 0)))


def test_c22_conv_dispatch_stats_count_like_mxtpu(monkeypatch):
    """``DISPATCH_STATS`` counts a gated conv in ``pallas`` as the
    reference's does (its kernel run by the interpreter on the CPU, the
    port's plain version). A deliberate difference: the port counts a conv
    the gate refuses in ``xla`` with the gate's reason, where the
    reference's ``conv_fast`` counts nothing (its ``xla`` counts only its
    kernel's own fallbacks, a platform that is not a TPU or a VMEM plan
    over budget, which the port's kernel, taking every shape, lacks)."""
    import jax.numpy as jnp
    from mxtpu.ops import conv_acc as jca
    from mxtpu.ops.pallas import conv as jpc
    from mxtpu_torch.ops import conv_acc as tca
    from mxtpu_torch.ops.pallas import conv as tpc
    monkeypatch.setenv("MXTPU_PALLAS_CONV", "1")
    monkeypatch.setenv("MXTPU_PALLAS_CONV_INTERPRET", "1")
    dims = ("NHWC", "HWIO", "NHWC")
    r = _rng(22)
    jpc.reset_dispatch_stats()
    tpc.reset_dispatch_stats()
    assert dict(tpc.DISPATCH_STATS.items()) == {
        "pallas": 0, "xla": 0, "fallback_reasons": {}}
    for sx, sw, pad in (_GATED, _REFUSED):
        x, w = _c22_conv_args(r, sx, sw)
        ref = jca.conv_fast(jnp.asarray(x), jnp.asarray(w), (1, 1), pad,
                            (1, 1), (1, 1), dims, 1)
        got = tca.conv_fast(torch.tensor(x), torch.tensor(w), (1, 1), pad,
                            (1, 1), (1, 1), dims, 1)
        _close(got.numpy(), np.asarray(ref), FWD)
    assert jpc.DISPATCH_STATS["pallas"] == tpc.DISPATCH_STATS["pallas"] == 1
    x, w = _c22_conv_args(r, *_REFUSED[:2])
    _ok, reason = jpc.pallas_applicable(
        jnp.asarray(x), jnp.asarray(w), (1, 1), _REFUSED[2], (1, 1), (1, 1),
        dims, 1)
    assert tpc.DISPATCH_STATS["xla"] == 1
    assert tpc.DISPATCH_STATS["fallback_reasons"] == {reason: 1}
    assert jpc.DISPATCH_STATS["xla"] == 0
    tpc.reset_dispatch_stats()
    assert tpc.DISPATCH_STATS["pallas"] == tpc.DISPATCH_STATS["xla"] == 0
    assert set(tpc.__all__) >= set(jpc.__all__)


def test_c22_dispatch_stats_count_once_per_capture_never_a_replay():
    """Pinned: an eager call counts, a graph's capture pass counts once,
    its warm-up and its replays count nothing (``graphs.counts_dispatch``);
    ``fused_conv.launches`` counts every launch, replays included."""
    from mxtpu_torch import graphs
    from mxtpu_torch.ops.pallas import conv as tpc
    x, w = _c22_conv_args(_rng(1), *_GATED[:2])
    xt, wt = torch.tensor(x), torch.tensor(w)

    def call():
        tpc.fused_conv(xt, wt, (1, 1), _GATED[2])
        return tpc.DISPATCH_STATS["pallas"]

    tpc.reset_dispatch_stats()
    assert call() == 1 and graphs.counts_dispatch()
    graphs._STATE.depth = getattr(graphs._STATE, "depth", 0) + 1
    try:
        assert not graphs.counts_dispatch()
        assert call() == 1                  # the warm-up
        with graphs._tally():
            assert graphs.counts_dispatch()
            assert call() == 2              # the capture pass
    finally:
        graphs._STATE.depth -= 1
    assert call() == 3


def test_c22_shape_class_of_is_the_references():
    import jax.numpy as jnp
    import importlib
    from mxtpu.ops.pallas import conv as jpc
    from mxtpu_torch.ops.pallas import conv as tpc
    jfa = importlib.import_module("mxtpu.ops.pallas.flash_attention")
    tfa = importlib.import_module("mxtpu_torch.ops.pallas.flash_attention")
    x, w = _c22_conv_args(_rng(2), (2, 9, 7, 3), (3, 3, 3, 16))
    for scale, res in ((False, False), (True, True)):
        kw = dict(strides=(2, 1), padding=((1, 0), (2, 1)), relu=True,
                  has_scale=scale, has_bias=False, has_residual=res)
        assert tpc.shape_class_of(torch.tensor(x), torch.tensor(w),
                                  tpc._Cfg(**kw)) == \
            jpc.shape_class_of(jnp.asarray(x), jnp.asarray(w),
                               jpc._Cfg(**kw))
    q = np.zeros((2, 3, 16, 8), np.float32)
    k = np.zeros((2, 3, 24, 8), np.float32)
    assert tfa.shape_class_of(torch.tensor(q), torch.tensor(k)) == \
        jfa.shape_class_of(jnp.asarray(q), jnp.asarray(k))
    assert tfa.shape_class_of(torch.tensor(q).bfloat16(), torch.tensor(
        k).bfloat16())["dtype"] == "bfloat16"


# ----------------------------------- C23: Parameter.list_ctx, Parameter.var
def test_c23_parameter_list_ctx_and_var_like_mxtpu():
    with mx.cpu():
        jp = mx.gluon.Parameter("c23_w", shape=(2, 3))
        ref_ctx = jp.list_ctx()
    with mt.cpu():
        tp = mt.gluon.Parameter("c23_w", shape=(2, 3))
        assert repr(tp.list_ctx()) == repr(ref_ctx) == "[cpu(0)]"
    assert tp.list_ctx() == [mt.current_context()] == [mt.gpu(0)]
    jv, tv = jp.var(), tp.var()
    assert tv.name == jv.name == "c23_w"
    assert tv.list_attr() == jv.list_attr()
    jd, td = mx.gluon.nn.Dense(4, in_units=3), mt.gluon.nn.Dense(4,
                                                                 in_units=3)
    jd.initialize()
    td.initialize(ctx=mt.cpu())
    assert repr(td.weight.list_ctx()) == "[cpu(0)]"
    assert td.weight.var().list_attr() == jd.weight.var().list_attr()
    assert td.weight.var().list_attr()["__shape__"] == "(4, 3)"


# ------------------------------------------------- C24: mxtpu_torch.base
def test_c24_base_names_work_like_mxtpu():
    from mxtpu import base as jb
    from mxtpu_torch import base as tb
    assert set(jb.__all__) <= set(tb.__all__)
    assert tb.Context is mt.Context and tb.cpu() == mt.cpu()
    assert repr(tb.cpu()) == repr(jb.cpu()) == "cpu(0)"
    assert repr(tb.gpu(1)) == repr(jb.gpu(1)) == "gpu(1)"
    assert tb.tpu(1) == tb.gpu(1)       # the accelerator: CUDA device 1
    with tb.cpu(), jb.cpu():
        assert repr(tb.current_context()) == repr(jb.current_context())
    for dt in ("float32", np.float16, np.dtype("int32"), "bfloat16", None):
        assert tb.np_dtype(dt) == jb.np_dtype(dt)
    assert tb.DTYPE_TO_CODE == jb.DTYPE_TO_CODE
    assert tb.CODE_TO_DTYPE == jb.CODE_TO_DTYPE


# --------------------------------------------------- C25: signatures
# Every public function and class method that both packages define, held
# by its parameters' names, order and kinds. The differences left are
# deliberate, each listed as (the reference's parameters the port lacks,
# the port's extra ones): levers as arguments (the reference reads them
# from its environment), ``generator=``/``root=``/``mesh=``/``ctx=``,
# JAX-only arguments (``compiled``, ``in_specs``, ``interpret``), and the
# sparse storage of A10.3 (``sparse_grad``, ``stype``, ``grad_stype``).
_SIG_DIFFERENCES = {
    "compile_service:get_or_build": ((), ("persist", "_preread")),
    "distributed:init": ((), ("backend", "timeout")),
    "distributed:shutdown": ((), ("timeout_s",)),
    "fleet:Fleet.__init__": ((), ("collective_timeout_s",
                                  "bringup_timeout_s")),
    "fleet:FleetMembership.__init__": ((), ("heartbeat_s",
                                            "heartbeat_miss")),
    "fleet:FleetSupervisor.__init__": ((), ("faults_for",
                                            "compile_cache_dir")),
    "fleet:init": ((), ("backend", "connect_retries", "connect_backoff_s",
                        "heartbeat_s", "heartbeat_miss",
                        "collective_timeout_s")),
    "fleet_obs:RegressionSentinel.__init__": ((), ("profile_on_trip",)),
    "fleet_obs:StragglerSentinel.__init__": ((), ("profile_on_trip",)),
    "gluon.block:Block.initialize": ((), ("generator",)),
    "gluon.block:SymbolBlock.hybrid_forward": (("kwargs",), ("params",)),
    "gluon.data.dataloader:DataLoader.__init__": ((), ("worker_restarts",)),
    "gluon.model_zoo.vision.alexnet:alexnet": ((), ("root",)),
    "gluon.model_zoo.vision.densenet:get_densenet": ((), ("root",)),
    "gluon.model_zoo.vision.inception:inception_v3": ((), ("root",)),
    "gluon.model_zoo.vision.mobilenet:get_mobilenet": ((), ("root",)),
    "gluon.model_zoo.vision.mobilenet:get_mobilenet_v2": ((), ("root",)),
    "gluon.model_zoo.vision.resnet:get_resnet": ((), ("root",)),
    "gluon.model_zoo.vision.squeezenet:get_squeezenet": ((), ("root",)),
    "gluon.model_zoo.vision.vgg:get_vgg": ((), ("root",)),
    "gluon.nn.activations:GELU.__init__": (("kwargs",), ("prefix",
                                                         "params")),
    "gluon.nn.activations:SELU.__init__": (("kwargs",), ("prefix",
                                                         "params")),
    "gluon.nn.basic_layers:Embedding.__init__": (("sparse_grad",), ()),
    "gluon.nn.basic_layers:Flatten.__init__": (("kwargs",), ("prefix",
                                                             "params")),
    "gluon.nn.conv_layers:MaxPool1D.__init__": ((), ("count_include_pad",)),
    "gluon.nn.conv_layers:MaxPool2D.__init__": ((), ("count_include_pad",)),
    "gluon.nn.conv_layers:MaxPool3D.__init__": ((), ("count_include_pad",)),
    "gluon.parameter:Constant.initialize": (
        ("args", "kwargs"),
        ("init", "ctx", "default_init", "force_reinit", "generator")),
    "gluon.parameter:Parameter.__init__": (("stype", "grad_stype"), ()),
    "gluon.parameter:Parameter.initialize": ((), ("generator",)),
    "gluon.parameter:ParameterDict.initialize": ((), ("generator",)),
    "io.stream:DevicePrefetcher.__init__": ((), ("max_restarts",)),
    "io.stream:ShardedRecordReader.__init__": ((), ("max_restarts",)),
    "io.stream:StreamRecordIter.__init__": ((), ("max_restarts",)),
    "ops.contrib_ops:contrib_arange_like": ((), ("ctx",)),
    "ops.init_ops:arange_like": ((), ("ctx",)),
    "optimizer_fused:MeshPlan.zero_eligible": (("state",), ()),
    "parallel.mesh:host_value": ((), ("sharding",)),
    "parallel.moe:switch_ffn": ((), ("expert_axis", "data_axis")),
    "parallel.ring_attention:ring_attention": ((), ("mesh",)),
    "parallel.ring_attention:ring_flash_attention": ((), ("mesh",)),
    "perf_model:bytes_accessed_of": (("compiled",), ("entry",)),
    "perf_model:critical_intensity": ((), ("dtype",)),
    "perf_model:flops_of": (("compiled",), ("entry",)),
    "perf_model:mfu": ((), ("dtype", "peak_tflops")),
    "perf_model:nominal_tflops": ((), ("dtype",)),
    "perf_model:peak_bandwidth": ((), ("peak_gbps",)),
    "perf_model:peak_flops": ((), ("dtype", "peak_tflops")),
    "profiler:set_config": ((), ("profile_device",)),
    "resilience:DivergenceSentinel.check": ((), ("axis",)),
    "rtc:Kernel.__init__": (("fn",), ("module", "params")),
    "rtc:Kernel.launch": (("in_specs", "out_specs", "interpret"),
                          ("block", "shared_mem")),
    "serving.replicas:ReplicaSet.__init__": ((), ("int8",)),
    "serving.zoo:ZooScheduler.__init__": ((), ("canary_floor",
                                               "canary_window", "int8")),
    "serving.zoo:ZooVersion.__init__": (("policy",), ()),
    "symbol.symbol:record_apply": (("inputs",), ()),
    "xprof:MFUMeter.__init__": ((), ("dtype", "peak_tflops")),
    "xprof:attach": (("compiled",), ("flops",)),
    "xprof:preflight": ((), ("need",)),
    "xprof:site_footprint": (("resolve",), ()),
    "xprof:watch": (("compiled",), ("flops",)),
}


def _signature_differences():
    import importlib
    import inspect
    import pkgutil

    def names(pkg):
        return {m.name[len(pkg.__name__) + 1:]
                for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")}

    def params(fn):
        try:
            return [(p.name, p.kind)
                    for p in inspect.signature(fn).parameters.values()]
        except (TypeError, ValueError):
            return None

    out = {}
    for mod in sorted(names(mx) & names(mt)):
        rm = importlib.import_module("mxtpu." + mod)
        pm = importlib.import_module("mxtpu_torch." + mod)
        for name in dir(rm):
            r, p = getattr(rm, name), getattr(pm, name, None)
            if name.startswith("_") or p is None \
                    or getattr(r, "__module__", None) != rm.__name__:
                continue
            pairs = []
            if inspect.isfunction(r) and callable(p):
                pairs.append((name, r, p))
            elif inspect.isclass(r) and inspect.isclass(p):
                for meth in ["__init__"] + [k for k in vars(r)
                                            if not k.startswith("_")]:
                    rv, pv = vars(r).get(meth), getattr(p, meth, None)
                    if inspect.isfunction(rv) and callable(pv):
                        pairs.append((name + "." + meth, rv, pv))
            for qual, rf, pf in pairs:
                a, b = params(rf), params(pf)
                if a is None or b is None or a == b:
                    continue
                an, bn = [n for n, _ in a], [n for n, _ in b]
                missing = tuple(n for n in an if n not in bn)
                extra = tuple(n for n in bn if n not in an)
                # the shared parameters in the same order and kinds
                shared_a = [x for x in a if x[0] in bn]
                shared_b = [x for x in b if x[0] in an]
                if shared_a != shared_b:
                    missing, extra = ("order",) + missing, extra
                out["%s:%s" % (mod, qual)] = (missing, extra)
    return out


def test_c25_signatures_are_the_references_but_the_listed():
    assert _signature_differences() == _SIG_DIFFERENCES


def test_c25_repaired_signatures():
    import inspect
    from mxtpu.serving import batcher as jb, engine as je
    from mxtpu_torch.serving import batcher as tb, engine as te

    def names(fn):
        return list(inspect.signature(fn).parameters)
    assert names(tb.MicroBatcher.__init__) == names(jb.MicroBatcher.__init__)
    assert names(te.pad_nd)[0] == names(je.pad_nd)[0] == "arr"
    t = torch.arange(6.0).reshape(2, 3)
    assert te.pad_nd(arr=t, batch=4).shape == (4, 3)
    # the reference's extra keywords are accepted
    from mxtpu_torch import compile_service, telemetry
    before = telemetry.value("retrace.c25_site")
    fn = object()
    assert telemetry.record_retrace("c25_site", {"k": 1}, compiled=fn,
                                    compile_s=0.25) is fn
    assert telemetry.value("retrace.c25_site") == before + 1
    compile_service.reset()
    key = compile_service.canonical_key(site="c25_site", fn_id="c25",
                                        signature=())
    e = compile_service.get_or_build(key, lambda: 7, example_args=(1,),
                                     aot=True, persist=False)
    assert e.fn == 7
    compile_service.reset()


def test_c25_sharded_train_step_flops():
    """``compiled_step_flops`` raises before a step and then counts one
    step's forward and backward without moving the weights, the moving
    statistics or the generator (a world of one on the CPU)."""
    import socket
    from mxtpu_torch import parallel as par
    from mxtpu_torch import random as trandom
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mt.distributed.init("127.0.0.1:%d" % port, num_processes=1,
                        process_id=0, backend="gloo")
    try:
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(8, in_units=3, activation="relu"),
                mt.gluon.nn.BatchNorm(in_channels=8),
                mt.gluon.nn.Dense(4, in_units=8))
        net.initialize(ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(1))
        net(torch.zeros(2, 3))
        step = par.ShardedTrainStep(net, mt.gluon.loss.L2Loss(),
                                    par.make_mesh({"data": 1}), "sgd",
                                    {"learning_rate": 0.1})
        with pytest.raises(MXNetError, match="at least one step"):
            step.compiled_step_flops()
        x = _rng(25).randn(5, 3).astype(np.float32)
        step(_nd(x), _nd(np.zeros((5, 4))))
        before = [p.data().asnumpy().copy()
                  for p in net.collect_params().values()]
        gen = trandom.generator("cpu").get_state()
        flops = step.compiled_step_flops()
        after = [p.data().asnumpy() for p in net.collect_params().values()]
        assert all(np.array_equal(a, b) for a, b in zip(before, after))
        assert torch.equal(trandom.generator("cpu").get_state(), gen)
        # forward 2*5*(3*8 + 8*4) multiply-adds; the backward's input and
        # weight gradients about twice that
        fwd = 2 * 5 * (3 * 8 + 8 * 4)
        assert 2 * fwd <= flops <= 3.5 * fwd, flops
    finally:
        mt.distributed.shutdown()
