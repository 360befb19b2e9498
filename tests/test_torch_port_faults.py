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
    "ops": {"contrib_ops", "custom", "legacy_vision", "linalg_ops",
            "random_ops"},
    "kvstore": set(),
    "gluon": set(),
}


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
                                  "kvstore"])
def test_c16_public_names_are_the_references(path):
    import importlib
    ref = importlib.import_module("mxtpu" + ("." + path if path else ""))
    port = importlib.import_module("mxtpu_torch" + ("." + path if path
                                                    else ""))
    missing = _public(ref) - _public(port)
    if path == "ndarray":
        # registry ops and sparse/dlpack/linalg arrays queued in A10
        queued = {n for n in missing
                  if n not in ("NDArray", "imdecode", "array", "load",
                               "save", "concatenate", "waitall")}
        assert not (missing - queued)
        assert {"imdecode", "NDArray"} <= _public(port)
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
