"""The rest of Gluon's layers and the ops they call, held to ``mxtpu`` on
the same seeded numpy inputs and weights:

* ops (``mx.nd``): ``LeakyReLU`` (leaky, prelu, elu, selu, gelu),
  ``_rrelu_train`` outside training, ``InstanceNorm``, ``Deconvolution``
  (1-3-D, channels-first and -last), ``pad`` (constant, edge, reflect),
  1-D and 3-D ``Convolution`` and ``Pooling`` (max, avg with and without
  the padding counted, sum, lp, global lp, the "full" convention);
  forward and the input's (and weight's) gradient;
* layers: Sequential, HybridSequential's slices, Dropout (predict mode),
  InstanceNorm, Lambda, HybridLambda, Concurrent, HybridConcurrent,
  Identity, LeakyReLU, PReLU, ELU, SELU, Swish, GELU, the 1-D, 3-D and
  transposed convs, the pools and ReflectionPad2D; forward and the
  gradients of the input and every parameter;
* ``Block.summary``'s printout, ``collect_params(select=)``, the forward
  hooks and ``__repr__``.

Dropout's draws come from torch's generator, not JAX's keys (a
deliberate difference), so its training mode is held to its definition:
kept share within 4 sigma of 1 - p, kept values x / (1 - p), ``axes``
sharing one draw, the input's gradient mask * g / (1 - p) exactly, and
equal masks from equal seeds; rrelu's slopes within their bounds.

Tolerances: float32 forward rtol=atol=1e-5 and gradients 1e-4, as
tests/test_torch_port_faults.py.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt

FWD, GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXTPU_PALLAS_CONV", "MXTPU_PALLAS_CONV_INTERPRET",
                "MXTPU_CONV_ACC", "MXTPU_CONV_IM2COL", "MXTPU_BN_ONEPASS"):
        monkeypatch.delenv(var, raising=False)


def _rng(seed):
    return np.random.RandomState(seed)


def _arr(pkg, a):
    a = np.asarray(a, np.float32)
    return mt.nd.array(a, ctx=mt.cpu()) if pkg is mt else mx.nd.array(a)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def _op_both(name, inputs, kwargs, seed=0, train=True):
    """``pkg.nd.<name>(*inputs, **kwargs)`` in both packages under
    record (in training mode unless ``train`` is False), backward from one
    seeded cotangent; returns per package (out, [input grads])."""
    res = []
    for pkg in (mx, mt):
        arrs = [_arr(pkg, a) for a in inputs]
        for a in arrs:
            a.attach_grad()
        with pkg.autograd.record(train_mode=train):
            out = getattr(pkg.nd, name)(*arrs, **kwargs)
        g = _rng(seed + 100).randn(*out.shape).astype(np.float32)
        out.backward(_arr(pkg, g))
        res.append((out.asnumpy(), [a.grad.asnumpy() for a in arrs]))
    return res


def _check_op(name, inputs, kwargs, train=True):
    (ref, rgrads), (got, grads) = _op_both(name, inputs, kwargs,
                                           train=train)
    _close(got, ref, FWD)
    for g, r in zip(grads, rgrads):
        _close(g, r, GRAD)


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "gelu"])
def test_leaky_relu_family(act):
    x = _rng(0).randn(3, 4, 5)
    _check_op("LeakyReLU", [x], dict(act_type=act, slope=0.3))


def test_prelu_op_broadcasts_gamma_over_axis_1():
    x = _rng(1).randn(2, 3, 4, 4)
    gamma = _rng(2).uniform(0.1, 0.5, (3,))
    _check_op("LeakyReLU", [x, gamma], dict(act_type="prelu"))


def test_rrelu_outside_training_uses_the_mean_slope():
    x = _rng(3).randn(4, 6)
    _check_op("LeakyReLU", [x], dict(act_type="rrelu", lower_bound=0.1,
                                     upper_bound=0.3), train=False)


def test_rrelu_in_training_draws_slopes_within_bounds():
    x = -np.abs(_rng(4).randn(2000)).astype(np.float32) - 0.1
    with mt.autograd.train_mode():
        out = mt.nd._rrelu_train(_arr(mt, x), 0.1, 0.3).asnumpy()
    slopes = out / x
    assert slopes.min() >= 0.1 - 1e-6 and slopes.max() <= 0.3 + 1e-6
    assert abs(slopes.mean() - 0.2) < 4 * 0.2 / np.sqrt(12 * 2000) * 0.2 \
        + 4 * (0.2 / np.sqrt(12)) / np.sqrt(2000)


def test_instance_norm_op():
    x = _rng(5).randn(2, 3, 5, 6) * 2 + 1
    gamma, beta = _rng(6).uniform(0.5, 1.5, (3,)), _rng(7).randn(3)
    _check_op("InstanceNorm", [x, gamma, beta], dict(eps=1e-5))


DECONV = [   # (x shape, w shape, kwargs)
    ((2, 3, 7), (3, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,),
                                adj=(1,), num_filter=4)),
    ((2, 3, 5, 6), (3, 4, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), num_filter=4)),
    ((1, 2, 3, 4, 4), (2, 3, 2, 2, 2), dict(kernel=(2, 2, 2),
                                            stride=(2, 2, 2), num_filter=3)),
    ((2, 5, 6, 3), (3, 3, 4, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), adj=(1, 1), num_filter=4,
                                      layout="NHWC")),
]


@pytest.mark.parametrize("xs,ws,kw", DECONV,
                         ids=["1d", "2d", "3d", "2d-nhwc"])
def test_deconvolution(xs, ws, kw):
    _check_op("Deconvolution", [_rng(8).randn(*xs), _rng(9).randn(*ws)],
              dict(kw, no_bias=True))


CONV = [
    ((2, 3, 9), (4, 3, 3), dict(kernel=(3,), stride=(2,), pad=(1,),
                                num_filter=4)),
    ((2, 9, 3), (3, 3, 4), dict(kernel=(3,), pad=(1,), num_filter=4,
                                layout="NWC")),
    ((1, 2, 5, 6, 6), (3, 2, 3, 3, 3), dict(kernel=(3, 3, 3), pad=(1, 1, 1),
                                            num_filter=3)),
    ((1, 5, 6, 6, 2), (3, 3, 3, 2, 3), dict(kernel=(3, 3, 3),
                                            stride=(1, 2, 2), num_filter=3,
                                            layout="NDHWC")),
]


@pytest.mark.parametrize("xs,ws,kw", CONV,
                         ids=["1d", "1d-nwc", "3d", "3d-ndhwc"])
def test_nd_convolution(xs, ws, kw):
    _check_op("Convolution", [_rng(10).randn(*xs), _rng(11).randn(*ws)],
              dict(kw, no_bias=True))


POOL = [
    ((2, 3, 9), dict(kernel=(3,), stride=(2,), pool_type="max")),
    ((2, 3, 9), dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="avg",
                     count_include_pad=False)),
    ((2, 9, 3), dict(kernel=(2,), stride=(2,), pool_type="sum",
                     layout="NWC", pooling_convention="full")),
    ((1, 2, 5, 6, 7), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                           pool_type="max", pooling_convention="full")),
    ((1, 5, 6, 7, 2), dict(kernel=(3, 3, 3), stride=(1, 2, 2),
                           pad=(1, 1, 1), pool_type="avg", layout="NDHWC")),
    ((2, 3, 6, 6), dict(kernel=(3, 3), stride=(2, 2), pool_type="lp",
                        p_value=2)),
    ((2, 3, 6, 6), dict(kernel=(2, 2), stride=(2, 2), pool_type="lp",
                        p_value=3, pooling_convention="full")),
    ((2, 3, 6, 6), dict(kernel=(1, 1), global_pool=True, pool_type="lp")),
    ((2, 6, 6, 3), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="avg", count_include_pad=False,
                        layout="NHWC", pooling_convention="full")),
]


@pytest.mark.parametrize("xs,kw", POOL, ids=[
    "max1d", "avg1d-nopad", "sum1d-nwc-full", "max3d-full", "avg3d-ndhwc",
    "lp2", "lp3-full", "global-lp", "avg2d-nhwc-nopad-full"])
def test_nd_and_lp_pooling(xs, kw):
    _check_op("Pooling", [_rng(12).randn(*xs) + 0.5], kw)


@pytest.mark.parametrize("mode,width", [
    ("constant", (0, 0, 0, 0, 1, 2, 2, 1)), ("edge", (0, 0, 0, 0, 2, 1, 1, 3)),
    ("reflect", (0, 0, 0, 0, 1, 2, 2, 1)),
    ("reflect", (0, 0, 1, 1, 2, 0, 0, 2)),
    ("constant", (1, 0, 0, 2, 1, 1))])
def test_pad(mode, width):
    x = _rng(13).randn(*((2, 3, 5, 6) if len(width) == 8 else (2, 3, 4)))
    kw = dict(mode=mode, pad_width=width)
    if mode == "constant":
        kw["constant_value"] = 0.5
    _check_op("pad", [x], kw)


def test_edge_pad_of_a_leading_axis_raises():
    with pytest.raises(mt.MXNetError, match="trailing 1-3 axes"):
        mt.nd.pad(_arr(mt, np.ones((2, 3, 4, 5))), mode="edge",
                  pad_width=(1, 1, 0, 0, 0, 0, 0, 0))


# --------------------------------------------------------------- Dropout
def _dropout(x, p, **kw):
    xt = _arr(mt, x)
    xt.attach_grad()
    with mt.autograd.record():
        out = mt.nd.Dropout(xt, p=p, **kw)
    g = _rng(20).randn(*x.shape).astype(np.float32)
    out.backward(_arr(mt, g))
    return out.asnumpy(), xt.grad.asnumpy(), g


def test_dropout_moments_and_its_gradient_reuses_the_mask():
    p, n = 0.3, 200_000
    x = _rng(21).uniform(0.5, 2.0, (n,)).astype(np.float32)
    mt.random.seed(7)
    out, grad, g = _dropout(x, p)
    mask = out != 0
    share = mask.mean()
    assert abs(share - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    keep = np.float32(1 - p)
    np.testing.assert_array_equal(out[mask], x[mask] / keep)
    np.testing.assert_array_equal(grad, np.where(mask, g / keep, 0))
    # the reference's draw has the same moments (its stream is JAX's)
    with mx.autograd.record():
        ref = mx.nd.Dropout(mx.nd.array(x), p=p).asnumpy()
    assert abs((ref != 0).mean() - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    assert abs(out.mean() - ref.mean()) < 8 * x.std() * np.sqrt(
        p / (1 - p) / n) + 8 * np.sqrt(p / (1 - p) / n)
    # one seed, one stream
    mt.random.seed(7)
    np.testing.assert_array_equal(_dropout(x, p)[0], out)


def test_dropout_axes_share_one_draw():
    mt.random.seed(1)
    out, grad, g = _dropout(np.ones((64, 5, 32), np.float32), 0.5, axes=(1,))
    kept = out != 0
    assert (kept == kept[:, :1, :]).all()
    assert 0.3 < kept.mean() < 0.7


def test_dropout_is_the_identity_outside_training_unless_always():
    x = _rng(22).randn(50, 40).astype(np.float32)
    for pkg in (mx, mt):
        got = pkg.nd.Dropout(_arr(pkg, x), p=0.5).asnumpy()
        np.testing.assert_array_equal(got, x)
    with mt.autograd.record(train_mode=False):
        np.testing.assert_array_equal(
            mt.nd.Dropout(_arr(mt, x), p=0.5).asnumpy(), x)
    out = mt.nd.Dropout(_arr(mt, x), p=0.5, mode="always").asnumpy()
    assert (out == 0).any() and (out != 0).any()


def test_dropout_layer_in_training_and_predict_mode():
    layer = mt.gluon.nn.Dropout(0.4)
    x = torch.ones(1000, 10)
    assert torch.equal(layer(x), x)
    with mt.autograd.record():
        y = layer(x)
    assert 0.5 < (y != 0).float().mean().item() < 0.7
    assert repr(layer) == repr(mx.gluon.nn.Dropout(0.4))


# ---------------------------------------------------------------- layers
def _keyed(params):
    return {k.partition("_")[2]: p for k, p in params.items()}


def _layer_both(make, x, seed=0):
    """``make(pkg)`` built in both packages with the reference's weights
    (settled by one forward there, loaded by name here), run under record
    on ``x``, backward from one seeded cotangent; per package (out, input
    grad, {param: grad})."""
    jl = make(mx)
    jl.initialize()
    jl(mx.nd.array(np.asarray(x, np.float32)))
    arrays = {k: p.data().asnumpy() for k, p in
              _keyed(jl.collect_params()).items()}
    tl = make(mt)
    for k, p in _keyed(tl.collect_params()).items():
        p.set_data(arrays[k])
    tl.initialize(ctx=mt.cpu())
    res = []
    for pkg, layer in ((mx, jl), (mt, tl)):
        xa = _arr(pkg, x)
        xa.attach_grad()
        with pkg.autograd.record():
            out = layer(xa)
        g = _rng(seed + 50).randn(*out.shape).astype(np.float32)
        out.backward(_arr(pkg, g))
        grads = {k: p.grad().asnumpy()
                 for k, p in _keyed(layer.collect_params()).items()
                 if p.grad_req != "null"}
        res.append((out.asnumpy(), xa.grad.asnumpy(), grads))
    return res


def _check_layer(make, x):
    (ref, rxg, rpg), (got, xg, pg) = _layer_both(make, x)
    _close(got, ref, FWD)
    _close(xg, rxg, GRAD)
    assert sorted(pg) == sorted(rpg)
    for k in rpg:
        _close(pg[k], rpg[k], GRAD)


def _seq(pkg, *makers, hybrid=True):
    net = (pkg.gluon.nn.HybridSequential if hybrid
           else pkg.gluon.nn.Sequential)()
    with net.name_scope():
        net.add(*[m(pkg) for m in makers])
    return net


LAYERS = {
    "leaky": (lambda pkg: pkg.gluon.nn.LeakyReLU(0.2), (3, 4)),
    "prelu": (lambda pkg: _seq(pkg, lambda p: p.gluon.nn.Dense(6),
                               lambda p: p.gluon.nn.PReLU()), (3, 4)),
    "elu": (lambda pkg: pkg.gluon.nn.ELU(0.7), (3, 4)),
    "selu": (lambda pkg: pkg.gluon.nn.SELU(), (3, 4)),
    "swish": (lambda pkg: pkg.gluon.nn.Swish(1.5), (3, 4)),
    "gelu": (lambda pkg: pkg.gluon.nn.GELU(), (3, 4)),
    "instance_norm": (lambda pkg: pkg.gluon.nn.InstanceNorm(
        scale=True, in_channels=3), (2, 3, 4, 5)),
    "instance_norm_last": (lambda pkg: pkg.gluon.nn.InstanceNorm(
        axis=-1, scale=True), (2, 5, 3)),
    "sequential": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.Dense(5, activation="tanh"),
        lambda p: p.gluon.nn.ELU(), lambda p: p.gluon.nn.Dense(3),
        hybrid=False), (4, 6)),
    "identity": (lambda pkg: _seq(pkg, lambda p: p.gluon.nn.Dense(3),
                                  lambda p: p.gluon.nn.Identity()), (2, 4)),
    "hybrid_lambda": (lambda pkg: pkg.gluon.nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="leaky", slope=0.1) * 2),
        (3, 4)),
    "hybrid_lambda_name": (lambda pkg: pkg.gluon.nn.HybridLambda("tanh"),
                           (3, 4)),
    "lambda_name": (lambda pkg: pkg.gluon.nn.Lambda("sigmoid"), (3, 4)),
    "hybrid_concurrent": (lambda pkg: _concurrent(pkg, True), (2, 4)),
    "concurrent": (lambda pkg: _concurrent(pkg, False), (2, 4)),
    "conv1d": (lambda pkg: pkg.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
               (2, 3, 9)),
    "conv3d_nhwc": (lambda pkg: pkg.gluon.nn.Conv3D(
        3, (2, 3, 3), padding=(0, 1, 1), layout="NDHWC"), (1, 4, 5, 5, 2)),
    "conv1d_transpose": (lambda pkg: pkg.gluon.nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (2, 4, 6)),
    "conv2d_transpose": (lambda pkg: pkg.gluon.nn.Conv2DTranspose(
        3, 3, strides=2, padding=1), (2, 4, 5, 5)),
    "conv2d_transpose_nhwc": (lambda pkg: pkg.gluon.nn.Conv2DTranspose(
        3, 4, strides=2, padding=1, layout="NHWC"), (2, 5, 5, 4)),
    "conv3d_transpose": (lambda pkg: pkg.gluon.nn.Conv3DTranspose(
        2, 2, strides=2), (1, 3, 2, 3, 3)),
    "pools": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.AvgPool2D(3, 1, 1, count_include_pad=False),
        lambda p: p.gluon.nn.MaxPool2D(2, ceil_mode=True),
        lambda p: p.gluon.nn.GlobalMaxPool2D()), (2, 3, 7, 7)),
    "pools_1d": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.MaxPool1D(3, 2),
        lambda p: p.gluon.nn.AvgPool1D(2), lambda p: p.gluon.nn.Flatten()),
        (2, 3, 11)),
    "pools_3d": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.MaxPool3D(2),
        lambda p: p.gluon.nn.AvgPool3D(2, ceil_mode=True),
        lambda p: p.gluon.nn.GlobalAvgPool3D()), (1, 2, 6, 6, 5)),
    "global_1d": (lambda pkg: _seq(
        pkg, lambda p: p.gluon.nn.GlobalMaxPool1D(),
        lambda p: p.gluon.nn.Flatten()), (2, 3, 5)),
    "reflection_pad": (lambda pkg: pkg.gluon.nn.ReflectionPad2D(2),
                       (2, 3, 5, 6)),
}


def _concurrent(pkg, hybrid):
    nn = pkg.gluon.nn
    net = nn.HybridConcurrent(axis=1) if hybrid else nn.Concurrent(axis=1)
    with net.name_scope():
        net.add(nn.Dense(3), nn.Dense(2, activation="relu"))
        net.add(nn.HybridLambda(lambda F, x: x * 3) if hybrid
                else nn.Identity())
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_mxtpu(name):
    make, shape = LAYERS[name]
    _check_layer(make, _rng(30).randn(*shape) + 0.1)


def test_sequential_slicing_and_iteration():
    for pkg in (mx, mt):
        net = _seq(pkg, lambda p: p.gluon.nn.Dense(3),
                   lambda p: p.gluon.nn.Activation("relu"),
                   lambda p: p.gluon.nn.Dense(2))
        assert len(net) == 3
        assert [type(b).__name__ for b in net] == ["Dense", "Activation",
                                                   "Dense"]
        assert type(net[1:]).__name__ == "HybridSequential"
        assert len(net[1:]) == 2 and net[-1] is list(net)[-1]


# ------------------------------------------------------- Block methods
def _mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3), nn.Activation("relu"),
                nn.Dropout(0.5), nn.Dense(2, in_units=4),
                nn.BatchNorm(in_channels=2))
    return net


def test_summary_prints_what_the_reference_prints(capsys):
    out = []
    for pkg in (mx, mt):
        net = _mlp(pkg)
        if pkg is mt:
            net.initialize(ctx=mt.cpu())
        else:
            net.initialize()
        capsys.readouterr()
        net.summary(_arr(pkg, np.ones((1, 3))))
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "Total params: 34" in out[1]


def test_repr_equals_the_reference():
    nets = []
    for pkg in (mx, mt):
        nn = pkg.gluon.nn
        net = _mlp(pkg)
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, strides=2, in_channels=4),
                    nn.MaxPool2D(3, 2, 1), nn.GlobalAvgPool2D(), nn.Flatten(),
                    nn.Embedding(10, 4), nn.LeakyReLU(0.1))
        nets.append(repr(net))
    assert nets[0] == nets[1]


def test_collect_params_select():
    for pattern in (".*dense0_weight", ".*weight|.*gamma", ".*dense1_.*"):
        keys = [sorted(k.partition("_")[2] for k in
                       _mlp(pkg).collect_params(select=pattern).keys())
                for pkg in (mx, mt)]
        assert keys[0] == keys[1] and keys[1]


def test_forward_hooks_fire_and_detach():
    for pkg in (mx, mt):
        net = _mlp(pkg)
        if pkg is mt:
            net.initialize(ctx=mt.cpu())
        else:
            net.initialize()
        seen = []
        pre = net[0].register_forward_pre_hook(
            lambda b, args: seen.append(("pre", tuple(args[0].shape))))
        post = net[3].register_forward_hook(
            lambda b, args, out: seen.append(("post", tuple(out.shape))))
        x = _arr(pkg, np.ones((5, 3)))
        net(x)
        assert seen == [("pre", (5, 3)), ("post", (5, 2))]
        pre.detach()
        post.detach()
        net(x)
        assert len(seen) == 2


def test_apply_visits_children_first():
    for pkg in (mx, mt):
        names = []
        _mlp(pkg).apply(lambda b: names.append(type(b).__name__))
        assert names == ["Dense", "Activation", "Dropout", "Dense",
                         "BatchNorm", "HybridSequential"]


def test_convert_carries_the_new_parameters():
    """``convert.load_mxtpu_params`` and ``params_to_numpy`` cover PReLU's
    alpha, InstanceNorm's gamma and beta and the transposed convs' weights
    (channels-first and -last): the reference's arrays load by name, come
    back unchanged, and give the reference's output."""
    from mxtpu_torch import convert

    def make(pkg):
        nn = pkg.gluon.nn
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2DTranspose(4, 3, strides=2, padding=1,
                                       in_channels=3),
                    nn.InstanceNorm(scale=True, in_channels=4), nn.PReLU(),
                    nn.Conv2DTranspose(2, 2, layout="NCHW", in_channels=4))
        return net
    x = _rng(40).randn(2, 3, 5, 5).astype(np.float32)
    jnet = make(mx)
    jnet.initialize()
    jnet(mx.nd.array(x))
    arrays = {k: p.data().asnumpy() + _rng(41).uniform(
        0.1, 0.3, p.shape).astype(np.float32)
        for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(arrays[k]))
    net = make(mt)
    convert.load_mxtpu_params(net, arrays)
    back = convert.params_to_numpy(net)
    assert sorted(k.partition("_")[2] for k in back) == sorted(
        k.partition("_")[2] for k in arrays)
    for k, a in back.items():
        np.testing.assert_array_equal(
            a, arrays[next(j for j in arrays
                           if j.partition("_")[2] == k.partition("_")[2])])
    got = net(torch.from_numpy(x)).detach().numpy()
    _close(got, jnet(mx.nd.array(x)).asnumpy(), FWD)
