"""The port's imperative surface (mxtpu_torch.nd: NDArray, the op registry,
mx.nd.random) against the JAX package's (mxtpu.nd), on the same seeded
numpy inputs, on the CPU.

Tolerances: elementwise float32 ops rtol 1e-6 (atol 1e-7 where a result
can be 0), reductions and contractions rtol 1e-5; integer and index
results exactly; the dtypes of both results must agree (the JAX package
runs with x64 off)."""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch.ops import registry

CPU = mt.cpu()
EW = dict(rtol=1e-6, atol=1e-7)
RED = dict(rtol=1e-5, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


def both(a, dtype=None):
    """The same host data as an mxtpu and an mxtpu_torch (CPU) NDArray."""
    return mx.nd.array(a, dtype=dtype), mt.nd.array(a, ctx=CPU, dtype=dtype)


def _dtype_name(d):
    return "bfloat16" if d == torch.bfloat16 else np.dtype(d).name


def same(got, ref, rtol=0.0, atol=0.0):
    """Port result ``got`` against JAX result ``ref``: shape, dtype, values."""
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            same(g, r, rtol, atol)
        return
    assert isinstance(got, mt.nd.NDArray)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert _dtype_name(got.dtype) == _dtype_name(ref.dtype)
    g, r = got.asnumpy(), ref.asnumpy()
    if rtol == 0 and atol == 0:
        np.testing.assert_array_equal(g, r)
    else:
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)


# ------------------------------------------------------------ constructors
@pytest.mark.parametrize("src", [
    np.arange(6, dtype=np.float64).reshape(2, 3),
    np.arange(6, dtype=np.int64),
    np.arange(6, dtype=np.int32),
    np.array([True, False]),
    np.float32(2.5),
    [[1, 2], [3, 4]],
    [1.5, 2.5],
    np.arange(4, dtype=np.uint8),
    np.arange(4, dtype=np.float16),
], ids=["f64", "i64", "i32", "bool", "scalar", "int-list", "float-list",
        "u8", "f16"])
def test_array_dtypes_match_x64_off(src):
    a, b = both(src)
    same(b, a)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "float16", "bfloat16", "uint8"])
def test_array_dtype_argument_and_astype(dtype):
    x = np.abs(_rng(1).randn(3, 4)) * 10   # float -> uint8 of a negative
    # value is undefined behaviour in C, so both libraries differ there
    a, b = both(x, dtype=dtype)
    same(b, a)
    a, b = both(x.astype(np.float32))
    same(b.astype(dtype), a.astype(dtype))


def test_array_lands_on_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.array(np.ones(3))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.nd.zeros((2,))
    t = torch.ones(2)
    assert mt.nd.array(t).context == CPU     # a tensor stays where it is
    assert mt.nd.from_torch(t).to_torch() is t


def test_attributes_and_conversions():
    x = _rng(2).randn(2, 3, 4).astype(np.float32)
    a, b = both(x)
    assert (b.shape, b.size, b.ndim, b.stype) == (a.shape, a.size, a.ndim,
                                                  a.stype)
    assert b.context == CPU and b.ctx == CPU
    assert len(b) == len(a) == 2
    assert [r.shape for r in b] == [r.shape for r in a]
    s = mt.nd.array(np.float32(3.5), ctx=CPU)
    assert s.asscalar() == s.item() == float(s) == 3.5 and int(s) == 3
    assert bool(mt.nd.array([0.0], ctx=CPU)) is False
    with pytest.raises(mt.MXNetError, match="ambiguous"):
        bool(b)
    with pytest.raises(mt.MXNetError, match="not a scalar"):
        b.asscalar()
    assert "<NDArray 2x3x4 @cpu>" in repr(b)
    c = b.copy()
    c += 1
    same(b, a)
    dst = mt.nd.zeros((2, 3, 4), ctx=CPU, dtype="bfloat16")
    assert b.copyto(dst) is dst and dst.dtype == torch.bfloat16
    np.testing.assert_allclose(dst.asnumpy(), x, rtol=1e-2)
    assert b.copyto("cpu").context == CPU
    assert b.as_in_context(CPU) is b
    with pytest.raises(mt.MXNetError, match="shape mismatch"):
        b.copyto(mt.nd.zeros((2,), ctx=CPU))
    mt.nd.waitall()
    assert b.wait_to_read() is b


# -------------------------------------------------------------- arithmetic
_BINOPS = {
    "add": lambda p, q: p + q, "sub": lambda p, q: p - q,
    "mul": lambda p, q: p * q, "div": lambda p, q: p / q,
    "mod": lambda p, q: p % q, "pow": lambda p, q: abs(p) ** q,
    "eq": lambda p, q: p == q, "ne": lambda p, q: p != q,
    "gt": lambda p, q: p > q, "ge": lambda p, q: p >= q,
    "lt": lambda p, q: p < q, "le": lambda p, q: p <= q,
}


@pytest.mark.parametrize("op", sorted(_BINOPS))
@pytest.mark.parametrize("rhs", ["ndarray", "broadcast", "int", "float",
                                 "numpy"])
def test_binary_dunders(op, rhs):
    r = _rng(3)
    x = np.round(r.randn(2, 3, 4) * 3).astype(np.float32) + 0.5
    y = np.round(r.randn(2, 3, 4) * 3).astype(np.float32) + 0.5
    a, b = both(x)
    if rhs == "ndarray":
        ra, rb = both(y)
    elif rhs == "broadcast":
        ra, rb = both(y[:1, :, :1])
    elif rhs == "int":
        ra = rb = 2
    elif rhs == "float":
        ra = rb = 1.5
    else:
        ra = rb = y
    same(_BINOPS[op](b, rb), _BINOPS[op](a, ra), **EW)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "mod", "pow"])
@pytest.mark.parametrize("lhs", ["int", "float", "numpy"])
def test_reflected_dunders(op, lhs):
    r = _rng(4)
    x = np.abs(r.randn(3, 4)).astype(np.float32) + 0.5
    a, b = both(x)
    s = {"int": 3, "float": 2.5,
         "numpy": np.abs(r.randn(3, 4)).astype(np.float32) + 0.5}[lhs]
    same(_BINOPS[op](s, b), _BINOPS[op](s, a), **EW)


def test_integer_arithmetic_keeps_jax_types():
    x = np.arange(-6, 6, dtype=np.int32).reshape(3, 4)
    a, b = both(x)
    for fn in (lambda p: p + 2, lambda p: p * 3, lambda p: p % 5,
               lambda p: p + 2.5, lambda p: p / 4, lambda p: -p,
               lambda p: abs(p)):
        same(fn(b), fn(a), **EW)


def test_unary_matmul_and_inplace_dunders():
    r = _rng(5)
    x = r.randn(3, 4).astype(np.float32)
    y = r.randn(4, 2).astype(np.float32)
    a, b = both(x)
    ya, yb = both(y)
    same(-b, -a)
    same(abs(b), abs(a))
    same(b @ yb, a @ ya, **RED)
    for fn in (lambda p: p.__iadd__(2.0), lambda p: p.__isub__(p),
               lambda p: p.__imul__(3), lambda p: p.__itruediv__(2.0)):
        ca, cb = both(x)
        ref = fn(ca)
        got = fn(cb)
        assert got is cb
        same(got, ref, **EW)
    assert b._version == 0 and (b.__iadd__(1)) is b and b._version == 1


# ---------------------------------------------------------------- indexing
@pytest.mark.parametrize("key", [
    1, -1, slice(1, 3), (0, slice(None), 2), (slice(None), -1),
    (Ellipsis, 1), "nd-int", "list", "bool-mask", 1.0, (None, 0),
], ids=["int", "neg", "slice", "tuple", "neg-col", "ellipsis", "nd-index",
        "list", "bool-mask", "float", "newaxis"])
def test_getitem(key):
    x = _rng(6).randn(4, 3, 5).astype(np.float32)
    a, b = both(x)
    if key == "nd-int":
        ka, kb = both(np.array([2, 0, 3], np.float32))   # float ids truncate
    elif key == "list":
        ka = kb = [3, 1]
    elif key == "bool-mask":
        m = x[:, 0, 0] > 0
        ka, kb = both(m)
    else:
        ka = kb = key
    same(b[kb], a[ka])


@pytest.mark.parametrize("case", ["scalar-slice", "full", "int-row",
                                  "nd-value", "numpy-value", "tuple"])
def test_setitem(case):
    x = _rng(7).randn(3, 4).astype(np.float32)
    v = _rng(8).randn(3, 4).astype(np.float32)
    a, b = both(x)
    if case == "scalar-slice":
        a[1:3] = 2.0
        b[1:3] = 2.0
    elif case == "full":
        va, vb = both(v)
        a[:] = va
        b[:] = vb
    elif case == "int-row":
        a[0] = 5
        b[0] = 5
    elif case == "nd-value":
        va, vb = both(v[1])
        a[2] = va
        b[2] = vb
    elif case == "numpy-value":
        a[:, 1] = v[:, 1]
        b[:, 1] = v[:, 1]
    else:
        a[1, 2] = -1.0
        b[1, 2] = -1.0
    same(b, a)


def test_setitem_under_record_raises():
    _, b = both(np.zeros(3, np.float32))
    with mt.autograd.record():
        with pytest.raises(mt.MXNetError, match="Inplace assignment"):
            b[0] = 1.0


# ------------------------------------------------------------ shape methods
@pytest.mark.parametrize("fn", [
    lambda p: p.reshape(4, -1), lambda p: p.reshape((0, -1)),
    lambda p: p.reshape(shape=(2, 2, 6)), lambda p: p.expand_dims(1),
    lambda p: p.reshape(1, 4, 1, 6).squeeze(),
    lambda p: p.reshape(1, 4, 1, 6).squeeze(axis=2),
    lambda p: p.transpose(), lambda p: p.transpose(1, 0),
    lambda p: p.T, lambda p: p.swapaxes(0, 1), lambda p: p.flatten(),
    lambda p: p[:1].broadcast_to((3, 6)), lambda p: p.zeros_like(),
    lambda p: p.ones_like(), lambda p: p.detach(),
    lambda p: p.reshape_like(p.reshape(6, 4)),
    lambda p: p[:1].broadcast_like(p),
], ids=["reshape", "reshape-0", "reshape-kw", "expand_dims", "squeeze",
        "squeeze-axis", "transpose", "transpose-axes", "T", "swapaxes",
        "flatten", "broadcast_to", "zeros_like", "ones_like", "detach",
        "reshape_like", "broadcast_like"])
def test_shape_methods(fn):
    a, b = both(_rng(9).randn(4, 6).astype(np.float32))
    same(fn(b), fn(a))


# ------------------------------------------------------- registry: elemwise
_ANY, _POS, _UNIT, _BIG = "any", "pos", "unit", "big"
_UNARY = [
    ("abs", _ANY), ("sign", _ANY), ("rint", _ANY), ("round", _ANY),
    ("ceil", _ANY), ("floor", _ANY), ("trunc", _ANY), ("fix", _ANY),
    ("square", _ANY), ("sqrt", _POS), ("rsqrt", _POS), ("cbrt", _ANY),
    ("rcbrt", _POS), ("exp", _ANY), ("log", _POS), ("log10", _POS),
    ("log2", _POS), ("log1p", _POS), ("expm1", _ANY), ("gamma", _POS),
    ("gammaln", _BIG), ("erf", _ANY), ("erfinv", _UNIT), ("sin", _ANY),
    ("cos", _ANY), ("tan", _UNIT), ("arcsin", _UNIT), ("arccos", _UNIT),
    ("arctan", _ANY), ("sinh", _ANY), ("cosh", _ANY), ("tanh", _ANY),
    ("arcsinh", _ANY), ("arctanh", _UNIT), ("degrees", _ANY),
    ("radians", _ANY), ("reciprocal", _POS), ("negative", _ANY),
    ("logical_not", _ANY), ("relu", _ANY), ("sigmoid", _ANY),
    ("softsign", _ANY), ("identity", _ANY), ("BlockGrad", _ANY),
    ("make_loss", _ANY),
]


def _domain(kind, shape, seed):
    r = _rng(seed)
    if kind == _POS:
        return r.uniform(0.5, 3.0, shape).astype(np.float32)
    if kind == _UNIT:
        return r.uniform(-0.9, 0.9, shape).astype(np.float32)
    if kind == _BIG:   # away from lgamma's roots at 1 and 2, where one
        # ulp of a term near 1 is a large relative error of the result
        return r.uniform(2.5, 6.0, shape).astype(np.float32)
    x = (r.randn(*shape) * 2).astype(np.float32)
    x.flat[0] = 0.0
    return x


@pytest.mark.parametrize("name,kind", _UNARY, ids=[u[0] for u in _UNARY])
def test_unary_ops(name, kind):
    a, b = both(_domain(kind, (3, 7), 10))
    # jax's gammaln is off float64 scipy by up to 2e-6 on these inputs
    # (torch's lgamma by 1.3e-7), so that one reference holds to 5e-6
    tol = dict(rtol=5e-6, atol=1e-7) if name == "gammaln" else EW
    same(getattr(mt.nd, name)(b), getattr(mx.nd, name)(a), **tol)


def test_unary_ops_as_methods_and_arccosh():
    a, b = both(_rng(11).uniform(1.1, 3.0, (4, 5)).astype(np.float32))
    same(mt.nd.arccosh(b), mx.nd.arccosh(a), **EW)
    for name in ("exp", "sqrt", "relu", "sigmoid", "clip", "sum", "norm"):
        same(getattr(b, name)(), getattr(a, name)(), **RED)


_BINARY = ["broadcast_add", "broadcast_sub", "broadcast_mul",
           "broadcast_div", "broadcast_mod", "broadcast_power",
           "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
           "arctan2", "broadcast_equal", "broadcast_not_equal",
           "broadcast_greater", "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_logical_and",
           "broadcast_logical_or", "broadcast_logical_xor", "elemwise_add",
           "elemwise_mul", "maximum", "ldexp"]


@pytest.mark.parametrize("name", _BINARY)
def test_binary_ops(name):
    r = _rng(12)
    x = np.round(r.uniform(0.5, 3.0, (2, 3, 4)) * 2).astype(np.float32) / 2
    y = np.round(r.uniform(0.5, 3.0, (1, 3, 1)) * 2).astype(np.float32) / 2
    if name.startswith("elemwise"):
        y = np.broadcast_to(y, x.shape).copy()
    a, b = both(x)
    ya, yb = both(y)
    same(getattr(mt.nd, name)(b, yb), getattr(mx.nd, name)(a, ya), **EW)


@pytest.mark.parametrize("name", ["_plus_scalar", "_minus_scalar",
                                  "_mul_scalar", "_div_scalar",
                                  "_rminus_scalar", "_rdiv_scalar",
                                  "_rpower_scalar", "_power_scalar",
                                  "_maximum_scalar", "_mod_scalar",
                                  "_rmod_scalar", "_greater_scalar",
                                  "_hypot_scalar"])
def test_scalar_ops(name):
    a, b = both(_rng(13).uniform(0.5, 3.0, (3, 4)).astype(np.float32))
    same(getattr(mt.nd._internal, name)(b, 1.5),
         getattr(mx.nd._internal, name)(a, 1.5), **EW)


@pytest.mark.parametrize("name,kwargs", [
    ("smooth_l1", dict(scalar=1.0)), ("smooth_l1", dict(scalar=2.0)),
    ("clip", dict(a_min=-0.5, a_max=0.7)), ("clip", dict(a_max=0.3)),
    ("hard_sigmoid", {}), ("hard_sigmoid", dict(alpha=0.5, beta=0.2)),
    ("cast", dict(dtype="int32")), ("cast", dict(dtype="bfloat16")),
    ("Cast", dict(dtype="float64")),
], ids=["smooth_l1", "smooth_l1-2", "clip", "clip-max", "hard_sigmoid",
        "hard_sigmoid-ab", "cast-int", "cast-bf16", "Cast-f64"])
def test_attr_elemwise_ops(name, kwargs):
    a, b = both((_rng(14).randn(4, 5) * 2).astype(np.float32))
    same(getattr(mt.nd, name)(b, **kwargs), getattr(mx.nd, name)(a, **kwargs),
         **EW)


@pytest.mark.parametrize("name,kw", [("zeros_like", {}), ("ones_like", {}),
                                     ("full_like", dict(fill_value=2.5))])
def test_like_ops(name, kw):
    a, b = both(np.arange(6, dtype=np.int32).reshape(2, 3))
    same(getattr(mt.nd, name)(b, **kw), getattr(mx.nd, name)(a, **kw))


def test_elemwise_sum_and_where():
    r = _rng(15)
    xs = [both(r.randn(3, 4).astype(np.float32)) for _ in range(3)]
    same(mt.nd.add_n(*[b for _, b in xs]), mx.nd.add_n(*[a for a, _ in xs]),
         **EW)
    ca, cb = both((r.randn(3, 4) > 0).astype(np.float32))
    same(mt.nd.where(cb, xs[0][1], xs[1][1]),
         mx.nd.where(ca, xs[0][0], xs[1][0]))


# --------------------------------------------------------- registry: reduce
@pytest.mark.parametrize("name", ["sum", "mean", "prod", "nansum", "nanprod",
                                  "max", "min"])
@pytest.mark.parametrize("kw", [
    {}, dict(axis=1), dict(axis=(0, 2), keepdims=True),
    dict(axis=1, exclude=True), dict(axis=-1, keepdims=True),
], ids=["all", "axis1", "axes-keep", "exclude", "last-keep"])
def test_reductions(name, kw):
    x = _rng(16).uniform(0.5, 1.5, (3, 4, 5)).astype(np.float32)
    if name.startswith("nan"):
        x[0, 1, 2] = np.nan
    a, b = both(x)
    same(getattr(mt.nd, name)(b, **kw), getattr(mx.nd, name)(a, **kw), **RED)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "prod"])
def test_integer_reductions_keep_jax_types(name):
    a, b = both(np.arange(1, 13, dtype=np.int32).reshape(3, 4))
    same(getattr(mt.nd, name)(b, axis=1), getattr(mx.nd, name)(a, axis=1),
         **RED)


@pytest.mark.parametrize("name,kw", [
    ("norm", {}), ("norm", dict(ord=1)), ("norm", dict(axis=1)),
    ("norm", dict(axis=(0, 1), keepdims=True)),
    ("argmax", {}), ("argmax", dict(axis=1)),
    ("argmax", dict(axis=0, keepdims=True)), ("argmin", dict(axis=-1)),
    ("argmin", dict(keepdims=True)), ("argmax_channel", {}),
    ("broadcast_axis", dict(axis=1, size=4)),
    ("broadcast_axis", dict(axis=(0, 1), size=(2, 4))),
    ("broadcast_to", dict(shape=(0, 4, 0))),
    ("L2Normalization", {}), ("L2Normalization", dict(mode="channel")),
    ("L2Normalization", dict(mode="spatial")),
], ids=["norm", "norm1", "norm-axis", "norm-keep", "argmax", "argmax-1",
        "argmax-keep", "argmin", "argmin-keep", "argmax_channel", "baxis",
        "baxes", "bto", "l2-instance", "l2-channel", "l2-spatial"])
def test_reduce_family(name, kw):
    x = _rng(17).randn(3, 1, 5).astype(np.float32)
    if name.startswith("broadcast"):
        x = x[:1] if name != "broadcast_to" else x
    a, b = both(x)
    same(getattr(mt.nd, name)(b, **kw), getattr(mx.nd, name)(a, **kw), **RED)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis,keepdims", [(-1, False), (0, True)])
def test_pick_and_broadcast_like(mode, axis, keepdims):
    r = _rng(18)
    x = r.randn(4, 5).astype(np.float32)
    n_idx = 5 if axis == -1 else 5
    idx = r.randint(-3, 8, size=(4,) if axis == -1 else (n_idx,)) \
        .astype(np.float32)
    a, b = both(x)
    ia, ib = both(idx)
    same(mt.nd.pick(b, ib, axis=axis, keepdims=keepdims, mode=mode),
         mx.nd.pick(a, ia, axis=axis, keepdims=keepdims, mode=mode))
    la, lb = both(np.zeros((3, 4, 5), np.float32))
    same(mt.nd.broadcast_like(b, lb), mx.nd.broadcast_like(a, la))


def test_softmax_cross_entropy():
    r = _rng(19)
    a, b = both(r.randn(6, 10).astype(np.float32))
    la, lb = both(r.randint(0, 10, 6).astype(np.float32))
    same(mt.nd.softmax_cross_entropy(b, lb),
         mx.nd.softmax_cross_entropy(a, la), **RED)


# ------------------------------------------------------ registry: creation
@pytest.mark.parametrize("name,args,kw", [
    ("zeros", ((2, 3),), {}), ("zeros", (4,), dict(dtype="int32")),
    ("ones", ((2, 3),), dict(dtype="float64")), ("full", ((2, 2), 7.5), {}),
    ("empty", ((3,),), {}), ("eye", (3,), {}), ("eye", (3, 4, 1), {}),
    ("eye", (4, 3, -1), dict(dtype="int32")),
    ("linspace", (0.0, 1.0, 7), {}),
    ("linspace", (-2.0, 3.0, 6), dict(endpoint=False)),
    ("arange", (5,), {}), ("arange", (2, 11, 3), dict(dtype="int32")),
    ("arange", (0, 3), dict(repeat=2)),
], ids=["zeros", "zeros-int", "ones-f64", "full", "empty", "eye", "eye-k",
        "eye-neg-int", "linspace", "linspace-open", "arange",
        "arange-step-int", "arange-repeat"])
def test_creation_ops(name, args, kw):
    same(getattr(mt.nd, name)(*args, ctx=CPU, **kw),
         getattr(mx.nd, name)(*args, **kw), **EW)


# -------------------------------------------------------- registry: matrix
_MATRIX = [
    ("Reshape", dict(shape=(-1, 0)), 1), ("reshape", dict(shape=(-3, -2)), 1),
    ("transpose", dict(axes=(2, 0, 1)), 1), ("transpose", {}, 1),
    ("expand_dims", dict(axis=-1), 1), ("squeeze", dict(axis=1), 1),
    ("slice", dict(begin=(1, 0), end=(3, 1)), 1),
    ("slice", dict(begin=(None, 0, 1), end=(None, 1, 4), step=(-1, 1, 2)), 1),
    ("slice_axis", dict(axis=2, begin=1, end=3), 1),
    ("slice_axis", dict(axis=-1, begin=-2, end=None), 1),
    ("flip", dict(axis=1), 1), ("reverse", dict(axis=(0, 2)), 1),
    ("tile", dict(reps=(2, 1, 3)), 1), ("tile", dict(reps=(2,)), 1),
    ("repeat", dict(repeats=2), 1), ("repeat", dict(repeats=3, axis=1), 1),
    ("swapaxes", dict(dim1=0, dim2=2), 1),
    ("SwapAxis", dict(dim1=1, dim2=2), 1),
    ("Concat", dict(dim=0), 2), ("concat", dict(dim=2), 3),
    ("stack", dict(axis=1), 2), ("stack", {}, 3),
]


@pytest.mark.parametrize("name,kw,n_in", _MATRIX,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(_MATRIX)])
def test_matrix_ops(name, kw, n_in):
    r = _rng(20)
    arrs = [both(r.randn(3, 1, 4).astype(np.float32)) for _ in range(n_in)]
    same(getattr(mt.nd, name)(*[b for _, b in arrs], **kw),
         getattr(mx.nd, name)(*[a for a, _ in arrs], **kw))


@pytest.mark.parametrize("shapes,kw", [
    (((3, 4), (4, 5)), {}), (((4, 3), (4, 5)), dict(transpose_a=True)),
    (((3, 4), (5, 4)), dict(transpose_b=True)), (((4,), (4,)), {}),
    (((2, 3, 4), (4, 5)), {}), (((4, 3, 2), (4, 5)), dict(transpose_a=True)),
], ids=["2d", "ta", "tb", "vec", "3d", "3d-ta"])
def test_dot(shapes, kw):
    r = _rng(21)
    (a, b), (c, d) = [both(r.randn(*s).astype(np.float32)) for s in shapes]
    same(mt.nd.dot(b, d, **kw), mx.nd.dot(a, c, **kw), **RED)


@pytest.mark.parametrize("kw", [{}, dict(transpose_a=True),
                                dict(transpose_b=True)])
def test_batch_dot(kw):
    r = _rng(22)
    a, b = both(r.randn(2, 3, 3).astype(np.float32))
    c, d = both(r.randn(2, 3, 3).astype(np.float32))
    same(mt.nd.batch_dot(b, d, **kw), mx.nd.batch_dot(a, c, **kw), **RED)


def test_dot_bf16_accumulates_in_f32():
    r = _rng(23)
    a, b = both(r.randn(8, 64).astype(np.float32), dtype="bfloat16")
    c, d = both(r.randn(64, 8).astype(np.float32), dtype="bfloat16")
    got, ref = mt.nd.dot(b, d), mx.nd.dot(a, c)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref.asnumpy()).max())) - 7)
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=0,
                               atol=ulp)


def test_nn_ops_through_the_registry():
    r = _rng(24)
    a, b = both(r.randn(4, 6).astype(np.float32))
    wa, wb = both(r.randn(5, 6).astype(np.float32))
    ba, bb = both(r.randn(5).astype(np.float32))
    same(mt.nd.FullyConnected(b, wb, bb, num_hidden=5),
         mx.nd.FullyConnected(a, wa, ba, num_hidden=5), **RED)
    ga, gb = both(r.uniform(0.5, 1.5, 6).astype(np.float32))
    same(mt.nd.LayerNorm(b, gb, gb), mx.nd.LayerNorm(a, ga, ga), **RED)
    for act in ("relu", "sigmoid", "tanh", "softrelu"):
        same(mt.nd.Activation(b, act_type=act),
             mx.nd.Activation(a, act_type=act), **EW)
    ia, ib = both(np.array([[0, 3], [4, 1]], np.float32))
    same(mt.nd.Embedding(ib, wb, input_dim=5, output_dim=6),
         mx.nd.Embedding(ia, wa, input_dim=5, output_dim=6))


# ---------------------------------------------------- namespace and registry
def test_namespace_registry_and_out():
    assert mt.nd.concat is registry.get_op("Concat").wrapper
    assert mt.nd.contrib.__name__ == "mxtpu_torch.ndarray.contrib"
    assert mt.nd._internal._plus_scalar is \
        registry.get_op("broadcast_add").wrapper
    a, b = both(np.ones((2, 3), np.float32))
    same(mt.nd.concatenate([b, b], axis=1), mx.nd.concatenate([a, a], axis=1))
    out = mt.nd.zeros((2, 3), ctx=CPU)
    assert mt.nd.exp(b, out=out) is out
    np.testing.assert_allclose(out.asnumpy(), np.e, rtol=1e-6)
    assert mt.ops.registry.invoke("sum", b).asscalar() == 6.0
    d = registry.describe("clip")
    assert d["arguments"] == [{"name": "x"}]
    assert {x["name"] for x in d["attributes"]} == {"a_min", "a_max"}
    with pytest.raises(KeyError, match="not registered"):
        registry.get_op("no_such_op")
    with pytest.raises(AttributeError):
        mt.nd.no_such_op
    missing = [n for n in ("sum", "dot", "FullyConnected", "broadcast_add",
                           "pick", "zeros", "linspace", "stack", "slice")
               if n not in registry.list_ops()]
    assert not missing
    # the op modules stay tensor-level: the F namespace of the Gluon layers
    t = torch.ones(2, 3)
    assert isinstance(mt.ops.elemwise.exp(t), torch.Tensor)


# ------------------------------------------------------------------ random
@pytest.mark.parametrize("name", ["uniform", "normal", "randn",
                                  "exponential"])
def test_random_shapes_dtypes_and_streams(name):
    fn = getattr(mt.nd.random, name)
    shape = (300, 200)
    args = shape if name == "randn" else ()
    kw = {} if name == "randn" else dict(shape=shape)
    mt.random.seed(5)
    x = fn(*args, ctx=CPU, **kw)
    y = fn(*args, ctx=CPU, **kw)
    mt.random.seed(5)
    z = fn(*args, ctx=CPU, **kw)
    ref = getattr(mx.nd.random, name)(*args, **kw)
    assert x.shape == ref.shape == shape and x.dtype == ref.dtype
    np.testing.assert_array_equal(x.asnumpy(), z.asnumpy())
    assert not np.array_equal(x.asnumpy(), y.asnumpy())
    # moments against the JAX sampler's, to a few standard errors
    xs, rs = x.asnumpy(), ref.asnumpy()
    se = rs.std() / np.sqrt(xs.size)
    assert abs(xs.mean() - rs.mean()) < 8 * se
    assert abs(xs.std() - rs.std()) < 0.02 * rs.std()


def test_random_parameters_and_ctx_seed():
    mt.random.seed(1)
    u = mt.nd.random.uniform(2.0, 3.0, shape=(1000,), ctx=CPU,
                             dtype="bfloat16")
    assert u.dtype == torch.bfloat16
    assert 2.0 <= u.asnumpy().min() and u.asnumpy().max() <= 3.0
    e = mt.nd.random.exponential(scale=2.0, shape=(20000,), ctx=CPU)
    assert abs(e.asnumpy().mean() - 2.0) < 0.1 and e.asnumpy().min() >= 0
    loc = mt.nd.array(np.array([0.0, 100.0], np.float32), ctx=CPU)
    n = mt.nd.random.normal(loc=loc, scale=1.0, shape=(500,))
    assert n.shape == (2, 500) and n.context == CPU
    assert abs(n.asnumpy()[1].mean() - 100.0) < 0.5
    out = mt.nd.zeros((3,), ctx=CPU)
    assert mt.nd.random.normal(shape=(3,), ctx=CPU, out=out) is out
    mt.random.seed(9, ctx=CPU)
    a = mt.nd.random.randn(4, ctx=CPU)
    mt.random.seed(9, ctx="cpu")
    np.testing.assert_array_equal(a.asnumpy(),
                                  mt.nd.random.randn(4, ctx=CPU).asnumpy())
    mt.random.seed(0)
