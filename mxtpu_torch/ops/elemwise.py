"""Elementwise unary, binary/broadcast, scalar and logic ops (counterpart of
``mxtpu/ops/elemwise.py``, dense only).

Each op is one PyTorch expression on tensors. ``elemwise_*``, ``broadcast_*``
and the ``_*_scalar`` names share one function (numpy broadcasting; a
Python scalar operand takes the tensor's type, as JAX's weak types do).
Logic and comparison results are float32, as in the JAX package. The
sparse scatter ops (``_scatter_*``) wait for sparse storage.
"""
from __future__ import annotations

import math

import torch

from ..base import canonical_dtype
from .registry import register

_f32 = torch.float32


def _u(name, fn, aliases=(), as_method=True):
    """Register a unary op (a one-argument function, so ``describe`` can
    read its signature where ``fn`` is a torch builtin)."""
    return register(name, aliases=aliases, as_method=as_method)(
        lambda x: fn(x))


def _t(v, like):
    """A Python scalar as a 0-d tensor beside ``like`` (0-d tensors take
    part in type promotion like scalars)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, device=like.device)


def _float(x):
    return x if x.is_floating_point() else x.to(_f32)


# ---------------------------------------------------------------- unary math
abs_ = _u("abs", torch.abs)


def _sign(x):
    """jnp.sign: NaN stays NaN and a zero keeps its sign (torch.sign maps
    both to +0); the gradient stays zero everywhere."""
    s = torch.sign(x)
    return torch.where(s == 0, x.detach(), s)


sign = _u("sign", _sign)
rint = _u("rint", torch.round)            # half to even, as jnp.rint
round_ = _u("round", torch.round)         # jnp.round is half to even too
ceil = _u("ceil", torch.ceil)
floor = _u("floor", torch.floor)
trunc = _u("trunc", torch.trunc)
fix = _u("fix", torch.trunc)
square = _u("square", torch.square)
sqrt = _u("sqrt", torch.sqrt)
rsqrt = _u("rsqrt", torch.rsqrt)
cbrt = _u("cbrt", lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0))
rcbrt = _u("rcbrt", lambda x: 1.0 / cbrt(x))
exp = _u("exp", torch.exp)
log = _u("log", torch.log)
log10 = _u("log10", torch.log10)
log2 = _u("log2", torch.log2)
log1p = _u("log1p", torch.log1p)
expm1 = _u("expm1", torch.expm1)
gamma = _u("gamma", lambda x: torch.exp(torch.lgamma(x)))
gammaln = _u("gammaln", torch.lgamma)
erf = _u("erf", torch.erf)
erfinv = _u("erfinv", torch.erfinv)
sin = _u("sin", torch.sin)
cos = _u("cos", torch.cos)
tan = _u("tan", torch.tan)
arcsin = _u("arcsin", torch.asin)
arccos = _u("arccos", torch.acos)
arctan = _u("arctan", torch.atan)
sinh = _u("sinh", torch.sinh)
cosh = _u("cosh", torch.cosh)
tanh = _u("tanh", torch.tanh)
arcsinh = _u("arcsinh", torch.asinh)
arccosh = _u("arccosh", torch.acosh)
arctanh = _u("arctanh", torch.atanh)
degrees = _u("degrees", lambda x: _float(x) * (180.0 / math.pi))
radians = _u("radians", lambda x: _float(x) * (math.pi / 180.0))
reciprocal = _u("reciprocal", lambda x: 1.0 / x)
negative = _u("negative", torch.neg)
logical_not = _u("logical_not", lambda x: torch.logical_not(x).to(_f32))
relu = _u("relu", torch.relu)
sigmoid = _u("sigmoid", torch.sigmoid)
softsign = _u("softsign", lambda x: x / (1.0 + torch.abs(x)))
identity = _u("identity", lambda x: x, aliases=("_copy",), as_method=False)


@register("BlockGrad", aliases=("stop_gradient",), as_method=True)
def BlockGrad(x):
    """Stop gradient flow (ref: elemwise_unary_op_basic.cc BlockGrad)."""
    return x.detach()


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_scale):
        ctx.grad_scale = grad_scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


@register("make_loss", aliases=("MakeLoss",))
def make_loss(x, grad_scale=1.0, **_ignored):
    """Head marker whose gradient is ``grad_scale`` (ref: make_loss.cc)."""
    return _MakeLoss.apply(x, float(grad_scale))


# ---------------------------------------------------------------- binary
def _b(name, fn, aliases=(), as_method=False):
    return register(name, aliases=aliases, as_method=as_method)(fn)


def _cmp(fn):
    return lambda a, b: fn(a, b).to(_f32)


broadcast_add = _b("broadcast_add", lambda a, b: a + b,
                   aliases=("elemwise_add", "_plus_scalar", "_add",
                            "_grad_add"))
broadcast_sub = _b("broadcast_sub", lambda a, b: a - b,
                   aliases=("elemwise_sub", "_minus_scalar", "_sub"))
broadcast_mul = _b("broadcast_mul", lambda a, b: a * b,
                   aliases=("elemwise_mul", "_mul_scalar", "_mul"))
broadcast_div = _b("broadcast_div", lambda a, b: a / b,
                   aliases=("elemwise_div", "_div_scalar", "_div"))
broadcast_mod = _b("broadcast_mod", lambda a, b: a % b,
                   aliases=("_mod_scalar", "_mod"))
_rmod_scalar = _b("_rmod_scalar", lambda a, b: b % a)
broadcast_power = _b("broadcast_power", lambda a, b: a ** b,
                     aliases=("_power_scalar", "_power"))
broadcast_maximum = _b("broadcast_maximum",
                       lambda a, b: torch.maximum(a, _t(b, a)),
                       aliases=("_maximum_scalar", "_maximum", "maximum"))
broadcast_minimum = _b("broadcast_minimum",
                       lambda a, b: torch.minimum(a, _t(b, a)),
                       aliases=("_minimum_scalar", "_minimum", "minimum"))
broadcast_hypot = _b("broadcast_hypot",
                     lambda a, b: torch.hypot(_float(a), _t(b, a)),
                     aliases=("_hypot", "_hypot_scalar"))
_rminus_scalar = _b("_rminus_scalar", lambda a, b: b - a)
_rdiv_scalar = _b("_rdiv_scalar", lambda a, b: b / a)
_rpower_scalar = _b("_rpower_scalar", lambda a, b: b ** a)
arctan2 = _b("arctan2", lambda a, b: torch.atan2(_float(a), _t(b, a)),
             aliases=("_arctan2",))
ldexp = _b("ldexp", lambda a, b: a * (2.0 ** b))

broadcast_equal = _b("broadcast_equal", _cmp(lambda a, b: a == b),
                     aliases=("_equal", "_equal_scalar"))
broadcast_not_equal = _b("broadcast_not_equal", _cmp(lambda a, b: a != b),
                         aliases=("_not_equal", "_not_equal_scalar"))
broadcast_greater = _b("broadcast_greater", _cmp(lambda a, b: a > b),
                       aliases=("_greater", "_greater_scalar"))
broadcast_greater_equal = _b("broadcast_greater_equal",
                             _cmp(lambda a, b: a >= b),
                             aliases=("_greater_equal",
                                      "_greater_equal_scalar"))
broadcast_lesser = _b("broadcast_lesser", _cmp(lambda a, b: a < b),
                      aliases=("_lesser", "_lesser_scalar"))
broadcast_lesser_equal = _b("broadcast_lesser_equal",
                            _cmp(lambda a, b: a <= b),
                            aliases=("_lesser_equal", "_lesser_equal_scalar"))
broadcast_logical_and = _b("broadcast_logical_and",
                           _cmp(lambda a, b: torch.logical_and(a, _t(b, a))),
                           aliases=("_logical_and", "_logical_and_scalar"))
broadcast_logical_or = _b("broadcast_logical_or",
                          _cmp(lambda a, b: torch.logical_or(a, _t(b, a))),
                          aliases=("_logical_or", "_logical_or_scalar"))
broadcast_logical_xor = _b("broadcast_logical_xor",
                           _cmp(lambda a, b: torch.logical_xor(a, _t(b, a))),
                           aliases=("_logical_xor", "_logical_xor_scalar"))


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    """Huber-like smooth L1 (ref: elemwise_binary_scalar_op_extended.cc)."""
    s2 = scalar * scalar
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       ax - 0.5 / s2)


@register("clip", as_method=True)
def clip(x, a_min=None, a_max=None):
    """Clamp (ref: matrix_op.cc clip); zero gradient outside the interval."""
    if a_min is None and a_max is None:
        return x
    return torch.clamp(x, a_min, a_max)


@register("elemwise_sum", aliases=("add_n", "ElementWiseSum"))
def elemwise_sum(*args):
    """Sum of N arrays (ref: ndarray.cc ElementwiseSum)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("where")
def where(condition, x, y):
    """Select by condition (ref: control_flow_op.cc where)."""
    return torch.where(condition.bool(), x, y)


@register("cast", aliases=("Cast",), as_method=False)
def cast(x, dtype="float32"):
    return x.to(canonical_dtype(dtype))


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    """``max(0, min(1, alpha*x + beta))`` as nested selects, so the
    gradient is alpha strictly inside the linear band and 0 at and beyond
    saturation (ref: elemwise_unary_op_basic.cc:109)."""
    y = alpha * x + beta
    return torch.where(y <= 0.0, torch.zeros_like(y),
                       torch.where(y >= 1.0, torch.ones_like(y), y))
