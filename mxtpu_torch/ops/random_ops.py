"""Random draws as registry ops (counterpart of ``mxtpu/ops/random_ops.py``;
ref: src/operator/random/sample_op.cc, multisample_op.cc,
sample_multinomial_op.cc, shuffle_op.cc, unique_sample_op.cc).

Every draw comes from the port's generator of the output's device
(``mxtpu_torch.random.generator``), through torch calls that take that
generator: ``torch.distributions`` is not used, since it draws from torch's
global default generator. The streams differ from the JAX package's keys
(one seed reproduces one stream), so the tests hold moments, supports and
shapes. Samples are fresh leaves: nothing is taped.

A creation op (``uniform``, ``normal``, ``randint``, ...) lands on ``ctx``
(default: the current context); given tensor parameters and no ``ctx`` it
lands on theirs. Parameters given as tensors broadcast together, and
``shape`` is appended to their shape: one sample set per parameter element.
A ``*_like`` op, ``multinomial`` and ``shuffle`` run where their input is.
Because they are registry ops, ``mx.sym`` graphs can draw; a captured graph
registers the generator, so each replay draws afresh. On a meta tensor
(shape inference) an op gives an empty meta tensor of the right shape.

``_sample_unique_zipfian`` is host work by design, as in the reference (a
rejection loop over a set): it raises inside a graph capture.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import graphs
from .. import random as _rnd
from ..base import MXNetError, canonical_dtype
from ..context import resolve_device
from .registry import register, register_num_outputs

__all__ = ["uniform", "normal", "gamma_sample", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "_sample_unique_zipfian", "shuffle",
           "uniform_like", "normal_like"]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dt(dtype):
    return torch.float32 if dtype in (None, "None") \
        else canonical_dtype(dtype)


def _params(shape, ctx, *params):
    """(sample shape, device, params as numbers or float32 tensors shaped
    to broadcast against the samples)."""
    tensors = [p for p in params if isinstance(p, torch.Tensor)]
    dev = tensors[0].device if tensors and ctx is None \
        else resolve_device(ctx)
    base = tuple(torch.broadcast_shapes(*[t.shape for t in tensors])) \
        if tensors else ()
    extra = _shape(shape)
    vals = [p.to(dev, torch.float32).reshape(tuple(p.shape)
                                             + (1,) * len(extra))
            if isinstance(p, torch.Tensor) else p for p in params]
    return base + extra, dev, vals


def _meta(shape, dev, dt):
    """The empty result of a draw on the meta device, else None."""
    if dev.type == "meta":
        return torch.empty(shape, dtype=dt, device=dev)
    return None


def _full(v, shape, dev):
    """``v`` (a number or a broadcastable tensor) as a float32 tensor of
    ``shape``."""
    if isinstance(v, torch.Tensor):
        return v.expand(shape).contiguous()
    return torch.full(shape, float(v), dtype=torch.float32, device=dev)


def _gamma(alpha, shape, dev, gen):
    return torch._standard_gamma(_full(alpha, shape, dev), generator=gen)


@register("uniform", aliases=("_random_uniform", "random_uniform"))
def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **_ig):
    """Samples of U[low, high)."""
    shape, dev, (lo, hi) = _params(shape, ctx, low, high)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    with torch.no_grad():
        u = torch.rand(shape, generator=_rnd.generator(dev), device=dev)
        return (u * (hi - lo) + lo).to(dt)


@register("normal", aliases=("_random_normal", "random_normal", "randn"))
def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **_ig):
    """Samples of N(loc, scale^2)."""
    shape, dev, (lo, sc) = _params(shape, ctx, loc, scale)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    with torch.no_grad():
        z = torch.randn(shape, generator=_rnd.generator(dev), device=dev)
        return (z * sc + lo).to(dt)


@register("_random_gamma",
          aliases=("random_gamma", "sample_gamma", "_sample_gamma"))
def gamma_sample(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None,
                 out=None, **_ig):
    """Samples of Gamma(shape ``alpha``, scale ``beta``). Registered under
    the ``_random_`` names only: ``gamma`` is the gamma function, as in the
    reference."""
    shape, dev, (a, b) = _params(shape, ctx, alpha, beta)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    with torch.no_grad():
        return (_gamma(a, shape, dev, _rnd.generator(dev)) * b).to(dt)


@register("exponential", aliases=("_random_exponential",
                                  "random_exponential"))
def exponential(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **_ig):
    """Samples of an exponential of rate ``lam`` (``mx.nd.random`` takes
    its mean, ``scale``)."""
    shape, dev, (lm,) = _params(shape, ctx, lam)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    with torch.no_grad():
        e = torch.empty(shape, dtype=torch.float32, device=dev).exponential_(
            1.0, generator=_rnd.generator(dev))
        return (e / lm).to(dt)


@register("poisson", aliases=("_random_poisson", "random_poisson"))
def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **_ig):
    """Samples of Poisson(``lam``), as ``dtype`` (float32 by default)."""
    shape, dev, (lm,) = _params(shape, ctx, lam)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    with torch.no_grad():
        return torch.poisson(_full(lm, shape, dev),
                             generator=_rnd.generator(dev)).to(dt)


def _gamma_poisson(shape_a, scale, shape, dev, dt):
    """Poisson(Gamma(shape_a) * scale): the negative binomials' mixture."""
    gen = _rnd.generator(dev)
    with torch.no_grad():
        lam = _gamma(shape_a, shape, dev, gen) * scale
        return torch.poisson(lam, generator=gen).to(dt)


@register("negative_binomial", aliases=("_random_negative_binomial",))
def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None, **_ig):
    """Failures before the ``k``-th success of trials that succeed with
    probability ``p``: Poisson(Gamma(k) * (1 - p) / p)."""
    shape, dev, (kk, pp) = _params(shape, ctx, k, p)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    return _gamma_poisson(kk, (1.0 - pp) / pp, shape, dev, dt)


@register("generalized_negative_binomial",
          aliases=("_random_generalized_negative_binomial",))
def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, **_ig):
    """Mean ``mu``, dispersion ``alpha``: Poisson(Gamma(1 / alpha) * alpha
    * mu)."""
    shape, dev, (mm, aa) = _params(shape, ctx, mu, alpha)
    dt = _dt(dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    return _gamma_poisson(1.0 / aa, aa * mm, shape, dev, dt)


@register("randint", aliases=("_random_randint", "random_randint"))
def randint(low=0, high=None, shape=None, dtype="int32", ctx=None, **_ig):
    """Integers drawn uniformly from [low, high)."""
    dev = resolve_device(ctx)
    shape = _shape(shape)
    dt = canonical_dtype("int32" if dtype in (None, "None") else dtype)
    m = _meta(shape, dev, dt)
    if m is not None:
        return m
    return torch.randint(int(low), int(high), shape,
                         generator=_rnd.generator(dev), device=dev, dtype=dt)


@register("multinomial", aliases=("_sample_multinomial",
                                  "sample_multinomial"))
def multinomial(data, shape=None, get_prob=False, dtype="int32", **_ig):
    """Category ids drawn from the distribution(s) in the last axis of
    ``data`` (1-D or 2-D; need not sum to 1): one id per distribution, or
    ``prod(shape)`` of them in a new last axis. With ``get_prob`` also the
    log-probability of each drawn id (ref: sample_multinomial_op.cc)."""
    n = 1 if shape in (None, ()) else int(_np.prod(_shape(shape)))
    logits = torch.log(torch.clamp_min(data.float(), 1e-30))
    dt = canonical_dtype(dtype)
    rows = logits.reshape(-1, logits.shape[-1])
    if data.device.type == "meta":
        out = torch.empty((rows.shape[0], n), dtype=torch.int64,
                          device=data.device)
    else:
        with torch.no_grad():
            out = torch.multinomial(torch.softmax(rows, -1), n,
                                    replacement=True,
                                    generator=_rnd.generator(data.device))
    lp = torch.log_softmax(rows, -1).gather(-1, out) if get_prob else None
    lead = tuple(data.shape[:-1])
    tail = () if shape in (None, ()) else (n,)
    out_shape = lead + tail
    res = out.reshape(out_shape).to(dt)
    if get_prob:
        return [res, lp.reshape(out_shape)]
    return res


@register("_sample_unique_zipfian", num_outputs=2)
def _sample_unique_zipfian(range_max, shape=None, ctx=None, **_ig):
    """Per row ``num_sampled`` distinct ids of the approximate Zipfian
    (log-uniform) distribution over [0, range_max), with the number of
    tries each row took (ref: unique_sample_op.cc, a host kernel there
    too): host work by design, so it raises inside a graph capture. Its
    host stream is seeded from the port's generator of the output's
    device."""
    if graphs.capturing():
        raise MXNetError(
            "_sample_unique_zipfian is a host rejection loop: it cannot run "
            "inside a CUDA-graph capture")
    shp = _shape(shape)
    if len(shp) != 2:
        raise ValueError("_sample_unique_zipfian needs a 2-D shape, got %r"
                         % (shape,))
    batch, num_sampled = shp
    if num_sampled > range_max:
        raise ValueError("cannot draw %d unique samples from range_max=%d"
                         % (num_sampled, range_max))
    if range_max >= 2 ** 31:
        raise ValueError("range_max %d exceeds int32 id space" % range_max)
    dev = resolve_device(ctx)
    if dev.type == "meta":
        return [torch.empty(shp, dtype=torch.int32, device=dev),
                torch.empty((batch,), dtype=torch.int32, device=dev)]
    seed = int(torch.randint(0, 2 ** 31 - 1, (), device=dev,
                             generator=_rnd.generator(dev)))
    rng = _np.random.default_rng(seed)
    log_range = _np.log(range_max)
    samples = _np.empty((batch, num_sampled), dtype=_np.int32)
    tries = _np.empty((batch,), dtype=_np.int32)
    for i in range(batch):
        seen = set()
        t = 0
        while len(seen) < num_sampled:
            draw = _np.floor(
                _np.exp(rng.random(max(num_sampled, 16)) * log_range) + 0.5
            ).astype(_np.int32) - 1
            for v in draw:
                t += 1
                if v not in seen:
                    samples[i, len(seen)] = v
                    seen.add(int(v))
                    if len(seen) == num_sampled:
                        break
        tries[i] = t
    return [torch.from_numpy(samples).to(dev),
            torch.from_numpy(tries).to(dev)]


@register("shuffle", aliases=("_shuffle",))
def shuffle(data, **_ig):
    """``data`` with its first axis permuted."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=_rnd.generator(
        data.device), device=data.device)
    with torch.no_grad():
        return data.index_select(0, perm)


@register("uniform_like")
def uniform_like(data, low=0.0, high=1.0, **_ig):
    """U[low, high) samples in ``data``'s shape and type."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    with torch.no_grad():
        u = torch.rand(data.shape, generator=_rnd.generator(data.device),
                       device=data.device)
        return (u * (high - low) + low).to(data.dtype)


@register("normal_like")
def normal_like(data, loc=0.0, scale=1.0, **_ig):
    """N(loc, scale^2) samples in ``data``'s shape and type."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    with torch.no_grad():
        z = torch.randn(data.shape, generator=_rnd.generator(data.device),
                        device=data.device)
        return (z * scale + loc).to(data.dtype)


@register_num_outputs("multinomial")
def _multinomial_num_outputs(attrs):
    return 2 if str(attrs.get("get_prob")) in ("True", "1", "true") else 1
