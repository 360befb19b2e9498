"""``mx.nd.random`` (counterpart of ``mxtpu/ndarray/random.py``): the
registry's samplers of ``ops/random_ops.py``, as the reference generates
them from its ``_random_*``/``_sample_*`` entries. Draws come from the
device's generator in ``mxtpu_torch.random``; samples are fresh leaves
(nothing is taped). Parameters given as NDArrays broadcast together, and
``shape`` is appended to their shape: one sample set per parameter
element."""
from __future__ import annotations

from ..ops import registry as _reg

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]


def _op(name):
    return _reg.get_op(name).wrapper


uniform = _op("uniform")
normal = _op("normal")


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None, **kwargs):
    """Normal samples of shape ``*shape`` (ref: ndarray/random.py:randn)."""
    return normal(loc=loc, scale=scale, shape=shape or None, dtype=dtype,
                  ctx=ctx, **kwargs)


gamma = _op("_random_gamma")


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, **kwargs):
    """Samples of an exponential with mean ``scale`` (ref:
    ndarray/random.py:exponential; the registry op takes the rate)."""
    return _op("exponential")(lam=1.0 / scale, shape=shape, dtype=dtype,
                              ctx=ctx, **kwargs)


poisson = _op("poisson")
negative_binomial = _op("negative_binomial")
generalized_negative_binomial = _op("generalized_negative_binomial")
multinomial = _op("multinomial")
shuffle = _op("shuffle")
randint = _op("randint")
