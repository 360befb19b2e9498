"""Weights carried between the JAX package and the port.

``load_mxtpu_params(net, arrays)`` takes ``{name: np.ndarray}`` as the JAX
package's ``collect_params()`` gives it (``p.data().asnumpy()``) and loads
it into a port block built the same way; ``params_to_numpy(net)`` is the
inverse. Names match after the top-level block prefix is stripped, so
``resnetv10_conv2d0_weight`` loads into ``resnetv11_conv2d0_weight`` of the
second net a process builds (``_key``). A missing, extra or misshapen
array raises.

``seeded_params`` makes reproducible random weights for such a net, with
BatchNorm statistics far enough from the defaults that a parity test
compares real signal (the default initializer gives ResNet logits near
1e-4).

``load_mxtpu_optimizer_states(trainer, blob)`` resumes a port Trainer from
what the JAX package's ``Updater.get_states(dump_optimizer=False)`` wrote:
a pickle of ``{index: state}`` with numpy arrays, tuples and None. It
unpickles numpy types only; a blob that holds a pickled ``mxtpu``
optimizer (``dump_optimizer=True``) or any other class raises, and the
JAX package is never imported to read it.
"""
from __future__ import annotations

import io
import pickle
import re
import zlib

import numpy as np
import torch

from .base import MXNetError

__all__ = ["load_mxtpu_params", "params_to_numpy", "seeded_params",
           "load_mxtpu_optimizer_states"]


def _strip_top(names):
    """{name without its top-level prefix: name}; the prefix is the first
    '_'-terminated token (block hints hold no '_') and must be shared."""
    tops = {n.partition("_")[0] for n in names}
    if len(tops) > 1:
        raise MXNetError("parameters come from several top-level blocks: %s"
                         % sorted(tops))
    return {n.partition("_")[2]: n for n in names}


def _key(name, prefix):
    """``name`` without its top-level prefix: ``prefix`` itself, or where
    ``prefix`` ends in a counter, the same stem with any counter
    (``resnetv10_`` for ``resnetv11_``, ``conv_lstm1_`` for
    ``conv_lstm0_``). A name that does not start so is left alone (a
    ``BidirectionalCell``'s, whose two cells are top-level blocks)."""
    m = re.fullmatch(r"(.*?)\d+_", prefix)
    top = re.escape(m.group(1)) + r"\d+_" if m else re.escape(prefix)
    return re.sub("^" + top, "", name)


def load_mxtpu_params(net, arrays):
    """Load ``{mxtpu name: array}`` into ``net``'s parameters, each in the
    parameter's dtype and on its device."""
    ours = {_key(n, net.prefix): p
            for n, p in net.collect_params().items()}
    theirs = {_key(n, net.prefix): n for n in arrays}
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise MXNetError("load_mxtpu_params: missing %s, extra %s"
                         % (missing[:5], extra[:5]))
    for key, p in ours.items():
        a = np.asarray(arrays[theirs[key]])
        known = p.shape or ()
        if len(known) != a.ndim or any(
                s != 0 and s != g for s, g in zip(known, a.shape)):
            raise MXNetError("load_mxtpu_params: %s has shape %s, the array "
                             "%s" % (p.name, p.shape, a.shape))
        p.set_data(a)


def params_to_numpy(net):
    """``{name: np.ndarray}`` of every parameter, a copy (bf16 as float32,
    exact)."""
    out = {}
    for name, p in net.collect_params().items():
        t = p.data().to_torch().detach()
        # a copy: an optimizer step writes into the parameter in place
        t = t.float() if t.dtype in (torch.bfloat16, torch.float16) \
            else t.clone()
        out[name] = t.cpu().numpy()
    return out


def seeded_params(shapes, seed=0, prefix=None):
    """Random weights for ``{name: shape}``, each drawn from its own numpy
    generator keyed by ``seed`` and ``_key(name, prefix)`` (so the order
    and the counter of the prefix do not matter); ``prefix`` defaults to
    each name's first '_'-terminated token. Pass the block's prefix where
    its parameters lie under several top-level blocks, so that no two
    names share a key. He-normal weights (4-D read as HWIO, 2-D as (out,
    in)), BatchNorm gamma and running_var ~U(0.5, 1.5), beta,
    running_mean and biases ~N(0, 0.1)."""
    out = {}
    for name in shapes:
        key = _key(name, name.partition("_")[0] + "_" if prefix is None
                   else prefix)
        shape = tuple(shapes[name])
        rng = np.random.default_rng([int(seed), zlib.crc32(key.encode())])
        if key.endswith("weight"):
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else \
                int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif key.endswith(("gamma", "running_var")):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        out[name] = a.astype(np.float32)
    return out


class _NumpyOnly(pickle.Unpickler):
    """Unpickles numpy arrays, dtypes and scalars, and plain containers."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        if module.split(".")[0] == "mxtpu":
            raise MXNetError(
                "the optimizer-state blob holds a pickled %s.%s of the JAX "
                "package: write it with get_states(dump_optimizer=False), "
                "which holds numpy arrays only" % (module, name))
        raise MXNetError("the optimizer-state blob holds %s.%s; only numpy "
                         "arrays, tuples and None are read" % (module, name))


def load_mxtpu_optimizer_states(trainer, blob):
    """Set ``trainer``'s optimizer states from the JAX package's
    ``Updater.get_states(dump_optimizer=False)`` bytes (keys are the
    indices of the trainer's parameter list, in the same order). Each
    state moves to its weight's device and type at its first update;
    update counts stay the port optimizer's own."""
    states = _NumpyOnly(io.BytesIO(blob)).load()
    if not isinstance(states, dict):
        raise MXNetError("the optimizer-state blob holds %s, not {index: "
                         "state}" % type(states).__name__)
    for updater in trainer._updaters:
        updater.set_numpy_states(states)
