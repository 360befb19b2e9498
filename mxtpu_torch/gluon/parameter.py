"""Parameter & ParameterDict (counterpart of ``mxtpu/gluon/parameter.py``).

A ``Parameter`` carries the reference's metadata (name, shape with 0 for an
unknown dim, dtype, grad_req, initializer). Its tensor lives in the owning
Block's ``nn.Module._parameters`` under the attribute name, so
``module.to()``, ``state_dict()`` and ``named_parameters()`` see it. Until
its shape is known the tensor is a ``torch.nn.UninitializedParameter``,
which follows ``module.to(device)`` like any parameter; the first forward
(``infer_shape``) or loaded weights (``set_data``) settle the shape and
materialize it on the device and in the dtype the placeholder carries.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import resolve_device

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "torch_dtype"]

class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape is known."""


def _seeded_generator(seed=0):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


class Parameter:
    """A weight/bias/aux tensor owned by a Block (ref: gluon/parameter.py)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 init=None, allow_deferred_init=False, differentiable=True):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._deferred_init = None   # (init, default_init, generator)
        self._owner = None           # (module, attribute) holding the tensor
        self._own = self._placeholder(torch.device("cpu"))

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                     self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    # ------------------------------------------------------------- storage
    def _requires_grad(self):
        return self._grad_req != "null"

    def _placeholder(self, device, dtype=None):
        return nn.UninitializedParameter(
            requires_grad=self._requires_grad(), device=device,
            dtype=dtype or torch_dtype(self.dtype))

    def _get(self):
        if self._owner is None:
            return self._own
        module, attr = self._owner
        return module._parameters[attr]

    def _put(self, tensor):
        if not isinstance(tensor, nn.UninitializedParameter):
            tensor = nn.Parameter(tensor.detach(), requires_grad=(
                self._requires_grad() and tensor.is_floating_point()))
        if self._owner is None:
            self._own = tensor
        else:
            module, attr = self._owner
            module._parameters[attr] = tensor

    def _attach(self, module, attr):
        """Move the tensor into ``module._parameters[attr]`` (Block.__setattr__)."""
        if self._owner is not None and self._owner != (module, attr):
            raise MXNetError("Parameter %s is already held by another block; "
                             "sharing parameters is not ported" % self.name)
        tensor = self._get()
        self._owner = (module, attr)
        self._own = None
        self._put(tensor)

    @property
    def initialized(self):
        return not isinstance(self._get(), nn.UninitializedParameter)

    # ---------------------------------------------------------- initialize
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Initialize on ``ctx`` (default: the CUDA device, or raise), now
        when the shape is known, else at the first forward, drawing from
        ``generator`` (default: a new one seeded 0)."""
        default_init = default_init or init_mod.Uniform()
        generator = generator or _seeded_generator()
        device = resolve_device(ctx)
        if self.initialized and not force_reinit:
            return
        self._put(self._placeholder(device))
        if self.shape is None or any(s == 0 for s in self.shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, default_init, generator)
                return
            raise MXNetError("Cannot initialize Parameter %s: unknown shape %s"
                             % (self.name, self.shape))
        self._finish_init(init, default_init, generator)

    def _finish_init(self, init, default_init, generator):
        placeholder = self._get()
        data = torch.zeros(self.shape, dtype=torch.float32)
        chosen = init or self.init
        desc = (init_mod.InitDesc(self.name, attrs={"__init__": chosen})
                if chosen is not None else init_mod.InitDesc(self.name))
        init_mod.create(default_init)(desc, data, generator)
        self._put(data.to(device=placeholder.device, dtype=placeholder.dtype))
        self._deferred_init = None

    def _shape_resolved(self, shape):
        """Fill unknown dims once the first forward sees real data."""
        if self.shape is None:
            self.shape = tuple(shape)
        else:
            if len(self.shape) != len(shape):
                raise MXNetError("shape mismatch for %s: %s vs %s"
                                 % (self.name, self.shape, tuple(shape)))
            merged = []
            for mine, given in zip(self.shape, shape):
                if mine != 0 and given != 0 and mine != given:
                    raise MXNetError("shape mismatch for %s: %s vs %s"
                                     % (self.name, self.shape, tuple(shape)))
                merged.append(mine or given)
            self.shape = tuple(merged)
        if not self.initialized and self._deferred_init is not None:
            self._finish_init(*self._deferred_init)

    # -------------------------------------------------------------- access
    def data(self):
        t = self._get()
        if isinstance(t, nn.UninitializedParameter):
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s deferred init not complete (run a forward "
                    "pass or load weights)" % self.name)
            raise MXNetError("Parameter %s has not been initialized"
                             % self.name)
        return t

    def set_data(self, data):
        """Load ``data`` (numpy array or tensor) in this parameter's dtype,
        on its device. An unknown dim takes the data's size; a known one
        must match."""
        src = data if isinstance(data, torch.Tensor) else torch.tensor(
            np.asarray(data))
        if self.shape is None or any(s == 0 for s in self.shape):
            self._shape_resolved(tuple(src.shape))
        if tuple(src.shape) != tuple(self.shape):
            raise MXNetError("set_data: %s has shape %s, got %s"
                             % (self.name, self.shape, tuple(src.shape)))
        cur = self._get()
        self._put(src.detach().to(device=cur.device, dtype=cur.dtype,
                                  copy=True))
        self._deferred_init = None

    def cast(self, dtype):
        self.dtype = dtype
        t = self._get()
        if isinstance(t, nn.UninitializedParameter):
            self._put(self._placeholder(t.device, torch_dtype(dtype)))
        else:
            self._put(t.detach().to(torch_dtype(dtype)))

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a placeholder records it)."""
        device = resolve_device(ctx)
        t = self._get()
        if isinstance(t, nn.UninitializedParameter):
            self._put(self._placeholder(device, t.dtype))
        else:
            self._put(t.detach().to(device))


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix (ref: ParameterDict)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        return "%s(\n%s)" % (type(self).__name__, "".join(
            "  %r\n" % p for p in self._params.values()))

    def get(self, name, **kwargs):
        """Create ``prefix + name`` (ref: ParameterDict.get); a name that
        exists is returned as it is (sharing parameters is not ported)."""
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = Parameter(name, **kwargs)
        return self._params[name]

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False,
                   generator=None):
        """Initialize every parameter, all drawing from one ``generator``
        (default: a new one seeded 0)."""
        generator = generator or _seeded_generator()
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit, generator=generator)

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)
