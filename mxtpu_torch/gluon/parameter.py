"""Parameter & ParameterDict (counterpart of ``mxtpu/gluon/parameter.py``).

A ``Parameter`` carries the reference's metadata (name, shape with 0 for an
unknown dim, dtype, grad_req, initializer). Its tensor lives in the owning
Block's ``nn.Module._parameters`` under the attribute name, so
``module.to()``, ``state_dict()`` and ``named_parameters()`` see it. Until
its shape is known the tensor is a ``torch.nn.UninitializedParameter``,
which follows ``module.to(device)`` like any parameter; the first forward
(``infer_shape``) or loaded weights (``set_data``) settle the shape and
materialize it on the device and in the dtype the placeholder carries.

``data()`` is an ``NDArray`` over that same ``torch.nn.Parameter`` (one
storage, one autograd leaf), made once and rebound whenever the tensor is
replaced (``set_data``, ``cast``, ``reset_ctx``). The leaf points back at
it (``_mx_owner``) and it holds a gradient buffer following ``grad_req``,
so ``autograd.backward`` fills ``grad()`` as it fills an array's after
``attach_grad``. A write through the array (``p.data()[:] = v``) goes to
the parameter. An optimizer step writes into that same tensor in place,
under ``torch.no_grad()``, so an array taken from ``data()`` before a
step shows the new values after it and the leaf keeps its link.

``lr_mult`` and ``wd_mult`` scale the optimizer's learning rate and
weight decay for this parameter; ``_trainer`` is the Trainer that owns
it.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
from torch import nn

from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "torch_dtype"]

class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape is known."""


def _seeded_generator(seed=0):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


class _ParamArray(NDArray):
    """The NDArray of a Parameter: its payload is the parameter's own
    ``torch.nn.Parameter``, already an autograd leaf."""

    __slots__ = ("_param",)

    def _set_data(self, new_data):
        # a write through the array replaces the parameter's tensor
        self._param._put(new_data.detach())
        self._version += 1

    def _make_leaf(self, grad_buf, grad_req):
        self._grad, self._grad_req = grad_buf, grad_req


class Parameter:
    """A weight/bias/aux tensor owned by a Block (ref: gluon/parameter.py)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._trainer = None
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._deferred_init = None   # (init, default_init, generator)
        self._owner = None           # (module, attribute) holding the tensor
        self._read = None            # what a layer reads of the tensor
        self._nd = None              # the _ParamArray data() returns
        self._own = self._placeholder(torch.device("cpu"))

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                     self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', got "
                             "%r" % (req,))
        self._grad_req = req
        t = self._get()
        if isinstance(t, nn.UninitializedParameter):
            self._put(self._placeholder(t.device, t.dtype))
        else:
            self._put(t.detach())

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
        if not isinstance(tensor, nn.UninitializedParameter):
            self._bind(tensor)

    def _bind(self, tensor):
        """Point the NDArray of ``data()`` at ``tensor`` and the leaf back
        at it; the gradient buffer is kept while it still fits."""
        nd = self._nd
        if nd is None:
            nd = self._nd = _ParamArray(tensor)
            nd._param = self
        nd._data = tensor
        if not tensor.requires_grad:
            nd._grad, nd._grad_req = None, "null"
            return
        g = nd._grad
        if g is None or g._data.shape != tensor.shape \
                or g._data.dtype != tensor.dtype \
                or g._data.device != tensor.device:
            nd._grad = NDArray(torch.zeros_like(tensor.detach()))
        nd._grad_req = self._grad_req
        tensor._mx_owner = weakref.ref(nd)

    def _attach(self, module, attr):
        """Move the tensor into ``module._parameters[attr]`` (Block.__setattr__).
        A parameter that another block holds already is shared: it stays
        there, and both blocks read the one tensor."""
        if self._owner is not None and self._owner != (module, attr):
            return
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
    def _tensor(self):
        """The parameter's tensor (what a layer's ``hybrid_forward`` gets)."""
        t = self._get()
        if isinstance(t, nn.UninitializedParameter):
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s deferred init not complete (run a forward "
                    "pass or load weights)" % self.name)
            raise MXNetError("Parameter %s has not been initialized"
                             % self.name)
        return t

    def data(self, ctx=None):
        """The parameter as an NDArray over its own tensor (ref:
        Parameter.data; one copy, so ``ctx`` is not read)."""
        t = self._tensor()
        if self._nd is None or self._nd._data is not t:
            self._bind(t)   # the module replaced the tensor (module.to)
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer that ``autograd.backward`` writes
        (``grad_req='write'``) or adds to (``'add'``)."""
        g = self.data()._grad
        if g is None:
            raise MXNetError("Cannot get gradient array for Parameter %s "
                             "because grad_req='null'" % self.name)
        return g

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        g = self.data()._grad
        if g is not None:
            g._set_data(torch.zeros_like(g._data))

    def _update_aux(self, value):
        """Overwrite a statistic (BatchNorm's moving mean and variance) in
        place, outside autograd."""
        with torch.no_grad():
            self._tensor().copy_(value)

    def set_data(self, data):
        """Load ``data`` (numpy array or tensor) in this parameter's dtype,
        on its device. An unknown dim takes the data's size; a known one
        must match."""
        if isinstance(data, NDArray):
            data = data._data
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


class Constant(Parameter):
    """A parameter that holds a fixed value and takes no gradient (ref:
    gluon/parameter.py:Constant). The value stays where it is given until
    ``initialize(ctx=...)`` moves it (host data: to the default device)."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        self.value = value
        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=str(value.dtype).split(".")[-1],
                         init=init_mod.Constant(0.0), differentiable=False)
        self._put(value.detach().clone())

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        if ctx is not None or self._get().device.type == "cpu":
            self.reset_ctx(ctx)


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix; ``shared`` is a
    dict whose parameters ``get`` hands out by name instead of making new
    ones (ref: ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

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
        """Create or retrieve ``prefix + name`` (ref: ParameterDict.get): a
        name that exists is returned with its unknown attributes filled
        from ``kwargs``, one in the shared dict is shared."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            for k, v in kwargs.items():
                if k == "shape" and v is not None and param.shape is not None:
                    continue
                if getattr(param, k, None) in (None, 0) and v is not None:
                    setattr(param, k, v)
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._params[name]
        self._params[name] = Parameter(name, **kwargs)
        return self._params[name]

    def get_constant(self, name, value=None):
        """Create or retrieve the Constant ``prefix + name``."""
        name = self._prefix + name
        if name not in self._params:
            if value is None:
                raise MXNetError("No constant named %s: give its value" % name)
            self._params[name] = Constant(name, value)
        return self._params[name]

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, generator=None):
        """Initialize every parameter, all drawing from one ``generator``
        (default: a new one seeded 0); ``verbose`` is accepted and
        unused, as the reference's."""
        generator = generator or _seeded_generator()
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit, generator=generator)

    def setattr(self, name, value):
        """Set attribute ``name`` of every Parameter to ``value``
        (``collect_params('.*dense0.*').setattr('grad_req', 'null')``
        freezes those layers)."""
        for p in self._params.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename`` by name, less
        ``strip_prefix`` (ref: ParameterDict.save)."""
        from ..ndarray.utils import save as nd_save
        arg = {}
        for p in self._params.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load ``filename`` by name, ``restore_prefix`` put back and the
        checkpoints' ``arg:``/``aux:`` markers dropped, through
        ``set_data`` (ref: ParameterDict.load)."""
        from ..context import cpu
        from ..ndarray.utils import load as nd_load
        with cpu():   # staged on the host; set_data moves each array
            loaded = nd_load(filename)
        loaded = {restore_prefix + (k[4:] if k.startswith(("arg:", "aux:"))
                                    else k): v for k, v in loaded.items()}
        if not allow_missing:
            for name in self._params:
                if name not in loaded:
                    raise MXNetError("Parameter %s missing in file %s"
                                     % (name, filename))
        for name, v in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError("Parameter %s in file is not in this dict"
                                 % name)
            self._params[name].set_data(v)
