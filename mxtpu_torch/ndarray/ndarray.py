"""NDArray: the imperative tensor of the port, a wrapper over a dense
``torch.Tensor`` (counterpart of ``mxtpu/ndarray/ndarray.py``).

* Every op goes through ``_apply``, which unwraps NDArrays, runs the
  tensor function under ``torch.set_grad_enabled(autograd.taping())``
  and wraps the result: outside ``record()`` (and a recorded control-flow
  body) nothing is taped, even for an array with an attached gradient.
* Mutation is value replacement (``_set_data``): ``x += y``, ``x[i] = v``
  and ``out=`` rebind the payload to a new tensor, never a torch in-place
  op on a tensor autograd may have saved. An array with an attached
  gradient stays an autograd leaf across a replacement made outside
  ``record()`` (an optimizer's ``w -= lr * w.grad``).
* Dtypes follow the JAX package with x64 off: float64 input gives float32
  and int64 gives int32.
* Arrays made from host data land on ``default_device()`` (``cuda:0``, or
  raise) unless given a ``ctx``; arrays made from tensors stay where the
  tensor is.
"""
from __future__ import annotations

import time as _time
import weakref

import numpy as _np
import torch

from .. import autograd, profiler as _profiler, telemetry
from ..base import MXNetError, canonical_dtype, numpy_dtype
from ..context import Context, resolve_device

__all__ = ["NDArray", "array", "_apply", "from_torch", "waitall"]


def _unwrap(out):
    return out._data if isinstance(out, NDArray) else out


# the symbol trace's tape (symbol.symbol._SYM_TAPE), set when that module
# is imported: while a block is traced on this thread an op run here
# records its node
_TRACE = None


_PROF = _profiler._PROF   # the profiler's state: ``active`` gates the hook


def _apply(fn, args, kwargs=None, name="", num_outputs=None):
    """Invoke a tensor-level function on NDArray/scalar args (ref:
    Imperative::Invoke): NDArrays among the top-level ``args``/``kwargs``
    become their tensors; the output (a tensor, or a tuple/list of them)
    comes back as NDArray(s). Taped only while ``autograd.taping()``."""
    kwargs = kwargs or {}
    a = [x._data if isinstance(x, NDArray) else x for x in args]
    kw = {k: (v._data if isinstance(v, NDArray) else v)
          for k, v in kwargs.items()}
    if _PROF.active:   # the profiler's op hook: one attribute read when off
        t0 = _time.perf_counter_ns()
        with torch.set_grad_enabled(autograd.taping()):
            out = fn(*a, **kw)
        _profiler.record_event(name or "op", "operator", t0 // 1000,
                               (_time.perf_counter_ns() - t0) // 1000)
    else:
        with torch.set_grad_enabled(autograd.taping()):
            out = fn(*a, **kw)
    if _TRACE is not None and _TRACE.active is not None:
        from ..symbol.symbol import record_apply
        record_apply(name, a, kw, [_unwrap(o) for o in out]
                     if isinstance(out, (tuple, list)) else [_unwrap(out)])
    if isinstance(out, (tuple, list)):
        return [NDArray(_unwrap(o)) for o in out]
    return NDArray(_unwrap(out))


def _to_tensor(source, ctx=None, dtype=None):
    """A tensor from host data (numpy, lists, scalars) or a tensor, in the
    JAX package's dtypes (x64 off)."""
    if isinstance(source, torch.Tensor):
        t = source
        if ctx is not None:
            t = t.to(resolve_device(ctx))
    else:
        host = _np.asarray(source)
        if any(st < 0 for st in host.strides):
            host = host.copy()   # a flipped view cannot become a tensor
        if host.dtype == _np.float64 and dtype is None:
            host = host.astype(_np.float32)   # MXNet's float default
        t = torch.tensor(host, device=resolve_device(ctx))
    dt = canonical_dtype(dtype) if dtype is not None \
        else canonical_dtype(t.dtype)
    return t if t.dtype == dt else t.to(dt)


class NDArray:
    """Multi-dimensional array with MXNet NDArray semantics over a tensor."""

    __slots__ = ("_data", "_grad", "_grad_req", "_version", "__weakref__")

    # make `ndarray op numpy_array` use our reflected ops, not numpy's
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor) or ctx is not None:
            data = _to_tensor(data, ctx)
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._version = 0

    # ------------------------------------------------------------------ core
    def _set_data(self, new_data):
        """Replace the payload (the mutation primitive). An array with an
        attached gradient keeps a leaf that requires grad when the new
        payload carries no history."""
        if self._grad is not None and new_data.grad_fn is None \
                and new_data.is_floating_point() \
                and not new_data.requires_grad:
            new_data = self._leaf(new_data)
        self._data = new_data
        self._version += 1

    def _leaf(self, t):
        t = t.detach()
        if t.is_floating_point():
            t.requires_grad_(True)
            t._mx_owner = weakref.ref(self)
        return t

    def _make_leaf(self, grad_buf, grad_req):
        """Detach from any history and become an autograd leaf whose
        gradient goes into ``grad_buf`` (attach_grad / mark_variables)."""
        self._data = self._leaf(self._data)
        self._grad = grad_buf
        self._grad_req = grad_req

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """A numpy dtype (``torch.bfloat16`` for bfloat16)."""
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        """The torch.device the payload lives on."""
        return self._data.device

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return _apply(lambda x: x.permute(tuple(range(x.ndim))[::-1]),
                      (self,), name="transpose")

    @property
    def grad(self):
        return self._grad

    # ------------------------------------------------------------- sync points
    def wait_to_read(self):
        """Block until the value is computed; deferred CUDA errors surface
        here."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)
        return self

    def asnumpy(self) -> _np.ndarray:
        """A copy on the host (a CPU tensor's ``numpy()`` would share its
        memory, which later in-place writes, an optimizer step's, change).
        Counted as one device-to-host sync (``telemetry.record_d2h``)."""
        telemetry.record_d2h()
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            return d.float().cpu().numpy()
        if d.device.type == "cpu":
            return d.numpy().copy()
        return d.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(map(str, self.shape)), self.context)

    # ------------------------------------------------------------ conversions
    def astype(self, dtype, copy=True):
        dt = canonical_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return _apply(lambda x: x.to(dt), (self,), name="cast")

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into another NDArray or onto a device (ref: CopyFromTo)."""
        if isinstance(other, NDArray):
            if self.shape != other.shape:
                raise MXNetError("copyto shape mismatch: %s vs %s"
                                 % (self.shape, other.shape))
            other._set_data(self._data.detach().to(
                dtype=other._data.dtype, device=other._data.device,
                copy=True))
            return other
        if isinstance(other, (Context, torch.device, str)):
            return NDArray(self._data.detach().to(resolve_device(other),
                                                  copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, ctx):
        if resolve_device(ctx) == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        if stype == "default":
            return self
        from .sparse import cast_storage  # late: sparse is built on NDArray
        return cast_storage(self, stype)

    def to_torch(self):
        """The underlying tensor (takes the place of the JAX package's
        ``to_jax``)."""
        return self._data

    def __dlpack__(self, *a, **kw):
        return self._data.detach().__dlpack__(*a, **kw)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def to_dlpack_for_read(self):
        """A one-shot "dltensor" capsule over this array's memory (ref:
        NDArray.to_dlpack_for_read)."""
        from .dlpack import to_dlpack_for_read
        return to_dlpack_for_read(self)

    def to_dlpack_for_write(self):
        from .dlpack import to_dlpack_for_write
        return to_dlpack_for_write(self)

    # --------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a grad buffer; marks this array as an autograd leaf
        (ref: NDArray.attach_grad)."""
        self._make_leaf(NDArray(torch.zeros_like(self._data.detach())),
                        grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # ---------------------------------------------------------------- indexing
    def __getitem__(self, key):
        key = _clean_index(key, self._data.device)
        return _apply(lambda x: x[key], (self,), name="slice")

    def __setitem__(self, key, value):
        if autograd.is_recording():
            raise MXNetError("Inplace assignment is not supported when "
                             "recording (ref: mxnet inplace-under-autograd "
                             "restriction)")
        key = _clean_index(key, self._data.device)
        if isinstance(value, NDArray):
            v = value._data
        elif isinstance(value, (int, float, bool)):
            v = value
        else:
            v = _to_tensor(value, self._data.device)
        with torch.no_grad():
            if isinstance(key, slice) and key == slice(None) \
                    and isinstance(v, torch.Tensor) \
                    and tuple(v.shape) == self.shape:
                new = v.to(self._data.dtype, copy=True)
            else:
                new = self._data.detach().clone()
                new[key] = v
        self._set_data(new)

    # ------------------------------------------------------------- arithmetic
    def _operand(self, other):
        if isinstance(other, NDArray):
            # a sparse operand's _data is its values: the dense fallback
            return other if other.stype == "default" else other.todense()
        if isinstance(other, _np.number):
            return other.item()
        if isinstance(other, (int, float, bool)):
            return other
        if isinstance(other, _np.ndarray):
            return NDArray(_to_tensor(other, self._data.device))
        return None

    def _binop(self, other, fn, name):
        other = self._operand(other)
        if other is None:
            return NotImplemented
        return _apply(fn, (self, other), name=name)

    def _rbinop(self, other, fn, name):
        other = self._operand(other)
        if other is None:
            return NotImplemented
        return _apply(fn, (other, self), name=name)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b, "broadcast_sub")

    def __rsub__(self, o):
        return self._rbinop(o, lambda a, b: a - b, "broadcast_sub")

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b, "broadcast_div")

    def __rtruediv__(self, o):
        return self._rbinop(o, lambda a, b: a / b, "broadcast_div")

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __mod__(self, o):
        return self._binop(o, lambda a, b: a % b, "broadcast_mod")

    def __rmod__(self, o):
        return self._rbinop(o, lambda a, b: a % b, "broadcast_mod")

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b, "broadcast_power")

    def __rpow__(self, o):
        return self._rbinop(o, lambda a, b: a ** b, "broadcast_power")

    def __neg__(self):
        return _apply(torch.neg, (self,), name="negative")

    def __abs__(self):
        return _apply(torch.abs, (self,), name="abs")

    def __matmul__(self, o):
        return self._binop(o, torch.matmul, "matmul")

    def _compare(self, o, fn, name):
        if self._operand(o) is None:
            return NotImplemented
        return self._binop(o, lambda a, b: fn(a, b).to(torch.float32), name)

    def __eq__(self, o):
        return self._compare(o, lambda a, b: a == b, "broadcast_equal")

    def __ne__(self, o):
        return self._compare(o, lambda a, b: a != b, "broadcast_not_equal")

    def __gt__(self, o):
        return self._compare(o, lambda a, b: a > b, "broadcast_greater")

    def __ge__(self, o):
        return self._compare(o, lambda a, b: a >= b,
                             "broadcast_greater_equal")

    def __lt__(self, o):
        return self._compare(o, lambda a, b: a < b, "broadcast_lesser")

    def __le__(self, o):
        return self._compare(o, lambda a, b: a <= b, "broadcast_lesser_equal")

    __hash__ = object.__hash__

    # in-place ops rebind the payload; while recording they tape like
    # ordinary ops (the reference's kWriteInplace + var version bump)
    def _inplace(self, res):
        if res is NotImplemented:
            return res
        self._set_data(res._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    # ------------------------------------------------------------ shape ops
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
        # MXNet 0 means "copy this dim"
        new_shape = tuple(self.shape[i] if s == 0 else s
                          for i, s in enumerate(shape))
        return _apply(lambda x: x.reshape(new_shape), (self,), name="reshape")

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return _apply(lambda x: x.unsqueeze(axis), (self,), name="expand_dims")

    def squeeze(self, axis=None):
        return _apply(lambda x: _squeeze(x, axis), (self,), name="squeeze")

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _apply(lambda x: x.permute(
            axes if axes else tuple(range(x.ndim))[::-1]), (self,),
            name="transpose")

    def swapaxes(self, dim1, dim2):
        return _apply(lambda x: x.transpose(dim1, dim2), (self,),
                      name="swapaxes")

    def flatten(self):
        n = self.shape[0] if self.ndim > 0 else 1
        return _apply(lambda x: x.reshape(n, -1), (self,), name="flatten")

    def broadcast_to(self, shape):
        return _apply(lambda x: x.broadcast_to(tuple(shape)), (self,),
                      name="broadcast_to")

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data.detach()))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data.detach()))


def _squeeze(x, axis=None):
    """numpy squeeze: every size-1 axis, or the given ones."""
    if axis is None:
        return x.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return x.squeeze(tuple(a % x.ndim for a in axes)) if axes else x


def _clean_index(key, device):
    """Normalize an index: NDArrays and lists become int64 tensors (float
    index arrays truncate, the reference's float-index convention), float
    scalars become ints, tuples recursively; boolean masks stay masks."""
    if isinstance(key, tuple):
        return tuple(_clean_index(k, device) for k in key)
    if isinstance(key, (float, _np.floating)):
        return int(key)
    if isinstance(key, NDArray):
        key = key._data
    elif isinstance(key, (list, _np.ndarray)):
        key = torch.as_tensor(_np.asarray(key), device=device)
    if isinstance(key, torch.Tensor) and key.dtype != torch.bool:
        return key.to(device=device, dtype=torch.int64)
    return key


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """Create an NDArray from any array-like (ref: mx.nd.array): host data
    lands on ``ctx`` (default: ``default_device()``), a tensor or NDArray
    stays on its device unless ``ctx`` is given."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data.detach()
    return NDArray(_to_tensor(source_array, ctx, dtype))


def from_torch(x) -> NDArray:
    """Wrap a tensor (shares its storage; takes the place of from_jax)."""
    return NDArray(x)


def waitall():
    """Block until all enqueued work completes (ref: MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
