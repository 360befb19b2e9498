"""Devices (counterpart of ``mxtpu/base.py:Context`` and ``mxtpu/context.py``).

A ``Context`` names a device as the reference does (``cpu(0)``, ``gpu(1)``)
and compares equal to the ``torch.device`` it stands for (``cpu()`` to
``torch.device("cpu")``, ``gpu(i)`` to ``cuda:i``). ``with ctx:`` makes it
the current context of this thread (``current_context()``) until the
block ends. There is no CPU fallback: an entry point that is given no
device runs on ``default_device()``, which is the device of the innermost
``with ctx:`` scope, else ``cuda:0``, and raises when there is no scope and
no CUDA device. The CPU runs only where the caller asks for it (``cpu()``,
as an argument or as a scope), as the tests do.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "default_device", "resolve_device"]


class Context:
    """A device context (ref: mxtpu/base.py:Context); ``cpu_pinned`` and
    ``cpu_shared`` are host memory, as ``cpu`` is."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        elif isinstance(device_type, str):
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        else:
            self.device_typeid = int(device_type)
            self.device_id = int(device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The ``torch.device`` this context names."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @property
    def type(self):
        """``torch_device.type`` ("cuda" or "cpu")."""
        return self.torch_device.type

    @property
    def index(self):
        """``torch_device.index``."""
        return self.torch_device.index

    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_typeid == other.device_typeid
                    and self.device_id == other.device_id)
        if isinstance(other, torch.device):
            return self.torch_device == resolve_device(other)
        return NotImplemented

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def empty_cache(self):
        """Release cached device memory (ref: MXStorageEmptyCache)."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    def __enter__(self):
        _scopes().append(self)
        return self

    def __exit__(self, *args):
        _scopes().pop()


def _scopes():
    stack = getattr(Context._default_ctx, "contexts", None)
    if stack is None:
        stack = Context._default_ctx.contexts = []
    return stack


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for the reference's API)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def current_context():
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``
    (the reference's is its accelerator, ``tpu(0)``)."""
    stack = _scopes()
    return stack[-1] if stack else gpu(0)


def num_gpus():
    """Number of visible CUDA devices (ref: mx.context.num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device():
    """The device of the innermost ``with ctx:`` scope, else ``cuda:0``;
    raises when there is no scope and this process sees no CUDA device."""
    stack = _scopes()
    if stack:
        return stack[-1].torch_device
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available and no device was given: pass "
            "device='cpu' (mxtpu_torch.cpu()) to run on the host")
    return torch.device("cuda", 0)


def resolve_device(device=None):
    """``None`` -> ``default_device()``; contexts, strings and devices ->
    torch.device."""
    if device is None:
        return default_device()
    if isinstance(device, Context):
        return device.torch_device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device
