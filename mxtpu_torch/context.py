"""Devices (counterpart of ``mxtpu/context.py``).

A context is a ``torch.device``. ``gpu(i)`` is ``cuda:i``; there is no CPU
fallback: an entry point that is given no device runs on
``default_device()``, which is ``cuda:0`` or raises. The CPU runs only
where the caller asks for it (``cpu()``), as the tests do.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device"]


def cpu(device_id=0):
    """The host CPU (``device_id`` is accepted for the reference's API)."""
    return torch.device("cpu")


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return torch.device("cuda", int(device_id))


def default_device():
    """``cuda:0``; raises when this process sees no CUDA device."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available and no device was given: pass "
            "device='cpu' (mxtpu_torch.cpu()) to run on the host")
    return gpu(0)


def resolve_device(device=None):
    """``None`` -> ``default_device()``; strings and devices -> torch.device."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = gpu(0)
    return device
