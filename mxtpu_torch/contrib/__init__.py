"""Contributed extensions of the port (counterpart of ``mxtpu/contrib``):
so far the external-kernel hook."""
from . import external_kernel  # noqa: F401
from .external_kernel import register_external_kernel, register_host_kernel

__all__ = ["external_kernel", "register_external_kernel",
           "register_host_kernel"]
