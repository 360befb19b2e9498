"""Contributed extensions of the port (counterpart of ``mxtpu/contrib``):
the external-kernel hook and the space-to-depth ResNet stem."""
from . import external_kernel, s2d_stem  # noqa: F401
from .external_kernel import register_external_kernel, register_host_kernel

__all__ = ["external_kernel", "s2d_stem", "register_external_kernel",
           "register_host_kernel"]
